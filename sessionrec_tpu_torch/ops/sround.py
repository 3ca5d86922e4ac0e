"""Stochastic rounding float32 -> bfloat16 (counter hash, plain torch).

Counterpart of ``sessionrec_tpu/ops/sround.py``.  With a bfloat16 table
the trainer adds each update in float32 and rounds the sum back with
these functions: a round-to-nearest ``p + u`` stalls once ``|u| < 2^-9
|p|`` (bf16 keeps 8 mantissa bits), which happens as soon as StepLR
lowers the rate.  Rounding down or up with a probability proportional to
the discarded mantissa keeps the update unbiased, ``E[sr(x)] == x``.

The bit rule: add a uniform 16-bit value to the low 16 bits of the
float32 pattern and keep the top 16 bits.  IEEE754's ordering makes this
exact stochastic rounding toward the two bf16 neighbours in magnitude,
carries included; NaN is quieted (``| 0x00400000``) and Inf passes
through.  The 16 bits are the top half of the murmur3 finalizer of
``(seed, flat index)``, the hash of ``ops/dropout.py``, so the result is
bit-identical to the JAX package's for the same ``(x, seed)``.

The JAX package writes this as a fused XLA expression, not a Pallas
kernel, and so is it here: plain torch ops in int64 (PyTorch's uint32
arithmetic is incomplete), a full pass over the table per step.  The
seed is an int or a 0-d int64 tensor on ``x``'s device; a device seed
lets a captured CUDA graph round differently on every replay.
"""

from __future__ import annotations

import torch

from sessionrec_tpu_torch.ops.dropout import _M32, _hash_bits

_QUIET = 0x00400000


def stochastic_round_bf16_bits(x, seed, offset=0):
    """The bf16 bit patterns of ``stochastic_round_bf16(x, seed)``: the
    uint16 values in an int16 tensor of ``x``'s shape (the JAX package's
    ``stochastic_round_bf16_bits`` returns them as uint16).  ``offset``
    is added to the flat indices that are hashed (a catalog shard's place
    in the whole table)."""
    x = x.to(torch.float32)
    C = x.shape[-1]
    flat = x.reshape(-1, C)
    u = flat.view(torch.int32).to(torch.int64) & _M32
    r = _hash_bits(seed, tuple(flat.shape), x.device, offset) >> 16
    y = torch.where(torch.isfinite(flat), u + r,
                    torch.where(torch.isnan(flat), u | _QUIET, u))
    bits = y >> 16                                  # [0, 2^16)
    return (bits - ((bits & 0x8000) << 1)).to(torch.int16).reshape(x.shape)


def bf16_from_bits(bits):
    """int16-held bf16 bit patterns -> bfloat16 values (a bitcast)."""
    return bits.view(torch.bfloat16)


def stochastic_round_bf16(x, seed):
    """Round float32 ``x`` (rank >= 1; the last axis is the row) to
    bfloat16 stochastically; the draw is a pure function of ``(seed, flat
    element index)``."""
    return bf16_from_bits(stochastic_round_bf16_bits(x, seed))
