"""Counter-hash dropout.

Counterpart of ``sessionrec_tpu/ops/dropout.py``: each element's keep bit
is a murmur3-finalizer hash of ``(seed, flat element index)``, so the
mask is a pure function of one integer seed and is bit-identical to the
JAX package's for the same seed.  The seed is a Python integer or an
int64 tensor on the data's device; the two give the same bits for the
same value, and a device seed costs no host-to-device copy, so a
captured CUDA graph reads a new seed on every replay
(``models/layers.py:SeedSource``).  The JAX package switches to
``jax.random.bernoulli`` for tensors under 4096 elements or 32 features;
the port uses the hash everywhere, which changes only the random stream.

PyTorch's uint32 arithmetic is incomplete on both CPU and CUDA, so the
hash runs in int64 and keeps the low 32 bits after each step.  A 32-bit
by 32-bit product can pass 2**63, so ``_mul32`` splits the constant into
16-bit halves and never forms a product above 2**48.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(a, c: int):
    """``(a * c) mod 2**32`` for int64 ``a`` in [0, 2**32)."""
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (hi + a * (c & 0xFFFF)) & _M32


def fmix32(h):
    """murmur3's 32-bit finalizer of int64 ``h`` in [0, 2**32): a
    bijection on 32-bit values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _hash_bits(seed, shape, device=None, offset=0):
    """murmur3 finalizer of (seed, flat element index) -> [R, C] int64
    holding uint32 values (``sessionrec_tpu/ops/dropout.py:_hash_bits``).
    ``seed`` is an int or a 0-d int64 tensor on ``device``; its low 32
    bits count.  ``offset`` (an int, or an int64 ``[R, 1]`` tensor, one
    per row) is added to the flat indices: the place of a mesh rank's
    block in the global tensor whose indices the JAX package hashes."""
    R, C = shape
    if not torch.is_tensor(seed):
        seed = torch.tensor(int(seed) & _M32, dtype=torch.int64,
                            device=device)
    idx = torch.arange(R * C, dtype=torch.int64, device=device) \
        .reshape(R, C)
    if torch.is_tensor(offset) or offset:     # one device adds nothing
        idx = idx + offset
    idx = idx & _M32
    return fmix32(idx ^ _mul32(seed & _M32, 0x9E3779B9))


def _keep_threshold(rate: float) -> int:
    # keep iff bits < keep_prob * 2^32  (bits uniform in [0, 2^32))
    return min(int((1.0 - rate) * 4294967296.0), 4294967295)


def dropout(x, rate: float, seed, offset=0):
    """Inverted dropout on ``x`` (any rank; last axis = features):
    ``y = x / keep * [hash < keep * 2^32]``, torch nn.Dropout semantics.
    ``seed``: an int or a 0-d int64 tensor on ``x``'s device; ``offset``
    as ``_hash_bits`` takes it."""
    if rate == 0.0:
        return x
    C = x.shape[-1]
    keep = _hash_bits(seed, (x.numel() // C, C), x.device, offset) \
        < _keep_threshold(rate)
    # a host tensor's value: no device work, so legal inside a capture
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32) \
        .to(x.dtype).item()
    y = torch.where(keep, x.reshape(-1, C) * scale, 0.0)
    return y.reshape(x.shape)
