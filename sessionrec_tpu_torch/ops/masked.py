"""Masked reductions over padded axes.

Counterpart of ``sessionrec_tpu/ops/masked.py``: the dense-layout
equivalents of DGL's segment kernels (segment_softmax / segment_reduce
and edge_softmax in the reference).  Each session graph occupies one row
of a padded ``[B, N, ...]`` tensor with a ``mask`` marking real entries.
"""

from __future__ import annotations

import torch

# Large-but-finite negative used to mask logits; finite so that an
# all-masked row yields zeros (not NaNs) after the exp-normalise.
NEG_INF = -1e30


def masked_softmax(e, mask, dim: int):
    """Softmax of ``e`` over ``dim`` restricted to ``mask`` (0/1 or bool).

    Masked entries get probability exactly 0 and a fully masked row gives
    all zeros.  The exp-normalise runs in float32; the result returns in
    the input dtype.
    """
    in_dtype = e.dtype
    mask = mask.to(torch.bool)
    e = torch.where(mask, e.to(torch.float32), NEG_INF)
    m = torch.amax(e, dim=dim, keepdim=True)
    # guard: for an all-masked row m == NEG_INF; shift so exp() is finite
    m = torch.clamp(m, min=NEG_INF * 0.5)
    ex = torch.where(mask, torch.exp(e - m), 0.0)
    s = torch.sum(ex, dim=dim, keepdim=True)
    out = ex / torch.clamp(s, min=torch.finfo(torch.float32).tiny)
    return out.to(in_dtype)


def masked_mean(x, mask, dim: int):
    """Mean of ``x`` over ``dim`` restricted to ``mask`` (0 for empty)."""
    mask = mask.to(x.dtype)
    s = torch.sum(x * mask, dim=dim)
    n = torch.sum(mask, dim=dim)
    return s / torch.clamp(n, min=1.0)
