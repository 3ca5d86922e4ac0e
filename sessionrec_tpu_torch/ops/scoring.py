"""Full-catalog scoring: the [B, d] x [d, num_items] products of eval.

Counterpart of ``sessionrec_tpu/ops/scoring.py``.  The catalog is padded
to a multiple of 512 rows (the JAX kernel's catalog tile); padded columns
are masked before any softmax or ranking, so results equal the unpadded
computation.
"""

from __future__ import annotations

import torch

from sessionrec_tpu_torch.ops.masked import NEG_INF


def pad_catalog(num_items: int, multiple: int = 512) -> int:
    """Padded catalog size: the embedding table's row count.  Kept equal
    to the JAX package's so parameters convert one to one."""
    return ((num_items + multiple - 1) // multiple) * multiple


def item_mask(num_items: int, padded: int, device=None):
    """[padded] bool mask of real catalog entries."""
    return torch.arange(padded, device=device) < num_items


def catalog_logits(sr, table, compute_dtype=None):
    """sr [.., d] @ table[P, d]^T -> [.., P] in float32.

    A plain product, left to ``torch.matmul`` as the JAX package leaves
    it to XLA.  ``compute_dtype`` (e.g. ``torch.bfloat16``) rounds the
    inputs to it first; the products and their sums stay float32 either
    way, as JAX's ``preferred_element_type=float32``.
    """
    if compute_dtype is not None:
        sr, table = sr.to(compute_dtype), table.to(compute_dtype)
    return torch.matmul(sr.to(torch.float32), table.to(torch.float32).T)


def masked_catalog_softmax(logits, col_mask):
    """softmax over the last axis restricted to ``col_mask``; rows with an
    empty mask return zeros (MSGIFSR's REnorm split, msgifsr.py:289-292)."""
    keep = col_mask.bool()
    x = torch.where(keep, logits, NEG_INF)
    m = torch.clamp(torch.amax(x, dim=-1, keepdim=True), min=NEG_INF * 0.5)
    ex = torch.where(keep, torch.exp(x - m), 0.0)
    s = torch.sum(ex, dim=-1, keepdim=True)
    return ex / torch.clamp(s, min=torch.finfo(ex.dtype).tiny)


def nll_loss(log_probs, labels, valid):
    """Mean negative log-likelihood over valid rows (train.py:99)."""
    lp = torch.gather(log_probs, -1, labels.to(torch.int64)[:, None])[:, 0]
    v = valid.to(lp.dtype)
    return -torch.sum(lp * v) / torch.clamp(torch.sum(v), min=1.0)


def label_ranks_by_count(scores, labels, k: int):
    """1-based rank of each label within the top-k, else 0 — counted, not
    sorted (``sessionrec_tpu/ops/scoring.py:label_ranks_by_count``).

    The label sits at position ``#{j : s_j > s_label} + #{j : s_j ==
    s_label, j < label}`` of the descending sort: the second term is the
    stable tie rule (equal values ordered by ascending index) of
    ``lax.top_k``.  Padded columns must score strictly below the label
    (callers give them -inf).
    """
    labels = labels[:, None].to(torch.int64)
    lv = torch.gather(scores, -1, labels)
    col = torch.arange(scores.shape[-1], device=scores.device)[None, :]
    greater = torch.sum(scores > lv, dim=-1)
    eq_before = torch.sum((scores == lv) & (col < labels), dim=-1)
    rank = greater + eq_before + 1
    return torch.where(rank <= k, rank, 0)
