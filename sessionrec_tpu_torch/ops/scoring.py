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


def log_softmax_scores(sr, table, imask, scale: float = 1.0,
                       compute_dtype=None):
    """log(softmax(scale * sr @ table^T)) over real items; padded columns
    (``imask`` false) get ~NEG_INF log-probability (srgnn.py:147,
    niser.py:154)."""
    logits = scale * catalog_logits(sr, table, compute_dtype)
    logits = torch.where(imask.bool(), logits, NEG_INF)
    return torch.log_softmax(logits, dim=-1)


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


def use_count_ranks(rank_method) -> bool:
    """Resolve the eval rank method: None (auto) and "count" count, "topk"
    takes the reference-shaped top-k; anything else raises."""
    if rank_method not in (None, "count", "topk"):
        raise ValueError(
            f"rank_method must be None, 'count' or 'topk', got "
            f"{rank_method!r}")
    return rank_method != "topk"


def stable_topk(x, k: int):
    """``lax.top_k`` over the last axis: ``(values, int64 indices)``, the
    largest first, equal values by ascending index.

    ``torch.topk`` finds the right values but promises no order among
    equal ones.  So its k-th value ``v`` fixes the set: every element
    above ``v``, and of those equal to ``v`` the lowest indices, until
    there are k.  The set's indices come out in ascending order (a prefix
    sum places each); a stable sort of their k values then puts them in
    ``lax.top_k``'s order.  Every shape is static, so the function runs
    inside a CUDA graph.
    """
    n = x.shape[-1]
    v = torch.topk(x, k, dim=-1).values[..., -1:]
    above = x > v
    eq = x == v
    need = k - torch.sum(above, dim=-1, keepdim=True, dtype=torch.int32)
    take = above | (eq & (torch.cumsum(eq, -1, dtype=torch.int32) <= need))
    pos = torch.cumsum(take, -1, dtype=torch.int32) - 1
    cols = torch.arange(n, device=x.device).expand(x.shape)
    slots = torch.full(x.shape[:-1] + (k + 1,), n, dtype=torch.int64,
                       device=x.device)
    # the columns not taken all land in slot k, which is dropped
    slots.scatter_(-1, torch.where(take, pos, k).to(torch.int64), cols)
    ids = slots[..., :k]
    vals = torch.gather(x, -1, ids)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return torch.gather(vals, -1, order), torch.gather(ids, -1, order)


def topk_ranks(log_probs, labels, k: int):
    """1-based rank of each label within the top-k, else 0: the label's
    position in ``stable_topk`` (evaluate(), train.py:45-53), ties
    resolved as ``lax.top_k`` resolves them."""
    _, idx = stable_topk(log_probs, k)
    hit = idx == labels.to(torch.int64)[:, None]
    rank = torch.argmax(hit.to(torch.int32), dim=-1) + 1
    return torch.where(torch.any(hit, dim=-1), rank, 0)
