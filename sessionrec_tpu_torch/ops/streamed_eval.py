"""Streamed full-catalog eval ranking: the ``[B, (K,) P]`` scores never exist.

Counterpart of ``sessionrec_tpu/ops/streamed_eval.py``.  Eval and serving
on the materialised path build the whole score tensor: ``[B, P]`` float32
for the plain head (2 GiB at B 512 and P = 2^20), ``[B, K, P]`` several
times over for the multi head.  The functions here compute the same label
ranks and top-k ids while walking the catalog in ``[tile, D]`` slabs, so
the largest temporary is ``[B, (K,) tile]``.  ``train/runner.py`` streams
eval from 2^30 score elements on (``_auto_stream``), as the JAX package
does; ``serving.py`` streams the multi head's top-k there.

Each slab is one ``torch.matmul`` of the session vectors against the
slab's rows, accumulated in float32: a plain large product that the JAX
package leaves to XLA outside any Pallas kernel (its module docstring,
:23-27), and the masks and reductions around it are plain torch too.
The loops over slabs are Python loops over static shapes, with no host
synchronisation, so a CUDA graph captures them (the runner's eval graphs,
``serving.RecommendStep``).  The table is l2-normalised, cast to the
compute type and padded to whole slabs once per call (one ``[P, D]``
copy); normalisation is row by row, so each slab's rows carry the bits
the JAX package's per-slab normalisation gives them.

Ties.  The counting rankers (``streamed_count_ranks``,
``streamed_multi_count_ranks``) take the label's own score from the slab
product itself in one pass and count the scores above it, and the equal
ones at lower columns, in a second pass: both passes run the same
product on the same shapes, so the label's score compares bitwise equal
against its own column and the ranks equal ``lax.top_k``'s, ties
included.  The top-k forms take a stable top-k of each slab
(``scoring.stable_topk``) and merge it after the running candidates,
which come from lower columns, with a stable sort, so equal scores
resolve to the lowest column, as one global ``lax.top_k`` does.

The multi-order functions replay MSGIFSR's REnorm/fusion scoring
(``models/msgifsr.py:apply``): one pass gathers the online max and
sum-exp per (example, order, part), a later pass forms each slab's
blended score.  Values are raw blended probabilities, whose order is the
order of the ``log(clamp(score))`` that ``apply`` returns.  Session
membership is scattered into a ``[B, tile]`` mask per slab, where the
JAX package compares ``[B, N, tile]``: the same mask, N times fewer
bytes.

``col_offset`` and ``n_valid`` give the shard-local form (the table is
one catalog shard, ``col_offset`` its first global row, ``n_valid`` its
real rows).  With ``axis_name``, a ``parallel/mesh.py:Mesh``, the shards
of its model group merge: the label's score comes from the rank that
holds its column (a sum of one exact value and zeros), the counts add up,
and the multi head's (max, sum-exp) merge as the training loss's do
(``ops/xent.py:merge_partial_max_sum``), so every shard blends its columns
against the whole catalog's denominators.
"""

from __future__ import annotations

import torch

from sessionrec_tpu_torch.models.layers import l2norm
from sessionrec_tpu_torch.ops.masked import NEG_INF
from sessionrec_tpu_torch.ops.scoring import stable_topk
from sessionrec_tpu_torch.ops.xent import merge_partial_max_sum
from sessionrec_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, all_reduce

TILE = 2048


def _mesh_of(axis_name):
    """The mesh whose model group merges the shards, or None; the JAX
    package's axis names have no meaning here."""
    if axis_name is not None and not isinstance(axis_name, Mesh):
        raise TypeError(f"axis_name must be a parallel.mesh.Mesh, got "
                        f"{axis_name!r}")
    return axis_name


def _slabs(sr, table, normalize_table, compute_dtype, tile):
    """(float32 sr, float32 table padded to whole slabs, slab count): the
    operands of every slab product, as ``scoring.catalog_logits`` rounds
    them (the normalised table, both cast to ``compute_dtype`` first)."""
    if normalize_table:
        table = l2norm(table)
    if compute_dtype is not None:
        sr, table = sr.to(compute_dtype), table.to(compute_dtype)
    sr, table = sr.to(torch.float32), table.to(torch.float32)
    pad = (-table.shape[0]) % tile
    if pad:
        table = torch.cat([table, table.new_zeros(pad, table.shape[1])])
    return sr, table, table.shape[0] // tile


def _merge_topk(vals, idxs, tv, ti, k):
    """Merge the running candidates with a slab's top-k.  The running ones
    (earlier slabs, lower columns) come first, so the stable sort keeps
    the lowest column on ties."""
    v = torch.cat([vals, tv], dim=1)
    i = torch.cat([idxs, ti], dim=1)
    order = torch.sort(v, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(v, 1, order), torch.gather(i, 1, order)


def _ranks_of(labels, idxs, vals):
    hit = (idxs == labels.to(torch.int64)[:, None]) & (vals > NEG_INF * 0.5)
    rank = torch.argmax(hit.to(torch.int32), dim=-1) + 1
    return torch.where(torch.any(hit, dim=-1), rank, 0)


def _init_topk(B, k, device):
    return (torch.full((B, k), NEG_INF, dtype=torch.float32, device=device),
            torch.zeros(B, k, dtype=torch.int64, device=device))


def _label_scores(n_tiles, slab_scores, labels, col_offset, tile):
    """Pass 1 of the counting rankers: each label's own score, taken from
    the slab that holds its column (``slab_scores(i)`` gives slab ``i``'s
    ``([B, tile] scores, global column ids)``); NEG_INF where the table
    (shard) does not hold the label."""
    lv = torch.full(labels.shape, NEG_INF, dtype=torch.float32,
                    device=labels.device)
    for i in range(n_tiles):
        local = labels - col_offset - i * tile
        present = (local >= 0) & (local < tile)
        got = torch.gather(slab_scores(i)[0], 1,
                           local.clamp(0, tile - 1)[:, None])[:, 0]
        lv = torch.where(present, got, lv)
    return lv


def _counts(n_tiles, slab_scores, labels, lv):
    """Pass 2 of the counting rankers: per row, the scores above the
    label's ``lv`` and those equal to it at a lower column
    (``lax.top_k``'s tie rule), over every slab."""
    gt = eq = torch.zeros(labels.shape, dtype=torch.int64,
                          device=labels.device)
    for i in range(n_tiles):
        scores, col = slab_scores(i)
        gt = gt + torch.sum(scores > lv[:, None], dim=1)
        eq = eq + torch.sum((scores == lv[:, None])
                            & (col[None, :] < labels[:, None]), dim=1)
    return gt, eq


def _merge_label_scores(lv, labels, col_offset, n_valid, mesh):
    """Every shard's label score from the one that holds the label's
    column: that shard's exact value plus zeros over the model group."""
    if mesh is None:
        return lv
    owned = (labels >= col_offset) & (labels - col_offset < n_valid)
    return all_reduce(torch.where(owned, lv, 0.0), mesh, MODEL_AXIS)


def _clip_ranks(gt, eq, k, mesh=None):
    if mesh is not None:
        gt = all_reduce(gt, mesh, MODEL_AXIS)
        eq = all_reduce(eq, mesh, MODEL_AXIS)
    rank = gt + eq + 1
    return torch.where(rank <= k, rank, 0)


def _plain_ctx(sr, table, *, normalize_table, compute_dtype, tile,
               col_offset, n_valid):
    """(slab count, slab_logits) of the plain head's rankers:
    ``slab_logits(i)`` is slab ``i``'s ``([B, tile] logits, global column
    ids)``, NEG_INF past the ``n_valid`` real rows."""
    sr, tab, n_tiles = _slabs(sr, table, normalize_table, compute_dtype,
                              tile)
    cols = torch.arange(tile, device=sr.device)

    def slab_logits(i):
        lo = torch.matmul(sr, tab[i * tile:(i + 1) * tile].T)
        local_col = cols + i * tile
        return (torch.where(local_col < n_valid, lo, NEG_INF),
                local_col + col_offset)

    return n_tiles, slab_logits


def streamed_topk_ranks(sr, table, labels, *, num_items, k=20, scale=1.0,
                        normalize_table=False, compute_dtype=None,
                        tile=TILE):
    """Label ranks (1-based within top-k, else 0) for the plain head: the
    rank within ``stable_topk(scale * sr @ norm?(table)^T)``, by a per-slab
    top-k merged into running candidates (the ``rank_method="topk"``
    path).  Equals ``scoring.topk_ranks`` of the materialised scores."""
    n_tiles, slab_logits = _plain_ctx(
        sr, table, normalize_table=normalize_table,
        compute_dtype=compute_dtype, tile=tile, col_offset=0,
        n_valid=num_items)
    vals, idxs = _init_topk(sr.shape[0], k, sr.device)
    for i in range(n_tiles):
        tv, ti = stable_topk(scale * slab_logits(i)[0], k)
        vals, idxs = _merge_topk(vals, idxs, tv, ti + i * tile, k)
    return _ranks_of(labels, idxs, vals)


def streamed_count_ranks(sr, table, labels, *, num_items, k=20,
                         normalize_table=False, compute_dtype=None,
                         tile=TILE, col_offset=0, n_valid=None,
                         axis_name=None):
    """``scoring.label_ranks_by_count`` of the plain head without the
    ``[B, P]`` tensor: pass 1 takes each label's logit from the slab
    product that holds its column (a separate row-gathered dot product
    could differ in the last bit and break the exact-tie comparison);
    pass 2 counts ``#{j : s_j > s_label}`` and the equal scores at lower
    columns.  ``table`` may be one catalog shard: ``col_offset`` is its
    first global row and ``n_valid`` its real rows, labels are global
    ids; across the shards of ``axis_name`` (a mesh) the label scores of
    pass 1 and the counts of pass 2 add up to the whole catalog's."""
    mesh = _mesh_of(axis_name)
    labels = labels.to(torch.int64)
    n_valid = num_items if n_valid is None else n_valid
    n_tiles, slab_logits = _plain_ctx(
        sr, table, normalize_table=normalize_table,
        compute_dtype=compute_dtype, tile=tile, col_offset=col_offset,
        n_valid=n_valid)
    lv = _merge_label_scores(
        _label_scores(n_tiles, slab_logits, labels, col_offset, tile),
        labels, col_offset, n_valid, mesh)
    return _clip_ranks(*_counts(n_tiles, slab_logits, labels, lv), k, mesh)


def _multi_ctx(sr, table, iids, phi, alpha, *, num_items, extra, fusion,
               scale, normalize_table, compute_dtype, tile, col_offset=0,
               n_valid=None, axis_name=None):
    """What the multi-order rankers share: the slab logits, the REnorm part
    masks, the LSE pass, and the blended score of a slab (the same float
    operations in every caller, so the counting ranker's label score is
    bitwise the score its count pass computes at that column).  With
    ``axis_name`` (a mesh) the table is one catalog shard and the LSE
    pass's (max, sum-exp) merge over its model group
    (``xent.merge_partial_max_sum``).  Returns ``(slab count,
    slab_logits, fused_score)``."""
    mesh = _mesh_of(axis_name)
    B, K, _ = sr.shape
    sr, tab, n_tiles = _slabs(sr, table, normalize_table, compute_dtype,
                              tile)
    dev = sr.device
    if n_valid is None:
        n_valid = num_items
    cols = torch.arange(tile, device=dev)
    iids = iids.to(torch.int64)

    def slab_logits(i):
        lo = scale * torch.matmul(sr, tab[i * tile:(i + 1) * tile].T)
        local_col = cols + i * tile
        return lo, local_col + col_offset, local_col < n_valid   # [B,K,T]

    def part_masks(col, imask):
        """[B, T] masks of each part: (in the session, not in it) with
        ``extra``, else (every real item,)."""
        if not extra:
            return (imask.expand(B, tile),)
        local = iids - col[0]
        hit = (local >= 0) & (local < tile)       # -1 padding never hits
        member = torch.zeros(B, tile + 1, dtype=torch.bool, device=dev)
        # ids outside the slab land in column ``tile``, dropped below
        member.scatter_(1, torch.where(hit, local, tile), hit)
        ins = member[:, :tile]
        return ins & imask, ~ins & imask

    # pass 1: online max and sum-exp per (example, order, part)
    floor = NEG_INF * 0.5
    ms = [torch.full((B, K), NEG_INF, device=dev) for _ in range(1 + extra)]
    ss = [torch.zeros(B, K, device=dev) for _ in range(1 + extra)]
    for i in range(n_tiles):
        lo, col, imask = slab_logits(i)
        for p, pm in enumerate(part_masks(col, imask)):
            pm = pm[:, None, :]
            m_new = torch.maximum(
                ms[p], torch.amax(torch.where(pm, lo, NEG_INF), dim=-1))
            m_safe = torch.clamp(m_new, min=floor)   # all-masked rows
            ex = torch.where(pm, torch.exp(lo - m_safe[..., None]), 0.0)
            ss[p] = (ss[p] * torch.exp(torch.clamp(ms[p], min=floor)
                                       - m_safe) + torch.sum(ex, dim=-1))
            ms[p] = m_new
    if mesh is not None:
        for p in range(len(ms)):
            ms[p], ss[p] = merge_partial_max_sum(ms[p], ss[p], mesh)
    m_safe = [torch.clamp(m, min=floor)[..., None] for m in ms]
    denom = [torch.clamp(s, min=torch.finfo(torch.float32).tiny)[..., None]
             for s in ss]
    if fusion and K > 1:
        w = torch.softmax(alpha.to(torch.float32), dim=0)
    else:
        w = torch.zeros(K, device=dev)
        w[0] = 1.0                                 # score[:, 0]
    w = w[None, :, None]

    def fused_score(lo, col, imask):
        """Blended REnorm/fusion score of one slab, ``[B, T]``; padded
        items NEG_INF."""
        score = 0.0
        for p, pm in enumerate(part_masks(col, imask)):
            part = torch.where(pm[:, None, :],
                               torch.exp(lo - m_safe[p]) / denom[p], 0.0)
            score = score + (phi[..., p:p + 1] if extra else 1.0) * part
        return torch.where(imask, torch.sum(score * w, dim=1), NEG_INF)

    return n_tiles, slab_logits, fused_score


def streamed_multi_topk(sr, table, iids, phi, alpha, *, num_items, extra,
                        fusion, k=20, scale=12.0, normalize_table=True,
                        compute_dtype=None, tile=TILE, col_offset=0,
                        n_valid=None, axis_name=None):
    """Global top-k ``(values [B, k], item ids [B, k])`` of MSGIFSR's
    blended REnorm/fusion score without the ``[B, K, P]`` scores: the LSE
    pass, then each slab's blended score and its top-k merged into the
    running candidates.  Inputs are ``model.head_multi``'s: ``sr [B, K,
    d]``, the raw ``table``, ``phi [B, K, 2]`` or None, ``alpha [K]``,
    ``iids [B, N]`` (-1 padded).  Values are raw blended probabilities;
    the ids are ``stable_topk`` of ``model.apply``'s log-probabilities.
    On a catalog shard (``col_offset``, ``n_valid``, ``axis_name``, as
    ``_multi_ctx`` takes them) the shard's own top-k, global ids."""
    n_tiles, slab_logits, fused_score = _multi_ctx(
        sr, table, iids, phi, alpha, num_items=num_items, extra=extra,
        fusion=fusion, scale=scale, normalize_table=normalize_table,
        compute_dtype=compute_dtype, tile=tile, col_offset=col_offset,
        n_valid=n_valid, axis_name=axis_name)
    vals, idxs = _init_topk(sr.shape[0], k, sr.device)
    for i in range(n_tiles):
        tv, ti = stable_topk(fused_score(*slab_logits(i)), k)
        vals, idxs = _merge_topk(vals, idxs, tv,
                                 ti + i * tile + col_offset, k)
    return vals, idxs


def streamed_multi_topk_ranks(sr, table, labels, iids, phi, alpha, *,
                              num_items, extra, fusion, k=20, scale=12.0,
                              normalize_table=True, compute_dtype=None,
                              tile=TILE):
    """Label ranks of the multi-order head from ``streamed_multi_topk``
    (the ``rank_method="topk"`` path; counting is the default)."""
    vals, idxs = streamed_multi_topk(
        sr, table, iids, phi, alpha, num_items=num_items, extra=extra,
        fusion=fusion, k=k, scale=scale, normalize_table=normalize_table,
        compute_dtype=compute_dtype, tile=tile)
    return _ranks_of(labels, idxs, vals)


def streamed_multi_count_ranks(sr, table, labels, iids, phi, alpha, *,
                               num_items, extra, fusion, k=20, scale=12.0,
                               normalize_table=True, compute_dtype=None,
                               tile=TILE, col_offset=0, n_valid=None,
                               axis_name=None):
    """Counting form of the multi-order streamed ranker (the default, no
    per-slab sorts): after the LSE pass, one pass takes the label's own
    blended score from the slab that holds its column, and one more
    counts the scores above it and the equal ones at lower columns, with
    the same float operations, so ranks equal the materialised path's,
    ties included.  ``col_offset`` / ``n_valid`` as in
    ``streamed_count_ranks``."""
    n_tiles, slab_logits, fused_score = _multi_ctx(
        sr, table, iids, phi, alpha, num_items=num_items, extra=extra,
        fusion=fusion, scale=scale, normalize_table=normalize_table,
        compute_dtype=compute_dtype, tile=tile, col_offset=col_offset,
        n_valid=n_valid, axis_name=axis_name)
    labels = labels.to(torch.int64)
    mesh = _mesh_of(axis_name)

    def slab_scores(i):
        lo, col, imask = slab_logits(i)
        return fused_score(lo, col, imask), col

    lv = _merge_label_scores(
        _label_scores(n_tiles, slab_scores, labels, col_offset, tile),
        labels, col_offset, num_items if n_valid is None else n_valid, mesh)
    return _clip_ranks(*_counts(n_tiles, slab_scores, labels, lv), k, mesh)
