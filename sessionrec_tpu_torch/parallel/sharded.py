"""Losses, rankers and eval on the (data, model) mesh.

Counterpart of ``sessionrec_tpu/parallel/sharded.py``.  There, GSPMD
places the same step functions on the mesh and ``shard_map`` bodies run
the fused losses and rankers per catalog shard.  Here each rank is a
process: its model holds its table shard (``bind_mesh``), its batches are
its data position's rows, and the functions below run the kernels on the
shard and write the collectives out:

* the fused losses (``fused_nll_loss_sharded``: K1/K2;
  ``fused_multi_loss_sharded``: K3/K4) merge the shards' ``[B]`` (or
  ``[K, B]``) statistics over the model group, take a global masked mean
  over the data group, and in the backward sum ``d_sr`` over the model
  group.  The table's gradient lands, in float32, in the shard's gradient
  leaf (``TableShard.grad``), where the lookup's lands too; the trainer
  reduces it over the data group (``reduce_table_grad``: a
  reduce-scatter where the shard's rows divide over data, the ZeRO
  layout, else an all-reduce).  Each autograd Function writes its
  backward out, as the JAX package's ``custom_vjp``s do (:87-112,
  :200-259); the REnorm/fusion combiner's gradients (``phi``, ``alpha``)
  come from autograd, and ``alpha``'s, like every replicated parameter's,
  is summed over the data group by the trainer (``sum_data_grads``).
* eval ranks by counting per shard, merged with three ``[B]``
  all-reduces (``sharded_head_count_ranks``,
  ``sharded_multi_count_ranks``), or by a top-k per shard whose
  candidates are gathered (``sharded_topk``, ``rank_method="topk"``).

Each rank's loss is its data position's part of the global one: the
backward of a rank starts from its own rows, and the sums over the data
group make the whole gradient.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from sessionrec_tpu_torch.graph.batch import flatten_blocks
from sessionrec_tpu_torch.models.layers import l2norm
from sessionrec_tpu_torch.ops import scoring, xent, xent_multi
from sessionrec_tpu_torch.ops.streamed_eval import (
    streamed_count_ranks, streamed_multi_count_ranks, streamed_multi_topk)
from sessionrec_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                all_gather, all_reduce,
                                                reduce_scatter, shard_rows,
                                                shard_span)


class TableShard:
    """A model's catalog shard on a mesh: the mesh, the shard's rows, and
    ``grad``, the float32 leaf of the shard's shape where the lookup's and
    the loss's table gradients add up."""

    def __init__(self, mesh, rows, width, device):
        self.mesh = mesh
        self.rows = rows
        self.grad = torch.zeros(rows, width, dtype=torch.float32,
                                device=device, requires_grad=True)


def bind_mesh(model, mesh):
    """Put ``model`` on ``mesh``: its ``embedding`` becomes this rank's row
    shard (a parameter without autograd: its gradient goes to
    ``model.shard.grad``) and ``model.shard`` the ``TableShard``;
    ``num_items`` and ``padded_items`` stay global."""
    table = model.embedding.data
    local = shard_rows(table, mesh)
    model.embedding = nn.Parameter(local, requires_grad=False)
    model.shard = TableShard(mesh, local.shape[0], local.shape[1],
                             local.device)
    return model


# ---------------------------------------------------------------------------
# gradient layout
# ---------------------------------------------------------------------------

def table_grad_scatters(mesh, rows):
    """True where the table's gradient is reduce-scattered over data
    (``_table_grad_layout``): each rank of a data group then keeps
    ``rows / dp`` summed rows of its ``rows``-row shard, and the table's
    Adam moments shard over both axes, model-major and data-minor."""
    return mesh.dp > 1 and rows % mesh.dp == 0


def reduce_table_grad(dtab, mesh):
    """The shard's gradient ``dtab`` (float32) summed over the data group:
    this rank's ``rows / dp`` rows where ``table_grad_scatters``, else all
    of them."""
    if table_grad_scatters(mesh, dtab.shape[0]):
        return reduce_scatter(dtab, mesh, DATA_AXIS)
    return all_reduce(dtab, mesh, DATA_AXIS)


def sum_data_grads(params, mesh):
    """Sum the gradients of the replicated ``params`` over the data group,
    in place, as one flat all-reduce.  They need no sum over the model
    group: ``d_sr`` is summed there already, so the model ranks' graph
    sides agree."""
    grads = [p.grad for p in params]
    if mesh.dp == 1 or not grads:
        return
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh,
                      DATA_AXIS)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


# ---------------------------------------------------------------------------
# the fused losses
# ---------------------------------------------------------------------------

class _GlobalMean(torch.autograd.Function):
    """``sum(per_row * valid) / max(sum(valid), 1)`` with both sums over
    the data group; the backward gives this rank's rows ``g * valid /
    den`` (runner.py's masked mean over the global batch)."""

    @staticmethod
    def forward(ctx, per_row, valid, mesh):
        v = valid.to(per_row.dtype)
        num = all_reduce(torch.sum(per_row * v), mesh, DATA_AXIS)
        den = torch.clamp(all_reduce(torch.sum(v), mesh, DATA_AXIS),
                          min=1.0)
        ctx.save_for_backward(v, den)
        return num / den

    @staticmethod
    def backward(ctx, g):
        v, den = ctx.saved_tensors
        return g * v / den, None, None


class _ShardedXent(torch.autograd.Function):
    """Per-row loss of the plain head: K1 forward, K2 backward, on the
    shard."""

    @staticmethod
    def forward(ctx, sr, table, table_grad, labels, mesh, scale, num_items,
                normalize_table):
        sr, table = sr.contiguous(), table.contiguous()
        labels = labels.to(torch.int32).contiguous()
        per_row, lse = xent.sharded_xent_fwd(
            sr, table, labels, scale=scale, num_items=num_items,
            normalize_table=normalize_table, mesh=mesh)
        ctx.save_for_backward(sr, table, labels, lse)
        ctx.cfg = (mesh, scale, num_items, normalize_table)
        return per_row

    @staticmethod
    def backward(ctx, g):
        sr, table, labels, lse = ctx.saved_tensors
        mesh, scale, num_items, normalize_table = ctx.cfg
        dsr, dtab = xent.sharded_xent_bwd(
            g.to(torch.float32).contiguous(), sr, table, labels, lse,
            scale=scale, num_items=num_items,
            normalize_table=normalize_table, mesh=mesh)
        return (dsr.to(sr.dtype), None, dtab.to(torch.float32), None,
                None, None, None, None)


def fused_nll_loss_sharded(mesh, sr, table, labels, valid, *, scale,
                           num_items, normalize_table=False,
                           table_grad=None):
    """Mesh form of ``ops.xent.fused_nll_loss``: ``sr [B, D]``, ``labels``
    and ``valid`` are this rank's rows, ``table`` its ``[P/mp, D]`` shard;
    K1 and K2 run over the shard's rows only.  The table's local gradient
    adds into ``table_grad`` (``TableShard.grad``)."""
    sr, table = xent.common_dtype(sr, table)
    per_row = _ShardedXent.apply(sr, table.detach(), table_grad, labels,
                                 mesh, float(scale), int(num_items),
                                 bool(normalize_table))
    return _GlobalMean.apply(per_row, valid, mesh)


class _ShardedMultiStats(torch.autograd.Function):
    """``(zl, lse_in, lse_ex)`` ``[K, B]`` of the whole catalog from this
    rank's shard: K3 forward, K4 backward."""

    @staticmethod
    def forward(ctx, sr3, table, table_grad, labels, iids, mesh, scale,
                num_items, normalize_table):
        sr3, table = sr3.contiguous(), table.contiguous()
        labels = labels.to(torch.int32).contiguous()
        iids = iids.to(torch.int32).contiguous()
        zl, lse_in, lse_ex = xent_multi.sharded_multi_fwd(
            sr3, table, labels, iids, scale=scale, num_items=num_items,
            normalize_table=normalize_table, mesh=mesh)
        ctx.save_for_backward(sr3, table, labels, iids, lse_in, lse_ex)
        ctx.cfg = (mesh, scale, num_items, normalize_table)
        return zl, lse_in, lse_ex

    @staticmethod
    def backward(ctx, gz, gin, gex):
        sr3, table, labels, iids, lse_in, lse_ex = ctx.saved_tensors
        mesh, scale, num_items, normalize_table = ctx.cfg
        dsr, dtab = xent_multi.sharded_multi_bwd(
            gz.to(torch.float32), gin.to(torch.float32),
            gex.to(torch.float32), sr3, table, labels, iids, lse_in, lse_ex,
            scale=scale, num_items=num_items,
            normalize_table=normalize_table, mesh=mesh)
        return (dsr.to(sr3.dtype), None, dtab.to(torch.float32), None, None,
                None, None, None, None)


def fused_multi_loss_sharded(mesh, sr, table, labels, valid, iids, phi,
                             alpha, *, scale, num_items, normalize_table,
                             extra, fusion, table_grad=None):
    """Mesh form of ``ops.xent_multi.multi_nll_loss`` (``sr [B, K, D]``,
    the rest as there, this rank's rows and shard): K3 and K4 run over the
    shard's rows for all ``K * B`` rows at once, the REnorm/fusion
    combiner on the merged statistics under autograd."""
    sr3, table = xent.common_dtype(sr.transpose(0, 1), table)
    zl, lse_in, lse_ex = _ShardedMultiStats.apply(
        sr3, table.detach(), table_grad, labels, iids, mesh, float(scale),
        int(num_items), bool(normalize_table))
    lbl_in = torch.any(iids.to(torch.int64)
                       == labels.to(torch.int64)[:, None], dim=1)
    per_row = xent_multi.combine_stats(zl, lse_in, lse_ex, phi, alpha,
                                       lbl_in, extra=extra, fusion=fusion)
    return _GlobalMean.apply(per_row, valid, mesh)


# ---------------------------------------------------------------------------
# heads over length tiers
# ---------------------------------------------------------------------------

def shard_concat_rows(pieces):
    """Rows joined per data position: each rank holds its block of every
    piece, so the join is a local concatenation, with no collective
    (``shard_concat_rows`` of the JAX package, :436).  The global row
    order interleaves the ranks' blocks, which no consumer (masked means,
    per-row ranks, metric sums) depends on."""
    return torch.cat(pieces, dim=0)


def split_head_sharded(model, batch, *, training, seeds=None):
    """``(sr, table, labels, valid)`` of a (possibly nested) SplitBatch on
    the mesh: the model runs its graph side per length tier and joins the
    session vectors locally, and labels and valid join the same way."""
    sr, table = model.head(batch, training=training, seeds=seeds)
    parts = flatten_blocks(batch)
    return (sr, table, shard_concat_rows([p.labels for p in parts]),
            shard_concat_rows([p.valid for p in parts]))


def split_head_multi_sharded(model, batch, *, training, seeds=None):
    """``(sr, table, phi, alpha, iids, labels, valid)``: the multi head's
    counterpart of ``split_head_sharded`` (the tiers' narrower id rows pad
    with -1 to the widest, in ``model.head_multi``)."""
    sr, table, phi, alpha, iids = model.head_multi(batch, training=training,
                                                   seeds=seeds)
    parts = flatten_blocks(batch)
    return (sr, table, phi, alpha, iids,
            shard_concat_rows([p.labels for p in parts]),
            shard_concat_rows([p.valid for p in parts]))


def sharded_loss(model, batch, seeds):
    """The training loss of this rank's ``batch`` on the mesh (the mesh
    branches of ``make_loss_fn``, runner.py:29-111 of the JAX package)."""
    shard = model.shard
    kw = dict(scale=model.scale, num_items=model.num_items,
              normalize_table=model.table_norm, table_grad=shard.grad)
    if model.has_plain_head:
        sr, table, labels, valid = split_head_sharded(
            model, batch, training=True, seeds=seeds)
        return fused_nll_loss_sharded(shard.mesh, sr, table, labels, valid,
                                      **kw)
    sr, table, phi, alpha, iids, labels, valid = split_head_multi_sharded(
        model, batch, training=True, seeds=seeds)
    return fused_multi_loss_sharded(shard.mesh, sr, table, labels, valid,
                                    iids, phi, alpha, extra=model.extra,
                                    fusion=model.fusion, **kw)


# ---------------------------------------------------------------------------
# eval ranks
# ---------------------------------------------------------------------------

def _gather_candidates(mesh, vals, idxs, k):
    """The global top-k from every shard's ``(vals, global ids)``
    ``[B, k]``: gathered over the model group in shard order (lower
    columns first, so the stable top-k keeps the lowest column on ties),
    then a stable top-k of the ``mp * k`` candidates."""
    B = vals.shape[0]

    def joined(x):
        return all_gather(x, mesh, MODEL_AXIS).reshape(mesh.mp, B, -1) \
            .permute(1, 0, 2).reshape(B, -1)
    v, pos = scoring.stable_topk(joined(vals), k)
    return v, torch.gather(joined(idxs), 1, pos)


def sharded_topk(mesh, scores, k, col_offset):
    """Global ``(values, ids)`` top-k of catalog-sharded scores: this
    rank's ``[B, P/mp]`` columns start at ``col_offset``; a stable top-k
    per shard, its candidates gathered over the model group."""
    v, i = scoring.stable_topk(scores, k)
    return _gather_candidates(mesh, v, i + col_offset, k)


def _ranks_of(idxs, labels):
    hit = idxs == labels.to(torch.int64)[:, None]
    rank = torch.argmax(hit.to(torch.int32), dim=-1) + 1
    return torch.where(torch.any(hit, dim=-1), rank, 0)


def sharded_count_ranks(mesh, scores, labels, k, col_offset):
    """Label ranks by counting over catalog-sharded materialised scores
    (``scoring.label_ranks_by_count``'s rule): the label's score from the
    shard that holds its column, then the scores above it and the equal
    ones at lower global columns, each summed over the model group."""
    p_local = scores.shape[-1]
    lab = labels.to(torch.int64)
    local = lab - col_offset
    present = (local >= 0) & (local < p_local)
    got = torch.gather(scores, 1, local.clamp(0, p_local - 1)[:, None])[:, 0]
    lv = all_reduce(torch.where(present, got, 0.0), mesh, MODEL_AXIS)
    gcol = col_offset + torch.arange(p_local, device=scores.device)
    gt = all_reduce(torch.sum(scores > lv[:, None], dim=1), mesh, MODEL_AXIS)
    eq = all_reduce(torch.sum((scores == lv[:, None])
                              & (gcol[None, :] < lab[:, None]), dim=1),
                    mesh, MODEL_AXIS)
    rank = gt + eq + 1
    return torch.where(rank <= k, rank, 0)


def sharded_head_count_ranks(mesh, sr, table, labels, k, *, num_items,
                             normalize_table=False, compute_dtype=None):
    """Plain-head ranks from ``(sr, this rank's table shard)``: the slab
    counting ranker over the shard's rows, merged over the model group
    (``ops/streamed_eval.py:streamed_count_ranks`` with a mesh)."""
    offset, n_valid = shard_span(mesh, table.shape[0], num_items)
    return streamed_count_ranks(
        sr, table, labels, num_items=num_items, k=k,
        normalize_table=normalize_table, compute_dtype=compute_dtype,
        col_offset=offset, n_valid=n_valid, axis_name=mesh)


def sharded_multi_count_ranks(mesh, sr, table, labels, iids, phi, alpha, *,
                              num_items, extra, fusion, k, scale=12.0,
                              normalize_table=True, compute_dtype=None):
    """REnorm/fusion ranks from ``head_multi``'s outputs on the shard: the
    streamed two-pass counting ranker, whose softmax statistics merge over
    the model group as the training loss's do."""
    offset, n_valid = shard_span(mesh, table.shape[0], num_items)
    return streamed_multi_count_ranks(
        sr, table, labels, iids, phi, alpha, num_items=num_items,
        extra=extra, fusion=fusion, k=k, scale=scale,
        normalize_table=normalize_table, compute_dtype=compute_dtype,
        col_offset=offset, n_valid=n_valid, axis_name=mesh)


@torch.no_grad()
def sharded_eval_ranks(model, batch, cutoff, rank_method=None):
    """(label ranks, valid) of this rank's ``batch`` on the mesh
    (``_sharded_eval_ranks``, :584): counting from the heads by default,
    the per-shard top-k with gathered candidates for ``"topk"``.  The
    mesh always streams; the rows are the tiers' joined in ``batch``'s
    order, and ``valid`` comes in that order."""
    mesh = model.shard.mesh
    count = scoring.use_count_ranks(rank_method)
    kw = dict(num_items=model.num_items, normalize_table=model.table_norm,
              compute_dtype=model.cdt)
    if model.has_plain_head:
        sr, table, labels, valid = split_head_sharded(model, batch,
                                                      training=False)
        if count:
            return sharded_head_count_ranks(mesh, sr, table, labels, cutoff,
                                            **kw), valid
        if model.table_norm:
            table = l2norm(table)
        offset, n_valid = shard_span(mesh, table.shape[0], model.num_items)
        logits = scoring.catalog_logits(sr, table, model.cdt)
        live = torch.arange(table.shape[0], device=sr.device) < n_valid
        scores = torch.where(live, logits, -math.inf)
        return _ranks_of(sharded_topk(mesh, scores, cutoff, offset)[1],
                         labels), valid
    sr, table, phi, alpha, iids, labels, valid = split_head_multi_sharded(
        model, batch, training=False)
    mkw = dict(kw, extra=model.extra, fusion=model.fusion,
               scale=float(model.scale))
    if count:
        return sharded_multi_count_ranks(mesh, sr, table, labels, iids, phi,
                                         alpha, k=cutoff, **mkw), valid
    offset, n_valid = shard_span(mesh, table.shape[0], model.num_items)
    vals, idxs = streamed_multi_topk(
        sr, table, iids, phi, alpha, k=cutoff, col_offset=offset,
        n_valid=n_valid, axis_name=mesh, **mkw)
    return _ranks_of(_gather_candidates(mesh, vals, idxs, cutoff)[1],
                     labels), valid


@torch.no_grad()
def sharded_eval_sums(model, batch, cutoff, rank_method=None):
    """``[hits@cutoff, reciprocal-rank sum, valid rows]`` of this rank's
    rows, float64 (the body of the JAX package's mesh eval steps, :645 and
    :674); the trainer sums a sweep's over the data group once."""
    ranks, v = sharded_eval_ranks(model, batch, cutoff, rank_method)
    hit = torch.sum((ranks > 0) * v)
    mrr = torch.sum(torch.where(ranks > 0,
                                1.0 / torch.clamp(ranks, min=1), 0.0) * v)
    return torch.stack([hit, mrr, torch.sum(v)]).to(torch.float64)
