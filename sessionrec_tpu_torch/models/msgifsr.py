"""MSGIFSR — multi-granularity consecutive-intent-unit session recommender
(WSDM'22; reference src/models/msgifsr.py:157-323).

Counterpart of ``sessionrec_tpu/models/msgifsr.py`` as an ``nn.Module``
whose parameter names follow the JAX parameter tree (``embedding``,
``alpha``, ``beta``, ``expander.{grus,Ws}[i]``,
``layers[i].conv{1,2}.{intra<k>,inter}``, ``readout.fc_{u,v,e}[k]``,
``fc_sr[k]``, ``sc_sr[k].{l1,l2}``), so ``sessionrec_tpu_torch.convert``
maps JAX parameters one to one.

Two heads, as in the JAX package:

* ``head`` (``has_plain_head``: no REnorm, and order 1 or no fusion): the
  loss is the softmax cross-entropy of 12 * the order-1 logits, which the
  trainer computes with the fused catalog loss (ops/xent.py).
* ``head_multi`` (the WSDM'22 paper head, ``--order 3 --extra --fusion``):
  per-order session vectors, the REnorm gate ``phi``, the fusion weights
  ``alpha`` and the level-1 session item ids, the inputs of the fused
  multi-order loss (ops/xent_multi.py).  ``apply`` is the same head over
  materialised ``[B, K, P]`` scores, for eval.

The ``max_norm=1`` embedding is a whole-table projection
(``project_params``, or ``project_table`` of a float32 copy for a
bfloat16 table) that the trainer applies after every update, so
gradients are always taken at a projected table (see
models/lessr.py).

``compute_dtype`` bfloat16 runs the layers in bf16 on float32 master
parameters (``layers.cast_floats``) with the gathered rows cast to it;
the REnorm gate's softmax and the fusion weights stay float32.
``table_dtype`` bfloat16 stores the table in bf16 (drawn in float32,
then cast, as the JAX package does).
"""

from __future__ import annotations

import torch
from torch import nn

from sessionrec_tpu_torch.graph.batch import SplitBatch, flatten_blocks
from sessionrec_tpu_torch.models import layers as L
from sessionrec_tpu_torch.models.lessr import renorm_rows
from sessionrec_tpu_torch.ops import scoring
from sessionrec_tpu_torch.ops.masked import NEG_INF, masked_softmax
from sessionrec_tpu_torch.utils import profiling

# safe-log floor of the REnorm/fusion score (sessionrec_tpu/models/
# msgifsr.py:_TINY): a normal float32 far below any reachable probability
_TINY = 1e-30


class _Readout(nn.Module):
    """Multi-order attention readout (msgifsr.py:113-116: fc_u with bias,
    fc_v and fc_e without)."""

    def __init__(self, d, order):
        super().__init__()
        self.fc_u = nn.ModuleList(nn.Linear(d, d, bias=True)
                                  for _ in range(order))
        self.fc_v = nn.ModuleList(nn.Linear(d, d, bias=False)
                                  for _ in range(order))
        self.fc_e = nn.ModuleList(nn.Linear(d, 1, bias=False)
                                  for _ in range(order))


class _ScSr(nn.Module):
    """REnorm gate; only ``sc_sr[0]`` is ever used (msgifsr.py:283)."""

    def __init__(self, d):
        super().__init__()
        self.l1 = nn.Linear(d, d, bias=True)
        self.l2 = nn.Linear(d, 2, bias=False)


class MSGIFSR(nn.Module):
    num_heads = 8
    scale = 12.0

    has_multi_head = True
    graph_kind = "ccs"
    shard = None        # parallel/sharded.py:bind_mesh sets it on a mesh

    def __init__(self, num_items, embedding_dim, num_layers, feat_drop=0.0,
                 reducer="mean", order=1, norm=True, extra=False,
                 fusion=False, compute_dtype="float32",
                 table_dtype="float32"):
        super().__init__()
        if reducer not in ("mean", "max", "concat"):
            raise ValueError(f"unknown reducer {reducer!r}")
        self.num_items = num_items
        self.embedding_dim = d = embedding_dim
        self.num_layers = num_layers
        self.feat_drop = feat_drop
        self.reducer = reducer
        self.order = K = order
        self.norm = norm
        self.extra = extra
        self.fusion = fusion
        self.compute_dtype = compute_dtype
        self.embedding = nn.Parameter(torch.empty(
            self.padded_items, d, dtype=getattr(torch, table_dtype)))
        self.alpha = nn.Parameter(torch.empty(K))
        self.beta = nn.Parameter(torch.empty(1))
        self.expander = L.SemanticExpander(d, reducer, K)
        self.layers = nn.ModuleList(L.MSHGNN(d, K, self.num_heads)
                                    for _ in range(num_layers))
        self.readout = _Readout(d, K)
        self.fc_sr = nn.ModuleList(nn.Linear(2 * d, d, bias=False)
                                   for _ in range(K))
        self.sc_sr = nn.ModuleList(_ScSr(d) for _ in range(K))

    @classmethod
    def from_config(cls, cfg, num_items):
        return cls(num_items=num_items, embedding_dim=cfg.embedding_dim,
                   num_layers=cfg.num_layers, feat_drop=cfg.feat_drop,
                   reducer=cfg.reducer, order=cfg.order, norm=cfg.norm,
                   extra=cfg.extra, fusion=cfg.fusion,
                   compute_dtype=cfg.compute_dtype,
                   table_dtype=cfg.table_dtype)

    @property
    def padded_items(self):
        return scoring.pad_catalog(self.num_items)

    @property
    def table_norm(self):
        return self.norm

    @property
    def cdt(self):
        """The compute dtype; None for float32."""
        return L.compute_dtype(self.compute_dtype)

    @property
    def has_plain_head(self):
        """Without REnorm the loss reduces to softmax-CE of 12 * the
        order-1 logits (no fusion takes score[:, 0], msgifsr.py:316-317;
        fusion over K=1 is the identity)."""
        return (not self.extra) and (self.order == 1 or not self.fusion)

    def reset_parameters(self, gen: torch.Generator):
        from sessionrec_tpu_torch.models.init import reset_msgifsr
        reset_msgifsr(self, gen)

    def project_table(self, table):
        """Max-norm projection of ``table`` (the table or a float32 copy of
        it), in place."""
        return renorm_rows(table, 1.0)

    def project_params(self):
        """Max-norm projection of the table, in place."""
        self.project_table(self.embedding.data)

    # -- pieces ------------------------------------------------------------

    def _gather_levels(self, batch):
        """Every tier's and level's ``[B, Nk, k, d]`` table rows, shortest
        tier first, each tier's levels in order: the step's gathers in one
        ``model.embed`` span (its backward part is the gather's backward,
        one ``ops/embed.py`` launch on the card)."""
        ids = [lv.iid for blk in flatten_blocks(batch) for lv in blk.levels]
        with profiling.span("model.embed") as s:
            return s.outputs(L.embedding_lookups(self.embedding, ids,
                                                 self.shard))

    def _embed_levels(self, cp, rows, rng, training):
        feats = []
        for l, feat in enumerate(rows, 1):
            # the gathered rows move to the compute dtype (the table may
            # be stored bf16 whatever the compute dtype)
            feat = feat.to(self.cdt or torch.float32)      # [B, Nk, k, d]
            feat = L.dropout(rng, feat, self.feat_drop, training)
            feat = L.semantic_expander_apply(cp.expander, feat, l,
                                             self.reducer)
            if self.norm:
                feat = L.l2norm(feat)
            feats.append(feat)
        return feats

    def _readout(self, cp, batch, feats):
        """Attention readout over the combined node set of all orders
        (msgifsr.py:124-155)."""
        all_feat = torch.cat(feats, dim=1)
        all_mask = torch.cat([lv.mask for lv in batch.levels], dim=1)
        outs = []
        for i in range(self.order):
            last = L.gather_rows(feats[i], batch.levels[i].last_idx)
            fu = cp.readout.fc_u[i](all_feat)
            fv = cp.readout.fc_v[i](last)
            e = cp.readout.fc_e[i](torch.sigmoid(fu + fv[:, None, :]))
            alpha = masked_softmax(e, all_mask[..., None], dim=1)
            outs.append(torch.sum(all_feat * alpha, dim=1))
        return torch.stack(outs, dim=1)                    # [B, K, d]

    def _session_repr(self, batch, rng, training, rows=None):
        """Per-order session vectors ``sr [B, K, d]``.  A SplitBatch runs
        the graph side once per length tier and concatenates the rows
        (shortest tier first); MSGIFSR has no BatchNorm, so the tiers are
        independent.  The table rows of every tier are gathered first, at
        once (``rows``: an iterator over them, in ``_gather_levels``'s
        order, shared by the tiers)."""
        if rows is None:
            rows = iter(self._gather_levels(batch))
        if isinstance(batch, SplitBatch):
            tiers = [self._session_repr(batch.short, rng, training, rows),
                     self._session_repr(batch.long, rng, training, rows)]
            with profiling.span("model.readout") as s:
                s.inputs(tiers)
                return s.outputs(torch.cat(tiers, dim=0))
        cp = L.cast_floats(self, self.cdt)
        rows = [next(rows) for _ in batch.levels]
        with profiling.span("model.graph") as s:
            s.inputs(rows)
            h = self._embed_levels(cp, rows, rng, training)
            for lp in cp.layers:
                h = L.mshgnn_apply(lp, h, batch, rng,
                                   feat_drop=self.feat_drop,
                                   training=training,
                                   num_heads=self.num_heads)
            s.outputs(h)
        with profiling.span("model.readout") as s:
            s.inputs(h)
            if self.norm:
                h = [L.l2norm(x) for x in h]
            sr_g = self._readout(cp, batch, h)
            sr_l = torch.stack([L.gather_rows(h[i], batch.levels[i].last_idx)
                                for i in range(self.order)], dim=1)
            sr = torch.cat([sr_l, sr_g], dim=-1)           # [B, K, 2d]
            sr = torch.stack([cp.fc_sr[i](sr[:, i])
                              for i in range(self.order)], dim=1)
            if self.norm:
                sr = L.l2norm(sr)
            return s.outputs(sr)

    def _session_item_mask(self, batch):
        """[B, P] 0/1 float: items occurring in the session (level-1
        iids)."""
        if isinstance(batch, SplitBatch):
            return torch.cat([self._session_item_mask(batch.short),
                              self._session_item_mask(batch.long)], dim=0)
        lv1 = batch.levels[0]
        B = lv1.iid.shape[0]
        mask = torch.zeros(B, self.padded_items, device=lv1.mask.device)
        return mask.scatter_reduce(1, lv1.iid[:, :, 0].to(torch.int64),
                                   lv1.mask.to(torch.float32), reduce="amax")

    def _session_iids(self, batch):
        """[B, N1] int32 level-1 (unique session item) ids, -1 on padding:
        the REnorm membership input of the fused multi-order loss.  For a
        SplitBatch the narrower tier pads with -1 to the wider tier's
        width before the rows are concatenated."""
        if isinstance(batch, SplitBatch):
            a = self._session_iids(batch.short)
            b = self._session_iids(batch.long)
            w = max(a.shape[1], b.shape[1])
            a = torch.nn.functional.pad(a, (0, w - a.shape[1]), value=-1)
            b = torch.nn.functional.pad(b, (0, w - b.shape[1]), value=-1)
            return torch.cat([a, b], dim=0)
        lv1 = batch.levels[0]
        return torch.where(lv1.mask.bool(), lv1.iid[:, :, 0].to(torch.int32),
                           -1)

    def _phi(self, sr):
        """REnorm gate ``softmax(l2(relu(l1(sr))))`` of ``sc_sr[0]``,
        float32 ``[B, K, 2]``."""
        sc = L.cast_floats(self.sc_sr[0], self.cdt)
        return torch.softmax(sc.l2(torch.relu(sc.l1(sr))).to(torch.float32),
                             dim=-1)

    def head(self, batch, *, training=False, seeds=None):
        """``(sr [B, d], raw table)`` for the fused softmax-CE path (logit
        scale 12; the loss folds in l2norm(table) when ``table_norm``).
        ``seeds`` (a ``layers.SeedSource``) drives dropout; None disables
        it."""
        sr = self._session_repr(batch, seeds, training)
        with profiling.span("model.readout") as s:
            s.inputs(sr)
            return s.outputs(sr[:, 0]), self.embedding

    def head_multi(self, batch, *, training=False, seeds=None):
        """Inputs of the fused REnorm/fusion loss (ops/xent_multi.py):
        ``(sr [B, K, d], raw table, phi [B, K, 2] | None, alpha [K],
        iids [B, N1])``.  ``iids`` are the level-1 session item ids, -1 on
        padding; the [B, P] session mask never exists."""
        sr = self._session_repr(batch, seeds, training)
        with profiling.span("model.readout") as s:
            s.inputs(sr)
            phi = s.outputs(self._phi(sr)) if self.extra else None
            iids = self._session_iids(batch)
        return sr, self.embedding, phi, self.alpha, iids

    def apply(self, batch, *, training=False, seeds=None):
        """``[B, P]`` log-probabilities over the catalog (padded columns
        NEG_INF), materialising the per-order scores: REnorm splits each
        order's softmax into in-session and other items, blended by
        ``phi``; fusion weights the orders by ``softmax(alpha)``, else
        order 1 is taken (msgifsr.py:276-321)."""
        sr = self._session_repr(batch, seeds, training)
        with profiling.span("serve.score"):
            return self._blend(batch, sr)

    def _blend(self, batch, sr):
        """``apply``'s scoring of the session vectors ``sr``: the catalog
        products, the REnorm softmax passes and the fusion blend."""
        table = L.l2norm(self.embedding) if self.norm else self.embedding
        imask = scoring.item_mask(self.num_items, self.padded_items,
                                  sr.device).to(torch.float32)
        logits = scoring.catalog_logits(sr, table, self.cdt)
        if self.extra:
            phi = self._phi(sr)
            smask = self._session_item_mask(batch)
            in_mask = (smask * imask)[:, None, :]
            ex_mask = ((1.0 - smask) * imask)[:, None, :]
            score_in = scoring.masked_catalog_softmax(12.0 * logits, in_mask)
            score_ex = scoring.masked_catalog_softmax(12.0 * logits, ex_mask)
            score = phi[..., 0:1] * score_in + phi[..., 1:2] * score_ex
        else:
            score = scoring.masked_catalog_softmax(12.0 * logits,
                                                   imask[None, None, :])
        if self.order > 1 and self.fusion:
            w = torch.softmax(self.alpha, dim=0)[None, :, None]
            score = torch.sum(score * w, dim=1)
        else:
            score = score[:, 0]
        return torch.where(imask.bool(),
                           torch.log(torch.clamp(score, min=_TINY)), NEG_INF)
