"""MSGIFSR — multi-granularity consecutive-intent-unit session recommender
(WSDM'22; reference src/models/msgifsr.py:157-323), order 1.

Counterpart of ``sessionrec_tpu/models/msgifsr.py`` as an ``nn.Module``
whose parameter names follow the JAX parameter tree (``embedding``,
``alpha``, ``beta``, ``layers[i].conv{1,2}.{intra1,inter}``,
``readout.fc_{u,v,e}[k]``, ``fc_sr[k]``, ``sc_sr[k].{l1,l2}``), so
``sessionrec_tpu_torch.convert`` maps JAX parameters one to one.

At order 1 without REnorm (``extra``) the loss is the softmax
cross-entropy of 12 * the order-1 logits (the JAX package's
``has_plain_head``), which the trainer computes with the fused catalog
loss (ops/xent.py).  Orders above
1, ``extra`` and ``fusion`` wait for the paper-head slice (ROADMAP.md,
queue 1 item 7).

The ``max_norm=1`` embedding is a whole-table projection
(``project_params``) that the trainer applies after every update, so
gradients are always taken at a projected table (see
``sessionrec_tpu/models/lessr.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from sessionrec_tpu_torch.graph.batch import SplitBatch
from sessionrec_tpu_torch.models import layers as L
from sessionrec_tpu_torch.ops import scoring
from sessionrec_tpu_torch.ops.masked import masked_softmax


@torch.no_grad()
def renorm_rows(table, max_norm=1.0, eps=1e-7):
    """torch Embedding(max_norm) renorm, in place: rows with
    ``||r|| > max_norm`` are scaled by ``max_norm / (||r|| + eps)``; norms
    and scales in float32 (``sessionrec_tpu/models/lessr.py:renorm_rows``).
    """
    n = torch.linalg.vector_norm(table.to(torch.float32), dim=-1,
                                 keepdim=True)
    scale = torch.where(n > max_norm, max_norm / (n + eps), 1.0)
    table.mul_(scale.to(table.dtype))
    return table


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
    """REnorm gate (unused without ``extra``; kept for parameter parity)."""

    def __init__(self, d):
        super().__init__()
        self.l1 = nn.Linear(d, d, bias=True)
        self.l2 = nn.Linear(d, 2, bias=False)


class MSGIFSR(nn.Module):
    num_heads = 8
    scale = 12.0

    def __init__(self, num_items, embedding_dim, num_layers, feat_drop=0.0,
                 order=1, norm=True, extra=False, fusion=False):
        super().__init__()
        if order != 1 or extra or fusion:
            raise NotImplementedError(
                "the PyTorch port runs MSGIFSR at order 1 without "
                "--extra/--fusion; the paper head (order > 1, REnorm, "
                "fusion) is ROADMAP.md queue 1 item 7")
        self.num_items = num_items
        self.embedding_dim = d = embedding_dim
        self.num_layers = num_layers
        self.feat_drop = feat_drop
        self.order = K = order
        self.norm = norm
        self.embedding = nn.Parameter(torch.empty(self.padded_items, d))
        self.alpha = nn.Parameter(torch.empty(K))
        self.beta = nn.Parameter(torch.empty(1))
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
                   order=cfg.order, norm=cfg.norm,
                   extra=cfg.extra, fusion=cfg.fusion)

    @property
    def padded_items(self):
        return scoring.pad_catalog(self.num_items)

    @property
    def table_norm(self):
        return self.norm

    def reset_parameters(self, gen: torch.Generator):
        from sessionrec_tpu_torch.models.init import reset_msgifsr
        reset_msgifsr(self, gen)

    def project_params(self):
        """Max-norm projection of the table, in place."""
        renorm_rows(self.embedding.data, 1.0)

    # -- pieces ------------------------------------------------------------

    def _embed_levels(self, batch, rng, training):
        lv = batch.levels[0]
        feat = L.embedding_lookup(self.embedding, lv.iid) \
            .to(torch.float32)                             # [B, N1, 1, d]
        feat = L.dropout(rng, feat, self.feat_drop, training)
        feat = L.semantic_expander_apply(feat, 1)
        if self.norm:
            feat = L.l2norm(feat)
        return [feat]

    def _readout(self, batch, feats):
        """Attention readout over the combined node set of all orders
        (msgifsr.py:124-155)."""
        all_feat = torch.cat(feats, dim=1)
        all_mask = torch.cat([lv.mask for lv in batch.levels], dim=1)
        outs = []
        for i in range(self.order):
            last = self._last(feats[i], batch.levels[i].last_idx)
            fu = self.readout.fc_u[i](all_feat)
            fv = self.readout.fc_v[i](last)
            e = self.readout.fc_e[i](torch.sigmoid(fu + fv[:, None, :]))
            alpha = masked_softmax(e, all_mask[..., None], dim=1)
            outs.append(torch.sum(all_feat * alpha, dim=1))
        return torch.stack(outs, dim=1)                    # [B, K, d]

    @staticmethod
    def _last(x, last_idx):
        idx = last_idx.to(torch.int64)[:, None, None].expand(-1, 1,
                                                            x.shape[-1])
        return torch.gather(x, 1, idx)[:, 0]

    def _session_repr(self, batch, rng, training):
        """Per-order session vectors ``sr [B, K, d]``.  A SplitBatch runs
        the graph side once per length tier and concatenates the rows
        (shortest tier first); MSGIFSR has no BatchNorm, so the tiers are
        independent."""
        if isinstance(batch, SplitBatch):
            return torch.cat([self._session_repr(batch.short, rng, training),
                              self._session_repr(batch.long, rng, training)],
                             dim=0)
        h = self._embed_levels(batch, rng, training)
        for lp in self.layers:
            h = L.mshgnn_apply(lp, h, batch, rng, feat_drop=self.feat_drop,
                               training=training, num_heads=self.num_heads)
        if self.norm:
            h = [L.l2norm(x) for x in h]
        sr_g = self._readout(batch, h)
        sr_l = torch.stack([self._last(h[i], batch.levels[i].last_idx)
                            for i in range(self.order)], dim=1)
        sr = torch.cat([sr_l, sr_g], dim=-1)               # [B, K, 2d]
        sr = torch.stack([self.fc_sr[i](sr[:, i])
                          for i in range(self.order)], dim=1)
        if self.norm:
            sr = L.l2norm(sr)
        return sr

    def head(self, batch, *, training=False, gen=None):
        """``(sr [B, d], raw table)`` for the fused softmax-CE path (logit
        scale 12; the loss folds in l2norm(table) when ``table_norm``).
        ``gen`` drives dropout; None disables it."""
        rng = L.RngGen(gen) if gen is not None else None
        sr = self._session_repr(batch, rng, training)
        return sr[:, 0], self.embedding
