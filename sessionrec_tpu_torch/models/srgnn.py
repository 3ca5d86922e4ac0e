"""SRGNN — the gated session-graph network (reference
src/models/srgnn.py:93-148).

Counterpart of ``sessionrec_tpu/models/srgnn.py`` as an ``nn.Module``
whose parameter names follow the JAX parameter tree (``embedding``,
``layers[i].{gru,W1,W2}``, ``readout.fc_{u,v,e}``, ``fc_sr``), so
``sessionrec_tpu_torch.convert`` maps JAX parameters one to one.  NISER
(models/niser.py) is this model with its ``norm`` and ``scale`` on.

* Every parameter starts U(-1/sqrt(d), 1/sqrt(d)) (srgnn.py:126-129).
* ``readout_on_embedding`` (the default) keeps the reference's quirk: the
  readout reads the dropped embedding, not the GNN's output
  (srgnn.py:141-142).  The GNN layers then reach nothing, so they are not
  run; their gradients stay zero and they still take Adam's weight-decay
  step, as in the JAX package, where XLA drops the unused layers.
* The head is plain: the loss is the softmax cross-entropy of ``scale *
  sr @ table^T`` over the catalog (against ``l2norm(table)`` with
  ``norm``), which the trainer computes with the fused catalog loss
  (ops/xent.py, K1/K2).  There is no max-norm table.
* ``compute_dtype`` bfloat16 runs the layers in bf16 on float32 master
  parameters (``layers.cast_floats``), the gathered rows and the
  adjacency cast to it; ``table_dtype`` bfloat16 stores the table in bf16.
"""

from __future__ import annotations

import torch
from torch import nn

from sessionrec_tpu_torch.graph.batch import SplitBatch, flatten_blocks
from sessionrec_tpu_torch.models import layers as L
from sessionrec_tpu_torch.ops import scoring


class SRGNN(nn.Module):
    has_plain_head = True
    graph_kind = "session"
    shard = None        # parallel/sharded.py:bind_mesh sets it on a mesh

    def __init__(self, num_items, embedding_dim, num_layers, feat_drop=0.0,
                 readout_on_embedding=True, norm=False, scale=1.0,
                 compute_dtype="float32", table_dtype="float32"):
        super().__init__()
        self.num_items = num_items
        self.embedding_dim = d = embedding_dim
        self.num_layers = num_layers
        self.feat_drop = feat_drop
        self.readout_on_embedding = readout_on_embedding
        self.norm = norm
        self.scale = float(scale) if scale else 1.0
        self.compute_dtype = compute_dtype
        self.embedding = nn.Parameter(torch.empty(
            self.padded_items, d, dtype=getattr(torch, table_dtype)))
        self.layers = nn.ModuleList(L.SRGNNLayer(d)
                                    for _ in range(num_layers))
        self.fc_sr = L.Linear(2 * d, d, bias=False)
        self.readout = L.AttnReadout(d, d, d)

    @classmethod
    def from_config(cls, cfg, num_items):
        return cls(num_items=num_items, embedding_dim=cfg.embedding_dim,
                   num_layers=cfg.num_layers, feat_drop=cfg.feat_drop,
                   readout_on_embedding=cfg.readout_on_embedding,
                   compute_dtype=cfg.compute_dtype,
                   table_dtype=cfg.table_dtype)

    @property
    def padded_items(self):
        return scoring.pad_catalog(self.num_items)

    @property
    def table_norm(self):
        """The loss scores against ``l2norm(table)``, folded into K1/K2."""
        return self.norm

    @property
    def cdt(self):
        """The compute dtype; None for float32."""
        return L.compute_dtype(self.compute_dtype)

    def reset_parameters(self, gen: torch.Generator):
        from sessionrec_tpu_torch.models.init import reset_uniform
        reset_uniform(self, gen)

    def project_table(self, table):
        """No max-norm table: ``table`` as it is."""
        return table

    def project_params(self):
        """No max-norm table: nothing to project."""

    def _session_repr(self, batch, rng, training, rows=None):
        """``sr [B, d]``.  A SplitBatch runs the graph side once per length
        tier and concatenates the rows, shortest tier first; there is no
        BatchNorm, so the tiers are independent.  Every tier's table rows
        are gathered first, at once (``rows``: an iterator over them,
        shortest tier first, shared by the tiers)."""
        if rows is None:
            rows = iter(L.embedding_lookups(
                self.embedding, [b.node_iid for b in flatten_blocks(batch)],
                self.shard))
        if isinstance(batch, SplitBatch):
            return torch.cat(
                [self._session_repr(batch.short, rng, training, rows),
                 self._session_repr(batch.long, rng, training, rows)], dim=0)
        cdt = self.cdt
        cp = L.cast_floats(self, cdt)
        # the gathered rows move to the compute dtype (the table may be
        # stored bf16 whatever the compute dtype)
        emb = next(rows).to(cdt or torch.float32)
        adj = batch.adj if cdt is None else batch.adj.to(cdt)
        feat = L.dropout(rng, emb, self.feat_drop, training)
        if self.norm:
            feat = L.l2norm(feat)
        ro_feat = feat
        if not self.readout_on_embedding:
            for lp in cp.layers:
                ro_feat = L.srgnn_layer_apply(lp, ro_feat, adj, rng,
                                              feat_drop=self.feat_drop,
                                              training=training)
        if self.norm:
            ro_feat = L.l2norm(ro_feat)
        sr_g = L.attn_readout_apply(cp.readout, ro_feat, batch.node_mask,
                                    batch.last_idx, rng,
                                    feat_drop=self.feat_drop,
                                    training=training)
        sr_l = L.gather_rows(ro_feat, batch.last_idx)
        sr = cp.fc_sr(torch.cat([sr_l, sr_g], dim=-1))
        return L.l2norm(sr) if self.norm else sr

    def head(self, batch, *, training=False, seeds=None):
        """``(sr [B, d], raw table)`` for the fused softmax-CE path; the
        loss folds in ``l2norm(table)`` when ``table_norm``.  ``seeds`` (a
        ``layers.SeedSource``) drives dropout; None disables it."""
        return self._session_repr(batch, seeds, training), self.embedding
