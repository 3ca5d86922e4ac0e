"""LESSR — edge-order-preserving aggregation and shortcut-graph attention
(reference src/models/lessr.py:121-183).

Counterpart of ``sessionrec_tpu/models/lessr.py`` as an ``nn.Module``
whose parameter and buffer names follow the JAX parameter and state trees
(``embedding``, ``layers[i]`` (EOPA at even i, SGAT at odd),
``readout.{fc_u,fc_v,fc_e,fc_out,act,bn}``, ``bn``, ``fc_sr``), so
``sessionrec_tpu_torch.convert`` maps both one to one.

* The layers concatenate densely: layer i reads ``d * (i + 1)`` features
  (lessr.py:133-152,174).
* BatchNorm (``batch_norm``) normalises each layer's and the readout's
  input over the real nodes, and the concatenated session vectors over
  the valid rows.  A SplitBatch runs the layers once per length tier but
  takes each BatchNorm's batch statistics jointly over the tiers
  (``layers.batchnorm_parts``), so it trains as the unsplit batch would,
  up to float summation order; the running statistics update once per
  step, in place.  Eval normalises with them.
* The ``max_norm=1`` embedding (lessr.py:126) is the whole-table
  projection ``project_params``, which the trainer runs after every
  update, so gradients are always taken at a projected table.
* No ``reset_parameters`` in the reference: torch's per-module defaults
  apply (models/init.py).
* ``compute_dtype`` bfloat16 runs every layer in bf16 on float32 master
  parameters (``layers.cast_floats``; the BatchNorm statistics and
  normalisation stay float32), the gathered rows and the shortcut
  adjacency cast to it; ``table_dtype`` bfloat16 stores the table in
  bf16, whose renorm takes its norms in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from sessionrec_tpu_torch.graph.batch import flatten_blocks
from sessionrec_tpu_torch.models import layers as L
from sessionrec_tpu_torch.ops import scoring


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


def _normalised(module, xs, masks, training, mesh=None):
    """The tiers ``xs`` through ``module.bn`` where the module has one;
    on a ``mesh`` with the global batch's statistics."""
    if not hasattr(module, "bn"):
        return xs
    return L.batchnorm_parts(module.bn, xs, masks, training=training,
                             mesh=mesh)


class LESSR(nn.Module):
    has_plain_head = True
    graph_kind = "lessr"
    scale = 1.0
    table_norm = False
    shard = None        # parallel/sharded.py:bind_mesh sets it on a mesh

    def __init__(self, num_items, embedding_dim, num_layers, batch_norm=True,
                 feat_drop=0.0, compute_dtype="float32",
                 table_dtype="float32"):
        super().__init__()
        self.num_items = num_items
        self.embedding_dim = d = embedding_dim
        self.num_layers = num_layers
        self.batch_norm = batch_norm
        self.feat_drop = feat_drop
        self.compute_dtype = compute_dtype
        self.embedding = nn.Parameter(torch.empty(
            self.padded_items, d, dtype=getattr(torch, table_dtype)))
        self.layers = nn.ModuleList()
        width = d
        for i in range(num_layers):
            self.layers.append(
                L.EOPA(width, d, batch_norm=batch_norm) if i % 2 == 0
                else L.SGAT(width, d, d, batch_norm=batch_norm))
            width += d
        self.readout = L.AttnReadout(width, d, d, batch_norm=batch_norm,
                                     activation=True)
        width += d
        if batch_norm:
            self.bn = L.BatchNorm(width)
        self.fc_sr = L.Linear(width, d, bias=False)

    @classmethod
    def from_config(cls, cfg, num_items):
        return cls(num_items=num_items, embedding_dim=cfg.embedding_dim,
                   num_layers=cfg.num_layers, batch_norm=cfg.batch_norm,
                   feat_drop=cfg.feat_drop, compute_dtype=cfg.compute_dtype,
                   table_dtype=cfg.table_dtype)

    @property
    def padded_items(self):
        return scoring.pad_catalog(self.num_items)

    @property
    def cdt(self):
        """The compute dtype; None for float32."""
        return L.compute_dtype(self.compute_dtype)

    def reset_parameters(self, gen: torch.Generator):
        from sessionrec_tpu_torch.models.init import reset_torch_defaults
        reset_torch_defaults(self, gen)

    def project_table(self, table):
        """Max-norm projection of ``table`` (the table or a float32 copy of
        it), in place."""
        return renorm_rows(table, 1.0)

    def project_params(self):
        """Max-norm projection of the table, in place."""
        self.project_table(self.embedding.data)

    def head(self, batch, *, training=False, seeds=None):
        """``(sr [B, d], raw table)`` for the fused softmax-CE path (scale
        1, raw table); rows in the order of ``batch.labels``.  ``seeds``
        (a ``layers.SeedSource``) drives dropout; None disables it.  A
        training forward updates the BatchNorm buffers in place."""
        parts = flatten_blocks(batch)
        masks = [b.node_mask for b in parts]
        kw = dict(feat_drop=self.feat_drop, training=training)
        cdt = self.cdt
        cp = L.cast_floats(self, cdt)
        # the gathered rows move to the compute dtype (the table may be
        # stored bf16 whatever the compute dtype)
        mesh = self.shard.mesh if self.shard is not None else None
        feats = [f.to(cdt or torch.float32) for f in L.embedding_lookups(
            self.embedding, [b.node_iid for b in parts], self.shard)]
        for i, lp in enumerate(cp.layers):
            ins = _normalised(lp, feats, masks, training, mesh)
            if i % 2 == 0:
                outs = [L.eopa_apply(lp, f, b.mail_idx, b.mail_mask, seeds,
                                     **kw) for b, f in zip(parts, ins)]
            else:
                outs = [L.sgat_apply(lp, f, b.sc_adj if cdt is None
                                     else b.sc_adj.to(cdt), seeds, **kw)
                        for b, f in zip(parts, ins)]
            feats = [torch.cat([o, f], dim=-1) for o, f in zip(outs, feats)]
        ro_in = _normalised(cp.readout, feats, masks, training, mesh)
        srs = [torch.cat([L.gather_rows(f, b.last_idx),
                          L.attn_readout_apply(cp.readout, x, b.node_mask,
                                               b.last_idx, seeds, **kw)],
                         dim=-1)
               for b, f, x in zip(parts, feats, ro_in)]
        sr = torch.cat(srs, dim=0)
        valid = torch.cat([b.valid for b in parts], dim=0)
        sr = _normalised(cp, [sr], [valid], training, mesh)[0]
        sr = cp.fc_sr(L.dropout(seeds, sr, self.feat_drop, training,
                                tiers=[b.valid.shape[0] for b in parts]))
        return sr, self.embedding
