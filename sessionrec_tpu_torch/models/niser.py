"""NISER+ — SRGNN with l2-normalised embeddings and a scaled softmax
(reference src/models/niser.py:91-157).

Counterpart of ``sessionrec_tpu/models/niser.py``.  The deltas from SRGNN
(models/srgnn.py), with ``norm`` on: the embedding is normalised after
dropout (niser.py:134-135) and again before the readout (141-142), the
session vector too (147-151), and the catalog table is normalised inside
the fused loss kernels (``table_norm``); the logits are scaled by
``scale`` (12, niser.py:152-156).  It keeps SRGNN's readout-on-embedding
quirk and its parameter names.
"""

from __future__ import annotations

from sessionrec_tpu_torch.models.srgnn import SRGNN


class NISER(SRGNN):
    def __init__(self, num_items, embedding_dim, num_layers, feat_drop=0.0,
                 norm=True, scale=12.0, readout_on_embedding=True,
                 compute_dtype="float32", table_dtype="float32"):
        super().__init__(num_items, embedding_dim, num_layers,
                         feat_drop=feat_drop,
                         readout_on_embedding=readout_on_embedding,
                         norm=norm, scale=scale, compute_dtype=compute_dtype,
                         table_dtype=table_dtype)

    @classmethod
    def from_config(cls, cfg, num_items):
        return cls(num_items=num_items, embedding_dim=cfg.embedding_dim,
                   num_layers=cfg.num_layers, feat_drop=cfg.feat_drop,
                   norm=cfg.norm, scale=cfg.scale,
                   readout_on_embedding=cfg.readout_on_embedding,
                   compute_dtype=cfg.compute_dtype,
                   table_dtype=cfg.table_dtype)
