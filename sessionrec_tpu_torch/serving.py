"""Inference / serving: top-k item recommendations from a checkpoint.

Counterpart of ``sessionrec_tpu/serving.py``.  The reference has no
serving surface (top-k indices are computed and discarded at
train.py:45-53); this module restores a trained model from a checkpoint
directory written by ``train --checkpoint-dir`` and emits the top-k item
ids per session, batched.

Serving semantics differ from eval on purpose: each input session is
scored ONCE in full (the next-item continuation a recommender actually
serves), not expanded into the per-prefix examples of training.
Sessions longer than ``max_len`` keep their most recent items.  Batches
are flat (no length tiers), padded to the batch size with ``[0]``
sessions whose ``valid`` is 0; their rows are dropped before the ids go
to the host.

The plain head always scores its materialised masked catalog logits
(``train/runner.py:eval_scores``: against ``l2norm(table)`` for NISER;
LESSR's BatchNorm at its running statistics), as the JAX package does.
The multi head scores its fused REnorm/fusion blend: ``model.apply``'s
log-probabilities while the ``[B, K, P]`` scores stay below eval's
streaming threshold (``runner._auto_stream``), and above it, or with
``streamed=True``, the slab-streamed two-pass top-k
(``ops/streamed_eval.py:streamed_multi_topk``), whose values are raw
blended probabilities in the same order and whose ids are the same.
Top-k is ``scoring.stable_topk``: ``lax.top_k``'s order, equal scores by
ascending id.  On CUDA the step replays a CUDA graph captured over a
static batch slot after its first, eager batch; a capture that fails
raises.  With tracing on (``utils/profiling.py``) a batch's build is a
``serving.build`` span, the scoring after the session vectors
``serve.score`` and the top-k ``serve.topk``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sessionrec_tpu_torch.data.loader import _make_batch
from sessionrec_tpu_torch.ops.scoring import stable_topk
from sessionrec_tpu_torch.ops.streamed_eval import streamed_multi_topk
from sessionrec_tpu_torch.train.runner import (StepGraph, _capture, _launch,
                                               _on_side_stream, _Slots,
                                               _streams, eval_scores,
                                               resolve_device, set_precision)
from sessionrec_tpu_torch.utils import profiling
from sessionrec_tpu_torch.utils.checkpoint import Checkpointer


def restore_params(model, checkpoint_dir, device="cuda"):
    """``model`` on ``device`` with the latest checkpoint's parameters in
    ``checkpoint_dir``.  Reads ``params.pt`` only: the Adam moments of a
    training checkpoint (two table-sized tensors) are never loaded, and
    serving works when ``train.pt`` was deleted to save space."""
    set_precision()
    model.to(resolve_device(str(device)))
    if not Checkpointer(checkpoint_dir).restore_params(model):
        raise FileNotFoundError(f"no checkpoint found in {checkpoint_dir}")
    return model


def session_batches(sessions, kind, batch_size, max_len, order=1,
                    use_native=True):
    """Fixed-shape host batches: one row per FULL session (no prefix
    augmentation), labels 0, the tail padded with ``[0]`` sessions whose
    ``valid`` is 0.  Yields ``(batch, real rows)``.  ``use_native`` picks
    the loader's builder (the C++ one by default)."""
    for start in range(0, len(sessions), batch_size):
        chunk = [list(s[-max_len:]) for s in
                 sessions[start:start + batch_size]]
        n = len(chunk)
        chunk += [[0]] * (batch_size - n)
        with profiling.span("serving.build"):
            batch = _make_batch(kind, chunk, [0] * batch_size, max_len,
                                batch_size, order, use_native)
        valid = np.zeros(batch_size, np.float32)
        valid[:n] = 1.0
        yield dataclasses.replace(batch, valid=valid), n


def serving_tile(padded_items):
    """Slab rows of the streamed multi-head top-k: 16 times eval's, since
    each slab pays a top-k where counting pays none (chosen on a TPU,
    ``sessionrec_tpu/serving.py:145-150``; PERF.md §7 holds it against
    2048 on the H100)."""
    return 32768 if padded_items >= 32768 else 2048


@torch.no_grad()
def recommend_topk(model, batch, k, streamed=None, tile=None):
    """``(scores [B, k], item ids [B, k])`` of a device batch.
    ``streamed``: None streams the multi head where eval would
    (``runner._auto_stream``), True or False forces it; the plain head
    always materialises.  ``tile``: the streamed slab rows, None for
    ``serving_tile``."""
    if model.has_plain_head or not _streams(model, batch, streamed):
        scores = eval_scores(model, batch)
        with profiling.span("serve.topk"):
            return stable_topk(scores, k)
    sr, table, phi, alpha, iids = model.head_multi(batch, training=False)
    return streamed_multi_topk(
        sr, table, iids, phi, alpha, num_items=model.num_items,
        extra=model.extra, fusion=model.fusion, k=k,
        scale=float(model.scale), normalize_table=model.table_norm,
        compute_dtype=model.cdt,
        tile=tile or serving_tile(model.padded_items))


class RecommendStep:
    """``step(batch) -> (scores [B, k], item ids [B, k])`` on the model's
    device for a host batch (``recommend_topk``).  On CUDA the first batch
    runs eagerly on a side stream and later ones replay a graph captured
    over a static batch slot (``graph``, None until captured)."""

    def __init__(self, model, k, streamed=None, tile=None):
        self.model = model
        self.k = k
        self.streamed = streamed
        self.tile = tile
        self.device = next(model.parameters()).device
        self._slot = _Slots(self.device)
        self._graphs = {}

    @property
    def graph(self) -> StepGraph | None:
        """The captured graph (its ``replays``), None before the
        capture."""
        return self._graphs.get(1)

    def _topk(self, batch):
        return recommend_topk(self.model, batch, self.k, self.streamed,
                              self.tile)

    def __call__(self, batch):
        if self.device.type != "cuda":
            return self._topk(batch.to(self.device))
        if not self._slot:
            return _on_side_stream(self.device, lambda: self._topk(
                self._slot.stage(0, batch)))
        self._slot.stage(0, batch)
        g, _ = _capture(self._graphs, 1, None,
                        lambda: self._topk(self._slot[0]), "serve")
        _launch(g)
        return tuple(t.clone() for t in g.out)


def make_recommend_step(model, k=20, method="exact", recall_target=0.95,
                        streamed=None, tile=None):
    """The step that scores a batch and takes its top-k
    (``RecommendStep``; ``streamed`` and ``tile`` as in
    ``recommend_topk``).  Projects the model's table once (identity for a
    trained checkpoint: the training step keeps it projected).

    ``method="approx"`` is ``lax.approx_max_k`` in the JAX package, which
    is approximate only on a TPU: on the CPU and the GPU XLA computes it
    as the exact ``lax.top_k``.  So here it is the exact stable top-k, of
    recall 1, which meets any ``recall_target`` in (0, 1]."""
    if method not in ("exact", "approx"):
        raise ValueError(f"unknown topk method {method!r}")
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target must lie in (0, 1], got "
                         f"{recall_target}")
    model.eval()
    model.project_params()
    return RecommendStep(model, k, streamed, tile)


def validate_sessions(sessions, num_items):
    """Reject out-of-catalog item ids before they reach the device: a
    gather with an id >= num_items would fault on the card or score
    against a padding row.  Raises naming the first offending session
    (1-based, matching --sessions-file line numbers)."""
    for i, s in enumerate(sessions):
        for iid in s:
            if not 0 <= iid < num_items:
                raise ValueError(
                    f"session {i + 1}: item id {iid} is outside the "
                    f"catalog [0, {num_items}) — check that the sessions "
                    f"use the same item-id space as the training dataset")


def recommend(model, sessions, *, max_len, k=20, batch_size=256,
              method="exact", recall_target=0.95, order=1, streamed=None,
              use_native=True):
    """Yield (session, top-k item ids, scores) for each input session, on
    the model's device (``make_recommend_step``'s options)."""
    validate_sessions(sessions, model.num_items)
    step = make_recommend_step(model, k=k, method=method,
                               recall_target=recall_target,
                               streamed=streamed)
    kind = model.graph_kind
    done = 0
    for batch, n in session_batches(sessions, kind, batch_size, max_len,
                                    order=order, use_native=use_native):
        vals, ids = step(batch)
        vals = vals[:n].cpu().tolist()
        ids = ids[:n].cpu().tolist()
        for i in range(n):
            yield sessions[done + i], ids[i], vals[i]
        done += n
