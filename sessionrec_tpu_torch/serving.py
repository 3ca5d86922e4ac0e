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

Scores are ``train/runner.py:eval_scores``, the code eval ranks: the
plain head's raw masked catalog logits (against ``l2norm(table)`` for
NISER; LESSR's BatchNorm at its running statistics), the multi head's
log-probabilities.  Top-k is exact (``torch.topk``; tied scores may come
in another order than ``lax.top_k``'s lower-index-first).  On CUDA the
step replays a CUDA graph captured over a static batch slot after its
first, eager batch; a capture that fails raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sessionrec_tpu_torch.data.loader import _make_batch
from sessionrec_tpu_torch.train.runner import (StepGraph, _Slots, _capture,
                                               _on_side_stream, eval_scores,
                                               resolve_device, set_precision)
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
        batch = _make_batch(kind, chunk, [0] * batch_size, max_len,
                            batch_size, order, use_native)
        valid = np.zeros(batch_size, np.float32)
        valid[:n] = 1.0
        yield dataclasses.replace(batch, valid=valid), n


class RecommendStep:
    """``step(batch) -> (scores [B, k], item ids [B, k])`` on the model's
    device for a host batch.  On CUDA the first batch runs eagerly on a
    side stream and later ones replay a graph captured over a static
    batch slot (``graph``, None until captured)."""

    def __init__(self, model, k):
        self.model = model
        self.k = k
        self.device = next(model.parameters()).device
        self._slot = _Slots(self.device)
        self._graphs = {}

    @property
    def graph(self) -> StepGraph | None:
        """The captured graph (its ``replays``), None before the
        capture."""
        return self._graphs.get(1)

    @torch.no_grad()
    def _topk(self, batch):
        return torch.topk(eval_scores(self.model, batch), self.k, dim=-1)

    def __call__(self, batch):
        if self.device.type != "cuda":
            return self._topk(batch.to(self.device))
        if not self._slot:
            return _on_side_stream(self.device, lambda: self._topk(
                self._slot.stage(0, batch)))
        self._slot.stage(0, batch)
        g, _ = _capture(self._graphs, 1, None,
                        lambda: self._topk(self._slot[0]))
        g.graph.replay()
        g.replays += 1
        return tuple(t.clone() for t in g.out)


def make_recommend_step(model, k=20, method="exact"):
    """The step that scores a batch and takes its exact top-k
    (``RecommendStep``).  Projects the model's table once (identity for a
    trained checkpoint: the training step keeps it projected).
    ``method="approx"`` is the TPU's ``lax.approx_max_k`` in the JAX
    package and is not ported."""
    if method == "approx":
        raise NotImplementedError(
            "topk method 'approx' is the TPU's lax.approx_max_k; on the GPU "
            "it would be a kernel of its own, not ported (ROADMAP.md, "
            "'Serving')")
    if method != "exact":
        raise ValueError(f"unknown topk method {method!r}")
    model.eval()
    model.project_params()
    return RecommendStep(model, k)


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
              method="exact", order=1, use_native=True):
    """Yield (session, top-k item ids, scores) for each input session, on
    the model's device."""
    validate_sessions(sessions, model.num_items)
    step = make_recommend_step(model, k=k, method=method)
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
