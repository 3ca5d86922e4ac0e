"""Checkpoint/resume — a capability the reference lacks (it never saves
the model, SURVEY.md §5), flag-gated and off by default.

Counterpart of ``sessionrec_tpu/utils/checkpoint.py``, with torch files in
place of orbax.  Epoch ``e`` of a run writes, under the checkpoint
directory:

* ``epoch_EEEE/params.pt`` — the model's ``state_dict``, its parameters
  and buffers (LESSR's running BatchNorm statistics): all that serving
  reads (``restore_params``), so it works when ``train.pt`` is deleted;
* ``epoch_EEEE/train.pt`` — the rest of the runner's ``named_state``:
  Adam's moments and step counts by parameter name, the schedule's
  counter and rate, the dropout counter;
* ``epoch_EEEE.json`` — the sidecar, written last, with the JAX package's
  keys: ``epoch``, ``metrics``, ``batch`` (the runner's step count),
  ``max_mrr``, ``max_hit``, ``bad_counter``.  Only sidecars decide
  ``latest_epoch``.

A restore copies the saved values *in place* into the tensors the runner
already holds, so CUDA graphs captured from them stay valid.  Files load
with ``weights_only=True`` onto the target's device.

On a (data, model) mesh a checkpoint holds global tensors, as orbax saves
the JAX package's global arrays: every rank gathers the table (over the
model group) and its Adam moments (over the data group where they are
ZeRO-sharded, then over the model group), and rank 0 writes the files.
A restore, at any ``(dp, mp)`` or on one device, slices each rank's part
out of them.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
import torch.distributed as dist

from sessionrec_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                all_gather)
from sessionrec_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

PARAMS = "params.pt"
TRAIN = "train.pt"


def _load(path, device):
    return torch.load(path, weights_only=True, map_location=device)


def _migrate(name, saved, target):
    """``saved`` made to fit ``target``'s shape (VERDICT r3 item 6 of the
    JAX package): a checkpoint written under another ``pad_catalog``
    multiple carries embedding rows (and their Adam moments) at another
    padded catalog size.  Such catalog-axis drift on a leaf whose name
    holds ``embedding`` is padded with the target's own rows (fresh rows
    for the table, zeros for fresh moments; both are masked-out padding)
    or sliced down: real items occupy rows ``[0, num_items)``.  A dtype
    difference is cast by the copy, and logged.  Any other shape drift
    raises ``ValueError`` naming the leaf."""
    if saved.shape != target.shape:
        if not ("embedding" in name and saved.dim() == target.dim() >= 2
                and saved.shape[1:] == target.shape[1:]):
            raise ValueError(
                f"checkpoint leaf {name}: saved shape {tuple(saved.shape)} "
                f"is incompatible with template {tuple(target.shape)} "
                "(only catalog-axis drift on embedding rows is migratable)")
        n = target.shape[0]
        log.warning("migrated %s rows %d -> %d", name, saved.shape[0], n)
        saved = (torch.cat([saved, target[saved.shape[0]:].to(saved.dtype)])
                 if saved.shape[0] < n else saved[:n])
    if saved.dtype != target.dtype:
        log.warning("migrated %s dtype %s -> %s (resume is no longer "
                    "bit-identical)", name, saved.dtype, target.dtype)
    return saved


@torch.no_grad()
def _copy_into(targets, saved, path):
    """Copy ``saved[name]`` into each of ``targets`` in place."""
    for name, target in targets.items():
        if name not in saved:
            raise ValueError(
                f"checkpoint {path} is missing leaf {name}: saved under an "
                f"incompatible code version (saved leaves: "
                f"{sorted(saved)[:20]})")
        target.copy_(_migrate(name, saved[name], target))


_TABLE = "embedding"
_MOMENTS = ("adam/embedding/exp_avg", "adam/embedding/exp_avg_sq")


def global_state(runner):
    """``runner.named_state()`` with the table and its moments whole: on a
    mesh every rank gathers them (a collective; every rank calls it)."""
    state = runner.named_state()
    mesh = runner.mesh
    if mesh is None:
        return state
    state[_TABLE] = all_gather(state[_TABLE], mesh, MODEL_AXIS)
    for name in _MOMENTS:
        x = state[name]
        if runner.table_opt.scatter:
            x = all_gather(x, mesh, DATA_AXIS)
        state[name] = all_gather(x, mesh, MODEL_AXIS)
    return state


def _local_part(runner, name, saved):
    """This rank's part of the global ``saved`` tensor ``name``: its shard
    of the table, its slice of the table's moments; all of the rest."""
    if runner.mesh is None or name not in (_TABLE,) + _MOMENTS:
        return saved
    opt = runner.table_opt
    lo = runner.mesh.m * opt.shard.rows
    if name == _TABLE:
        return saved[lo:lo + opt.shard.rows]
    return saved[lo + opt.lo:lo + opt.lo + opt.rows]


def load_state(runner, saved, source="state"):
    """Copy the global state ``saved`` (``global_state``'s names and
    shapes) into ``runner`` in place, each rank its part; Adam's state is
    created first where no step has made it yet."""
    saved = {k: _local_part(runner, k, v) for k, v in saved.items()}
    runner.init_opt_state()
    _copy_into(runner.named_state(), saved, source)


class Checkpointer:
    def __init__(self, directory):
        self.dir = Path(directory).absolute()

    def _path(self, epoch):
        return self.dir / f"epoch_{epoch:04d}"

    def save(self, epoch, runner, metrics=None):
        """Snapshot everything a bit-identical resume needs: the runner's
        ``named_state`` in the two files, and the loop counters and
        early-stop bookkeeping in the sidecar, written last."""
        state = global_state(runner)
        mesh = runner.mesh
        if mesh is None or mesh.is_primary:
            path = self._path(epoch)
            path.mkdir(parents=True, exist_ok=True)
            names = runner.model.state_dict().keys()
            torch.save({k: state[k] for k in names}, path / PARAMS)
            torch.save({k: v for k, v in state.items() if k not in names},
                       path / TRAIN)
            meta = {"epoch": epoch, "metrics": metrics or {},
                    "batch": runner.steps, "max_mrr": runner.max_mrr,
                    "max_hit": runner.max_hit,
                    "bad_counter": runner.bad_counter}
            (self.dir / f"epoch_{epoch:04d}.json").write_text(
                json.dumps(meta))
            log.info("saved checkpoint %s", path)
        if mesh is not None:
            dist.barrier()      # the files exist for every rank

    def latest_epoch(self):
        epochs = sorted(int(p.stem.split("_")[1])
                        for p in self.dir.glob("epoch_*.json"))
        return epochs[-1] if epochs else None

    def restore_latest(self, runner):
        """Resume ``runner`` from the latest checkpoint: its state in place
        (Adam's state is created first where no step has made it yet),
        then the counters; False when there is none."""
        ep = self.latest_epoch()
        if ep is None:
            log.info("no checkpoint to resume from in %s", self.dir)
            return False
        path = self._path(ep)
        saved = _load(path / PARAMS, runner.device)
        saved.update(_load(path / TRAIN, runner.device))
        load_state(runner, saved, path)
        meta = json.loads((self.dir / f"epoch_{ep:04d}.json").read_text())
        runner.epoch = ep + 1
        runner.steps = int(meta.get("batch", 0))
        runner.max_mrr = float(meta.get("max_mrr", 0.0))
        runner.max_hit = float(meta.get("max_hit", 0.0))
        runner.bad_counter = int(meta.get("bad_counter", 0))
        log.info("resumed from %s (epoch %d)", path, ep)
        return True

    def restore_params(self, model):
        """Copy the latest checkpoint's parameters and buffers into
        ``model`` in place (the counterpart of ``restore_subtree``): reads
        ``params.pt`` only, never ``train.pt``, so Adam's table-sized
        moments are never loaded.  False when there is no checkpoint."""
        ep = self.latest_epoch()
        if ep is None:
            return False
        path = self._path(ep)
        device = next(model.parameters()).device
        _copy_into(model.state_dict(), _load(path / PARAMS, device), path)
        return True
