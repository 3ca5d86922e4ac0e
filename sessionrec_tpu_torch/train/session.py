"""End-to-end training session: dataset -> loaders -> model -> runner.

Counterpart of ``sessionrec_tpu/train/session.py`` (reference wiring
main_msgifsr.py:128-188): read the dataset, optional tail valid split,
prefix-augmented loaders (ordered train stream unless the preset
shuffles), model, TrainRunner, on one device, with the checkpointer, the
metrics sink and the profiler trace that the config asks for.  Both
loaders yield host batches, which the runner moves to the device (into
its static slots on CUDA).

With ``data_parallel x model_parallel > 1`` this process is one rank of a
(data, model) mesh (``_make_mesh``; ``cli train`` starts the processes).
On one host each rank builds the global batch stream and keeps its data
position's rows of every tier (``BatchLoader(data_block=...)``), the
layout GSPMD gives the JAX package's batches, so the ``(4, 8)`` tiers
stay; each rank pays the whole build.  A ``--coordinator`` launch
(``slice_batches``) builds only the rank's rows of each global batch
(``multihost.local_batch_slice``) and takes no tiers, as the JAX
package's multi-host loader does.  Logs and metrics come from rank 0.
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as dist

from sessionrec_tpu_torch.data.io import max_session_len, read_dataset
from sessionrec_tpu_torch.data.loader import BatchLoader
from sessionrec_tpu_torch.models import build_model, graph_kind
from sessionrec_tpu_torch.parallel.mesh import make_mesh
from sessionrec_tpu_torch.parallel.multihost import local_batch_slice
from sessionrec_tpu_torch.train.runner import TrainRunner, resolve_device
from sessionrec_tpu_torch.utils.checkpoint import Checkpointer
from sessionrec_tpu_torch.utils.logging import get_logger
from sessionrec_tpu_torch.utils.metrics import MetricsLogger
from sessionrec_tpu_torch.utils.profiling import trace

log = get_logger(__name__)


def make_loaders(cfg, model_name=None, order=1, mesh=None,
                 slice_batches=False):
    """(train loader, test loader, items, max_len); on a ``mesh`` the
    loaders yield this rank's rows (see the module docstring)."""
    train_sessions, test_sessions, num_items = read_dataset(cfg.dataset_dir)
    if cfg.valid_split is not None:
        # tail split: the last fraction of the time-ordered train stream
        # becomes the validation set (main_msgifsr.py:136-139)
        num_valid = int(len(train_sessions) * cfg.valid_split)
        test_sessions = train_sessions[-num_valid:]
        train_sessions = train_sessions[:-num_valid]
    max_len = cfg.max_len or max(max_session_len(train_sessions),
                                 max_session_len(test_sessions))
    if cfg.max_len is None and max_len > 50:
        log.warning(
            "longest session is %d items; consider --max-len 20 "
            "(prefixes keep their most recent items)", max_len)
    kind = graph_kind(model_name)
    split_len = getattr(cfg, "split_len", None)
    rows = {}
    if mesh is not None and slice_batches:
        if split_len:
            log.warning("length tiers are off where each process builds "
                        "its own rows of the batches (--coordinator)")
        split_len = None
        rows["batch_slice"] = local_batch_slice(mesh, cfg.batch_size)
    elif mesh is not None:
        rows["data_block"] = (mesh.d, mesh.dp)
    train_loader = BatchLoader(
        train_sessions, kind, cfg.batch_size, max_len,
        shuffle=cfg.shuffle_train, order=order, prefetch=cfg.num_prefetch,
        split_len=split_len, use_native=cfg.use_native_collate, **rows)
    test_loader = BatchLoader(
        test_sessions, kind, cfg.batch_size, max_len, shuffle=False,
        order=order, prefetch=cfg.num_prefetch, split_len=split_len,
        use_native=cfg.use_native_collate, **rows)
    if train_loader.split is not None:
        log.info("length-bucketed batches: split_len=%s, tier caps "
                 "train=%s test=%s", train_loader.split[0],
                 train_loader.split[1], test_loader.split[1]
                 if test_loader.split else None)
    return train_loader, test_loader, num_items, max_len


def _make_mesh(t, slice_batches=False):
    """This rank's (data, model) mesh when ``data_parallel x
    model_parallel > 1``, else None (``train/session.py:82-104`` of the
    JAX package).  The process group must be up: one process per rank.
    On the CPU (``device`` cpu) the ranks talk over gloo; on CUDA over
    NCCL, rank r on card r of its host, and on one host a mesh with more
    ranks than visible cards raises."""
    dp = int(t.data_parallel or 1)
    mp = int(t.model_parallel or 1)
    if dp * mp <= 1:
        return None
    if dp > 1 and mp == 1:
        log.warning(
            "data_parallel=%d with model_parallel=1: every rank's table "
            "gradient and update cross the data group whole, twice the "
            "table bytes a rank moves at model_parallel=2", dp)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {dp * mp} ranks runs one process per rank: "
            "'cli train' starts them, or launch each with --coordinator, "
            "--num-processes and --process-id")
    world = dist.get_world_size()
    if t.device == "cpu":
        return make_mesh(dp, mp, devices=[torch.device("cpu")] * world,
                         backend="gloo")
    resolve_device(t.device)
    n = torch.cuda.device_count()
    if not slice_batches and dp * mp > n:
        raise ValueError(f"requested data_parallel={dp} x model_parallel="
                         f"{mp} but only {n} devices are visible")
    return make_mesh(dp, mp, devices=[torch.device("cuda", r % n)
                                      for r in range(world)])


def run_training(cfg, max_epoch_batches=None, slice_batches=False):
    """Train as ``cfg`` says; returns the TrainRunner, whose ``max_mrr`` /
    ``max_hit`` are the run's result.  With ``resume``, training goes on
    from the latest checkpoint in ``checkpoint_dir``.  On a mesh,
    ``slice_batches`` builds only this rank's rows of each batch (a
    ``--coordinator`` launch; see the module docstring)."""
    name = cfg.model.name.lower()
    t = cfg.train
    if t.resume and not t.checkpoint_dir:
        raise ValueError("resume needs a checkpoint directory "
                         "(--checkpoint-dir)")
    mesh = _make_mesh(t, slice_batches)
    if mesh is not None and not mesh.is_primary:
        logging.getLogger("sessionrec_tpu_torch").setLevel(logging.WARNING)
    device = resolve_device(t.device) if mesh is None else mesh.device
    train_loader, test_loader, num_items, max_len = make_loaders(
        cfg.data, model_name=name, order=cfg.model.order, mesh=mesh,
        slice_batches=slice_batches)
    log.info("dataset %s: %d train / %d test examples, %d items, max_len %d",
             cfg.data.dataset_dir, train_loader.num_examples,
             test_loader.num_examples, num_items, max_len)
    model = build_model(cfg.model, num_items)
    log.info("model %s on %s", name, device)
    if mesh is not None:
        log.info("mesh: data=%d x model=%d ranks over %s", mesh.dp, mesh.mp,
                 mesh.backend)
    if max_epoch_batches is not None:
        train_loader = _CappedLoader(train_loader, max_epoch_batches)
    checkpointer = Checkpointer(t.checkpoint_dir) if t.checkpoint_dir \
        else None
    metrics = MetricsLogger(t.metrics_file) if t.metrics_file and (
        mesh is None or mesh.is_primary) else None
    try:
        runner = TrainRunner(
            model, train_loader, test_loader,
            lr=t.lr, weight_decay=t.weight_decay, patience=t.patience,
            seed=t.seed, cutoff=t.cutoff, lr_step_size=t.lr_step_size,
            lr_gamma=t.lr_gamma, eval_before_train=t.eval_before_train,
            checkpointer=checkpointer,
            checkpoint_every=t.checkpoint_every_epochs, unroll=t.unroll,
            metrics=metrics, device=device, mesh=mesh)
        if checkpointer is not None and t.resume:
            checkpointer.restore_latest(runner)
        with trace(t.profile_dir if mesh is None or mesh.is_primary
                   else None):
            runner.train(t.epochs, t.log_interval)
    finally:
        if metrics is not None:
            metrics.close()
    return runner


class _CappedLoader:
    """Wraps a loader to yield at most N batches per epoch (smoke runs);
    its length is what the LR schedule counts as an epoch."""

    def __init__(self, loader, cap):
        self.loader = loader
        self.cap = cap

    def __len__(self):
        return min(len(self.loader), self.cap)

    @property
    def num_examples(self):
        return self.loader.num_examples

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        it = iter(self.loader)
        try:
            for _ in range(len(self)):
                yield next(it)
        finally:
            it.close()
