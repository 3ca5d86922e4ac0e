"""The (data, model) mesh over ``torch.distributed`` process groups.

Counterpart of ``sessionrec_tpu/parallel/mesh.py``.  The scaling axis of
this workload is the catalog: the item table is ``[P, D]`` and every step
ends in a ``[B, D] x [D, P]`` product.  The mesh is ``(data, model)``:

* ``data`` — the batch: each data position takes its block of every
  batch's rows, and the gradients of the replicated parameters are summed
  over it;
* ``model`` — the catalog: rank ``(d, m)`` holds rows ``[m P/mp, (m + 1)
  P/mp)`` of the padded table, the losses and rankers run per shard and
  merge ``[B]``-sized statistics over it.

One process runs each rank.  Rank ``r = d * mp + m``: model is the minor
axis, as ``np.asarray(devices).reshape(data, model)`` lays the JAX mesh
out.  Every rank belongs to two groups: its **data group** (the ranks of
its model position, one per data position) and its **model group** (the
ranks of its data position).

The collectives the port needs are plain functions over a group (sum and
max all-reduce, reduce-scatter, all-gather), plus one all-reduce whose
backward all-reduces the gradient (``all_reduce_sum``), for statistics
that the loss of every data position reads (LESSR's BatchNorm).  gloo
takes host tensors only for some of them, so on a ``gloo`` mesh a CUDA
tensor is copied to host memory for the collective and back; the first
time each operation does so it is logged.  NCCL is the default and never
stages.  ``gloo`` serves the CPU and a mesh whose ranks share one card;
it is used only where it is asked for.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sessionrec_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """One rank's view of a ``dp x mp`` mesh: its position ``(d, m)``, its
    device, the backend and its two process groups."""

    def __init__(self, dp, mp, rank, device, backend, data_group,
                 model_group):
        self.dp, self.mp, self.rank = dp, mp, rank
        self.device = torch.device(device)
        self.backend = backend
        self.groups = {DATA_AXIS: data_group, MODEL_AXIS: model_group}
        self.staged = set()

    @property
    def d(self):
        """The rank's data position."""
        return self.rank // self.mp

    @property
    def m(self):
        """The rank's model position (its catalog shard)."""
        return self.rank % self.mp

    @property
    def shape(self):
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.mp}

    @property
    def is_primary(self):
        return self.rank == 0

    def size(self, axis):
        return self.shape[axis]

    def __repr__(self):
        return (f"Mesh(data={self.dp}, model={self.mp}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


def make_mesh(data: int = -1, model: int = 1, devices=None,
              backend=None) -> Mesh:
    """This rank's ``(data, model)`` mesh over the initialised default
    process group (``multihost.initialize``), whose world size must be
    ``data * model``; ``data=-1`` takes all the ranks that ``model``
    leaves.  ``devices`` lists every rank's device, by rank; by default
    rank ``r`` runs on ``cuda:r``, and a mesh with more ranks than visible
    cards raises.  ``backend`` (default ``nccl``) must be the process
    group's."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel/multihost.py:initialize)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data == -1:
        if world % model:
            raise ValueError(f"{world} ranks not divisible by "
                             f"model={model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"data={data} x model={model} != {world} ranks")
    backend = backend or "nccl"
    if dist.get_backend() != backend:
        raise ValueError(f"mesh backend {backend!r} but the process group "
                         f"runs {dist.get_backend()!r}")
    if devices is None:
        n = torch.cuda.device_count()
        if world > n:
            raise ValueError(f"a mesh of {world} ranks needs a card per "
                             f"rank, but only {n} devices are visible")
        devices = [torch.device("cuda", r) for r in range(world)]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    device = torch.device(devices[rank])
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs CUDA devices, got {device}; the CPU "
                         "runs a mesh with backend='gloo'")
    if device.type == "cuda":
        # NCCL's barriers and object collectives use the current device
        torch.cuda.set_device(device)
    # every rank creates every group, in one order
    data_groups = [dist.new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    return Mesh(data, model, rank, device, backend,
                data_groups[rank % model], model_groups[rank // model])


def shard_rows(table, mesh: Mesh):
    """This rank's rows of ``table`` ``[P, ...]``, row-sharded over model:
    ``[m P/mp, (m + 1) P/mp)``, a contiguous copy."""
    P = table.shape[0]
    if P % mesh.mp:
        raise ValueError(f"{P} table rows do not divide over "
                         f"model={mesh.mp}")
    ploc = P // mesh.mp
    return table[mesh.m * ploc:(mesh.m + 1) * ploc].contiguous()


def shard_span(mesh: Mesh, rows: int, num_items: int):
    """``(offset, n_valid)`` of this rank's shard of ``rows`` rows per
    shard: its first global row and its real (item) rows, ``clip(
    num_items - offset, 0, rows)``, as ``xent._localize_labels`` of the
    JAX package takes them."""
    offset = mesh.m * rows
    return offset, min(max(num_items - offset, 0), rows)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _staged(mesh, op, x, fn):
    """Run ``fn`` (an in-place collective) on ``x``, through host memory
    where the backend is gloo and ``x`` lies on a card; returns the
    tensor ``fn`` filled, on ``x``'s device."""
    if mesh.backend == "gloo" and x.is_cuda:
        if op not in mesh.staged:
            mesh.staged.add(op)
            log.info("rank %d: gloo stages %s through host memory",
                     mesh.rank, op)
        return fn(x.cpu()).to(x.device)
    return fn(x)


def all_reduce(x, mesh: Mesh, axis: str, op: str = "sum"):
    """``x`` reduced (``"sum"`` or ``"max"``) over ``axis``'s group, a new
    tensor on every rank of the group."""
    if mesh.size(axis) == 1:
        return x.clone()
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

    def fn(t):
        t = t.clone() if t is x else t
        dist.all_reduce(t, op=rop, group=mesh.groups[axis])
        return t
    return _staged(mesh, f"all_reduce_{op}", x.contiguous(), fn)


def reduce_scatter(x, mesh: Mesh, axis: str):
    """``x`` ``[R, ...]`` summed over ``axis``'s group, of which this rank
    keeps its block of ``R / n`` rows (its position on the axis)."""
    n = mesh.size(axis)
    if n == 1:
        return x.clone()
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not divide over {axis}={n}")

    def fn(t):
        out = torch.empty_like(t[:t.shape[0] // n])
        dist.reduce_scatter(out, list(t.chunk(n)), group=mesh.groups[axis])
        return out
    return _staged(mesh, "reduce_scatter", x.contiguous(), fn)


def all_gather(x, mesh: Mesh, axis: str):
    """The group's ``x`` concatenated along dim 0 in axis order."""
    n = mesh.size(axis)
    if n == 1:
        return x.clone()

    def fn(t):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=mesh.groups[axis])
        return torch.cat(parts)
    return _staged(mesh, "all_gather", x.contiguous(), fn)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


def all_reduce_sum(x, mesh: Mesh, axis: str):
    """``all_reduce(x, mesh, axis)`` under autograd: each rank's loss is its
    data position's part of the global one, so the gradient of the sum is
    the sum of the ranks' gradients."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    return _AllReduceSum.apply(x, mesh, axis)
