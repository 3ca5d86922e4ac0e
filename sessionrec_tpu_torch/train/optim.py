"""Optimizer reproducing the reference trainer's update rule.

Counterpart of ``sessionrec_tpu/train/optim.py``: torch ``Adam(lr,
weight_decay)`` with a no-decay parameter group for bias / batch-norm /
activation parameters (reference train.py:12-23,74), plus
``StepLR(step_size=3, gamma=0.1)``.  torch Adam's ``weight_decay`` adds
``wd * param`` to the gradient before the moment updates (not AdamW),
exactly the JAX chain ``add_decayed_weights -> scale_by_adam``.

The schedule counts optimizer steps: the learning rate of step ``k`` is
``lr * gamma ** ((k // steps_per_epoch) // step_size)``, as the JAX
package's ``step_lr``, so the drop lands on the same step.  The count and
the rate are float32/int64 tensors on the parameters' device that
``StepLR.step`` updates in place, and both groups read the one ``lr``
tensor, so a CUDA graph that captures the step replays the schedule too.
On CUDA, Adam is ``capturable``: its step counts live on the device.

A bfloat16 table takes its own update, ``TableAdam``, the counterpart of
the JAX chain's ``_upcast_grads`` and ``_scale_by_adam_f32``:
``torch.optim.Adam`` keeps its moments in the parameter's type, and a
bf16 second moment freezes once ``(1 - b2) g^2`` falls below its half
ulp.  Its moments are float32, the gradient is upcast before the weight
decay is added, and it returns the float32 update, which the trainer
adds to the table in float32 and rounds back stochastically
(``train/runner.py``).
"""

from __future__ import annotations

import torch

from sessionrec_tpu_torch.ops.sround import stochastic_round_bf16_bits
from sessionrec_tpu_torch.parallel.mesh import DATA_AXIS, all_gather
from sessionrec_tpu_torch.parallel.sharded import (reduce_table_grad,
                                                   table_grad_scatters)

# parameter-name components that mark a no-decay parameter, mirroring the
# reference's substring rule ['bias', 'batch_norm', 'activation']
# (train.py:18) as the JAX package keys it
_NO_DECAY_KEYS = {"b", "b_ih", "b_hh", "bias", "bn", "act"}


def decays(name: str) -> bool:
    """True where weight decay applies to parameter ``name``."""
    return not any(part in _NO_DECAY_KEYS for part in name.split("."))


class StepLR:
    """``lr * gamma ** ((count // steps_per_epoch) // step_size)`` from a
    device step counter into the device tensor ``lr``."""

    def __init__(self, lr, steps_per_epoch, step_size=3, gamma=0.1,
                 device=None):
        self.base_lr = float(lr)
        self.spe = max(int(steps_per_epoch), 1)
        self.step_size = int(step_size)
        f32 = dict(dtype=torch.float32, device=device)
        self.gamma = torch.tensor(float(gamma), **f32)
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.lr = torch.tensor(self.base_lr, **f32)

    def step(self):
        """Count one optimizer step and set ``lr`` for the next."""
        self.count.add_(1)
        drops = torch.div(torch.div(self.count, self.spe, rounding_mode="floor"),
                          self.step_size, rounding_mode="floor")
        self.lr.copy_(self.base_lr * torch.pow(self.gamma,
                                               drops.to(torch.float32)))


class TableAdam:
    """Adam (torch's rule: ``wd * p`` added to the gradient) for one
    bfloat16 table, with float32 moments and a float32 step count in
    ``state`` (the keys of ``torch.optim.Adam``'s state).  Every operand
    is a device tensor, the rate the schedule's ``lr``, so the update
    replays inside a CUDA graph.  ``rows``: moments for that many rows
    only (a ``ShardedTableAdam``'s slice)."""

    def __init__(self, param, lr, weight_decay, betas=(0.9, 0.999),
                 eps=1e-8, rows=None):
        self.param = param
        self.lr = lr
        self.weight_decay = float(weight_decay)
        self.b1, self.b2 = betas
        self.eps = eps
        f32 = dict(dtype=torch.float32, device=param.device)
        shape = param.shape if rows is None else (rows, param.shape[1])
        self.state = {"step": torch.zeros((), **f32),
                      "exp_avg": torch.zeros(shape, **f32),
                      "exp_avg_sq": torch.zeros(shape, **f32)}

    def zero_grad(self):
        self.param.grad.zero_()

    @torch.no_grad()
    def update(self, g=None, p=None):
        """Advance the moments by the float32 gradient ``g`` of the rows
        ``p`` (by default the parameter's own gradient and value) and
        return this step's float32 update, ``-lr * m_hat / (sqrt(v_hat) +
        eps)``."""
        st = self.state
        if g is None:
            g, p = self.param.grad.to(torch.float32), self.param
        if self.weight_decay:
            g = g + self.weight_decay * p.to(torch.float32)
        st["step"].add_(1)
        m, v = st["exp_avg"], st["exp_avg_sq"]
        m.mul_(self.b1).add_(g, alpha=1 - self.b1)
        v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
        bc1 = 1 - torch.pow(self.b1, st["step"])
        bc2 = 1 - torch.pow(self.b2, st["step"])
        return -self.lr * (m / bc1) / (torch.sqrt(v / bc2) + self.eps)


class ShardedTableAdam(TableAdam):
    """Adam for a model's table shard on a (data, model) mesh, with the
    ZeRO layout of the JAX package (``parallel/sharded.py:281-307``,
    ``train/runner.py:121-232``).

    Where the shard's rows divide over the data axis, the shard's float32
    gradient (``model.shard.grad``) is reduce-scattered over the data
    group, and each rank keeps the Adam moments of its ``rows / dp`` rows
    only: the table's moments shard over both axes, model-major and
    data-minor.  ``TableAdam``'s update (float32 moments) steps that
    slice, the max-norm projection runs on its float32 sum,
    and the updated rows are gathered over the data group.  Otherwise the
    gradient is all-reduced and every rank steps its whole shard.

    A bfloat16 table rounds the slice stochastically before the gather,
    with the JAX package's per-shard seed ``seed + sid * 0x27D4EB2F``,
    ``sid = m * dp + d``, over the slice's own flat indices, and gathers
    the bits; without the ZeRO layout the shard rounds with the step's
    seed at its place in the whole table, as the JAX package's global
    rounding does."""

    SID_STRIDE = 0x27D4EB2F

    def __init__(self, model, lr, weight_decay, betas=(0.9, 0.999),
                 eps=1e-8):
        self.model = model
        self.shard = model.shard
        mesh = self.shard.mesh
        self.scatter = table_grad_scatters(mesh, self.shard.rows)
        self.rows = self.shard.rows // mesh.dp if self.scatter \
            else self.shard.rows
        self.lo = mesh.d * self.rows if self.scatter else 0
        super().__init__(model.embedding, lr, weight_decay, betas, eps,
                         rows=self.rows)

    def zero_grad(self):
        if self.shard.grad.grad is not None:
            self.shard.grad.grad.zero_()

    def _round(self, new, seed):
        """The bfloat16 bits of ``new``, this rank's rows, rounded with the
        JAX package's seed and indices for them."""
        mesh = self.shard.mesh
        if self.scatter:
            sid = mesh.m * mesh.dp + mesh.d
            return stochastic_round_bf16_bits(new, seed
                                              + sid * self.SID_STRIDE)
        return stochastic_round_bf16_bits(new, seed,
                                          mesh.m * new.numel())

    @torch.no_grad()
    def step(self, seed=None):
        """Reduce the shard's gradient, step Adam on this rank's rows,
        project them and write the gathered rows into the table; ``seed``
        (the step's device seed) rounds a bfloat16 table."""
        mesh = self.shard.mesh
        # summed over data in float32, then cast once to the table's type
        # (a bfloat16 table's gradient is bfloat16, as on one device)
        g = reduce_table_grad(self.shard.grad.grad, mesh) \
            .to(self.param.dtype).to(torch.float32)
        p = self.param[self.lo:self.lo + self.rows].to(torch.float32)
        new = self.model.project_table(p + self.update(g, p))
        if self.param.dtype == torch.bfloat16:
            new = self._round(new, seed).view(torch.bfloat16)
        if self.scatter:
            new = all_gather(new, mesh, DATA_AXIS)
        self.param.copy_(new)


def make_optimizer(model, lr, weight_decay, steps_per_epoch, lr_step_size=3,
                   lr_gamma=0.1):
    """``(Adam, StepLR, table optimizer or None)`` on the model's device: a
    bfloat16 ``model.embedding`` takes a ``TableAdam``, a table shard on a
    mesh (``model.shard``) a ``ShardedTableAdam``, every other parameter
    the Adam.  Call ``StepLR.step()`` after every step of both."""
    table = model.embedding
    sharded = getattr(model, "shard", None) is not None
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        if p is table and (sharded or p.dtype == torch.bfloat16):
            continue
        (decay if decays(name) else no_decay).append(p)
    device = decay[0].device
    sched = StepLR(lr, steps_per_epoch, lr_step_size, lr_gamma, device)
    cuda = device.type == "cuda"
    # a tensor lr needs the capturable update on CUDA, and on the CPU the
    # single-tensor one (torch refuses it with foreach and no capture)
    opt = torch.optim.Adam(
        [{"params": decay, "weight_decay": weight_decay},
         {"params": no_decay, "weight_decay": 0.0}],
        lr=sched.lr, betas=(0.9, 0.999), eps=1e-8, capturable=cuda,
        foreach=cuda)
    if sharded:
        table_opt = ShardedTableAdam(model, sched.lr, weight_decay)
    elif table.dtype == torch.bfloat16:
        table_opt = TableAdam(table, sched.lr, weight_decay)
    else:
        table_opt = None
    return opt, sched, table_opt
