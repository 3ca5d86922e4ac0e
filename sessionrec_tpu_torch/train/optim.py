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
    replays inside a CUDA graph."""

    def __init__(self, param, lr, weight_decay, betas=(0.9, 0.999),
                 eps=1e-8):
        self.param = param
        self.lr = lr
        self.weight_decay = float(weight_decay)
        self.b1, self.b2 = betas
        self.eps = eps
        f32 = dict(dtype=torch.float32, device=param.device)
        self.state = {"step": torch.zeros((), **f32),
                      "exp_avg": torch.zeros(param.shape, **f32),
                      "exp_avg_sq": torch.zeros(param.shape, **f32)}

    def zero_grad(self):
        self.param.grad.zero_()

    @torch.no_grad()
    def update(self):
        """Advance the moments by the parameter's gradient and return this
        step's float32 update, ``-lr * m_hat / (sqrt(v_hat) + eps)``."""
        st = self.state
        g = self.param.grad.to(torch.float32)
        if self.weight_decay:
            g = g + self.weight_decay * self.param.to(torch.float32)
        st["step"].add_(1)
        m, v = st["exp_avg"], st["exp_avg_sq"]
        m.mul_(self.b1).add_(g, alpha=1 - self.b1)
        v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
        bc1 = 1 - torch.pow(self.b1, st["step"])
        bc2 = 1 - torch.pow(self.b2, st["step"])
        return -self.lr * (m / bc1) / (torch.sqrt(v / bc2) + self.eps)


def make_optimizer(model, lr, weight_decay, steps_per_epoch, lr_step_size=3,
                   lr_gamma=0.1):
    """``(Adam, StepLR, TableAdam or None)`` on the model's device: a
    bfloat16 ``model.embedding`` takes the ``TableAdam``, every other
    parameter the Adam.  Call ``StepLR.step()`` after every step of
    both."""
    table = model.embedding
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        if p is table and p.dtype == torch.bfloat16:
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
    table_opt = TableAdam(table, sched.lr, weight_decay) \
        if table.dtype == torch.bfloat16 else None
    return opt, sched, table_opt
