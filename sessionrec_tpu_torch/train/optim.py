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


def make_optimizer(model, lr, weight_decay, steps_per_epoch, lr_step_size=3,
                   lr_gamma=0.1):
    """``(Adam, StepLR)`` on the model's device; call ``StepLR.step()``
    after every ``optimizer.step()``."""
    decay, no_decay = [], []
    for name, p in model.named_parameters():
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
    return opt, sched
