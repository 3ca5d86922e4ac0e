"""Optimizer reproducing the reference trainer's update rule.

Counterpart of ``sessionrec_tpu/train/optim.py``: torch ``Adam(lr,
weight_decay)`` with a no-decay parameter group for bias / batch-norm /
activation parameters (reference train.py:12-23,74), plus
``StepLR(step_size=3, gamma=0.1)``.  torch Adam's ``weight_decay`` adds
``wd * param`` to the gradient before the moment updates (not AdamW),
exactly the JAX chain ``add_decayed_weights -> scale_by_adam``.

The schedule counts optimizer steps: the learning rate of step ``k`` is
``lr * gamma ** ((k // steps_per_epoch) // step_size)``, as the JAX
package's ``step_lr``, so the drop lands on the same step.
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


def make_optimizer(model, lr, weight_decay, steps_per_epoch, lr_step_size=3,
                   lr_gamma=0.1):
    """``(Adam, LambdaLR)``; call ``scheduler.step()`` after every
    ``optimizer.step()``."""
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        (decay if decays(name) else no_decay).append(p)
    opt = torch.optim.Adam(
        [{"params": decay, "weight_decay": weight_decay},
         {"params": no_decay, "weight_decay": 0.0}],
        lr=lr, betas=(0.9, 0.999), eps=1e-8)
    spe = max(int(steps_per_epoch), 1)

    def factor(count):
        return lr_gamma ** ((count // spe) // lr_step_size)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)
