"""Parameter initialisation for MSGIFSR (the reset_parameters regime).

Counterpart of the MSGIFSR part of ``sessionrec_tpu/models/init.py``: the
reference overwrites every parameter with U(-1/sqrt(d), 1/sqrt(d))
(msgifsr.py:224-227), then resets ``alpha`` to one-hot and ``beta`` to 1
(msgifsr.py:213-216).  Draws come from an explicit ``torch.Generator``,
so they differ from the JAX package's ``jax.random`` draws; the tests
carry JAX parameters across with ``sessionrec_tpu_torch.convert``.
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def uniform_(t, bound: float, gen: torch.Generator):
    """Fill ``t`` with U(-bound, bound) drawn on the CPU from ``gen``."""
    draw = torch.empty(t.shape, dtype=torch.float32)
    draw.uniform_(-bound, bound, generator=gen)
    t.copy_(draw)


@torch.no_grad()
def reset_msgifsr(model, gen: torch.Generator):
    """U(-1/sqrt(d), 1/sqrt(d)) for every parameter in registration order,
    then ``alpha`` one-hot and ``beta`` = 1."""
    bound = 1.0 / math.sqrt(model.embedding_dim)
    for _, p in model.named_parameters():
        uniform_(p, bound, gen)
    model.alpha.zero_()
    model.alpha[0] = 1.0
    model.beta.fill_(1.0)
