"""Parameter initialisation: the reference's two regimes.

Counterpart of ``sessionrec_tpu/models/init.py``:

* SRGNN, NISER and MSGIFSR call ``reset_parameters``, which overwrites
  every parameter with U(-1/sqrt(d), 1/sqrt(d)) (srgnn.py:126-129,
  niser.py:125-128, msgifsr.py:224-227); MSGIFSR then resets ``alpha`` to
  one-hot and ``beta`` to 1 (msgifsr.py:213-216).
* LESSR has no reset: each submodule keeps torch's default (Linear
  U(-1/sqrt(fan_in), ..) for weight and bias, GRU U(-1/sqrt(H), ..) on
  every weight, Embedding N(0, 1), PReLU 0.25, BatchNorm weight 1 and
  bias 0 with running mean 0 and variance 1).

Draws come from an explicit ``torch.Generator``, on the CPU, never from
the global RNG, so they differ from the JAX package's ``jax.random``
draws; the tests carry JAX parameters across with
``sessionrec_tpu_torch.convert``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from sessionrec_tpu_torch.models import layers as L


@torch.no_grad()
def uniform_(t, bound: float, gen: torch.Generator):
    """Fill ``t`` with U(-bound, bound) drawn on the CPU from ``gen``."""
    draw = torch.empty(t.shape, dtype=torch.float32)
    draw.uniform_(-bound, bound, generator=gen)
    t.copy_(draw)


@torch.no_grad()
def reset_uniform(model, gen: torch.Generator):
    """U(-1/sqrt(d), 1/sqrt(d)) for every parameter in registration
    order (the SRGNN/NISER regime)."""
    bound = 1.0 / math.sqrt(model.embedding_dim)
    for _, p in model.named_parameters():
        uniform_(p, bound, gen)


@torch.no_grad()
def reset_msgifsr(model, gen: torch.Generator):
    """``reset_uniform``, then ``alpha`` one-hot and ``beta`` = 1."""
    reset_uniform(model, gen)
    model.alpha.zero_()
    model.alpha[0] = 1.0
    model.beta.fill_(1.0)


@torch.no_grad()
def reset_torch_defaults(model, gen: torch.Generator):
    """torch's per-module defaults, module by module in registration order
    (the LESSR regime): the table N(0, 1) over its padded rows."""
    draw = torch.empty(model.embedding.shape, dtype=torch.float32)
    model.embedding.copy_(draw.normal_(generator=gen))
    for m in model.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.weight.shape[1])
            uniform_(m.weight, bound, gen)
            if m.bias is not None:
                uniform_(m.bias, bound, gen)
        elif isinstance(m, L.GRU):
            bound = 1.0 / math.sqrt(m.w_hh.shape[1])
            for p in (m.w_ih, m.w_hh, m.b_ih, m.b_hh):
                uniform_(p, bound, gen)
        elif isinstance(m, L.PReLU):
            m.a.fill_(0.25)
        elif isinstance(m, L.BatchNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
            m.mean.zero_()
            m.var.fill_(1.0)
