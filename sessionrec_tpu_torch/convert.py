"""Carry parameters and model state from the JAX package into the port.

``params_from_jax`` maps a JAX parameter tree (nested dicts and lists of
numpy arrays, e.g. ``jax.device_get(params)``) of any of the four models
one to one onto the port model's parameter names: dict keys and list
indices join with dots, and a JAX linear's ``w`` and ``b`` become
``weight`` and ``bias``.  JAX linears store ``w`` as ``[out, in]``,
torch's layout, so every array copies unchanged; the table keeps its
padded ``[pad_catalog(num_items), d]`` shape.  ``state_from_jax`` maps
LESSR's BatchNorm state tree (``{"layers": [{"bn": {mean, var}}],
"readout": {"bn": ...}, "bn": ...}``) onto the port's buffers the same
way.  ``model.load_state_dict({**params_from_jax(p),
**state_from_jax(s)})`` then loads a JAX model.
"""

from __future__ import annotations

import numpy as np
import torch

_LEAF_NAMES = {"w": "weight", "b": "bias"}


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _walk(tree, prefix, out):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        out[prefix] = _t(tree)
        return out
    for key, sub in items:
        if not isinstance(sub, (dict, list, tuple)):
            key = _LEAF_NAMES.get(key, key)
        _walk(sub, f"{prefix}.{key}" if prefix else str(key), out)
    return out


def params_from_jax(tree) -> dict:
    """JAX params -> ``{name: tensor}`` of the port model's parameters."""
    return _walk(tree, "", {})


def state_from_jax(state) -> dict:
    """JAX model state (LESSR's running BatchNorm statistics; ``{}`` for
    the other models) -> ``{name: tensor}`` of the port model's
    buffers."""
    return _walk(state, "", {})
