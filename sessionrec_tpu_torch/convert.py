"""Carry MSGIFSR parameters from the JAX package into the port.

``params_from_jax`` maps the JAX parameter tree (nested dicts and lists of
numpy arrays, e.g. ``jax.device_get(params)``) one to one onto the
``state_dict`` of ``sessionrec_tpu_torch.models.MSGIFSR``.  JAX linears
store ``{"w": [out, in], "b": [out]}`` in torch's layout, so weights copy
unchanged; the table keeps its padded ``[pad_catalog(num_items), d]``
shape.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _linear(out, prefix, p):
    out[f"{prefix}.weight"] = _t(p["w"])
    if "b" in p:
        out[f"{prefix}.bias"] = _t(p["b"])


def params_from_jax(tree) -> dict:
    """JAX MSGIFSR params -> ``state_dict`` of the port's MSGIFSR."""
    out = {"embedding": _t(tree["embedding"]), "alpha": _t(tree["alpha"]),
           "beta": _t(tree["beta"])}
    for i, gru in enumerate(tree["expander"]["grus"]):
        for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
            out[f"expander.grus.{i}.{name}"] = _t(gru[name])
    for i, p in enumerate(tree["expander"]["Ws"]):
        _linear(out, f"expander.Ws.{i}", p)
    for i, layer in enumerate(tree["layers"]):
        for conv in ("conv1", "conv2"):
            for rel, gat in layer[conv].items():
                for name in ("fc", "attn_l", "attn_r", "bias"):
                    out[f"layers.{i}.{conv}.{rel}.{name}"] = _t(gat[name])
    for part in ("fc_u", "fc_v", "fc_e"):
        for k, p in enumerate(tree["readout"][part]):
            _linear(out, f"readout.{part}.{k}", p)
    for k, p in enumerate(tree["fc_sr"]):
        _linear(out, f"fc_sr.{k}", p)
    for k, p in enumerate(tree["sc_sr"]):
        _linear(out, f"sc_sr.{k}.l1", p["l1"])
        _linear(out, f"sc_sr.{k}.l2", p["l2"])
    return out
