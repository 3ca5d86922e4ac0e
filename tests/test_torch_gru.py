"""The port's GRU (ops/gru.py) and SemanticExpander (models/layers.py)
against the JAX package's, from the same numpy weights and inputs: one
cell step, runs of T = 2, 3 (unrolled in the JAX package) and 6 (its
``lax.scan``), and the expander at levels 2 and 3 with each reducer.
Tolerance atol 1e-5: the same float32 products, summed in another
order."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionrec_tpu.models import layers as jl
from sessionrec_tpu.ops import gru as jg
from sessionrec_tpu_torch.models import layers as tl
from sessionrec_tpu_torch.ops import gru as tg

ATOL = 1e-5
H = 16


def _weights(rng, in_dim=H, hidden=H):
    b = 1.0 / np.sqrt(hidden)
    return {"w_ih": rng.uniform(-b, b, (3 * hidden, in_dim)),
            "w_hh": rng.uniform(-b, b, (3 * hidden, hidden)),
            "b_ih": rng.uniform(-b, b, 3 * hidden),
            "b_hh": rng.uniform(-b, b, 3 * hidden)}


def _pair(w):
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in w.items()}
    tp = types.SimpleNamespace(**{k: torch.tensor(v, dtype=torch.float32)
                                  for k, v in w.items()})
    return jp, tp


def test_gru_cell_matches_jax():
    rng = np.random.default_rng(0)
    jp, tp = _pair(_weights(rng, in_dim=12))
    x = rng.normal(size=(5, 7, 12)).astype(np.float32)
    h = rng.normal(size=(5, 7, H)).astype(np.float32)
    want = np.asarray(jg.gru_cell(jp, jnp.asarray(x), jnp.asarray(h)))
    got = tg.gru_cell(tp, torch.from_numpy(x), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("T", [2, 3, 6])
def test_gru_scan_matches_jax(T):
    rng = np.random.default_rng(T)
    jp, tp = _pair(_weights(rng))
    xs = rng.normal(size=(4, 9, T, H)).astype(np.float32)
    want = np.asarray(jg.gru_scan(jp, jnp.asarray(xs)))
    got = tg.gru_scan(tp, torch.from_numpy(xs))
    assert got.shape == (4, 9, H)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_gru_scan_equals_torch_gru():
    """The layout is torch's own: nn.GRU with the same weights agrees."""
    rng = np.random.default_rng(3)
    w = _weights(rng)
    _, tp = _pair(w)
    ref = torch.nn.GRU(H, H, batch_first=True)
    with torch.no_grad():
        for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
            getattr(ref, name.replace("w_", "weight_").replace(
                "b_", "bias_") + "_l0").copy_(getattr(tp, name))
    xs = torch.from_numpy(rng.normal(size=(6, 5, H)).astype(np.float32))
    with torch.no_grad():
        want = ref(xs)[1][0]
    np.testing.assert_allclose(tg.gru_scan(tp, xs).numpy(), want.numpy(),
                               atol=ATOL)


@pytest.mark.parametrize("reducer", ["mean", "max", "concat"])
@pytest.mark.parametrize("level", [1, 2, 3])
def test_semantic_expander_matches_jax(reducer, level):
    rng = np.random.default_rng(10 + level)
    order = 3
    te = tl.SemanticExpander(H, reducer, order)
    jp = {"grus": [], "Ws": []}
    for i in range(order - 1):
        w = _weights(rng)
        jp["grus"].append({k: jnp.asarray(v, jnp.float32)
                           for k, v in w.items()})
        for k, v in w.items():
            getattr(te.grus[i], k).data = torch.tensor(v, dtype=torch.float32)
    if reducer == "concat":
        for i in range(1, order):
            wt = rng.uniform(-0.2, 0.2, (H, H * (i + 1))).astype(np.float32)
            bt = rng.uniform(-0.2, 0.2, H).astype(np.float32)
            jp["Ws"].append({"w": jnp.asarray(wt), "b": jnp.asarray(bt)})
            te.Ws[i - 1].weight.data = torch.from_numpy(wt)
            te.Ws[i - 1].bias.data = torch.from_numpy(bt)
    assert len(te.Ws) == (order - 1 if reducer == "concat" else 0)
    feat = rng.normal(size=(3, 5, level, H)).astype(np.float32)
    want = np.asarray(jl.semantic_expander_apply(jp, jnp.asarray(feat), level,
                                                 reducer))
    with torch.no_grad():
        got = tl.semantic_expander_apply(te, torch.from_numpy(feat), level,
                                         reducer)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
