"""Each model's head, loss and gradients with a bf16 table and bf16
compute, against the JAX package's (the tolerances of
tests/test_torch_bf16.py, whose helpers this file uses; a file of its own
so that each file's JAX compiles stay under a minute on one worker)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionrec_tpu_torch.convert import params_from_jax
from sessionrec_tpu_torch.train.runner import make_loss
from test_torch_bf16 import (BF, DIM, HEAD, MODELS, NUM_ITEMS, _batch,
                             _jax_loss, _np, _rel_err, make_model,
                             one_thread)  # noqa: F401


def _jax_grads(jm, jp, js, jb):
    """(loss, sr, {parameter: float32 gradient}) of the JAX model."""
    (lj, srj), gj = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jm, p, js, jb), has_aux=True))(jp)
    return lj, srj, params_from_jax(jax.device_get(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32), gj)))


@pytest.mark.parametrize("case", list(MODELS))
def test_head_loss_and_grads_in_bf16_match_jax(case):
    """Session vectors and loss against JAX's bf16 run to ``HEAD``; each
    gradient's error against the float32 gradients (JAX, float32 compute
    on the same bf16 table) of the order of JAX's own bf16 error: at most
    ``3 * max(JAX's, HEAD)``.  A gradient summed from terms that nearly
    cancel keeps little of bf16's 8 bits in either package, and which one
    rounds luckier varies: the readouts' ``fc_u`` and ``fc_v`` are off by
    10% to 40% of their largest magnitude in JAX's bf16 run on the CPU,
    the paper head's ``inter`` attention by 1% in JAX's and 8% in the
    port's, with the port closer on most others."""
    jm, jp, js, tm = make_model(case, seed=3, **BF)
    jm32 = MODELS[case][0](num_items=NUM_ITEMS, embedding_dim=DIM,
                           num_layers=MODELS[case][2], **MODELS[case][3],
                           table_dtype="bfloat16")
    jb, tb = (b[0] for b in _batch(case, split_len=None))
    lj, srj, gbf = _jax_grads(jm, jp, js, jb)
    _, _, g32 = _jax_grads(jm32, jp, js, jb)
    assert srj.dtype == jnp.bfloat16
    lt = make_loss(tm, tb, None)
    lt.backward()
    if tm.has_plain_head:
        sr = tm.head(tb, training=True)[0]
    else:
        sr = tm.head_multi(tb, training=True)[0]
    assert sr.dtype == torch.bfloat16
    assert _rel_err(sr, _np(srj)) <= HEAD
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=HEAD)
    assert set(gbf) == {n for n, _ in tm.named_parameters()}
    assert tm.embedding.grad.dtype == torch.bfloat16
    for name, p in tm.named_parameters():
        want = g32[name].numpy()
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        assert got.dtype == p.dtype, name
        if not np.abs(want).max():
            assert not bool(got.any()), name
            continue
        jax_err = _rel_err(gbf[name].numpy(), want)
        assert _rel_err(got, want) <= 3 * max(jax_err, HEAD), \
            (name, jax_err)
