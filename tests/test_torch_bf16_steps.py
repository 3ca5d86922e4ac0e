"""Three optimizer steps with a bf16 table, and eval ranks in full bf16,
against the JAX package's (the tolerances of tests/test_torch_bf16.py,
whose helpers this file uses; a file of its own so that each file's JAX
compiles stay under a minute on one worker)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionrec_tpu.train.optim import make_optimizer as j_make_optimizer
from sessionrec_tpu.train.runner import _apply_updates_project, _eval_ranks
from sessionrec_tpu_torch.convert import params_from_jax
from sessionrec_tpu_torch.train.runner import TrainRunner, eval_ranks
from test_torch_bf16 import (BF, BF16_TIE, BF16_ULP, NUM_ITEMS, _batch,
                             _jax_loss, make_model, one_thread)  # noqa: F401


@pytest.mark.parametrize("case", ["o1", "paper"])
def test_three_steps_with_a_bf16_table_match_jax(case):
    """Three optimizer steps (lr 1e-3, the StepLR drop every step), the
    table bf16 and compute float32.  The JAX step is ``make_train_step``'s
    (loss, Adam, ``_apply_updates_project``) with the fused loss through
    the interpret-mode Pallas kernels, which the port's rule follows
    (ops/xent.py): the JAX package's plain reference on the CPU rounds
    the normalised bf16 table to bf16 before its product, its kernels do
    not."""
    jm, jp, js, tm = make_model(case, seed=5, table_dtype="bfloat16")
    jbs, tbs = _batch(case, split_len=None, n=120, batch=32)
    start = {**params_from_jax(jax.device_get(jp))}
    sched = dict(steps_per_epoch=1, lr_step_size=1, lr_gamma=0.5)
    tx_ = j_make_optimizer(jp, 1e-3, 1e-4, **sched)
    opt_state = tx_.init(jp)

    @jax.jit
    def step(p, opt_state, b, key):
        (loss, _), g = jax.value_and_grad(
            lambda q: _jax_loss(jm, q, js, b, use_pallas=True),
            has_aux=True)(p)
        updates, opt_state = tx_.update(g, opt_state, p)
        return _apply_updates_project(jm, p, updates, key), opt_state, loss

    jlosses = []
    for i, b in enumerate(jbs[:3]):
        jp, opt_state, loss = step(jp, opt_state, b, jax.random.PRNGKey(i))
        jlosses.append(float(loss))
    runner = TrainRunner(tm, tbs[:1], [], lr=1e-3, weight_decay=1e-4,
                         device="cpu", lr_step_size=1, lr_gamma=0.5)
    tm.load_state_dict(start)
    tlosses = [float(runner.train_step(b)) for b in tbs[:3]]
    # the first step starts from the same table; after it the tables
    # differ by the rounding streams (a bf16 ulp on some elements)
    np.testing.assert_allclose(tlosses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(tlosses[1:], jlosses[1:], rtol=2e-3)
    want = params_from_jax(jax.device_get(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32), jp)))
    assert tm.embedding.dtype == torch.bfloat16
    assert runner.table_opt.state["exp_avg"].dtype == torch.float32
    assert float(runner.table_opt.state["step"]) == 3.0
    for name, p in tm.named_parameters():
        got, w = p.detach().float().numpy(), want[name].numpy()
        gap = np.abs(got - w)
        if name == "embedding":
            gap -= 2 * BF16_ULP * np.abs(w)
        # Adam's early steps move an element by about +-lr whatever its
        # gradient's size, so a near-zero gradient whose sign the rounding
        # stream flips moves it the other way: at most twice the rates'
        # sum, on few elements
        assert float(gap.max()) <= 2 * 1e-3 * (1 + 0.5 + 0.25), name
        assert float((gap > 1e-4).mean()) <= 0.01, name


def _clear_rows(scores, labels, tie):
    """Rows whose label score lies more than ``tie`` times the row's
    largest live magnitude from every other live item's score."""
    lv = np.take_along_axis(scores, labels[:, None].astype(np.int64), 1)
    scale = np.abs(scores[:, :NUM_ITEMS]).max(axis=1)
    gap = np.abs(scores - lv)
    gap[np.arange(len(labels)), labels] = np.inf
    gap[:, NUM_ITEMS:] = np.inf
    return gap.min(axis=1) > tie * scale


def _jax_scores(jm, jp, js, jb):
    """The scores the JAX eval ranks (runner.py:407-430 of the JAX
    package)."""
    from sessionrec_tpu.models.layers import l2norm
    from sessionrec_tpu.ops import scoring as jscoring
    if not jm.has_plain_head:
        return jm.apply(jp, js, jb, training=False, rng=None)[0]
    sr, table, _ = jm.head(jp, js, jb, training=False, rng=None)
    if jm.table_norm:
        table = l2norm(table)
    return jscoring.catalog_logits(sr, table, compute_dtype=jm.cdt)


@pytest.mark.parametrize("case", ["o1", "paper", "lessr"])
def test_eval_ranks_in_bf16_match_jax(case):
    """Ranks equal on every row whose JAX label score lies more than
    ``BF16_TIE`` of the row's largest score from every other's."""
    jm, jp, js, tm = make_model(case, seed=3, **BF)
    jbs, tbs = _batch(case, split_len=None, n=60)
    tm.eval()
    ranks = jax.jit(lambda p, st, b: _eval_ranks(jm, p, st, b, 20))
    score = jax.jit(lambda p, st, b: _jax_scores(jm, p, st, b))
    rows = clear_rows = 0
    for jb, tb in zip(jbs, tbs):
        want = np.asarray(ranks(jp, js, jb))
        scores = np.asarray(score(jp, js, jb), np.float32)
        got = eval_ranks(tm, tb, 20).numpy()
        clear = _clear_rows(scores, np.asarray(jb.labels), BF16_TIE)
        np.testing.assert_array_equal(got[clear], want[clear])
        rows += len(clear)
        clear_rows += int(clear.sum())
    assert clear_rows >= 30
