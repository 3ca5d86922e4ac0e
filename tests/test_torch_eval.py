"""Eval parity: the port's ``train/runner.py:eval_ranks`` and ``evaluate``
against the JAX package's ``_eval_ranks`` and ``make_eval_step``
(sessionrec_tpu/train/runner.py:356, :433), on the order-1 head and on
the order-3 paper head (REnorm + fusion), with the same converted
parameters (``make_pair``) and the same batches, flat and tiered.

Ranks must be equal on every row whose label score is more than 1e-5
from every other item's score (the JAX scores: the order-1 head's masked
logits, the paper head's log-probabilities); closer rows could swap
places under float32 rounding, so they are counted and left out.  MRR@20
and HR@20 over all batches must agree to 1e-6, for the port's per-batch
``evaluate`` against ``make_eval_step``, and for the runner's sweep
against the JAX package's unrolled eval (``make_unrolled_eval_step`` and
``evaluate``, runner.py:449-516) in chunks of 5 batches with a shorter
tail, which the JAX package pads with all-invalid batches.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionrec_tpu.data.loader import BatchLoader as JLoader
from sessionrec_tpu.models.layers import l2norm as jl2norm
from sessionrec_tpu.ops import scoring as jscoring
from sessionrec_tpu.train.runner import _eval_ranks, make_eval_step
from sessionrec_tpu.train.runner import evaluate as jevaluate
from sessionrec_tpu.train.runner import make_unrolled_eval_step
from sessionrec_tpu_torch.convert import params_from_jax
from sessionrec_tpu_torch.data.loader import BatchLoader as TLoader
from sessionrec_tpu_torch.train.runner import (TrainRunner, eval_ranks,
                                               evaluate)
from test_torch_model import NUM_ITEMS, PAPER, make_pair

CUTOFF = 20
TIE = 1e-5           # label-score margin below which a row may swap ranks
METRIC_ATOL = 1e-6

HEADS = {"o1": dict(), "paper": PAPER}


def _sessions(seed, n=70, max_len=12):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, NUM_ITEMS,
                              size=int(rng.integers(2, max_len))))
            for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _case(head, split_len):
    """(JAX model, params, port model, JAX batches, port batches)."""
    kw = HEADS[head]
    jm, jp, tm = make_pair(seed=11, **kw)
    order = kw.get("order", 1)
    sess = _sessions(5)
    jb = list(JLoader(sess, "ccs", 32, 11, use_native=False, prefetch=0,
                      split_len=split_len, order=order))
    tb = list(TLoader(sess, "ccs", 32, 11, prefetch=0, split_len=split_len,
                      device="cpu", order=order))
    tm.eval()
    tm.project_params()            # the JAX eval step projects its params
    return jm, jp, tm, jb, tb


@functools.lru_cache(maxsize=None)
def _jax_ranks_and_scores(head, split_len):
    """Per batch, the JAX package's label ranks and the scores it ranks."""
    jm, jp, _, jbs, _ = _case(head, split_len)
    ranks = jax.jit(lambda p, b: _eval_ranks(jm, p, {}, b, CUTOFF))
    scores = jax.jit(lambda p, b: _jax_scores(jm, p, b))
    return [(np.asarray(ranks(jp, jb)), np.asarray(scores(jp, jb)))
            for jb in jbs]


def _jax_scores(jm, jp, batch):
    """The scores ``_eval_ranks`` ranks on its materialised path."""
    if jm.has_plain_head:
        sr, table, _ = jm.head(jp, {}, batch, training=False, rng=None)
        if jm.table_norm:
            table = jl2norm(table)
        logits = jscoring.catalog_logits(sr, table, compute_dtype=jm.cdt)
        imask = jscoring.item_mask(jm.num_items, jm.padded_items)
        return jnp.where(imask.astype(bool), logits, -jnp.inf)
    return jm.apply(jp, {}, batch, training=False, rng=None)[0]


def _clear_rows(scores, labels):
    """Rows whose label score is more than TIE from every other live
    item's score."""
    lv = np.take_along_axis(scores, labels[:, None].astype(np.int64), 1)
    gap = np.abs(scores - lv)
    gap[np.arange(len(labels)), labels] = np.inf
    gap[:, NUM_ITEMS:] = np.inf
    return gap.min(axis=1) > TIE


CASES = [(head, split) for head in HEADS for split in (None, (4, 8))]


@pytest.mark.parametrize("head,split_len", CASES)
def test_eval_ranks_match_jax(head, split_len):
    _, _, tm, jbs, tbs = _case(head, split_len)
    assert len(jbs) == len(tbs) > 1
    rows = excluded = 0
    for jb, tb, (want, scores) in zip(
            jbs, tbs, _jax_ranks_and_scores(head, split_len)):
        got = eval_ranks(tm, tb, CUTOFF).numpy()
        labels = np.asarray(jb.labels)
        np.testing.assert_array_equal(tb.labels.numpy(), labels)
        clear = _clear_rows(scores, labels)
        np.testing.assert_array_equal(got[clear], want[clear])
        rows += len(labels)
        excluded += int((~clear).sum())
    print(f"{head} split_len={split_len}: {excluded} of {rows} rows "
          f"within {TIE} of another item's score, left out")
    assert excluded <= rows // 100


@pytest.mark.parametrize("head,split_len", CASES)
def test_eval_metrics_match_jax(head, split_len):
    jm, jp, tm, jbs, tbs = _case(head, split_len)
    step = make_eval_step(jm, CUTOFF)
    hit = mrr = n = 0.0
    for jb in jbs:
        h, m, v = step(jp, {}, jb)
        hit, mrr, n = hit + float(h), mrr + float(m), n + float(v)
    mrr_t, hit_t = evaluate(tm, tbs, CUTOFF)
    assert n > 100
    np.testing.assert_allclose(mrr_t, mrr / n, rtol=0, atol=METRIC_ATOL)
    np.testing.assert_allclose(hit_t, hit / n, rtol=0, atol=METRIC_ATOL)


UNROLL = 5


@pytest.mark.parametrize("head,split_len", CASES)
def test_runner_sweep_matches_jax_unrolled_eval(head, split_len):
    jm, jp, tm, jbs, tbs = _case(head, split_len)
    assert len(jbs) % UNROLL                 # a tail shorter than UNROLL
    want = jevaluate(make_unrolled_eval_step(jm, CUTOFF), jp, {}, jbs,
                     unroll=UNROLL)
    start = params_from_jax(jax.device_get(jp))
    runner = TrainRunner(tm, [None], tbs, cutoff=CUTOFF, unroll=UNROLL,
                         device="cpu")
    tm.load_state_dict(start)        # the runner drew its own init
    sums = runner.eval_sweep()
    assert sums.dtype == torch.float64 and float(sums[2]) > 100
    np.testing.assert_allclose(runner.evaluate(), want, rtol=0,
                               atol=METRIC_ATOL)
