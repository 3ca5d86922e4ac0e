"""Streamed serving in the port (``serving.py:recommend_topk`` through
``ops/streamed_eval.py:streamed_multi_topk``) against the JAX package's
``recommend(streamed=True)`` (tests/test_serving.py:133) and against the
port's materialised path, on the CPU.

The multi head on a 5,000-item catalog: 5,120 rows, three slabs at the
serving tile of 2,048.  ``recommend(streamed=True)`` returns the ids of
``streamed=False`` at every position whose materialised log-probability
lies more than 1e-5 from its neighbours' (closer ones may swap under
float32 rounding; the reference list is one longer so the last position
has a right neighbour), and its raw blended probabilities are the exps of
those log-probabilities to 1e-5 relative; against JAX's streamed lists
the ids are equal at every position whose JAX value lies more than 1e-5
of the row's largest from its neighbours', and the values to 1e-5 of it
(the session vectors come from the two packages' model forwards, which
agree to about 1e-7 and then pass through the scale of 12 and an exp;
tests/test_torch_serving.py holds the log-probabilities to the same
1e-5).
The plain head always materialises, so ``streamed=True`` changes nothing
there.
"""

import numpy as np
import pytest
import torch

from sessionrec_tpu import serving as jserving
from sessionrec_tpu_torch import serving
from test_torch_model import PAPER, make_pair

ITEMS = 5000
MAX_LEN = 8
K = 10
TIE = 1e-5
HEADS = {"paper": PAPER, "o2_fusion": dict(order=2, fusion=True)}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sessions(seed, n=13):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, ITEMS,
                                       size=int(rng.integers(1, 9)))))
            for _ in range(n)]


def _clear(scores, tie):
    """[n, K] mask of positions more than ``tie`` from both neighbours in
    descending [n, K + 1] score lists."""
    gap = np.abs(np.diff(scores, axis=1))
    left = np.concatenate([np.full((len(scores), 1), np.inf), gap[:, :-1]],
                          axis=1)
    return (gap > tie) & (left > tie)


def _lists(recs):
    recs = list(recs)
    return (np.array([ids for _, ids, _ in recs]),
            np.array([v for _, _, v in recs], np.float64))


@pytest.mark.parametrize("head", list(HEADS))
def test_streamed_recommend_matches_materialised_and_jax(head):
    kw = HEADS[head]
    order = kw["order"]
    jm, jp, tm = make_pair(seed=7, num_items=ITEMS, **kw)
    assert not tm.has_plain_head
    assert serving.serving_tile(tm.padded_items) == 2048
    sess = _sessions(8)
    common = dict(max_len=MAX_LEN, batch_size=4, order=order)
    got = list(serving.recommend(tm, sess, k=K, streamed=True, **common))
    assert [s for s, _, _ in got] == sess
    g_ids, g_val = _lists(got)
    assert (np.diff(g_val, axis=1) <= 0).all()

    m_ids, m_lp = _lists(serving.recommend(tm, sess, k=K + 1,
                                           streamed=False, **common))
    clear = _clear(m_lp, TIE)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(g_ids[clear], m_ids[:, :K][clear])
    np.testing.assert_allclose(g_val, np.exp(m_lp[:, :K]), rtol=TIE)

    j_ids, j_val = _lists(jserving.recommend(jm, jp, {}, sess, k=K + 1,
                                             streamed=True, **common))
    scale = j_val.max(axis=1, keepdims=True)
    clear = _clear(j_val / scale, TIE)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(g_ids[clear], j_ids[:, :K][clear])
    assert (np.abs(g_val - j_val[:, :K]) / scale).max() <= TIE


def test_plain_head_ignores_streamed():
    _, _, tm = make_pair(seed=8, num_items=ITEMS)
    assert tm.has_plain_head
    sess = _sessions(9)
    kw = dict(max_len=MAX_LEN, k=K, batch_size=4)
    a = list(serving.recommend(tm, sess, streamed=True, **kw))
    b = list(serving.recommend(tm, sess, streamed=False, **kw))
    assert a == b


def test_serving_tile_rule():
    assert serving.serving_tile(1 << 20) == 32768
    assert serving.serving_tile(32768) == 32768
    assert serving.serving_tile(32256) == 2048
    assert serving.serving_tile(3584) == 2048
