"""The streamed eval and serving paths on the card: ``stable_topk`` keeps
``lax.top_k``'s tie order where ``torch.topk`` on CUDA does not promise
it; the streamed rankers give the CPU's ranks and ids (exact ties built
from duplicated table rows, a catalog that pads); the eval graph and the
serving step's graph replay the slab loops and give the eager CPU's
ranks and ids.  No kernel of the port is involved (the slab products are
``torch.matmul``), but the graphs and the card's own ``topk``, ``sort``
and products are; without a card every test here skips.  No JAX is
imported:

    python -m pytest --noconftest tests/test_torch_streamed_gpu.py -m gpu

Ranks and ids equal exactly; streamed top-k values to 1e-5 of each
row's largest (float32 products and exponentials in another order).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from sessionrec_tpu_torch import serving
from sessionrec_tpu_torch.data.loader import BatchLoader
from sessionrec_tpu_torch.models import MSGIFSR, NISER
from sessionrec_tpu_torch.ops import scoring
from sessionrec_tpu_torch.ops import streamed_eval as se
from sessionrec_tpu_torch.train.runner import eval_ranks, set_precision

pytestmark = pytest.mark.gpu

P, ITEMS, TILE, D, B = 300, 295, 128, 16, 8
DUPS = ((3, 150), (3, 290), (200, 120), (7, 64))
LABELS = [3, 150, 290, 200, 120, 7, 64, 11]
TIE = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_precision()
    return torch.device("cuda")


def _inputs(seed, orders):
    """Table with DUPS, labels, unit sr [B, orders, D] near the labels'
    rows, iids [B, 5] -1 padded, phi, alpha; as CPU tensors."""
    rng = np.random.default_rng(seed)
    tab = (rng.standard_normal((P, D)) * 0.3).astype(np.float32)
    for src, dst in DUPS:
        tab[dst] = tab[src]
    labels = np.array(LABELS, np.int32)
    sr = 2 * tab[labels][:, None, :] + 0.1 * rng.standard_normal(
        (B, orders, D))
    sr = (sr / np.linalg.norm(sr, axis=-1, keepdims=True)).astype(np.float32)
    iids = rng.integers(0, ITEMS, size=(B, 5)).astype(np.int32)
    iids[:, 3:] = -1
    iids[0, 0] = 3
    phi = rng.random((B, orders, 2)).astype(np.float32)
    alpha = rng.standard_normal(orders).astype(np.float32)
    return [torch.tensor(x) for x in (tab, labels, sr, iids, phi, alpha)]


def test_stable_topk_keeps_the_lowest_index_on_ties(cuda):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.integers(-3, 4, size=(64, 5000)).astype(np.float32))
    for k in (1, 20, 64):
        want = scoring.stable_topk(x, k)
        got = scoring.stable_topk(x.to(cuda), k)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("norm", [False, True])
def test_streamed_rankers_match_the_cpu(cuda, norm):
    tab, labels, sr, iids, phi, alpha = _inputs(1, 3)
    kw = dict(num_items=ITEMS, k=20, normalize_table=norm, tile=TILE)
    for fn in (se.streamed_count_ranks, se.streamed_topk_ranks):
        want = fn(sr[:, 0], tab, labels, **kw)
        got = fn(sr[:, 0].to(cuda), tab.to(cuda), labels.to(cuda), **kw)
        assert torch.equal(got.cpu(), want) and int((want > 0).sum()) >= 7
    mkw = dict(kw, extra=True, fusion=True, scale=12.0)
    args = (sr, tab, labels, iids, phi, alpha)
    dev_args = [t.to(cuda) for t in args]
    for fn in (se.streamed_multi_count_ranks, se.streamed_multi_topk_ranks):
        assert torch.equal(fn(*dev_args, **mkw).cpu(), fn(*args, **mkw))
    top_args = (sr, tab, iids, phi, alpha)
    wv, wi = se.streamed_multi_topk(*top_args, **mkw)
    gv, gi = se.streamed_multi_topk(*[t.to(cuda) for t in top_args], **mkw)
    assert torch.equal(gi.cpu(), wi)
    err = (gv.cpu() - wv).abs().amax(1) / wv.abs().amax(1)
    assert float(err.max()) <= TIE


def _sessions(seed, n, items):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, items,
                                       size=int(rng.integers(2, 9)))))
            for _ in range(n)]


def test_eval_graph_replays_the_streamed_rankers(cuda):
    """``chip_smoke.graph_ranks``: one captured eval batch replayed over
    three batches gives the eager CPU's streamed ranks (NISER, 5,000
    items: three slabs), equal to the materialised ones."""
    model = NISER(5000, 16, 1)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.eval()
    batches = list(BatchLoader(_sessions(2, 40, 5000), "session", 32, 9,
                               prefetch=0, split_len=(4, 8)))[:3]
    want = [eval_ranks(model, b.to("cpu"), 20, streamed=True)
            for b in batches]
    assert all(torch.equal(w, eval_ranks(model, b.to("cpu"), 20,
                                         streamed=False))
               for w, b in zip(want, batches))
    model.to(cuda)
    got, _, ms = cs.graph_ranks(torch, model, batches, streamed=True)
    assert len(ms) == 3
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_streamed_recommend_step_replays_its_graph(cuda):
    """The paper head's ``RecommendStep`` streamed at tile 2,048 on the
    card (graph after the first batch) against ``recommend_topk`` on the
    CPU: ids equal where the CPU's values lie more than 1e-5 of the row's
    largest apart, values to 1e-5 of it."""
    model = MSGIFSR(5000, 16, 1, order=3, extra=True, fusion=True)
    model.reset_parameters(torch.Generator().manual_seed(1))
    model.eval()
    sess = _sessions(3, 12, 5000)
    batches = list(serving.session_batches(sess, "ccs", 4, 9, 3))
    want = [serving.recommend_topk(model, b.to("cpu"), 11, streamed=True)
            for b, _ in batches]
    model.to(cuda)
    step = serving.make_recommend_step(model, 10, streamed=True)
    got = [step(b) for b, _ in batches]
    assert step.graph is not None and step.graph.replays == 2
    for (gv, gi), (wv, wi) in zip(got, want):
        scale = wv.abs().amax(1, keepdim=True)
        clear = torch.tensor(cs.clear_positions(np, (wv / scale).numpy(),
                                                TIE))
        assert torch.equal(gi.cpu()[clear], wi[:, :10][clear])
        assert float(((gv.cpu() - wv[:, :10]).abs() / scale).max()) <= TIE
