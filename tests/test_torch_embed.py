"""The embedding gather of a step and its backward (ops/embed.py) on the
CPU: the plain backward, which the card's kernel (csrc/embed_bwd.cu)
equals to the bit, against a float64 sum at a padding run of 16,384
slots, ids with no slots, runs of 1-24 and runs across tile edges; the
single gather node against one gather a tier and level; and the models'
one gather a step.  The kernel itself runs only on the card
(tests/test_torch_embed_gpu.py).

Tolerances: a float32 sum of ``n`` terms in any order is off by at most
``(n - 1) * eps * sum |term|``; the plain backward's order is at most
``TILE + runs / ways + ways`` terms deep, held here to ``DEPTH * eps *
sum |term|`` a row; a bfloat16 result adds its one rounding, 2^-8
relative.
"""

import numpy as np
import pytest
import torch

from sessionrec_tpu_torch.data.loader import BatchLoader
from sessionrec_tpu_torch.graph.batch import flatten_blocks
from sessionrec_tpu_torch.models import LESSR, MSGIFSR, SRGNN
from sessionrec_tpu_torch.ops import embed
from sessionrec_tpu_torch.utils import profiling

EPS32 = float(torch.finfo(torch.float32).eps)
DEPTH = 200        # terms deep, at most, for 16,384 slots at width 256
PAPER = dict(order=3, extra=True, fusion=True)


def _ids(P, seed, pad=16384):
    """A padding run of ``pad`` slots on row 0, a run of every length 1-24
    and of 31, 32, 33, 64, 65 and 100, scattered ids, rows with none, all
    shuffled."""
    rng = np.random.default_rng(seed)
    parts = [np.zeros(pad, np.int64), rng.integers(1, P // 2, 600)]
    parts += [np.full(n, P // 2 + n) for n in range(1, 25)]
    parts += [np.full(n, P // 2 + 100 + n) for n in (31, 32, 33, 64, 65, 100)]
    ids = np.concatenate(parts)
    return torch.from_numpy(rng.permutation(ids)).to(torch.int32)


def _float64_sum(grads, ids, P):
    D = grads[0].shape[-1]
    g = torch.cat([x.reshape(-1, D) for x in grads]).to(torch.float64)
    out = torch.zeros(P, D, dtype=torch.float64)
    absum = torch.zeros(P, D, dtype=torch.float64)
    ix = (ids.reshape(-1).to(torch.int64),)
    out.index_put_(ix, g, accumulate=True)
    absum.index_put_(ix, g.abs(), accumulate=True)
    return out, absum


def assert_sums_close(got, grads, ids, P):
    """``got`` within summation (and, in bfloat16, rounding) error of the
    float64 sum, row by row."""
    want, absum = _float64_sum(grads, ids, P)
    bound = DEPTH * EPS32 * absum
    if got.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * want.abs()
    err = (got.to(torch.float64) - want).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 512])
def test_plain_backward_matches_the_float64_sum(D, dtype):
    P = 1200
    ids = _ids(P, seed=D)
    g = torch.randn(ids.numel(), D, generator=torch.Generator()
                    .manual_seed(1)).to(dtype)
    got = embed._bwd_plain([g], ids, P)
    assert got.dtype == dtype and got.shape == (P, D)
    assert_sums_close(got, [g], ids, P)
    hit = torch.zeros(P, dtype=torch.bool)
    hit[ids.long()] = True
    assert bool((got[~hit] == 0).all()) and int((~hit).sum()) > 400


@pytest.mark.parametrize("D", [4, 32, 258, 1000])
def test_plain_backward_at_other_widths(D):
    """A narrow row (many ways, 32 at most), one no multiple of 4 and a
    wide one (few ways)."""
    P = 600
    ids = _ids(P, seed=D, pad=2000)
    g = torch.randn(ids.numel(), D, generator=torch.Generator()
                    .manual_seed(2))
    assert_sums_close(embed._bwd_plain([g], ids, P), [g], ids, P)


def test_ways_follow_the_width():
    assert [embed.ways(D) for D in (4, 32, 64, 256, 258, 512, 1000, 2048)] \
        == [32, 32, 32, 16, 15, 8, 4, 2]


def test_pieces_and_their_cuts_give_the_same_bits():
    """The gradient rows cut into several tensors (the gathers of a step)
    give the bits of one tensor."""
    P, D = 500, 64
    ids = _ids(P, seed=3, pad=3000)
    g = torch.randn(ids.numel(), D, generator=torch.Generator()
                    .manual_seed(3))
    whole = embed._bwd_plain([g], ids, P)
    cut = [g[:1000].reshape(10, 100, D), g[1000:1001], g[1001:]]
    assert torch.equal(embed._bwd_plain(cut, ids, P), whole)


def test_ids_outside_the_table_land_nowhere():
    P, D = 50, 8
    ids = torch.tensor([3, -1, 3, 50, 7], dtype=torch.int32)
    g = torch.arange(40, dtype=torch.float32).reshape(5, D)
    got = embed._bwd_plain([g], ids, P)
    want = torch.zeros(P, D)
    want[3] = g[0] + g[2]
    want[7] = g[4]
    assert torch.equal(got, want)


def _table(P, D, seed=0):
    t = torch.randn(P, D, generator=torch.Generator().manual_seed(seed))
    return t.requires_grad_(True)


def _id_pieces(P):
    gen = torch.Generator().manual_seed(4)
    shapes = [(16, 5, 1), (16, 3, 2), (8, 9, 3), (30,)]
    return [torch.randint(0, P, s, generator=gen, dtype=torch.int32)
            for s in shapes]


def test_single_gather_splits_like_one_gather_a_piece():
    """The node's rows are each piece's ``table[ids]``, and its table
    gradient (the plain backward) is the per-piece gathers' within
    summation error."""
    P, D = 40, 16
    ids = _id_pieces(P)
    ids[0][:, :, 0] = 0                          # a padding run
    table = _table(P, D)
    rows = embed._Gather.apply(table, *ids)
    ref = [table[i.long()] for i in ids]
    assert len(rows) == len(ids)
    for a, b in zip(rows, ref):
        assert torch.equal(a, b)
    w = [torch.randn(r.shape, generator=torch.Generator().manual_seed(k))
         for k, r in enumerate(ref)]
    (g_one,) = torch.autograd.grad(sum((r * x).sum() for r, x in
                                       zip(rows, w)), table)
    (g_ref,) = torch.autograd.grad(sum((r * x).sum() for r, x in
                                       zip(ref, w)), table)
    flat = torch.cat([i.reshape(-1) for i in ids])
    assert_sums_close(g_one, w, flat, P)
    torch.testing.assert_close(g_one, g_ref, rtol=1e-6, atol=1e-6)


def test_cpu_tensors_keep_the_plain_gather():
    """On the CPU ``gather`` is ``table[ids]`` a piece (torch's index
    backward), counting no launch; without gradients likewise."""
    P, D = 40, 16
    ids = _id_pieces(P)
    table = _table(P, D)
    with profiling.tracing():
        rows = embed.gather(table, ids)
        rows[0].sum().backward()
        with torch.no_grad():
            plain = embed.gather(table, ids)
        counts = profiling.snapshot()["counts"]
    assert {type(r.grad_fn).__name__ for r in rows} == {"IndexBackward0"}
    assert all(r.grad_fn is None for r in plain)
    assert "embed.bwd" not in counts


def _sessions(seed, n=60, items=200):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, items, size=int(rng.integers(2,
                                                                     15)))))
            for _ in range(n)]


def _fused(monkeypatch, calls):
    """``embed.gather`` as the card runs it (one node), here with the
    plain backward; ``calls`` records each call's id tensors."""
    def one_node(table, ids):
        calls.append(len(ids))
        return list(embed._Gather.apply(table, *ids))
    monkeypatch.setattr(embed, "gather", one_node)


def _grads(model, batch, head):
    model.zero_grad(set_to_none=True)
    out = getattr(model, head)(batch, training=True, seeds=None)
    sr = out[0]
    w = torch.randn(sr.shape, generator=torch.Generator().manual_seed(9))
    (sr * w).sum().backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _compare(model, batch, head, monkeypatch, tiers):
    ref = _grads(model, batch, head)
    calls = []
    _fused(monkeypatch, calls)
    got = _grads(model, batch, head)
    assert calls == [tiers]                 # one gather a step, all tiers
    assert set(got) == set(ref)
    for n in ref:
        torch.testing.assert_close(got[n], ref[n], rtol=1e-5, atol=1e-6,
                                   msg=n)


@pytest.mark.parametrize("head", [dict(order=1), PAPER])
def test_msgifsr_gathers_every_tier_and_level_at_once(head, monkeypatch):
    """An MSGIFSR step over a three-tier SplitBatch: one gather of every
    tier's and level's ids, in the order the tiers and levels take them,
    and the gradients of one gather a tier and level."""
    model = MSGIFSR(200, 16, 1, **head)
    model.reset_parameters(torch.Generator().manual_seed(0))
    batch = next(iter(BatchLoader(_sessions(1), "ccs", 32, 14,
                                  order=model.order, prefetch=0,
                                  split_len=(4, 8)))).to("cpu")
    blocks = flatten_blocks(batch)
    assert len(blocks) == 3
    rows = model._gather_levels(batch)
    want = [lv.iid for b in blocks for lv in b.levels]
    assert len(rows) == 3 * model.order
    for r, i in zip(rows, want):
        assert torch.equal(r, model.embedding[i.long()])
    head_fn = "head_multi" if model.extra else "head"
    _compare(model, batch, head_fn, monkeypatch, 3 * model.order)


@pytest.mark.parametrize("name", ["srgnn", "lessr"])
def test_other_models_gather_every_tier_at_once(name, monkeypatch):
    if name == "srgnn":
        model, kind = SRGNN(200, 16, 1, feat_drop=0.0), "session"
    else:
        model, kind = LESSR(200, 16, 3), "lessr"
    model.reset_parameters(torch.Generator().manual_seed(0))
    batch = next(iter(BatchLoader(_sessions(2), kind, 32, 14, prefetch=0,
                                  split_len=(4, 8)))).to("cpu")
    _compare(model, batch, "head", monkeypatch, 3)
