"""K1-K4 past 256 features and 256 session items, on the CPU.

The plain versions of the port's kernels (ops/xent.py, ops/xent_multi.py)
against the JAX package's Pallas kernels in interpret mode, as
tests/test_torch_xent.py and tests/test_torch_xent_multi.py run them, at
D = 512 and, for K3/K4, with 300 session items a row; MSGIFSR's order-1
head and the paper head at embedding_dim 512 against the JAX heads (loss
and every gradient, atol 5e-5, as tests/test_torch_model.py); and the
host arithmetic of the kernels' wide path: the feature slabs
(csrc/tiles.cuh: slab_count, slab_width) and K2's and K4's backward plan
(ops/xent.py:slab_bwd_plan, as csrc/tiles.cuh:slab_bwd_chunks walks it).
The slab kernels themselves run on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py).

Tolerances: values rtol/atol 1e-5, gradients rtol 1e-3 / atol 2e-4, those
of the two parity files (the same float32 products, summed in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionrec_tpu.ops import xent as jx
from sessionrec_tpu.ops import xent_multi as jxm
from sessionrec_tpu_torch.ops import xent as tx
from sessionrec_tpu_torch.ops import xent_multi as txm
from test_torch_model import (NUM_ITEMS, PAPER, _batches, _grads_match,
                              make_pair)
from test_torch_xent import _case, _t
from test_torch_xent_multi import _stats_case

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=2e-4)
ATOL = 5e-5
WIDE = 512
MAX_D = 256                  # csrc/common.cuh: the one-pass kernels' width


@pytest.mark.parametrize("norm", [True, False])
def test_k1_k2_plain_match_pallas_at_d512(norm):
    """Unit rows of sr, as the model emits them: with raw normal rows of
    512 features the raw table's logits reach the thousands, and the
    softmax of either side is one-hot up to float32 rounding."""
    B, P, n = 8, 512, 450
    sr, table, labels, _ = _case(B, WIDE, P, n, seed=5, zero_row=2)
    sr /= np.linalg.norm(sr, axis=1, keepdims=True)
    labels[1] = -1
    mj, sj, zj = jx._fwd_pallas(jnp.asarray(sr), jnp.asarray(table),
                                jnp.asarray(labels), n, scale=12.0,
                                normalize_table=norm)
    mt, st, zt = tx._fwd_plain(_t(sr), _t(table), _t(labels, torch.int32),
                               n, scale=12.0, normalize_table=norm)
    for a, b in ((mt, mj), (st, sj), (zt, zj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **VAL)
    lse = np.asarray(jx._finish_lse(mj, sj))
    g = np.linspace(0.0, 1.0, B).astype(np.float32)
    dsrj, dtabj = jx._bwd_pallas(jnp.asarray(g), jnp.asarray(sr),
                                 jnp.asarray(table), jnp.asarray(labels),
                                 jnp.asarray(lse), n, scale=12.0,
                                 normalize_table=norm)
    dsrt, dtabt = tx._bwd_plain(_t(g), _t(sr), _t(table),
                                _t(labels, torch.int32), _t(lse), n,
                                scale=12.0, normalize_table=norm)
    np.testing.assert_allclose(dsrt.numpy(), np.asarray(dsrj), **GRAD)
    np.testing.assert_allclose(dtabt.numpy(), np.asarray(dtabj), **GRAD)


@pytest.mark.parametrize("D,N,norm", [(WIDE, 6, True), (WIDE, 6, False),
                                      (64, 300, True), (WIDE, 300, False)])
def test_k3_k4_plain_match_pallas_wide_and_long(D, N, norm):
    """Rows of D features and iid lists of N items (-1 padded)."""
    col_offset, n_valid = 0, 900
    sr3, table, labels, iids = _stats_case(norm, col_offset, D=D, N=N)
    kw = dict(scale=12.0, normalize_table=norm)
    want = jxm._fwd_pallas(jnp.asarray(sr3), jnp.asarray(table),
                           jnp.asarray(labels), jnp.asarray(iids), n_valid,
                           col_offset, n_sess=N, **kw)
    got = txm._fwd_plain(_t(sr3), _t(table), _t(labels, torch.int32),
                         _t(iids, torch.int32), n_valid, col_offset, **kw)
    for name, a, b in zip(("m_in", "s_in", "m_ex", "s_ex", "zl"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **VAL,
                                   err_msg=name)
    m_in, s_in, m_ex, s_ex, _ = (np.asarray(x) for x in want)
    lse_in = np.asarray(jxm._finish(m_in, s_in))
    lse_ex = np.asarray(jxm._finish(m_ex, s_ex))
    rng = np.random.default_rng(1)
    gz, gin, gex = (rng.normal(size=lse_in.shape).astype(np.float32)
                    for _ in range(3))
    dsrj, dtabj = jxm._bwd_pallas(
        jnp.asarray(gz), jnp.asarray(gin), jnp.asarray(gex),
        jnp.asarray(sr3), jnp.asarray(table), jnp.asarray(labels),
        jnp.asarray(iids), jnp.asarray(lse_in), jnp.asarray(lse_ex),
        n_valid, col_offset, n_sess=N, **kw)
    dsrt, dtabt = txm._bwd_plain(
        _t(gz), _t(gin), _t(gex), _t(sr3), _t(table),
        _t(labels, torch.int32), _t(iids, torch.int32), _t(lse_in),
        _t(lse_ex), n_valid, col_offset, **kw)
    np.testing.assert_allclose(dsrt.numpy(), np.asarray(dsrj), **GRAD)
    np.testing.assert_allclose(dtabt.numpy(), np.asarray(dtabj), **GRAD)


def test_o1_head_at_d512_matches_jax():
    jm, jp, tm = make_pair(seed=3, dim=WIDE)
    jb, tb = _batches(None)

    def jloss(p):
        sr, table, _ = jm.head(p, {}, jb, training=True, rng=None)
        return jx.fused_nll_loss(sr, table, jb.labels, jb.valid, scale=12.0,
                                 num_items=NUM_ITEMS, normalize_table=True,
                                 use_pallas=False)

    lj, gj = jax.jit(jax.value_and_grad(jloss))(jp)
    sr, table = tm.head(tb, training=True, seeds=None)
    assert sr.shape[-1] == table.shape[-1] == WIDE
    lt = tx.fused_nll_loss(sr, table, tb.labels, tb.valid, scale=12.0,
                           num_items=NUM_ITEMS, normalize_table=True)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), atol=ATOL)
    _grads_match(tm, gj)


def test_paper_head_at_d512_matches_jax():
    jm, jp, tm = make_pair(seed=6, dim=WIDE, **PAPER)
    jb, tb = _batches(None, order=3)
    kw = dict(scale=12.0, num_items=NUM_ITEMS, normalize_table=True,
              extra=True, fusion=True)

    def jloss(p):
        sr, table, phi, alpha, iids, _ = jm.head_multi(p, {}, jb,
                                                       training=True,
                                                       rng=None)
        return jxm.multi_nll_loss(sr, table, jb.labels, jb.valid, iids, phi,
                                  alpha, use_pallas=False, **kw)

    lj, gj = jax.jit(jax.value_and_grad(jloss))(jp)
    sr, table, phi, alpha, iids = tm.head_multi(tb, training=True)
    assert sr.shape[-1] == WIDE
    lt = txm.multi_nll_loss(sr, table, tb.labels, tb.valid, iids, phi,
                            alpha, **kw)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), atol=ATOL)
    _grads_match(tm, gj)


def slab_layout(D):
    """``[(k0, width)]`` of the feature slabs of csrc/tiles.cuh
    (``slab_count``, ``slab_width``)."""
    n = -(-D // MAX_D)
    sw = (-(-D // n) + 3) & ~3
    return [(k0, min(sw, D - k0)) for k0 in range(0, D, sw)]


@pytest.mark.parametrize("D", [258, 512, 1000])
def test_slabs_cover_every_feature_once(D):
    """Each slab at most 256 features, starting four-aligned (so cp.async
    copies stay aligned), together every feature once, as many as
    ceil(D / 256)."""
    slabs = slab_layout(D)
    assert len(slabs) == -(-D // MAX_D) >= 2
    feats = [k for k0, w in slabs for k in range(k0, k0 + w)]
    assert feats == list(range(D))
    assert all(0 < w <= MAX_D and k0 % 4 == 0 for k0, w in slabs)


def plan_blocks(plan):
    """The blocks of csrc/tiles.cuh:slab_bwd_chunks on ``plan``, chunk by
    chunk: d_table's product as ((catalog tile, slab, row split), row
    tiles it reduces), d_sr's as ((partial, row tile, slab), catalog tiles
    it reduces), and the chunks' catalog tiles."""
    dtable, dsr, chunks, part = [], [], [], 0
    n, chunk = plan["slabs"], plan["chunk"]
    for t0 in range(0, plan["tiles"], chunk):
        tiles = min(chunk, plan["tiles"] - t0)
        chunks.append(range(t0, t0 + tiles))
        dtable += [((t0 + x, y, z),
                    range(z * plan["t_per"],
                          min(plan["rows"], (z + 1) * plan["t_per"])))
                   for x in range(tiles) for y in range(n)
                   for z in range(plan["t_split"])]
        splits = -(-tiles // plan["s_per"])
        dsr += [((part + z, x, y),
                 range(t0 + z * plan["s_per"],
                       t0 + min(tiles, (z + 1) * plan["s_per"])))
                for x in range(plan["rows"]) for y in range(n)
                for z in range(splits)]
        part += splits
    return dtable, dsr, chunks, part


def dz_bytes(plan, esz):
    return plan["dz_shape"][0] * plan["dz_shape"][1] * esz


@pytest.mark.parametrize("D", [258, 512, 1000])
@pytest.mark.parametrize("B,P", [(512, 3584), (512, 37888), (509, 37484),
                                 (1, 70)])
@pytest.mark.parametrize("slots", [132, 264, 1])
def test_slab_grid_covers_every_block_once(D, B, P, slots):
    """K2's (R = B rows) and K4's (R = 3 B) backward plan past 256 features
    (ops/xent.py:slab_bwd_plan), float32 and bfloat16: the chunks cover
    each catalog tile, so each catalog row, once; every output tile of
    both products lands in exactly one block, whose splits together reduce
    every row tile (d_table) or catalog tile (d_sr) once; no split is
    empty; a full chunk's products fill one wave of blocks at most unless
    one split alone passes it; the dz scratch stays within
    DZ_SCRATCH_BYTES, also for K4's rows at P = 2^20."""
    n = len(slab_layout(D))
    for R in (B, 3 * B):
        for esz in (4, 2):
            plan = tx.slab_bwd_plan(R, P, esz, slots, n)
            rows, tiles = -(-R // 64), -(-P // 64)
            assert (plan["rows"], plan["tiles"]) == (rows, tiles)
            dtable, dsr, chunks, parts = plan_blocks(plan)
            assert [t for c in chunks for t in c] == list(range(tiles))
            assert len(chunks) == plan["chunks"]
            assert (tiles - 1) * 64 < P <= tiles * 64
            assert parts == plan["dsr_parts"]
            assert dz_bytes(plan, esz) <= tx.DZ_SCRATCH_BYTES
            assert plan["dz_shape"] == (rows * 64, plan["chunk"] * 64)
            assert plan["chunk"] <= 65535
            for blocks, outs, reduced in (
                    (dtable, [(t, y) for t in range(tiles)
                              for y in range(n)], rows),
                    (dsr, [(x, y) for x in range(rows) for y in range(n)],
                     tiles)):
                keys = [k for k, _ in blocks]
                assert len(set(keys)) == len(keys)
                assert all(len(r) > 0 for _, r in blocks)
                cover = {o: [] for o in outs}
                for (a, b, c), r in blocks:
                    # d_table: (tile, slab) of (tile, slab, split);
                    # d_sr: (row tile, slab) of (part, row tile, slab)
                    cover[(a, b) if blocks is dtable else (b, c)] += list(r)
                assert all(sorted(v) == list(range(reduced))
                           for v in cover.values())
            if plan["t_split"] > 1:
                assert plan["chunk"] * n * plan["t_split"] <= slots
            if plan["s_split"] > 1:
                assert rows * n * plan["s_split"] <= slots
    big = tx.slab_bwd_plan(3 * B, 2 ** 20, 4, slots, n)
    assert dz_bytes(big, 4) <= tx.DZ_SCRATCH_BYTES
    assert big["chunks"] * big["chunk"] >= big["tiles"] > \
        (big["chunks"] - 1) * big["chunk"]


def test_slab_grid_on_the_path_and_north_star_catalogs():
    # 132 SMs with two resident product blocks each, 2 slabs at D = 512,
    # float32.  K2 (512 rows): the path's 56 tiles in one chunk, d_table
    # 112 tiles x 2 row splits, d_sr 16 x 14 catalog splits; the north
    # star's 592 in one chunk of 37,888 columns (77.6 MB of dz), d_table
    # one split, d_sr 16.  K4 (1,536 rows): d_sr 48 x 5 splits; at the
    # north star one chunk of 232.8 MB; at P = 2^20, 25 chunks of 682 tiles
    # and 121 d_sr partials.
    assert tx.slab_bwd_plan(512, 3584, 4, 264, 2) == dict(
        rows=8, tiles=56, chunk=56, chunks=1, slabs=2, t_split=2, t_per=4,
        s_split=14, s_per=4, dsr_parts=14, dz_shape=(512, 3584))
    assert tx.slab_bwd_plan(512, 37888, 4, 264, 2) == dict(
        rows=8, tiles=592, chunk=592, chunks=1, slabs=2, t_split=1,
        t_per=8, s_split=16, s_per=37, dsr_parts=16, dz_shape=(512, 37888))
    assert tx.slab_bwd_plan(1536, 3584, 4, 264, 2) == dict(
        rows=24, tiles=56, chunk=56, chunks=1, slabs=2, t_split=2,
        t_per=12, s_split=5, s_per=12, dsr_parts=5, dz_shape=(1536, 3584))
    assert tx.slab_bwd_plan(1536, 37888, 4, 264, 2) == dict(
        rows=24, tiles=592, chunk=592, chunks=1, slabs=2, t_split=1,
        t_per=24, s_split=5, s_per=119, dsr_parts=5,
        dz_shape=(1536, 37888))
    assert tx.slab_bwd_plan(1536, 2 ** 20, 4, 264, 2) == dict(
        rows=24, tiles=16384, chunk=682, chunks=25, slabs=2, t_split=1,
        t_per=24, s_split=5, s_per=137, dsr_parts=121,
        dz_shape=(1536, 43648))
