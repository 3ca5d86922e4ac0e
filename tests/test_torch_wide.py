"""K1-K4 past 256 features and 256 session items, on the CPU.

The plain versions of the port's kernels (ops/xent.py, ops/xent_multi.py)
against the JAX package's Pallas kernels in interpret mode, as
tests/test_torch_xent.py and tests/test_torch_xent_multi.py run them, at
D = 512 and, for K3/K4, with 300 session items a row; MSGIFSR's order-1
head and the paper head at embedding_dim 512 against the JAX heads (loss
and every gradient, atol 5e-5, as tests/test_torch_model.py); and the
slab grid of the kernels' wide path (csrc/tiles.cuh: slab_count,
slab_width; ops/xent.py: _fwd_grid, _bwd_grid with a slab axis), which is
host arithmetic.  The slab kernels themselves run on the card
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


@pytest.mark.parametrize("D", [258, 512, 1000])
@pytest.mark.parametrize("B,P", [(512, 3584), (512, 37888), (509, 37484),
                                 (1, 70)])
@pytest.mark.parametrize("slots", [132, 264, 1])
def test_slab_grid_covers_every_block_once(D, B, P, slots):
    """K2's and K4's slab grids (ops/xent.py:_bwd_grid with a slab axis):
    every (catalog tile, row chunk, slab) of d_table and every (row tile,
    catalog tile, slab) of d_sr in exactly one block, no split empty, one
    wave of blocks at most unless one split alone passes it (K1's and
    K3's grids loop over the slabs inside a block and keep no slab
    axis)."""
    n = len(slab_layout(D))
    grid = tx._bwd_grid(B, P, slots, 64, n)
    tiles, rows = -(-P // 64), -(-B // 64)
    assert (grid["tiles"], grid["rows"]) == (tiles, rows)
    dtable = [(t, c, z) for t in range(tiles) for s in range(grid["t_split"])
              for c in range(s * grid["t_per"],
                             min(rows, (s + 1) * grid["t_per"]))
              for z in range(n)]
    assert sorted(dtable) == [(t, c, z) for t in range(tiles)
                              for c in range(rows) for z in range(n)]
    dsr = [(r, t, z) for r in range(rows) for s in range(grid["s_split"])
           for t in range(s * grid["s_per"],
                          min(tiles, (s + 1) * grid["s_per"]))
           for z in range(n)]
    assert sorted(dsr) == [(r, t, z) for r in range(rows)
                           for t in range(tiles) for z in range(n)]
    assert all(s * grid["t_per"] < rows for s in range(grid["t_split"]))
    assert all(s * grid["s_per"] < tiles for s in range(grid["s_split"]))
    if grid["t_split"] > 1:
        assert tiles * grid["t_split"] * n <= slots
    if grid["s_split"] > 1:
        assert rows * grid["s_split"] * n <= slots


def test_slab_grid_on_the_path_and_north_star_catalogs():
    # 132 SMs, one resident slab block each, 2 slabs at D = 512: d_table's
    # 56 path tiles take one row split (112 blocks), d_sr's 8 row tiles 8
    # catalog splits (128 blocks); at the north star both take one split
    # of d_table (1,184 blocks) and 8 of d_sr
    assert tx._bwd_grid(512, 3584, 132, 64, 2) == dict(
        tiles=56, t_split=1, t_per=8, rows=8, s_split=8, s_per=7)
    assert tx._bwd_grid(512, 37888, 132, 64, 2) == dict(
        tiles=592, t_split=1, t_per=8, rows=8, s_split=8, s_per=74)
