"""Parity of the port's fused catalog cross-entropy (ops/xent.py, plain
path on the CPU) with the JAX package's: the Pallas kernels run in
interpret mode as tests/test_xent.py runs them, and the jnp oracle.

Tolerances: values rtol/atol 1e-5, gradients rtol 1e-3 / atol 2e-4 (those
of tests/test_xent.py: the sums run in another order), bfloat16 inputs
1e-2.  The CUDA kernels themselves are held against the plain versions on
the card by tests/test_torch_kernels_gpu.py and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionrec_tpu.ops import xent as jx
from sessionrec_tpu_torch.ops import xent as tx
from sessionrec_tpu_torch.utils import profiling

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=2e-4)


def _case(B, D, P, num_items, seed, zero_row=None, big_row=None):
    rng = np.random.default_rng(seed)
    sr = rng.normal(size=(B, D)).astype(np.float32)
    table = rng.normal(size=(P, D)).astype(np.float32)
    if zero_row is not None:
        table[zero_row] = 0.0
    if big_row is not None:
        table[big_row] *= 50.0
    labels = rng.integers(0, num_items, size=B).astype(np.int32)
    valid = np.ones(B, np.float32)
    valid[-1] = 0.0                                  # one masked row
    return sr, table, labels, valid


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


CASES = [
    # B, D, P, num_items, scale, normalize_table
    (8, 64, 512, 500, 12.0, True),
    (8, 64, 512, 500, 12.0, False),
    (5, 32, 700, 650, 1.0, True),     # nothing aligned, num_items < P
    (16, 128, 1024, 1000, 12.0, False),
]


@pytest.mark.parametrize("B,D,P,n,scale,norm", CASES)
def test_loss_and_grads_match_jax(B, D, P, n, scale, norm):
    sr, table, labels, valid = _case(B, D, P, n, seed=B + P,
                                     zero_row=3 if norm else None,
                                     big_row=7 if norm else None)

    def jloss(s, t):
        return jx.fused_nll_loss(s, t, jnp.asarray(labels),
                                 jnp.asarray(valid), scale=scale,
                                 num_items=n, normalize_table=norm,
                                 use_pallas=True)

    lj, (gsj, gtj) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(sr), jnp.asarray(table))

    s = _t(sr).requires_grad_(True)
    t = _t(table).requires_grad_(True)
    lt = tx.fused_nll_loss(s, t, _t(labels, torch.int32), _t(valid),
                           scale=scale, num_items=n, normalize_table=norm)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), **VAL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(gsj), **GRAD)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gtj), **GRAD)


@pytest.mark.parametrize("norm", [True, False])
def test_per_row_values_match_reference(norm):
    B, D, P, n = 8, 64, 512, 450
    sr, table, labels, _ = _case(B, D, P, n, seed=11, zero_row=0)
    want = jx.reference_xent(jnp.asarray(sr), jnp.asarray(table),
                             jnp.asarray(labels), scale=12.0, num_items=n,
                             normalize_table=norm)
    got = tx.catalog_xent(_t(sr), _t(table), _t(labels, torch.int32),
                          scale=12.0, num_items=n, normalize_table=norm)
    ref = tx.reference_xent(_t(sr), _t(table), _t(labels, torch.int32),
                            scale=12.0, num_items=n, normalize_table=norm)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), **VAL)


@pytest.mark.parametrize("norm", [True, False])
def test_kernel_stats_match_pallas(norm):
    """(m, s, zl) and (dsr, dtable) of the plain versions against the
    Pallas kernels' own outputs, with an off-shard label (-1)."""
    B, D, P, n = 8, 128, 1024, 900
    # the large-norm row only where the table is normalised: unnormalised,
    # its logits reach ~1e4 and float32 rounding of z alone exceeds GRAD
    sr, table, labels, _ = _case(B, D, P, n, seed=5, zero_row=2,
                                 big_row=4 if norm else None)
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


def test_zero_norm_row_gradient_is_finite_and_matches():
    """The kernel clamps ``max(n, eps)`` where the oracle takes
    ``sqrt(max(nsq, eps^2))``: equal, also for an all-zero row."""
    B, D, P, n = 6, 32, 512, 512
    sr, table, labels, valid = _case(B, D, P, n, seed=9, zero_row=1)
    s1 = _t(sr).requires_grad_(True)
    t1 = _t(table).requires_grad_(True)
    tx.catalog_xent(s1, t1, _t(labels, torch.int32), scale=12.0,
                    num_items=n, normalize_table=True).sum().backward()
    s2 = _t(sr).requires_grad_(True)
    t2 = _t(table).requires_grad_(True)
    tx.reference_xent(s2, t2, _t(labels, torch.int32), scale=12.0,
                      num_items=n, normalize_table=True).sum().backward()
    assert torch.isfinite(t1.grad).all()
    np.testing.assert_allclose(t1.grad.numpy(), t2.grad.numpy(),
                               rtol=1e-3, atol=1e-3 * float(
                                   t2.grad.abs().max()))
    np.testing.assert_allclose(s1.grad.numpy(), s2.grad.numpy(), **GRAD)


def test_bfloat16_inputs():
    B, D, P, n = 8, 128, 512, 500
    sr, table, labels, _ = _case(B, D, P, n, seed=3)
    want = jx.catalog_xent(jnp.asarray(sr, jnp.bfloat16),
                           jnp.asarray(table, jnp.bfloat16),
                           jnp.asarray(labels), scale=1.0, num_items=n)
    s = _t(sr, torch.bfloat16).requires_grad_(True)
    t = _t(table, torch.bfloat16).requires_grad_(True)
    got = tx.catalog_xent(s, t, _t(labels, torch.int32), scale=1.0,
                          num_items=n)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-2, atol=1e-2)
    got.sum().backward()
    assert s.grad.dtype == torch.bfloat16 and t.grad.dtype == torch.bfloat16

    def jl(a, b):
        return jnp.sum(jx.catalog_xent(a, b, jnp.asarray(labels), scale=1.0,
                                       num_items=n))
    gs, gt = jax.grad(jl, argnums=(0, 1))(jnp.asarray(sr, jnp.bfloat16),
                                          jnp.asarray(table, jnp.bfloat16))
    np.testing.assert_allclose(s.grad.float().numpy(),
                               np.asarray(gs, np.float32), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(t.grad.float().numpy(),
                               np.asarray(gt, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_padded_rows_excluded():
    """Rows past num_items get no probability mass and no gradient."""
    B, D, n = 8, 64, 500
    sr, table, labels, _ = _case(B, D, 512, n, seed=4)
    junk = np.concatenate([table, 100.0 * np.ones((512, D), np.float32)])
    t = _t(junk).requires_grad_(True)
    base = tx.catalog_xent(_t(sr), _t(table), _t(labels, torch.int32),
                           scale=1.0, num_items=n)
    with_junk = tx.catalog_xent(_t(sr), t, _t(labels, torch.int32),
                                scale=1.0, num_items=n)
    np.testing.assert_allclose(base.numpy(), with_junk.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    with_junk.sum().backward()
    assert float(t.grad[n:].abs().max()) == 0.0


def test_cpu_launches_no_kernel():
    """CPU tensors take the plain version and leave the counters alone,
    with tracing on."""
    sr, table, labels, _ = _case(4, 16, 512, 512, seed=1)
    s = _t(sr).requires_grad_(True)
    with profiling.tracing():
        tx.catalog_xent(s, _t(table), _t(labels, torch.int32), scale=12.0,
                        num_items=512).sum().backward()
        counts = profiling.snapshot()["counts"]
    assert not {k for k in counts if k.startswith("xent")}


# K2's grid (ops/xent.py:_bwd_grid): pure arithmetic, so it is checked here
# for the shapes the card sees and for ragged and degenerate ones
@pytest.mark.parametrize("B,P", [(512, 3584), (512, 37888), (509, 37484),
                                 (1, 3584), (100, 1000), (1, 1), (4096, 64),
                                 (20000, 70)])
@pytest.mark.parametrize("slots", [132, 264, 1])
def test_bwd_grid_covers_every_tile_and_row_once(B, P, slots):
    assert_grid_covers(B, P, slots)


def assert_grid_covers(B, P, slots, tile=64):
    """``_bwd_grid`` over ``B`` rows: every catalog tile and row chunk in
    exactly one split, no split empty, one wave of blocks at most unless
    one split alone passes it."""
    grid = tx._bwd_grid(B, P, slots, tile)
    tiles, rows = -(-P // tile), -(-B // tile)
    assert (grid["tiles"], grid["rows"]) == (tiles, rows)
    # d_table: row split s takes chunks [s * t_per, (s + 1) * t_per)
    chunks = [c for s in range(grid["t_split"])
              for c in range(s * grid["t_per"],
                             min(rows, (s + 1) * grid["t_per"]))]
    assert chunks == list(range(rows))
    assert all(s * grid["t_per"] < rows for s in range(grid["t_split"]))
    # d_sr: catalog split s takes tiles [s * s_per, (s + 1) * s_per)
    cat = [t for s in range(grid["s_split"])
           for t in range(s * grid["s_per"],
                          min(tiles, (s + 1) * grid["s_per"]))]
    assert cat == list(range(tiles))
    assert all(s * grid["s_per"] < tiles for s in range(grid["s_split"]))
    # at most one wave of blocks unless one split alone passes it
    if grid["t_split"] > 1:
        assert tiles * grid["t_split"] <= slots
    if grid["s_split"] > 1:
        assert rows * grid["s_split"] <= slots
    if tiles >= slots:
        assert grid["t_split"] == 1
    if rows >= slots:
        assert grid["s_split"] == 1


@pytest.mark.parametrize("B,P", [(512, 3584), (512, 37888), (509, 37484)])
@pytest.mark.parametrize("slots", [132, 264, 1])
def test_fwd_grid_covers_every_row_tile_and_catalog_tile_once(B, P, slots):
    """K1's grid (ops/xent.py:_fwd_grid): block (row tile, catalog split s)
    takes tiles [s * s_per, (s + 1) * s_per); every (row tile, catalog
    tile) pair in exactly one block, no split empty, one wave of blocks at
    most unless the row tiles alone pass it."""
    grid = tx._fwd_grid(B, P, slots, 64)
    tiles, rows = -(-P // 64), -(-B // 64)
    assert (grid["tiles"], grid["rows"]) == (tiles, rows)
    blocks = [(r, t) for r in range(grid["rows"])
              for s in range(grid["s_split"])
              for t in range(s * grid["s_per"],
                             min(tiles, (s + 1) * grid["s_per"]))]
    assert blocks == [(r, t) for r in range(rows) for t in range(tiles)]
    assert all(s * grid["s_per"] < tiles for s in range(grid["s_split"]))
    if grid["s_split"] > 1:
        assert rows * grid["s_split"] <= slots
    if rows >= slots:
        assert grid["s_split"] == 1


def test_fwd_grid_on_the_path_and_north_star_catalogs():
    # 132 SMs, one resident block each: 8 row tiles times 14 catalog splits
    # of 4 tiles on the path, 16 of 37 at the north star; two a SM halve
    # the tiles per split
    assert tx._fwd_grid(512, 3584, 132, 64) == dict(
        tiles=56, rows=8, s_split=14, s_per=4)
    assert tx._fwd_grid(512, 37888, 132, 64) == dict(
        tiles=592, rows=8, s_split=16, s_per=37)
    assert tx._fwd_grid(512, 3584, 264, 64) == dict(
        tiles=56, rows=8, s_split=28, s_per=2)
    assert tx._fwd_grid(512, 37888, 264, 64) == dict(
        tiles=592, rows=8, s_split=33, s_per=18)


def test_k3_fwd_grid_at_two_blocks_an_sm():
    # K3 past 256 features: the chunk ring's two blocks a SM on 132 SMs
    # over K * B = 1,536 rows (24 row tiles): 10 catalog splits of 6 tiles
    # on the path, 11 of 54 at the north star
    for P, s_split, s_per in ((3584, 10, 6), (37888, 11, 54)):
        grid = tx._bwd_grid(1536, P, 264, 64)
        assert (grid["rows"], grid["s_split"], grid["s_per"]) == \
            (24, s_split, s_per)
        assert grid["rows"] * grid["s_split"] <= 264


def test_bwd_grid_on_the_path_and_north_star_catalogs():
    # 132 SMs, one resident block each: the path catalog's 56 tiles take 2
    # row splits, the north star's 592 tiles one; d_sr's 8 row tiles take
    # 14 and 16 catalog splits
    assert tx._bwd_grid(512, 3584, 132, 64) == dict(
        tiles=56, t_split=2, t_per=4, rows=8, s_split=14, s_per=4)
    assert tx._bwd_grid(512, 37888, 132, 64) == dict(
        tiles=592, t_split=1, t_per=8, rows=8, s_split=16, s_per=37)


# bfloat16 up to 256 features: the tensor-core kernels' launch bounds ask
# for two resident blocks an SM, so on 132 SMs the grids fill 264 slots.
# A stub of the slots queries (two blocks an SM, tensor cores) stands in
# for the card; the launch shapes take their grids from it.

class _Library:
    @staticmethod
    def srt_xent_bwd_tile():
        return 64

    @staticmethod
    def srt_xent_slabs(D):
        return -(-D // 256)


@pytest.mark.parametrize("P,k1,k2", [
    (3584, dict(blocks=224, catalog_splits=28, tiles_per_split=2),
     dict(dtable_blocks=224, dsr_blocks=224, row_splits=4,
          catalog_splits=28)),
    (37888, dict(blocks=264, catalog_splits=33, tiles_per_split=18),
     dict(dtable_blocks=592, dsr_blocks=264, row_splits=1,
          catalog_splits=33))])
def test_bf16_grids_at_two_blocks_an_sm(monkeypatch, P, k1, k2):
    monkeypatch.setattr(tx, "_library", lambda: _Library)
    monkeypatch.setattr(tx, "_fwd_attrs", lambda dev, D, dt: (
        2, 132, 80, 0, 101376, 2, 1))
    monkeypatch.setattr(tx, "_bwd_attrs", lambda dev, D, dt: (
        2, 2, 132, 120, 120, 0, 0, 1))
    sr = torch.zeros(512, 256, dtype=torch.bfloat16)
    fwd, bwd = tx.fwd_launch_shape(sr, P), tx.bwd_launch_shape(sr, P)
    assert {k: fwd[k] for k in k1} == k1
    assert fwd["row_tiles"] == 8 and fwd["blocks"] <= 264
    assert {k: bwd[k] for k in k2} == k2
    assert bwd["resident_per_sm"] == 2 and bwd["slabs"] == 1
    assert fwd["product"] == bwd["product"] == "tensor_core"
    # the same grids as the arithmetic on 264 slots, twice the one-block
    # grid's slots on the path catalog
    assert tx._fwd_grid(512, P, 264, 64)["s_split"] == k1["catalog_splits"]
    if P == 3584:
        assert tx._fwd_grid(512, P, 132, 64)["s_split"] * 2 == \
            k1["catalog_splits"]
