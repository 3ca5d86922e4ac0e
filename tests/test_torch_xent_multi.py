"""Parity of the port's fused multi-order REnorm/fusion loss
(ops/xent_multi.py, plain path on the CPU) with the JAX package's: the
Pallas kernels K3/K4 run in interpret mode, as tests/test_xent_multi.py
runs them.

Tolerances: stats and loss values rtol/atol 1e-5, gradients rtol 1e-3 /
atol 2e-4 (those of tests/test_torch_xent.py: the same float32 products,
summed in another order).  The CUDA kernels themselves are held against
the plain versions on the card by tests/test_torch_kernels_gpu.py and by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionrec_tpu.ops import xent_multi as jxm
from sessionrec_tpu_torch.ops import xent as tx
from sessionrec_tpu_torch.ops import xent_multi as txm
from sessionrec_tpu_torch.utils import profiling
from test_torch_xent import assert_grid_covers

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=2e-4)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _stats_case(norm, col_offset, K=3, B=8, D=64, P=1024, n_valid=900,
                N=6, seed=0):
    """Inputs of K3/K4 with the edge rows: row 0 has no session item, row
    1 an off-shard label (-1), even rows a label inside the session, odd
    rows one drawn from the catalog; table row 2 has norm 0 and, where the
    table is normalised, row 4 norm 50 (unnormalised its logits reach 1e4
    and float32 rounding of z alone exceeds GRAD)."""
    rng = np.random.default_rng(seed)
    sr3 = rng.normal(size=(K, B, D)).astype(np.float32)
    sr3 /= np.linalg.norm(sr3, axis=-1, keepdims=True)
    table = rng.normal(size=(P, D)).astype(np.float32) / 8
    table[2] = 0.0
    if norm:
        table[4] *= 50.0
    iids = rng.integers(0, n_valid, size=(B, N)).astype(np.int32)
    lens = rng.integers(1, N + 1, size=B)
    iids[np.arange(N)[None, :] >= lens[:, None]] = -1
    iids[0] = -1
    labels = rng.integers(0, n_valid, size=B).astype(np.int32)
    labels[::2] = np.maximum(iids[::2, 0], 0)
    iids[iids >= 0] += col_offset           # membership is in global ids
    labels[1] = -1
    return sr3, table, labels, iids


@pytest.mark.parametrize("norm,col_offset", [(True, 0), (False, 0),
                                             (True, 300)])
def test_kernel_stats_match_pallas(norm, col_offset):
    """(m_in, s_in, m_ex, s_ex, zl) and (d_sr, d_table) of the plain
    versions against the Pallas kernels' own outputs."""
    sr3, table, labels, iids = _stats_case(norm, col_offset)
    n_valid, N = 900, iids.shape[1]
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
    assert np.all(m_in[:, 0] == -1e30) and np.all(s_in[:, 0] == 0.0)
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
    assert float(dtabt[n_valid:].abs().max()) == 0.0   # padding rows


def _loss_case(B=16, K=3, D=32, P=512, num_items=470, N=6, seed=0):
    """tests/test_xent_multi.py's inputs: half the labels in-session."""
    rng = np.random.default_rng(seed)
    sr = rng.normal(size=(B, K, D)).astype(np.float32)
    table = rng.normal(size=(P, D)).astype(np.float32)
    table[num_items:] = 0.0
    iids = rng.integers(0, num_items, size=(B, N)).astype(np.int32)
    lens = rng.integers(1, N + 1, size=B)
    iids[np.arange(N)[None, :] >= lens[:, None]] = -1
    labels = rng.integers(0, num_items, size=B).astype(np.int32)
    labels[::2] = np.maximum(iids[::2, 0], 0)
    phi_logits = rng.normal(size=(B, K, 2)).astype(np.float32)
    phi = np.exp(phi_logits) / np.exp(phi_logits).sum(-1, keepdims=True)
    alpha = rng.normal(size=K).astype(np.float32)
    valid = np.ones(B, np.float32)
    valid[-3:] = 0.0
    return sr, table, labels, valid, iids, phi.astype(np.float32), alpha


def _torch_loss(case, kw):
    sr, table, labels, valid, iids, phi, alpha = case
    ts = [_t(x).requires_grad_(True) for x in (sr, table, phi, alpha)]
    loss = txm.multi_nll_loss(ts[0], ts[1], _t(labels, torch.int32),
                              _t(valid), _t(iids, torch.int32), ts[2], ts[3],
                              **kw)
    loss.backward()
    # an input the loss does not read (phi without REnorm, alpha without
    # fusion) has no gradient; JAX's is zero
    return loss, [torch.zeros_like(t) if t.grad is None else t.grad
                  for t in ts]


@pytest.mark.parametrize("extra,fusion", [(True, True), (True, False),
                                          (False, True)])
@pytest.mark.parametrize("norm", [True, False])
def test_loss_and_grads_match_jax_pallas(extra, fusion, norm):
    case = _loss_case()
    sr, table, labels, valid, iids, phi, alpha = case
    kw = dict(scale=12.0, num_items=470, normalize_table=norm, extra=extra,
              fusion=fusion)

    def jloss(s, t, p, a):
        return jxm.multi_nll_loss(s, t, jnp.asarray(labels),
                                  jnp.asarray(valid), jnp.asarray(iids), p,
                                  a, use_pallas=True, **kw)

    lj, gj = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (sr, table, phi, alpha)))
    lt, gt = _torch_loss(case, kw)
    np.testing.assert_allclose(float(lt.detach()), float(lj), **VAL)
    for name, a, b in zip(("sr", "table", "phi", "alpha"), gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("extra,fusion", [(True, True), (True, False),
                                          (False, True), (False, False)])
def test_loss_matches_reference_stats(extra, fusion):
    """The kernel path's stats and the materialising oracle
    (``reference_multi_stats``) give one loss and one set of gradients;
    the JAX oracle gives the same value."""
    case = _loss_case(seed=2)
    sr, table, labels, valid, iids, phi, alpha = case
    kw = dict(scale=12.0, num_items=470, normalize_table=True)
    lt, gt = _torch_loss(case, dict(kw, extra=extra, fusion=fusion))

    ts = [_t(x).requires_grad_(True) for x in (sr, table, phi, alpha)]
    lbl, ids = _t(labels, torch.int32), _t(iids, torch.int32)
    zl, lin, lex = txm.reference_multi_stats(ts[0].transpose(0, 1), ts[1],
                                             lbl, ids, **kw)
    per_row = txm.combine_stats(zl, lin, lex, ts[2], ts[3],
                                torch.any(ids == lbl[:, None], dim=1),
                                extra=extra, fusion=fusion)
    v = _t(valid)
    lr = torch.sum(per_row * v) / torch.sum(v)
    lr.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lr.detach()), **VAL)
    for name, a, t in zip(("sr", "table", "phi", "alpha"), gt, ts):
        b = torch.zeros_like(a) if t.grad is None else t.grad
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD,
                                   err_msg=name)
    lj = jxm.multi_nll_loss(*(jnp.asarray(x) for x in (sr, table, labels,
                                                       valid, iids, phi,
                                                       alpha)),
                            extra=extra, fusion=fusion, use_pallas=False,
                            **kw)
    np.testing.assert_allclose(float(lt.detach()), float(lj), **VAL)


def test_orders_the_loss_does_not_read_get_exactly_zero():
    """REnorm without fusion reads order 1 only; K3 still computes every
    order, and orders 2 and 3 must get a d_sr of exactly 0, not NaN."""
    case = _loss_case(seed=3)
    _, (gsr, gtab, _, _) = _torch_loss(
        case, dict(scale=12.0, num_items=470, normalize_table=True,
                   extra=True, fusion=False))
    assert torch.isfinite(gsr).all() and torch.isfinite(gtab).all()
    assert float(gsr[:, 1:].abs().max()) == 0.0
    assert float(gsr[:, 0].abs().max()) > 0.0


def test_rows_with_no_session_item_stay_finite():
    """An empty in-session partition: lse_in near -inf, finite loss and
    gradients."""
    sr, table, labels, valid, iids, phi, alpha = _loss_case(seed=4)
    iids[:] = -1
    _, grads = _torch_loss((sr, table, labels, valid, iids, phi, alpha),
                           dict(scale=12.0, num_items=470,
                                normalize_table=True, extra=True,
                                fusion=True))
    assert all(torch.isfinite(g).all() for g in grads)


def test_cpu_launches_no_kernel():
    """CPU tensors take the plain versions and leave the counters alone,
    with tracing on."""
    with profiling.tracing():
        _torch_loss(_loss_case(B=4, D=16, seed=5),
                    dict(scale=12.0, num_items=470, normalize_table=True,
                         extra=True, fusion=True))
        counts = profiling.snapshot()["counts"]
    assert not {k for k in counts if k.startswith("xent")}


# K3's and K4's grids: ops/xent.py:_bwd_grid over the K * B rows (K = 3),
# with the slots of their own kernels
@pytest.mark.parametrize("R,P", [(1536, 3584), (1536, 37888), (1527, 37484),
                                 (3, 1), (3, 70)])
@pytest.mark.parametrize("slots", [132, 264, 1])
def test_kb_grid_covers_every_tile_and_row_once(R, P, slots):
    assert_grid_covers(R, P, slots)


def test_kb_grid_on_the_path_and_north_star_catalogs():
    # 132 SMs, one resident block each, 1,536 rows in 24 tiles: the path
    # catalog's 56 tiles take 2 row splits of 12 chunks, the north star's
    # 592 tiles one; d_sr (and K3) 5 catalog splits, of 12 and 119 tiles
    assert tx._bwd_grid(3 * 512, 3584, 132, 64) == dict(
        tiles=56, t_split=2, t_per=12, rows=24, s_split=5, s_per=12)
    assert tx._bwd_grid(3 * 512, 37888, 132, 64) == dict(
        tiles=592, t_split=1, t_per=24, rows=24, s_split=5, s_per=119)
