"""The port's CUDA kernels (csrc/xent.cu, csrc/xent_bwd.cu,
csrc/xent_multi.cu) against their plain PyTorch versions, on the card.
CUDA kernels have no interpret mode, so without a card every test here
skips.  This file imports nothing of JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu

Tolerances: K1 rtol 1e-5 / atol 1e-4 on loss and lse (the same float32
products summed in another order); K2 1e-3 (float32) or 1e-2 (bfloat16) of the largest
reference magnitude, for d_table in each group of rows, since dz and a
bfloat16 d_table are rounded.  K3 and K4 likewise: the five stats to
1e-5 * max(1, |ref|) element by element, d_sr and d_table as K2, with
d_table's rows hit only by session items a group of their own.  K1-K4
also on a catalog shard, with the operands a (2, 2) mesh's losses give
them (``ops/xent.py`` and ``ops/xent_multi.py`` ``_shard_operands``), and
past 256 features (the slab kernels: widths 258, 512, 513, 1000) and, for
K3/K4, with 300 and 1,024 session items a row.
"""

import numpy as np
import pytest
import torch

from sessionrec_tpu_torch.ops import xent as tx
from sessionrec_tpu_torch.ops import xent_multi as txm
from sessionrec_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no "
                    "interpret mode)")
    return torch.device("cuda")


def _case(cuda, B, D, P, n, dtype, seed=7):
    rng = np.random.default_rng(seed)
    sr = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32))
    tab = torch.from_numpy(rng.normal(size=(P, D)).astype(np.float32)) / 16
    tab[2] = 0.0                                    # a zero-norm row
    labels = torch.from_numpy(rng.integers(0, n, size=B).astype(np.int32))
    labels[0] = -1                                  # an off-shard label
    return (sr.to(cuda, dtype), tab.to(cuda, dtype), labels.to(cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", [True, False])
def test_kernels_match_plain(cuda, dtype, norm):
    B, D, P, n = 64, 256, 1536, 1400
    s, t, lbl = _case(cuda, B, D, P, n, dtype)
    loss, lse = tx._fwd_cuda(s, t, lbl, n, 0, scale=12.0,
                             normalize_table=norm)
    m, st, zl = tx._fwd_plain(s, t, lbl, n, scale=12.0,
                              normalize_table=norm)
    lse_p = tx._finish_lse(m, st)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(loss, lse_p - zl, rtol=1e-5, atol=1e-4)
    g = torch.full((B,), 1.0 / B, device=cuda)
    dsr, dtab = tx._bwd_cuda(g, s, t, lbl, lse_p, n, 0, scale=12.0,
                             normalize_table=norm)
    dsr_p, dtab_p = tx._bwd_plain(g, s, t, lbl, lse_p, n, scale=12.0,
                                  normalize_table=norm)
    tol = 1e-3 if dtype == torch.float32 else 1e-2
    assert float((dsr - dsr_p).abs().max()) <= tol * float(dsr_p.abs().max())
    # d_table by groups of rows, each to its own scale: rows hit by a label
    # carry the large onehot term, the others only the softmax term; the
    # zero row's gradient is G / eps
    rows = torch.arange(P, device=cuda)
    hit = torch.zeros(P, dtype=torch.bool, device=cuda)
    hit[lbl[lbl >= 0].long()] = True
    for group in (hit & (rows != 2), ~hit & (rows != 2) & (rows < n),
                  rows >= n, rows == 2):
        err = (dtab[group].float() - dtab_p[group].float()).abs().max()
        assert float(err) <= tol * float(dtab_p[group].float().abs().max())


def _k1_case(cuda, B, D, P, n, dtype, seed=19):
    """K1's inputs at any B >= 1 and P >= 1: unit rows, a zero-norm table
    row where the table has three, an off-shard label (-1) on row 0 where
    there are two rows."""
    rng = np.random.default_rng(seed)
    sr = rng.normal(size=(B, D)).astype(np.float32)
    sr /= np.linalg.norm(sr, axis=-1, keepdims=True)
    tab = torch.from_numpy(rng.normal(size=(P, D)).astype(np.float32)) / 16
    if P > 2:
        tab[2] = 0.0                                # a zero-norm row
    labels = rng.integers(0, n, size=B).astype(np.int32)
    if B > 1:
        labels[0] = -1
    return (torch.from_numpy(sr).to(cuda, dtype), tab.to(cuda, dtype),
            torch.from_numpy(labels).to(cuda))


def _assert_k1_close(got, s, t, lbl, n, col_offset, norm):
    m, st, zl = tx._fwd_plain(s, t, lbl, n, col_offset, scale=12.0,
                              normalize_table=norm)
    lse_p = tx._finish_lse(m, st)
    loss, lse = got
    assert loss.dtype == lse.dtype == torch.float32
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(loss, lse_p - zl, rtol=1e-5, atol=1e-4)


# K1's tiles are 64 batch rows and 64 catalog rows: one row, a ragged
# batch, widths that are not multiples of 4 (plain loads, not cp.async) or
# of 32, catalogs of one row, one tile, one tile and a few rows; in
# bfloat16 the tensor cores' k steps of 16 at widths 16, 30, 32 (LESSR's),
# 64 (SRGNN's), 100, 132 and 256
@pytest.mark.parametrize("B,D,P,n", [(1, 256, 3584, 3429),
                                     (509, 256, 3584, 3429),
                                     (96, 16, 70, 64),
                                     (37, 30, 64, 60),
                                     (130, 32, 300, 290),
                                     (200, 64, 1000, 999),
                                     (100, 100, 1000, 999),
                                     (509, 132, 1, 1),
                                     (8, 132, 70, 70),
                                     (509, 258, 3584, 3429),
                                     (64, 512, 1536, 1400),
                                     (1, 513, 70, 64),
                                     (37, 1000, 300, 290)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", [True, False])
def test_k1_matches_plain_at_edge_shapes(cuda, B, D, P, n, dtype, norm):
    s, t, lbl = _k1_case(cuda, B, D, P, n, dtype)
    got = tx._fwd_cuda(s, t, lbl, n, 0, scale=12.0, normalize_table=norm)
    _assert_k1_close(got, s, t, lbl, n, 0, norm)


@pytest.mark.parametrize("D", [256, 512])
@pytest.mark.parametrize("norm", [True, False])
def test_k1_matches_plain_on_a_catalog_shard(cuda, norm, D):
    """A shard of the table at a column offset: K1 compares the global
    columns with n_valid and the (global) labels."""
    s, t, lbl = _k1_case(cuda, 300, D, 3584, 3429, torch.float32)
    shard = t[1000:2600].contiguous()
    got = tx._fwd_cuda(s, shard, lbl, 2500, 1000, scale=12.0,
                       normalize_table=norm)
    _assert_k1_close(got, s, shard, lbl, 2500, 1000, norm)


# rank (0, 1) of a (2, 2) mesh on the path catalog: shard 1 of the 3,584
# rows starts at row 1,792 and holds 1,637 of the 3,429 items
SHARD_P, SHARD_ITEMS, SHARD_ROWS = 3584, 3429, 1792


def _shard_operands(cuda, ops, labels):
    """The operands the mesh's losses give a kernel wrapper on that shard
    (``ops._shard_operands``): labels, n_valid and col_offset."""
    from sessionrec_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh(2, 2, 1, cuda, "nccl", None, None)
    lbl, n_valid, offset = ops._shard_operands(labels, SHARD_ROWS,
                                               SHARD_ITEMS, mesh)
    assert offset == SHARD_ROWS
    assert int((lbl >= 0).sum()) > 0 and int((lbl == -1).sum()) > 0
    return lbl, n_valid, offset


@pytest.mark.parametrize("D", [256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", [True, False])
def test_k2_matches_plain_on_a_catalog_shard(cuda, dtype, norm, D):
    """K2 on that shard with the mesh's operands (global labels the shard
    holds, -1 elsewhere; n_valid the shard's end in global ids; col_offset
    1,792) and the whole catalog's lse, as the mesh's backward calls it:
    its plain version's numbers, d_table by groups of rows, the rows past
    the last item exactly 0."""
    s, t, lbl, g, lse = _k2_case(cuda, 256, D, SHARD_P, SHARD_ITEMS, dtype,
                                 norm)
    shard = t[SHARD_ROWS:].contiguous()
    lk, n_valid, offset = _shard_operands(cuda, tx, lbl)
    assert n_valid == SHARD_ITEMS
    kw = dict(scale=12.0, normalize_table=norm)
    dsr, dtab = tx._bwd_cuda(g, s, shard, lk, lse, n_valid, offset, **kw)
    dsr_p, dtab_p = tx._bwd_plain(g, s, shard, lk, lse, n_valid, offset,
                                  **kw)
    _assert_k2_close(dsr, dtab, dsr_p, dtab_p,
                     torch.where(lk >= 0, lk - offset, -1), SHARD_ROWS,
                     SHARD_ITEMS - SHARD_ROWS,
                     1e-3 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("D", [256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [3584, 37888])
def test_k1_is_deterministic(cuda, dtype, P, D):
    """No atomics: two calls on the same inputs give the same bits."""
    s, t, lbl = _k1_case(cuda, 512, D, P, P - 100, dtype)
    kw = dict(scale=12.0, normalize_table=True)
    first = tx._fwd_cuda(s, t, lbl, P - 100, 0, **kw)
    second = tx._fwd_cuda(s, t, lbl, P - 100, 0, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("D", [256, 258, 512, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_kernels_spill_nothing(cuda, dtype, D):
    """K1's and K3's partial kernels keep everything in registers at the
    path's width and past 256 features: no local memory, and grids of
    their own slots.  Past 256 the chunk ring's kernels fit two blocks on
    an SM, so their grids take twice the blocks, and run on the tensor
    cores in bfloat16 (a ring of four stages), on the FMA pipes in float32
    (three)."""
    s = torch.zeros(512, D, device=cuda, dtype=dtype)
    least = 2 if D > 256 else 1
    k1 = tx.fwd_launch_shape(s, 3584)
    assert k1["local_bytes"] == 0 and k1["resident_per_sm"] >= least
    assert k1["blocks"] == k1["row_tiles"] * k1["catalog_splits"] <= \
        k1["resident_per_sm"] * k1["sms"]
    multi = txm.multi_launch_shape(s.expand(3, 512, D), 3584)
    k3 = multi["k3"]
    assert multi["local_bytes"]["fwd"] == 0 and k3["resident_per_sm"] >= least
    assert k3["blocks"] <= k3["resident_per_sm"] * multi["sms"]
    if D > 256:
        assert k1["ring_stages"] == k3["ring_stages"] >= 2
        assert k1["registers"] <= 128 and multi["registers"]["fwd"] <= 128
        bf16 = dtype == torch.bfloat16
        assert k1["ring_stages"] == (4 if bf16 else 3)
        assert k1["product"] == k3["product"] == \
            ("tensor_core" if bf16 else "fma")


def _k2_case(cuda, B, D, P, n, dtype, norm, seed=13):
    """K2's inputs with the plain lse, and a per-row cotangent that is 0 on
    one masked row (label -1) when there is more than one row."""
    s, t, lbl = _case(cuda, B, D, P, n, dtype, seed)
    if B == 1:
        lbl[0] = n // 2
    rng = np.random.default_rng(seed + 1)
    g = torch.from_numpy(rng.uniform(0.5, 1.5, size=B).astype(np.float32))
    g = (g / B).to(cuda)
    if B > 1:
        g[0] = 0.0
    m, st, _ = tx._fwd_plain(s, t, lbl, n, scale=12.0, normalize_table=norm)
    return s, t, lbl, g, tx._finish_lse(m, st)


def _assert_k2_close(dsr, dtab, dsr_p, dtab_p, lbl, P, n, tol):
    assert float((dsr - dsr_p).abs().max()) <= tol * float(dsr_p.abs().max())
    rows = torch.arange(P, device=lbl.device)
    hit = torch.zeros(P, dtype=torch.bool, device=lbl.device)
    hit[lbl[lbl >= 0].long()] = True
    for group in (hit & (rows != 2), ~hit & (rows != 2) & (rows < n),
                  rows == 2):
        err = (dtab[group].float() - dtab_p[group].float()).abs().max()
        assert float(err) <= tol * float(dtab_p[group].float().abs().max())
    assert float(dtab[n:].float().abs().max()) == 0.0   # padding rows


# K2's tiles are 64 rows of the batch and of the catalog: one row, a
# ragged batch, a width that is not a multiple of 32 and one that is not a
# multiple of 4 (staged by plain loads, not cp.async), catalogs that end
# inside a tile and inside a split; in bfloat16 the tensor cores' widths
# as K1's
@pytest.mark.parametrize("B,D,P,n", [(1, 256, 3584, 3429),
                                     (100, 100, 1000, 999),
                                     (509, 256, 4096, 4000),
                                     (37, 30, 300, 290),
                                     (130, 32, 300, 290),
                                     (200, 64, 1000, 999),
                                     (96, 16, 70, 64),
                                     (8, 132, 70, 64),
                                     (509, 258, 3584, 3429),
                                     (64, 512, 1536, 1400),
                                     (1, 513, 70, 64),
                                     (37, 1000, 300, 290)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", [True, False])
def test_k2_matches_plain_at_edge_shapes(cuda, B, D, P, n, dtype, norm):
    s, t, lbl, g, lse = _k2_case(cuda, B, D, P, n, dtype, norm)
    kw = dict(scale=12.0, normalize_table=norm)
    dsr, dtab = tx._bwd_cuda(g, s, t, lbl, lse, n, 0, **kw)
    dsr_p, dtab_p = tx._bwd_plain(g, s, t, lbl, lse, n, **kw)
    assert dsr.dtype == torch.float32 and dtab.dtype == dtype
    _assert_k2_close(dsr, dtab, dsr_p, dtab_p, lbl, P, n,
                     1e-3 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("D", [256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [3584, 37888])
def test_k2_is_deterministic(cuda, dtype, P, D):
    """No atomics: two calls on the same inputs give the same bits, with
    several row splits (P = 3,584) and with one (P = 37,888)."""
    s, t, lbl, g, lse = _k2_case(cuda, 512, D, P, P - 100, dtype, True)
    kw = dict(scale=12.0, normalize_table=True)
    first = tx._bwd_cuda(g, s, t, lbl, lse, P - 100, 0, **kw)
    second = tx._bwd_cuda(g, s, t, lbl, lse, P - 100, 0, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_autograd_runs_the_kernels_once_each(cuda):
    B, D, P, n = 48, 128, 1024, 1000
    s, t, lbl = _case(cuda, B, D, P, n, torch.float32, seed=3)
    lbl[0] = 5
    s1, t1 = s.clone().requires_grad_(True), t.clone().requires_grad_(True)
    with profiling.tracing():
        tx.catalog_xent(s1, t1, lbl, scale=12.0, num_items=n,
                        normalize_table=True).mean().backward()
        counts = profiling.snapshot()["counts"]
    assert (counts.get("xent.fwd"), counts.get("xent.bwd")) == (1, 1)
    s2, t2 = s.clone().requires_grad_(True), t.clone().requires_grad_(True)
    tx.reference_xent(s2, t2, lbl, scale=12.0, num_items=n,
                      normalize_table=True).mean().backward()
    torch.testing.assert_close(s1.grad, s2.grad, rtol=1e-3, atol=1e-6)
    keep = torch.arange(P, device=cuda) != 2
    torch.testing.assert_close(t1.grad[keep], t2.grad[keep], rtol=1e-3,
                               atol=1e-6)


def test_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    s, t, lbl = _case(cuda, 8, 64, 512, 500, torch.float32)
    kw = dict(scale=12.0, normalize_table=True)
    with pytest.raises(TypeError):
        tx._fwd_cuda(s.double(), t.double(), lbl, 500, 0, **kw)
    with pytest.raises(TypeError):
        tx._fwd_cuda(s, t, lbl.long(), 500, 0, **kw)
    with pytest.raises(ValueError):
        tx._fwd_cuda(s.t().contiguous().t(), t, lbl, 500, 0, **kw)
    empty = torch.zeros(8, 0, device=cuda)
    with pytest.raises(ValueError):
        tx._fwd_cuda(empty, torch.zeros(512, 0, device=cuda), lbl, 500, 0,
                     **kw)


def test_slab_count_is_one_up_to_256_features(cuda):
    """The one-pass kernels up to 256 features, ceil(D / 256) slabs past
    (csrc/tiles.cuh; the host layout tests/test_torch_wide.py covers)."""
    assert [tx.slabs(D) for D in (1, 255, 256, 257, 512, 513, 1000)] == \
        [1, 1, 1, 2, 2, 3, 4]


def _multi_case(cuda, K, B, D, P, n, N, dtype, seed=11):
    rng = np.random.default_rng(seed)
    sr3 = rng.normal(size=(K, B, D)).astype(np.float32)
    sr3 /= np.linalg.norm(sr3, axis=-1, keepdims=True)
    tab = torch.from_numpy(rng.normal(size=(P, D)).astype(np.float32)) / 16
    tab[2] = 0.0                                    # a zero-norm row
    iids = rng.integers(0, n, size=(B, N)).astype(np.int32)
    lens = rng.integers(1, N + 1, size=B)
    iids[np.arange(N)[None, :] >= lens[:, None]] = -1
    iids[1] = -1                                    # no session item
    labels = rng.integers(0, n, size=B).astype(np.int32)
    labels[::2] = np.maximum(iids[::2, 0], 0)       # in-session labels
    labels[3] = -1                                  # an off-shard label
    g = torch.from_numpy(rng.normal(size=(3, K, B)).astype(np.float32)) / B
    return (torch.from_numpy(sr3).to(cuda, dtype), tab.to(cuda, dtype),
            torch.from_numpy(labels).to(cuda),
            torch.from_numpy(iids).to(cuda), g.to(cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", [True, False])
def test_multi_kernels_match_plain(cuda, dtype, norm):
    K, B, D, P, n, N = 3, 96, 256, 1536, 1400, 19
    s, t, lbl, iids, g = _multi_case(cuda, K, B, D, P, n, N, dtype)
    kw = dict(scale=12.0, normalize_table=norm)
    got = txm._fwd_cuda(s, t, lbl, iids, n, 0, **kw)
    want = txm._fwd_plain(s, t, lbl, iids, n, 0, **kw)
    _assert_k3_close(got, want)
    lse = (txm._finish(want[0], want[1]), txm._finish(want[2], want[3]))
    dsr, dtab = txm._bwd_cuda(*g, s, t, lbl, iids, *lse, n, 0, **kw)
    dsr_p, dtab_p = txm._bwd_plain(*g, s, t, lbl, iids, *lse, n, 0, **kw)
    _assert_k4_close(dsr, dtab, dsr_p, dtab_p, lbl, iids, P, n,
                     1e-3 if dtype == torch.float32 else 1e-2)


def _assert_k3_close(got, want):
    for a, b in zip(got, want):
        assert float(((a - b).abs() / b.abs().clamp(min=1.0)).max()) <= 1e-5


def _assert_k4_close(dsr, dtab, dsr_p, dtab_p, lbl, iids, P, n, tol):
    """d_sr to tol of its largest magnitude; d_table by groups of rows,
    each to its own: rows hit by a label, rows hit only by session items,
    the other live rows, the zero-norm row; padding rows exactly 0."""
    assert float((dsr - dsr_p).abs().max()) <= tol * float(dsr_p.abs().max())
    rows = torch.arange(P, device=lbl.device)
    hit = torch.zeros(P, dtype=torch.bool, device=lbl.device)
    hit[lbl[lbl >= 0].long()] = True
    sess = torch.zeros(P, dtype=torch.bool, device=lbl.device)
    sess[iids[iids >= 0].long()] = True
    for group in (hit & (rows != 2), sess & ~hit & (rows != 2),
                  ~hit & ~sess & (rows != 2) & (rows < n), rows == 2):
        if not bool(group.any()):
            continue
        err = (dtab[group].float() - dtab_p[group].float()).abs().max()
        assert float(err) <= tol * float(dtab_p[group].float().abs().max())
    if P > n:
        assert float(dtab[n:].float().abs().max()) == 0.0   # padding rows


def _multi_edge_case(cuda, B, D, P, n, dtype, norm, K=3, N=19, seed=17):
    """K3/K4 inputs at any B >= 1 and P >= 1 (the edge rows of
    ``_multi_case`` where they exist), and K4's cotangents and the plain
    stats' log-partitions."""
    rng = np.random.default_rng(seed)
    sr3 = rng.normal(size=(K, B, D)).astype(np.float32)
    sr3 /= np.linalg.norm(sr3, axis=-1, keepdims=True)
    tab = torch.from_numpy(rng.normal(size=(P, D)).astype(np.float32)) / 16
    if P > 2:
        tab[2] = 0.0                                # a zero-norm row
    iids = rng.integers(0, n, size=(B, N)).astype(np.int32)
    lens = rng.integers(1, N + 1, size=B)
    iids[np.arange(N)[None, :] >= lens[:, None]] = -1
    labels = rng.integers(0, n, size=B).astype(np.int32)
    labels[::2] = np.maximum(iids[::2, 0], 0)       # in-session labels
    if B > 3:
        iids[1] = -1                                # no session item
        labels[3] = -1                              # an off-shard label
    g = torch.from_numpy(rng.normal(size=(3, K, B)).astype(np.float32)) / B
    s = torch.from_numpy(sr3).to(cuda, dtype)
    t = tab.to(cuda, dtype)
    lbl = torch.from_numpy(labels).to(cuda)
    ids = torch.from_numpy(iids).to(cuda)
    st = txm._fwd_plain(s, t, lbl, ids, n, 0, scale=12.0,
                        normalize_table=norm)
    lse = (txm._finish(st[0], st[1]), txm._finish(st[2], st[3]))
    return s, t, lbl, ids, g.to(cuda), st, lse


# K3/K4's tiles are 64 of the K * B rows and 64 catalog rows: one batch row
# (3 rows), a ragged batch (1,527 rows), widths that are not multiples of
# 4 (plain loads, not cp.async) or of 32, at most 128 (one half of the
# accumulators; in bfloat16 two or four feature pairs a warp at 32 and 64),
# catalogs of one row, one tile, one tile and a few rows
@pytest.mark.parametrize("B,D,P,n", [(1, 256, 3584, 3429),
                                     (509, 256, 3584, 3429),
                                     (509, 32, 640, 600),
                                     (96, 64, 3584, 3429),
                                     (96, 16, 70, 64),
                                     (37, 30, 64, 60),
                                     (509, 132, 1, 1),
                                     (8, 132, 70, 70),
                                     (509, 258, 3584, 3429),
                                     (64, 512, 1536, 1400),
                                     (1, 513, 70, 64),
                                     (37, 1000, 300, 290)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", [True, False])
def test_multi_kernels_match_plain_at_edge_shapes(cuda, B, D, P, n, dtype,
                                                  norm):
    s, t, lbl, iids, g, want, lse = _multi_edge_case(cuda, B, D, P, n, dtype,
                                                     norm)
    kw = dict(scale=12.0, normalize_table=norm)
    _assert_k3_close(txm._fwd_cuda(s, t, lbl, iids, n, 0, **kw), want)
    dsr, dtab = txm._bwd_cuda(*g, s, t, lbl, iids, *lse, n, 0, **kw)
    dsr_p, dtab_p = txm._bwd_plain(*g, s, t, lbl, iids, *lse, n, 0, **kw)
    assert dsr.dtype == torch.float32 and dtab.dtype == dtype
    _assert_k4_close(dsr, dtab, dsr_p, dtab_p, lbl, iids, P, n,
                     1e-3 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("D", [256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", [True, False])
def test_multi_kernels_match_plain_on_a_catalog_shard(cuda, dtype, norm, D):
    """K3 and K4 on rank (0, 1)'s shard with the mesh's operands (labels
    shifted into the shard, -1 elsewhere; n_valid its 1,637 real rows;
    col_offset 1,792 for the global session ids): their plain versions'
    numbers, K4 against the whole catalog's log-partitions."""
    K, B, N = 3, 256, 19
    s, t, lbl, iids, g = _multi_case(cuda, K, B, D, SHARD_P, SHARD_ITEMS, N,
                                     dtype)
    kw = dict(scale=12.0, normalize_table=norm)
    whole = txm._fwd_plain(s, t, lbl, iids, SHARD_ITEMS, 0, **kw)
    lse = (txm._finish(whole[0], whole[1]), txm._finish(whole[2], whole[3]))
    shard = t[SHARD_ROWS:].contiguous()
    lk, n_valid, offset = _shard_operands(cuda, txm, lbl)
    assert n_valid == SHARD_ITEMS - SHARD_ROWS
    _assert_k3_close(txm._fwd_cuda(s, shard, lk, iids, n_valid, offset,
                                   **kw),
                     txm._fwd_plain(s, shard, lk, iids, n_valid, offset,
                                    **kw))
    dsr, dtab = txm._bwd_cuda(*g, s, shard, lk, iids, *lse, n_valid, offset,
                              **kw)
    dsr_p, dtab_p = txm._bwd_plain(*g, s, shard, lk, iids, *lse, n_valid,
                                   offset, **kw)
    local = iids - offset
    local = torch.where((local >= 0) & (local < SHARD_ROWS), local, -1)
    _assert_k4_close(dsr, dtab, dsr_p, dtab_p, lk, local, SHARD_ROWS,
                     n_valid, 1e-3 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("D", [256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [3584, 37888])
def test_k4_is_deterministic(cuda, dtype, P, D):
    """No atomics: two calls on the same inputs give the same bits, with
    several row splits (P = 3,584) and with one (P = 37,888)."""
    s, t, lbl, iids, g, _, lse = _multi_edge_case(cuda, 512, D, P, P - 100,
                                                  dtype, True)
    kw = dict(scale=12.0, normalize_table=True)
    first = txm._bwd_cuda(*g, s, t, lbl, iids, *lse, P - 100, 0, **kw)
    second = txm._bwd_cuda(*g, s, t, lbl, iids, *lse, P - 100, 0, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("D", [256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [3584, 37888])
def test_k3_is_deterministic(cuda, dtype, P, D):
    """No atomics: two calls on the same inputs give the same bits, past
    256 features through the chunk ring too, on both catalogs' splits."""
    s, t, lbl, iids, _, _, _ = _multi_edge_case(cuda, 512, D, P, P - 100,
                                                dtype, True)
    kw = dict(scale=12.0, normalize_table=True)
    first = txm._fwd_cuda(s, t, lbl, iids, P - 100, 0, **kw)
    second = txm._fwd_cuda(s, t, lbl, iids, P - 100, 0, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_multi_autograd_runs_the_kernels_once_each(cuda):
    K, B, D, P, n, N = 3, 40, 128, 1024, 1000, 7
    s, t, lbl, iids, _ = _multi_case(cuda, K, B, D, P, n, N, torch.float32,
                                     seed=5)
    lbl[3] = 5
    rng = np.random.default_rng(2)
    phi = torch.softmax(torch.from_numpy(
        rng.normal(size=(B, K, 2)).astype(np.float32)), -1).to(cuda)
    alpha = torch.tensor([1.0, 0.0, 0.0], device=cuda)
    valid = torch.ones(B, device=cuda)
    kw = dict(scale=12.0, num_items=n, normalize_table=True, extra=True,
              fusion=True)
    sr = s.transpose(0, 1).contiguous()
    s1, t1 = sr.clone().requires_grad_(True), t.clone().requires_grad_(True)
    with profiling.tracing():
        txm.multi_nll_loss(s1, t1, lbl, valid, iids, phi, alpha,
                           **kw).backward()
        counts = profiling.snapshot()["counts"]
    assert (counts.get("xent_multi.fwd"), counts.get("xent_multi.bwd")) \
        == (1, 1)
    s2, t2 = sr.clone().requires_grad_(True), t.clone().requires_grad_(True)
    zl, lin, lex = txm.reference_multi_stats(
        s2.transpose(0, 1), t2, lbl, iids, scale=12.0, num_items=n,
        normalize_table=True)
    per_row = txm.combine_stats(zl, lin, lex, phi, alpha,
                                torch.any(iids == lbl[:, None], dim=1),
                                extra=True, fusion=True)
    per_row.mean().backward()
    torch.testing.assert_close(s1.grad, s2.grad, rtol=1e-3, atol=1e-6)
    keep = torch.arange(P, device=cuda) != 2
    torch.testing.assert_close(t1.grad[keep], t2.grad[keep], rtol=1e-3,
                               atol=1e-6)


def test_multi_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    s, t, lbl, iids, _ = _multi_case(cuda, 3, 8, 64, 512, 500, 5,
                                     torch.float32)
    kw = dict(scale=12.0, normalize_table=True)
    with pytest.raises(TypeError):
        txm._fwd_cuda(s, t, lbl, iids.long(), 500, 0, **kw)
    with pytest.raises(ValueError):
        txm._fwd_cuda(s[0], t, lbl, iids, 500, 0, **kw)
    with pytest.raises(ValueError):
        txm._fwd_cuda(s.transpose(1, 2).contiguous().transpose(1, 2), t,
                      lbl, iids, 500, 0, **kw)
    other_rows = torch.zeros(9, 5, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        txm._fwd_cuda(s, t, lbl, other_rows, 500, 0, **kw)


# session item lists past 256 (the paper head at --max-len above 256): the
# membership scan walks any list, at the one-pass width and past it
@pytest.mark.parametrize("N", [300, 1024])
@pytest.mark.parametrize("D", [256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multi_kernels_match_plain_with_long_item_lists(cuda, N, D, dtype):
    s, t, lbl, iids, g, want, lse = _multi_edge_case(
        cuda, 512, D, 3584, 3429, dtype, True, N=N)
    assert iids.shape[1] == N and int((iids >= 0).sum(1).max()) > 256
    kw = dict(scale=12.0, normalize_table=True)
    _assert_k3_close(txm._fwd_cuda(s, t, lbl, iids, 3429, 0, **kw), want)
    dsr, dtab = txm._bwd_cuda(*g, s, t, lbl, iids, *lse, 3429, 0, **kw)
    dsr_p, dtab_p = txm._bwd_plain(*g, s, t, lbl, iids, *lse, 3429, 0, **kw)
    _assert_k4_close(dsr, dtab, dsr_p, dtab_p, lbl, iids, 3584, 3429,
                     1e-3 if dtype == torch.float32 else 1e-2)


# K2 and K4 past 256 features with the dz scratch cap lowered to 8 of K2's
# catalog tiles: K2's 24 tiles go in 3 chunks, K4's (3 x 128 rows) in 12
@pytest.mark.parametrize("D", [512, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", [True, False])
def test_slab_backward_in_catalog_chunks(cuda, monkeypatch, D, dtype, norm):
    B, P, n = 128, 1536, 1400
    esz = torch.empty((), dtype=dtype).element_size()
    monkeypatch.setattr(tx, "DZ_SCRATCH_BYTES", 8 * B * 64 * esz)
    assert [tx.slab_bwd_plan(r, P, esz, 1, 2)["chunks"]
            for r in (B, 3 * B)] == [3, 12]
    kw = dict(scale=12.0, normalize_table=norm)
    tol = 1e-3 if dtype == torch.float32 else 1e-2
    s, t, lbl, g, lse = _k2_case(cuda, B, D, P, n, dtype, norm)
    first = tx._bwd_cuda(g, s, t, lbl, lse, n, 0, **kw)
    second = tx._bwd_cuda(g, s, t, lbl, lse, n, 0, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _assert_k2_close(*first, *tx._bwd_plain(g, s, t, lbl, lse, n, **kw),
                     lbl, P, n, tol)
    s, t, lbl, iids, g, _, lse = _multi_edge_case(cuda, B, D, P, n, dtype,
                                                  norm)
    first = txm._bwd_cuda(*g, s, t, lbl, iids, *lse, n, 0, **kw)
    second = txm._bwd_cuda(*g, s, t, lbl, iids, *lse, n, 0, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _assert_k4_close(*first, *txm._bwd_plain(*g, s, t, lbl, iids, *lse, n,
                                             0, **kw),
                     lbl, iids, P, n, tol)


@pytest.mark.parametrize("D", [64, 256, 512])
def test_tensor_core_kernels_take_rows_off_16_byte_alignment(cuda, D):
    """bfloat16 rows that start 8 bytes off 16 (four-element aligned, so
    the wrapper's vec holds) go by plain loads, not 16-byte cp.async: K1
    and K2, and K4 with its K * B rows; at 512 the slab kernels."""
    B, P, n = 100, 1000, 999
    s, t, lbl = _k1_case(cuda, B, D, P, n, torch.bfloat16)
    buf = torch.empty(B * D + 4, device=cuda, dtype=torch.bfloat16)
    off = buf[4:].view(B, D)
    off.copy_(s)
    assert off.data_ptr() % 16 == 8 and off.is_contiguous()
    got = tx._fwd_cuda(off, t, lbl, n, 0, scale=12.0, normalize_table=True)
    _assert_k1_close(got, s, t, lbl, n, 0, True)
    g = torch.full((B,), 1.0 / B, device=cuda)
    kw = dict(scale=12.0, normalize_table=True)
    dsr, dtab = tx._bwd_cuda(g, off, t, lbl, got[1], n, 0, **kw)
    dsr_p, dtab_p = tx._bwd_plain(g, s, t, lbl, got[1], n, **kw)
    _assert_k2_close(dsr, dtab, dsr_p, dtab_p, lbl, P, n, 1e-2)
    s3, t, lbl, iids, g3, _, lse = _multi_edge_case(cuda, B, D, P, n,
                                                    torch.bfloat16, True)
    buf = torch.empty(s3.numel() + 4, device=cuda, dtype=torch.bfloat16)
    off3 = buf[4:].view(s3.shape)
    off3.copy_(s3)
    assert off3.data_ptr() % 16 == 8 and off3.is_contiguous()
    dsr, dtab = txm._bwd_cuda(*g3, off3, t, lbl, iids, *lse, n, 0, **kw)
    dsr_p, dtab_p = txm._bwd_plain(*g3, s3, t, lbl, iids, *lse, n, 0, **kw)
    _assert_k4_close(dsr, dtab, dsr_p, dtab_p, lbl, iids, P, n, 1e-2)


@pytest.mark.parametrize("D", [16, 30, 64, 132, 256])
def test_tensor_core_kernels_spill_nothing(cuda, D):
    """In bfloat16 up to 256 features K1's, K2's, K3's and K4's product
    kernels run on the tensor cores and keep everything in registers (no
    local memory), two blocks an SM; float32 stays on the FMA pipes."""
    s = torch.zeros(512, D, device=cuda, dtype=torch.bfloat16)
    k1, k2 = tx.fwd_launch_shape(s, 3584), tx.bwd_launch_shape(s, 3584)
    multi = txm.multi_launch_shape(s.expand(3, 512, D), 3584)
    assert k1["product"] == k2["product"] == multi["k3"]["product"] == \
        multi["k4"]["product"] == "tensor_core"
    assert k1["local_bytes"] == multi["local_bytes"]["fwd"] == 0
    assert k2["local_bytes"] == {"dtable": 0, "dsr": 0}
    assert multi["local_bytes"]["dtable"] == multi["local_bytes"]["dsr"] == 0
    assert k1["resident_per_sm"] >= 2 and k2["resident_per_sm"] >= 2
    assert multi["k3"]["resident_per_sm"] >= 2
    assert multi["k4"]["resident_per_sm"] >= 2
    f32 = torch.zeros(512, D, device=cuda)
    assert tx.fwd_launch_shape(f32, 3584)["product"] == \
        tx.bwd_launch_shape(f32, 3584)["product"] == "fma"
    f32_multi = txm.multi_launch_shape(f32.expand(3, 512, D), 3584)
    assert f32_multi["k3"]["product"] == f32_multi["k4"]["product"] == "fma"


@pytest.mark.parametrize("D", [258, 512, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_slab_kernels_spill_nothing(cuda, D, dtype):
    """K2's and K4's dz kernels and the two products past 256 features keep
    everything in registers (at most 255 a thread, no local memory), and
    the products fit two blocks on an SM: on the tensor cores in bfloat16,
    on the FMA pipes in float32."""
    s = torch.zeros(512, D, device=cuda, dtype=dtype)
    for shape in (tx.bwd_launch_shape(s, 3584),
                  txm.multi_launch_shape(s.expand(3, 512, D), 3584)):
        for k in ("dz", "dtable", "dsr"):
            assert shape["registers"][k] <= 255
            assert shape["local_bytes"][k] == 0
    k2 = tx.bwd_launch_shape(s, 3584)
    assert k2["resident_per_sm"] >= 2 and k2["dz_resident_per_sm"] >= 2
    want = "tensor_core" if dtype == torch.bfloat16 else "fma"
    multi = txm.multi_launch_shape(s.expand(3, 512, D), 3584)
    assert k2["product"] == multi["k4"]["product"] == want


@pytest.mark.parametrize("D,bf16,f32", [(258, 144, 132), (512, 256, 256),
                                        (513, 176, 172), (1000, 256, 252)])
def test_bf16_slab_widths_start_on_a_k_step(cuda, D, bf16, f32):
    """Past 256 features the slabs of the backward's products start on a
    multiple of 16 features in bfloat16 (a tensor-core k step: 16-byte
    aligned ldmatrix rows and cp.async copies) and of 4 in float32; every
    slab at most 256 wide and none empty."""
    assert tx.slab_width(D, torch.bfloat16) == bf16
    assert tx.slab_width(D, torch.float32) == f32
    for sw in (bf16, f32):
        n = tx.slabs(D)
        assert sw <= 256 and 0 < D - (n - 1) * sw <= sw
