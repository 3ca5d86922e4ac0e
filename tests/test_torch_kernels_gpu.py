"""The port's CUDA kernels (csrc/xent.cu) against their plain PyTorch
versions, on the card.  CUDA kernels have no interpret mode, so without a
card every test here skips.  This file imports nothing of JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu

Tolerances: K1 rtol 1e-5 / atol 1e-4 (the same float32 products summed
in another order); K2 1e-3 (float32) or 1e-2 (bfloat16) of the largest
reference magnitude, for d_table in each group of rows, since dz and a
bfloat16 d_table are rounded.
"""

import numpy as np
import pytest
import torch

from sessionrec_tpu_torch.ops import xent as tx

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


def test_autograd_runs_the_kernels_once_each(cuda):
    B, D, P, n = 48, 128, 1024, 1000
    s, t, lbl = _case(cuda, B, D, P, n, torch.float32, seed=3)
    lbl[0] = 5
    s1, t1 = s.clone().requires_grad_(True), t.clone().requires_grad_(True)
    tx.reset_launches()
    tx.catalog_xent(s1, t1, lbl, scale=12.0, num_items=n,
                    normalize_table=True).mean().backward()
    assert (tx.fwd_launches, tx.bwd_launches) == (1, 1)
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
    wide = torch.zeros(8, 512, device=cuda)
    with pytest.raises(ValueError):
        tx._fwd_cuda(wide, torch.zeros(512, 512, device=cuda), lbl, 500, 0,
                     **kw)
