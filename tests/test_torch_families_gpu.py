"""SRGNN, NISER and LESSR on the card: K1 and K2 against their plain
versions at the widths and batches of these families (D 32 and 64, B 128
and 512, on a padded and an unpadded catalog, the table normalised and
not), K2 repeating its bits; then, from one state, 8 steps through the
captured 8-step graph and the same 8 batches through the plain
``train_step`` give the same losses (rtol 1e-4), parameters (atol 1e-5)
and LESSR's BatchNorm buffers (atol 1e-5).  The kernels have no
interpret mode, so without a card every test here skips.  No JAX is
imported:

    python -m pytest --noconftest tests/test_torch_families_gpu.py -m gpu

Tolerances are those of tests/test_torch_kernels_gpu.py: K1 rtol 1e-5 /
atol 1e-4 on loss and lse, K2 1e-3 of the largest reference magnitude,
for d_table in each group of rows.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from sessionrec_tpu_torch.data.loader import BatchLoader
from sessionrec_tpu_torch.models import LESSR, NISER, SRGNN
from sessionrec_tpu_torch.ops import xent as tx
from sessionrec_tpu_torch.train.runner import TrainRunner
from sessionrec_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

MODELS = {"srgnn": (SRGNN, "session", 2), "niser": (NISER, "session", 2),
          "lessr": (LESSR, "lessr", 3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no "
                    "interpret mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("B", [128, 512])
@pytest.mark.parametrize("P,n", [(3584, 3429), (3429, 3429)])
@pytest.mark.parametrize("norm", [True, False])
def test_k1_k2_match_plain_at_the_families_shapes(cuda, D, B, P, n, norm):
    """``chip_smoke.make_inputs``: unit rows, a table in the max-norm ball
    but for one zero row and one of norm 50, a masked row."""
    s, t, lbl, g = cs.make_inputs(torch, n, P, torch.float32, 3, dev=cuda,
                                  rows=B, dim=D)
    kw = dict(scale=12.0 if norm else 1.0, normalize_table=norm)
    loss, lse = tx._fwd_cuda(s, t, lbl, n, 0, **kw)
    m, st, zl = tx._fwd_plain(s, t, lbl, n, 0, **kw)
    lse_p = tx._finish_lse(m, st)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(loss, lse_p - zl, rtol=1e-5, atol=1e-4)
    dsr, dtab = tx._bwd_cuda(g, s, t, lbl, lse_p, n, 0, **kw)
    again = tx._bwd_cuda(g, s, t, lbl, lse_p, n, 0, **kw)
    assert torch.equal(dsr, again[0]) and torch.equal(dtab, again[1])
    dsr_p, dtab_p = tx._bwd_plain(g, s, t, lbl, lse_p, n, 0, **kw)
    errs = cs.dtable_errors(torch, dtab, dtab_p, lbl, n, 1e-3)
    errs["dsr"] = cs.dsr_errors(dsr, dsr_p, 1e-3)
    assert all(e <= tol for e, tol in errs.values()), errs


def _sessions(seed, n, items=300):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, items,
                                       size=int(rng.integers(2, 16)))))
            for _ in range(n)]


@pytest.mark.parametrize("name", list(MODELS))
def test_graph_matches_plain_over_8_steps(cuda, name):
    """Parameters, losses and (LESSR) the running BatchNorm statistics:
    the graph replays the buffers' in-place update."""
    cls, kind, layers = MODELS[name]
    loader = BatchLoader(_sessions(0, 400), kind, 64, 15, split_len=(4, 8))
    model = cls(300, 32, layers, feat_drop=0.2)
    runner = TrainRunner(model, loader, [], seed=3, unroll=8, device=cuda,
                         eval_before_train=False)
    batches = cs.first_batches(loader, 16)
    runner.run_chunk(batches[:8])               # eager: Adam's state exists
    start = [t.clone() for t in runner.state_tensors()]
    with profiling.tracing():
        got = runner.run_chunk(batches[8:])
    after = {n: t.clone() for n, t in runner.named_state().items()}
    for t, v in zip(runner.state_tensors(), start):
        t.copy_(v)
    want = torch.stack([runner.train_step(b.to(cuda)) for b in batches[8:]])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
    buffers = dict(runner.model.named_buffers())
    assert bool(buffers) == (name == "lessr")
    for n, t in list(runner.model.named_parameters()) + list(buffers.items()):
        assert cs.max_err(after[n], t.detach()) <= 1e-5, n
    assert runner.graphs[8].replays == 1
    assert runner.graphs[8].counts["xent.fwd"] == 8
    assert runner.graphs[8].counts["embed.bwd"] == 8     # one gather a step
