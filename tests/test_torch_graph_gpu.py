"""The runner's CUDA graphs against its plain steps, on the card: from one
state (parameters, Adam's moments and step counts, the schedule, the
dropout counter), 8 steps through the captured 8-step graph and the same
8 batches through the plain ``train_step`` give the same losses (rtol
1e-4) and parameters (atol 1e-5), the bars of tests/test_torch_train.py;
so does a tail chunk shorter than ``unroll`` through the one-step graph.
The graphs replay the kernels, which have no interpret mode, so without a
card every test here skips.  No JAX is imported:

    python -m pytest --noconftest tests/test_torch_graph_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from sessionrec_tpu_torch.data.loader import BatchLoader
from sessionrec_tpu_torch.models import MSGIFSR
from sessionrec_tpu_torch.train.runner import TrainRunner

pytestmark = pytest.mark.gpu

PATHS = {"order1": dict(order=1),
         "paper": dict(order=3, extra=True, fusion=True)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no "
                    "interpret mode)")
    return torch.device("cuda")


def _runner(cuda, kw, unroll):
    rng = np.random.default_rng(0)
    sess = [list(map(int, rng.integers(0, 300, size=int(rng.integers(2, 16)))))
            for _ in range(300)]
    loader = BatchLoader(sess, "ccs", 64, 15, split_len=(4, 8),
                         order=kw["order"])
    model = MSGIFSR(300, 64, 1, feat_drop=0.1, **kw)
    runner = TrainRunner(model, loader, [], seed=3, unroll=unroll,
                         lr_step_size=1, device=cuda,
                         eval_before_train=False)
    batches = cs.first_batches(loader, 2 * unroll)
    runner.run_chunk(batches[:unroll])          # eager: Adam's state exists
    return runner, batches[unroll:]


def _graph_vs_plain(runner, batches):
    got, want, gaps = cs.graph_vs_plain(torch, runner, batches)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
    assert max(gaps.values()) <= 1e-5, gaps


@pytest.mark.parametrize("path", PATHS)
def test_graph_matches_plain_over_8_steps(cuda, path):
    runner, batches = _runner(cuda, PATHS[path], 8)
    _graph_vs_plain(runner, batches)
    g = runner.graphs[8]
    assert set(runner.graphs) == {8} and g.replays == 1
    k1 = PATHS[path]["order"] == 1
    assert g.captured["xent_fwd"] == g.captured["xent_bwd"] == 8 * k1
    assert g.captured["xent_multi_fwd"] == 8 * (not k1)


@pytest.mark.parametrize("path", PATHS)
def test_tail_chunk_runs_its_real_steps_only(cuda, path):
    """A chunk of 3 under unroll 4: three replays of the one-step graph,
    three steps on the schedule and the dropout counter."""
    runner, batches = _runner(cuda, PATHS[path], 4)
    count = int(runner.sched.count)
    _graph_vs_plain(runner, batches[:3])
    assert set(runner.graphs) == {1} and runner.graphs[1].replays == 3
    assert int(runner.sched.count) == int(runner.seeds.count) == count + 3
    assert runner.steps == 4 + 3 + 3
