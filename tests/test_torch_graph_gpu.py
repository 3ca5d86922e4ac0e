"""The runner's CUDA graphs against its plain steps, on the card: from one
state (parameters, Adam's moments and step counts, the schedule, the
dropout counter), 8 steps through the captured 8-step graph and the same
8 batches through the plain ``train_step`` give the same losses (rtol
1e-4) and parameters (atol 1e-5), the bars of tests/test_torch_train.py;
so does a tail chunk shorter than ``unroll`` through the one-step graph.
The eval graphs give the eager sweep's (hit, mrr, n) sums, a tail
shorter than ``unroll`` included; a run resumed from a checkpoint on the
card matches the uninterrupted one within the same bars; and the
recommend step's graph gives the CPU's top-k.  The graphs replay the
kernels, which have no interpret mode, so without a card every test here
skips.  No JAX is imported:

    python -m pytest --noconftest tests/test_torch_graph_gpu.py -m gpu
"""

import contextlib
import copy
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

import chip_smoke as cs
from sessionrec_tpu_torch import serving
from sessionrec_tpu_torch.data.loader import BatchLoader
from sessionrec_tpu_torch.models import MSGIFSR
from sessionrec_tpu_torch.train.runner import (TrainRunner, eager_sums,
                                               launches)
from sessionrec_tpu_torch.utils import profiling
from sessionrec_tpu_torch.utils.checkpoint import Checkpointer

pytestmark = pytest.mark.gpu

PATHS = {"order1": dict(order=1),
         "paper": dict(order=3, extra=True, fusion=True)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no "
                    "interpret mode)")
    return torch.device("cuda")


def _sessions(seed, n):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, 300, size=int(rng.integers(2, 16)))))
            for _ in range(n)]


def _fresh_runner(cuda, kw, unroll, ckpt=None, test=()):
    loader = BatchLoader(_sessions(0, 300), "ccs", 64, 15, split_len=(4, 8),
                         order=kw["order"])
    model = MSGIFSR(300, 64, 1, feat_drop=0.1, **kw)
    return TrainRunner(model, loader, test, seed=3, unroll=unroll,
                       lr_step_size=1, device=cuda, eval_before_train=False,
                       checkpointer=Checkpointer(ckpt) if ckpt else None)


def _runner(cuda, kw, unroll):
    runner = _fresh_runner(cuda, kw, unroll)
    loader = runner.train_loader
    batches = cs.first_batches(loader, 2 * unroll)
    runner.run_chunk(batches[:unroll])          # eager: Adam's state exists
    return runner, batches[unroll:]


def _graph_vs_plain(runner, batches):
    got, want, gaps = cs.graph_vs_plain(torch, runner, batches)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
    assert max(gaps.values()) <= 1e-5, gaps


@pytest.mark.parametrize("path", PATHS)
def test_untraced_graph_matches_plain_over_8_steps(cuda, path):
    """The capture that the CLI and the benchmark's timed windows run:
    tracing off, so the graph has no map and the registry stays empty."""
    profiling.enable(False)
    profiling.reset()
    runner, batches = _runner(cuda, PATHS[path], 8)
    _graph_vs_plain(runner, batches)
    g = runner.graphs[8]
    assert set(runner.graphs) == {8} and g.replays == 1
    assert (g.nodes, g.owners, g.counts) == (None, [], {})
    assert profiling.snapshot() == {"spans": {}, "counts": {}}


@pytest.mark.parametrize("path", PATHS)
def test_graph_matches_plain_over_8_steps(cuda, path):
    runner, batches = _runner(cuda, PATHS[path], 8)
    with profiling.tracing():
        _graph_vs_plain(runner, batches)
    g = runner.graphs[8]
    assert set(runner.graphs) == {8} and g.replays == 1
    k1 = PATHS[path]["order"] == 1
    got = {k: g.counts.get(k, 0) for k in ("xent.fwd", "xent.bwd",
                                           "xent_multi.fwd", "embed.bwd")}
    assert got == {"xent.fwd": 8 * k1, "xent.bwd": 8 * k1,
                   "xent_multi.fwd": 8 * (not k1), "embed.bwd": 8}
    assert launches(g) == {k: n * g.replays for k, n in g.counts.items()}


def _replay_events(trace):
    """``[[device event]]`` of each ``cudaGraphLaunch`` in a Chrome trace,
    by its correlation id, each sorted by start."""
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    launches = [e["args"]["correlation"] for e in ev
                if e.get("cat") == "cuda_runtime"
                and e["name"].startswith("cudaGraphLaunch")]
    return [sorted((e for e in ev if e.get("cat") in
                    ("kernel", "gpu_memcpy", "gpu_memset")
                    and e.get("args", {}).get("correlation") == c),
                   key=lambda e: e["ts"]) for c in launches]


@pytest.mark.parametrize("path", PATHS)
def test_a_replay_zips_with_its_capture_map(cuda, path, tmp_path):
    """Captured with tracing on, a graph's replay under the profiler shows
    one device event a node, in node order: K1-K4 fall under ``loss``,
    the gather's backward (``csrc/embed_bwd.cu``, torch's index backward
    nowhere) under ``model.embed``'s backward, and few events under no
    span."""
    runner, batches = _runner(cuda, PATHS[path], 4)
    with profiling.tracing():
        runner.run_chunk(batches[:4])     # the capture and its replay
    g = runner.graphs[4]
    assert g.nodes > 0 and g.owners and g.owners[-1].end <= g.nodes
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        runner.run_chunk(batches[:4])
        torch.cuda.synchronize()
        time.sleep(0.5)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    (events,) = _replay_events(json.loads((tmp_path / "trace.json")
                                          .read_text()))
    assert len(events) == g.nodes
    who = ["other"] * g.nodes
    for o in g.owners:
        who[o.first:o.end] = [f"{o.span}.{o.direction}"] * (o.end - o.first)
    owned = list(zip(who, (e["name"] for e in events)))
    assert {w for w, n in owned if "xent_" in n} == {"loss.fwd", "loss.bwd"}
    assert {w for w, n in owned if "embed_bwd_" in n} == {"model.embed.bwd"}
    assert not any("indexing_backward" in n for _, n in owned)
    assert sum(w == "other" for w, _ in owned) < 0.02 * len(owned)


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


def _two_sweeps(cuda, path, traced):
    """Two sweeps of 11 test batches under unroll 4 against the eager
    sums, tracing on or off; the runner and the batches."""
    kw = PATHS[path]
    test = BatchLoader(_sessions(1, 90), "ccs", 64, 15, split_len=(4, 8),
                       order=kw["order"])
    runner = _fresh_runner(cuda, kw, 4, test=test)
    batches = list(test)
    assert len(batches) % 4
    want = eager_sums(runner.model, batches, 20, cuda)
    profiling.enable(False)
    profiling.reset()
    with profiling.tracing() if traced else contextlib.nullcontext():
        for _ in range(2):
            torch.testing.assert_close(runner.eval_sweep(), want, rtol=0,
                                       atol=1e-6)
    assert set(runner.eval_graphs) == {4, 1}
    assert runner.eval_graphs[4].replays == 2 * (len(batches) // 4) - 1
    assert runner.eval_graphs[1].replays == 2 * (len(batches) % 4)
    return runner, batches


@pytest.mark.parametrize("path", PATHS)
def test_eval_graph_matches_the_eager_sweep(cuda, path):
    """Two sweeps of 11 test batches under unroll 4: the first runs its
    first chunk eagerly and captures the 4-batch and the 1-batch graphs,
    the second only replays; both give the eager sums."""
    runner, _ = _two_sweeps(cuda, path, traced=True)
    assert not any(k.startswith("xent") for k in runner.eval_graphs[4].counts)


@pytest.mark.parametrize("path", PATHS)
def test_untraced_eval_graph_matches_the_eager_sweep(cuda, path):
    """The same sweeps with tracing off, as the CLI runs them: no map, an
    empty registry."""
    runner, _ = _two_sweeps(cuda, path, traced=False)
    g = runner.eval_graphs[4]
    assert (g.nodes, g.owners, g.counts) == (None, [], {})
    assert profiling.snapshot() == {"spans": {}, "counts": {}}


@pytest.mark.parametrize("path", PATHS)
def test_resume_on_the_card_matches_the_uninterrupted_run(cuda, path,
                                                         tmp_path):
    kw = PATHS[path]
    full = _fresh_runner(cuda, kw, 8, tmp_path / "full")
    full.train(2, log_interval=10 ** 9)
    _fresh_runner(cuda, kw, 8, tmp_path / "ab").train(1,
                                                      log_interval=10 ** 9)
    b = _fresh_runner(cuda, kw, 8, tmp_path / "ab")
    assert b.checkpointer.restore_latest(b)
    assert b.opt.state[b.params[0]]["step"].device.type == "cuda"
    b.train(2, log_interval=10 ** 9)
    half = len(full.losses) // 2
    torch.testing.assert_close(torch.tensor(b.losses),
                               torch.tensor(full.losses[half:]),
                               rtol=1e-4, atol=0)
    mine = dict(b.model.named_parameters())
    gaps = {n: cs.max_err(mine[n].detach(), p.detach()) for n, p in
            full.model.named_parameters()}
    assert max(gaps.values()) <= 1e-5, gaps
    assert b.bad_counter == full.bad_counter and b.steps == full.steps


@pytest.mark.parametrize("path", PATHS)
def test_recommend_step_matches_the_cpu(cuda, path):
    kw = PATHS[path]
    model = MSGIFSR(300, 64, 1, **kw)
    model.reset_parameters(torch.Generator().manual_seed(5))
    cpu_model = copy.deepcopy(model)
    model.to(cuda)
    sess = _sessions(2, 70)
    opts = dict(max_len=15, batch_size=16, order=kw["order"])
    got = list(serving.recommend(model, sess, k=10, **opts))
    want = list(serving.recommend(cpu_model, sess, k=11, **opts))
    cmp = cs.compare_recommendations(np, got, want)
    assert cmp["ok"], cmp
    step = serving.make_recommend_step(model, 10)
    for batch, _ in serving.session_batches(sess, "ccs", 16, 15,
                                            kw["order"]):
        step(batch)
    assert step.graph is not None and step.graph.replays == 4


@pytest.mark.parametrize("path", sorted(PATHS))
def test_batch_round_trips_through_the_card(cuda, path):
    """A batch moved to the card and back equals the host's arrays, also
    while the stream is busy: the copy back waits for its bytes (a
    non-blocking copy to the host returned before they had landed)."""
    loader = BatchLoader(_sessions(1, 200), "ccs", 64, 15, split_len=(4, 8),
                         order=PATHS[path]["order"], prefetch=0)
    host = next(iter(loader))
    busy = torch.randn(4096, 4096, device=cuda)
    for _ in range(3):
        on_card = host.to(cuda)
        for _ in range(8):
            busy = busy @ busy / 64.0
        back = on_card.to("cpu")
        for (name, got), (_, want) in zip(_leaves(back), _leaves(host)):
            assert np.array_equal(got.numpy(), np.asarray(want)), name


def _leaves(batch, prefix=""):
    """(dotted name, array) of every array of ``batch``, in field order."""
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        for i, e in enumerate(v if isinstance(v, tuple) else (v,)):
            name = f"{prefix}{f.name}[{i}]"
            if dataclasses.is_dataclass(e):
                yield from _leaves(e, name + ".")
            else:
                yield name, e
