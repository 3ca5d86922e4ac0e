"""The step profile counts the device's own work once: kernels, copies and
sets, as a union of intervals, and not the annotated ranges that span
them."""

import json

import pytest

from sessionrec_tpu_torch.utils.profiling import busy_us, device_events


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


TRACE = {"traceEvents": [
    _ev("kernel", "a", 0, 10),
    _ev("gpu_user_annotation", "Optimizer.step#Adam.step", 0, 40),
    _ev("kernel", "b", 5, 10),          # overlaps a
    _ev("kernel", "c", 6, 2),           # inside b
    _ev("gpu_memcpy", "Memcpy HtoD", 20, 5),
    _ev("gpu_memset", "Memset", 30, 1),
    _ev("cpu_op", "aten::mm", 0, 100),
    _ev("cuda_runtime", "cudaLaunchKernel", 1, 1),
    {"ph": "i", "cat": "kernel", "name": "marker", "ts": 50},
]}


def test_only_device_work_is_kept():
    names = [e[0] for e in device_events(TRACE)]
    assert names == ["a", "b", "c", "Memcpy HtoD", "Memset"]


@pytest.mark.parametrize("events,want", [
    ([], 0.0),
    ([("a", 0.0, 10.0)], 10.0),
    ([("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 6.0, 2.0)], 15.0),
    ([("b", 20.0, 5.0), ("a", 0.0, 10.0)], 15.0),
])
def test_busy_time_is_the_union_of_intervals(events, want):
    assert busy_us(events) == want


def test_busy_time_of_the_trace():
    assert busy_us(device_events(TRACE)) == 15.0 + 5.0 + 1.0


# -- spans, counters and capture maps (tracing) ------------------------------

import gc  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from sessionrec_tpu_torch import serving  # noqa: E402
from sessionrec_tpu_torch.data.loader import BatchLoader  # noqa: E402
from sessionrec_tpu_torch.models import MSGIFSR  # noqa: E402
from sessionrec_tpu_torch.train.runner import (StepGraph,  # noqa: E402
                                               TrainRunner, launches)
from sessionrec_tpu_torch.utils import profiling  # noqa: E402

MODEL_SPANS = ["model.embed", "model.graph", "model.readout", "loss",
               "step.optimizer"]
SESSIONS = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [4, 5], [6, 7, 8, 9],
            [11, 12, 13, 14, 15, 16, 17]] * 12


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and an empty
    registry."""
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def test_off_is_one_shared_no_op():
    a, b = profiling.span("x"), profiling.span("y")
    assert a is b
    with a as s:
        assert s.inputs(1) == 1 and s.outputs("o") == "o"
    profiling.count("c", 5)
    with profiling.capturing() as cmap:
        assert cmap is None
    assert profiling.snapshot() == {"spans": {}, "counts": {}}


def test_two_threads_add_up_exactly():
    n = 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        profiling.enable(True)

        def work():
            for _ in range(n):
                with profiling.span("s"):
                    profiling.count("c")
                profiling.count("c", 2)
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    snap = profiling.snapshot()
    assert snap["counts"] == {"c": 6 * n}
    s = snap["spans"]["s"]
    assert s["calls"] == 2 * n and s["seconds"] > 0


def _runner(order=1, extra=False, fusion=False):
    model = MSGIFSR(500, 16, 1, order=order, extra=extra, fusion=fusion,
                    feat_drop=0.1)
    loader = BatchLoader(SESSIONS, "ccs", 32, 20, order=order, prefetch=2,
                         split_len=(4, 8))
    return TrainRunner(model, loader, None, device="cpu",
                       eval_before_train=False), loader


def _program_spans(snap, names):
    return [n for n in snap["spans"] if n in names]


@pytest.mark.parametrize("head", [dict(), dict(order=3, extra=True,
                                               fusion=True)])
def test_a_training_step_records_its_spans_in_order(head):
    runner, loader = _runner(**head)
    with profiling.tracing():
        for chunk in [next(iter(loader))]:
            runner.run_chunk([chunk])
        snap = profiling.snapshot()
    assert _program_spans(snap, MODEL_SPANS) == MODEL_SPANS
    spans = snap["spans"]
    assert spans["loader.build"]["calls"] >= 1
    assert spans["loader.wait"]["calls"] == 1
    # one gather of every tier's and level's ids a step (ops/embed.py)
    assert spans["model.embed"]["calls"] == 1
    assert spans["step.optimizer"]["calls"] == 2


@pytest.mark.parametrize("head", [dict(), dict(order=3, extra=True,
                                               fusion=True)])
def test_a_serving_call_records_its_spans_in_order(head):
    model = MSGIFSR(500, 16, 1, **head)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with profiling.tracing():
        out = list(serving.recommend(model, SESSIONS[:5], max_len=20, k=3,
                                     order=model.order))
        snap = profiling.snapshot()
    assert len(out) == 5
    want = ["serving.build", "model.embed", "model.graph", "model.readout",
            "serve.score", "serve.topk"]
    assert _program_spans(snap, want) == want


class _Ops(TorchDispatchMode):
    """The ops run under it, in order: a CPU stand-in for a capture's
    device nodes."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def _owned(ops, cmap):
    who = [("other", "fwd")] * cmap.total
    for o in cmap.owners:
        who[o.first:o.end] = [(o.span, o.direction)] * (o.end - o.first)
    return list(zip(ops.names, who))


@pytest.mark.parametrize("head", [dict(), dict(order=3, extra=True,
                                               fusion=True)])
def test_the_capture_map_owns_each_op_of_a_step(head):
    """Two steps under a capture map that counts ops as its nodes (as a
    chunk's graph holds several): the gather's backward (``index_put``)
    under ``model.embed``'s backward in both, the plain loss under
    ``loss``, Adam under ``step.optimizer``, every span's forward and
    backward part present and few ops under none."""
    runner, loader = _runner(**head)
    batch = next(iter(loader)).to("cpu")
    runner.train_step(batch)                     # Adam's state first
    ops = _Ops()
    with profiling.tracing(), ops:
        with profiling.capturing(lambda: len(ops.names)) as cmap:
            for _ in range(2):
                runner.train_step(batch)
                gc.collect()        # the first step's spans are freed
    assert cmap.total == len(ops.names) > 0
    ends = [(o.first, o.end) for o in cmap.owners]
    assert all(a < b for a, b in ends) and ends == sorted(ends)
    owned = _owned(ops, cmap)
    parts = {w for _, w in owned}
    assert {(s, "fwd") for s in MODEL_SPANS} <= parts
    assert {(s, "bwd") for s in MODEL_SPANS[:4]} <= parts
    assert {w for n, w in owned if n == "index_put"} == {
        ("model.embed", "bwd")}
    assert {w for n, w in owned if n.startswith("_foreach")} <= {
        ("step.optimizer", "fwd")}
    assert sum(w == ("other", "fwd") for _, w in owned) < 0.02 * len(owned)


def test_sibling_backward_parts_interleave_under_their_parent():
    """Two gathers feed one span; autograd runs the parent's backward
    between theirs: each part owns its own ops, and the parent owns the
    rest until its inputs' gradients have come."""
    table = torch.randn(10, 4, requires_grad=True)
    ops = _Ops()
    with profiling.tracing(), ops:
        with profiling.capturing(lambda: len(ops.names)) as cmap:
            rows = []
            for ids in ([1, 2], [3, 4]):
                with profiling.span("embed") as s:
                    rows.append(s.outputs(table[torch.tensor(ids)]))
            with profiling.span("graph") as s:
                s.inputs(rows)
                h = s.outputs((rows[0].exp() * rows[1].sin()).sum())
            h.backward()
    owned = _owned(ops, cmap)
    assert [w for n, w in owned if n == "index_put"] == [("embed", "bwd")] * 2
    assert {w for n, w in owned if n in ("exp", "sin", "cos")} == {
        ("graph", "fwd"), ("graph", "bwd")}
    assert cmap.counts == {}


def test_launches_are_the_captured_counts_times_the_replays():
    g = StepGraph(None, None, "train.8", counts={"xent.fwd": 8,
                                                 "xent.bwd": 8}, replays=5)
    assert launches(g) == {"xent.fwd": 40, "xent.bwd": 40}
    assert launches(StepGraph(None, None, "eval.1", replays=3)) == {}


def test_the_capture_map_keeps_the_counters_it_saw():
    profiling.enable(True)
    profiling.count("xent.fwd")
    n = [0]
    with profiling.capturing(lambda: n[0]) as cmap:
        with profiling.span("loss"):
            n[0] += 2
            profiling.count("xent.fwd")
            profiling.count("xent.bwd")
        n[0] += 1
    assert cmap.counts == {"xent.fwd": 1, "xent.bwd": 1}
    assert cmap.total == 3
    assert [tuple(o) for o in cmap.owners] == [("loss", "fwd", 0, 2)]


def test_the_profile_dir_trace_holds_the_spans(tmp_path):
    runner, loader = _runner()
    batch = next(iter(loader))
    with profiling.trace(tmp_path):
        runner.run_chunk([batch])
    assert not profiling.enabled()
    (path,) = tmp_path.glob("*.json")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"] if e.get("cat") == "user_annotation"}
    assert set(MODEL_SPANS) <= names


def test_staged_bytes_count_every_tier():
    _, loader = _runner()
    batch = next(iter(loader))
    from sessionrec_tpu_torch.graph.batch import flatten_blocks
    want = sum(a.nbytes for blk in flatten_blocks(batch)
               for f in ("labels", "valid") for a in [getattr(blk, f)])
    assert batch.nbytes() > want > 0
    assert batch.to("cpu").nbytes() == batch.nbytes()


@pytest.mark.parametrize("other_nodes,want", [
    (0, [("x", "fwd", 0, 2)]),      # every node is device work: exact
    (1, [])])                       # a node of another kind: no owners
def test_owners_only_where_every_node_is_device_work(other_nodes, want):
    """The marks count every node of the capture; they index the device
    work only where the finished graph holds nothing else."""
    profiling.enable(True)
    n = [0]
    cmap = profiling.CaptureMap(lambda: n[0], lambda: n[0] - other_nodes)
    sp = profiling.span("x")
    cmap.open(sp, "fwd")
    n[0] += 2
    cmap.close(sp, "fwd")
    n[0] += 1
    cmap.finish()
    assert [tuple(o) for o in cmap.owners] == want
    assert cmap.total == 3 - other_nodes
