"""The benchmark's reader of the port's capture maps
(``benchmark/harness/owners.py``) on small synthetic Chrome traces: each
replay's device events zip with the graph's owners, a replay whose event
count differs gives no reading, nodes under no span are ``other``, idle
gaps are named after the innermost program span of the launching
thread; and the harness's existing trace reader (``harness/trace.py``)
gives the same ``Profile`` of a fixed trace as it did before the owners
reader existed, so the existing metrics read the same."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import owners, trace  # noqa: E402
from sessionrec_tpu_torch.utils.profiling import Owner  # noqa: E402


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(drop=False):
    """One window: a staging copy, two replays of a 3-node graph, the
    program's host spans on thread 1 and a build on thread 2."""
    ev = [_x("user_annotation", owners.RANGE, 0, 1000),
          _x("user_annotation", "runner.stage", 10, 20),
          _x("cuda_runtime", "cudaMemcpyAsync", 15, 2, corr=5),
          _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 20, 5, tid=7,
             corr=5),
          _x("user_annotation", "runner.replay", 30, 5),
          _x("cuda_runtime", "cudaGraphLaunch", 31, 3, corr=7),
          _x("kernel", "k_embed", 40, 10, tid=7, corr=7),
          _x("kernel", "xent_fwd_partial", 50, 20, tid=7, corr=7),
          _x("gpu_memset", "Memset (Device)", 70, 5, tid=7, corr=7),
          _x("user_annotation", "loader.wait", 200, 300),
          _x("user_annotation", "runner.stage", 300, 100),
          _x("user_annotation", "loader.build", 100, 800, tid=2),
          _x("user_annotation", "runner.replay", 600, 5),
          _x("cuda_runtime", "cudaGraphLaunch", 601, 3, corr=9),
          _x("kernel", "k_embed", 610, 10, tid=7, corr=9),
          _x("kernel", "xent_fwd_partial", 620, 20, tid=7, corr=9),
          _x("gpu_memset", "Memset (Device)", 640, 5, tid=7, corr=9),
          _x("cpu_op", "aten::mm", 0, 900),
          {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 31, "id": 7}]
    if drop:
        ev = [e for e in ev if not (e["ts"] == 640)]
    return {"traceEvents": ev}


OWNERS = [Owner("model.embed", "bwd", 0, 1), Owner("loss", "fwd", 1, 2)]


def test_replays_zip_with_their_spans():
    r = owners.attribute(_trace(), 3, OWNERS, units=2)
    assert r["replays"] == 2
    assert r["device_ms"] == pytest.approx({
        ("model.embed", "bwd"): 20 / 1e3 / 2,
        ("loss", "fwd"): 40 / 1e3 / 2,
        ("other", "fwd"): 10 / 1e3 / 2,
        ("runner.stage", "launch"): 5 / 1e3 / 2})
    assert r["kernels"]["loss.fwd"] == pytest.approx(
        {"xent_fwd_partial": 40 / 1e3 / 2})


def test_a_replay_out_of_order_gives_no_reading():
    """The second replay's first two kernels swapped in start order: its
    names no longer follow the first replay's, so no node can be trusted
    to be the event it zips with."""
    tr = _trace()
    for e in tr["traceEvents"]:
        if e.get("args", {}).get("correlation") == 9 and e["cat"] == \
                "kernel":
            e["ts"] = {"k_embed": 630, "xent_fwd_partial": 610}[e["name"]]
    assert owners.attribute(tr, 3, OWNERS, units=2) is None


def test_a_replay_with_another_count_gives_no_reading():
    assert owners.attribute(_trace(drop=True), 3, OWNERS, units=2) is None
    assert owners.attribute(_trace(), 4, OWNERS, units=2) is None
    assert owners.attribute(_trace(), None, OWNERS, units=2) is None
    assert owners.attribute({"traceEvents": []}, 3, OWNERS, 2) is None


def test_nodes_under_no_span_are_other():
    r = owners.attribute(_trace(), 3, [], units=1)
    assert r["device_ms"][("other", "fwd")] == pytest.approx(70 / 1e3)
    assert r["other_share"] == pytest.approx(1.0)
    r = owners.attribute(_trace(), 3, OWNERS, units=1)
    assert r["other_share"] == pytest.approx(10 / 70)


def test_idle_gaps_are_named_by_the_innermost_program_span():
    """The window opens at its first device event (20); gaps 25-40 under
    runner.replay (middle 32.5), 75-610 under runner.stage inside
    loader.wait (middle 342.5; the build on thread 2 does not count) and
    645-1000 under none."""
    r = owners.attribute(_trace(), 3, OWNERS, units=1)
    assert r["idle_ms"] == pytest.approx({"runner.replay": 15 / 1e3,
                                          "runner.stage": 535 / 1e3,
                                          "other": 355 / 1e3})


def test_the_harness_trace_reader_is_unchanged():
    """``harness/trace.read`` of a fixed trace: the numbers the existing
    metrics read."""
    ev = [_x("user_annotation", "window", 0, 100),
          _x("user_annotation", "dispatch", 5, 20),
          _x("user_annotation", "loader_wait", 30, 40),
          _x("kernel", "void xent_fwd_partial<float>(int)", 10, 10),
          _x("kernel", "b", 15, 10),
          _x("gpu_memcpy", "Memcpy HtoD", 50, 5),
          _x("gpu_user_annotation", "Optimizer.step", 10, 80),
          _x("kernel", "late", 150, 5)]
    p = trace.read({"traceEvents": ev}, ("dispatch", "loader_wait"))
    assert (p.window_s, p.busy_s) == pytest.approx((90e-6, 20e-6))
    assert p.events == [("void xent_fwd_partial<float>(int)", 10.0, 10.0),
                        ("b", 15.0, 10.0), ("Memcpy HtoD", 50.0, 5.0)]
    assert p.breakdown == {
        "device_ops": [["void xent_fwd_partial<float>(int)", 10e-6],
                       ["b", 10e-6], ["Memcpy HtoD", 5e-6]],
        "idle_gaps": [["other", 45e-6], ["loader_wait", 25e-6]]}
    assert p.device_seconds(lambda n: n.startswith("void xent")) == \
        pytest.approx(10e-6)


def test_no_reading_without_capture_maps(monkeypatch):
    """Against a program without capture maps (the parent's) or without
    a card, every reader returns None and nothing runs."""
    monkeypatch.setattr(owners, "supported", lambda: False)
    monkeypatch.setattr(owners, "measure", lambda *a: pytest.fail("ran"))
    monkeypatch.setattr(owners, "_cache", {})

    class Run:
        cell = None
        outcome = object()
    assert owners.device_ms(Run, ("loss",)) is None
    assert owners.host_ms(Run, "runner.stage") is None
    assert owners.idle_ms(Run, "runner.stage") is None


def test_the_owners_run_takes_the_command_lines_seed(monkeypatch):
    """The owners run makes the sessions and weights of the run it
    reports for: its seed is the command line's ``--seed``, and without
    one it refuses to run rather than fall back to another."""
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", "c",
                                      "--seed", "3000000001"])
    assert owners.run_seed() == 3000000001
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", "c"])
    with pytest.raises(RuntimeError, match="--seed"):
        owners.run_seed()
