"""The program's own spans and counters, read from a short run of the cell
made after the traffic driver's.

The port records spans and counters when its tracing is on
(``sessionrec_tpu_torch/utils/profiling.py``), and a CUDA graph captured
with tracing on keeps a capture map: its device-work node count and the
``owners``, the span (and direction, forward or backward) that owns each
run of nodes.  The traffic drivers run the program with tracing off, so
a ``--trace 1`` run's readers of those spans get them here: the cell is
set up once more, by its driver's own ``Setup`` (a training driver; a
stream cut to what this run takes) or ``Server`` (a serving driver;
``Cell.role``), with tracing on, so its
graph is captured with its map; then

* an untraced window of ``WINDOW`` times the cell's profiled chunks or
  requests, whose registry gives the host spans (``loader.build``,
  ``runner.stage``, ``runner.replay``, ``loader.wait``,
  ``serving.build``);
* a profiled window of the cell's ``trace_chunks`` chunks or
  ``trace_requests`` requests.  Each replay's kernel, memcpy and memset
  events (grouped by the correlation id of its ``cudaGraphLaunch``,
  sorted by start) are zipped with the graph's nodes: node ``i`` is the
  ``i``-th device event of a replay.  A replay whose event count is not
  the graph's node count, or whose kernel names in that order are not
  the first replay's (a replay out of order), makes the whole reading
  None (profiled again once, held open longer, before that).  Device events outside a replay
  (the staging copies) are put down to the program span their launch
  was made in, direction ``launch``.  Each idle gap of the window is
  named after the innermost program span the launching thread was in
  at the gap's middle, ``other`` under none.

The whole table (device ms a unit by span and direction, idle ms a unit
by program span, the unowned share, the host spans) goes to standard
error.  A unit is a training step or a request.  Against a program
without capture maps, or without a CUDA device, every reading is None
and nothing is run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time

from harness import program
from harness.outcome import Context
from harness.spans import Spans
from harness.trace import DEVICE_CATS, gaps, innermost, union

WINDOW = 5          # the untraced window, in profiled windows
RANGE = "owners.window"
OTHER = "other"
SETTLE_S = (0.5, 2.0)

_cache = {}


def supported() -> bool:
    """True where the program keeps capture maps and a card is there."""
    try:
        import torch
        from sessionrec_tpu_torch.train import runner
        from sessionrec_tpu_torch.utils import profiling
    except ImportError:
        return False
    return (hasattr(profiling, "capturing") and hasattr(runner, "launches")
            and torch.cuda.is_available())


def run_seed() -> int:
    """The ``--seed`` of this process's command line (``run.py``'s): a
    reader's ``Run`` does not carry the run's seed.  Raises where the
    command line has none, so that the owners run never makes other
    sessions and weights than the run it reports for."""
    argv = sys.argv
    for i, a in enumerate(argv[:-1]):
        if a == "--seed":
            return int(argv[i + 1])
    raise RuntimeError("the owners run needs the run's --seed on the "
                       "command line (benchmark/run.py --seed <n>)")


def reading(run):
    """The cell's reading (``measure``), made once a run; None where it
    cannot be made."""
    key = id(run.outcome)
    if key not in _cache:
        _cache.clear()
        _cache[key] = measure(run.cell, run_seed()) if supported() else None
    return _cache[key]


def device_ms(run, spans, directions=("fwd", "bwd")):
    """Device ms a unit owned by ``spans`` in ``directions``; None
    without a reading or where they own nothing."""
    r = reading(run)
    if r is None:
        return None
    ms = sum(v for (s, d), v in r["device_ms"].items()
             if s in spans and d in directions)
    return ms if ms > 0 else None


def host_ms(run, span):
    """Host ms a call of ``span`` in the untraced window (a batch built,
    a batch staged)."""
    r = reading(run)
    if r is None:
        return None
    s = r["host"]["spans"].get(span)
    if not s or not s["calls"]:
        return None
    return s["seconds"] / s["calls"] * 1e3


def idle_ms(run, span):
    """Device-idle ms a unit in gaps under program span ``span``."""
    r = reading(run)
    if r is None:
        return None
    return r["idle_ms"].get(span, 0.0)


# -- a run of the cell with tracing on -------------------------------------


def measure(cell, seed):
    """``attribute``'s reading of the cell's profiled window, with
    ``"host"`` (the untraced window's registry) and ``"unit"``, or None
    where no replay zips with the graph's map."""
    from sessionrec_tpu_torch.utils import profiling
    with profiling.tracing():
        try:
            cut = (TrainCut if cell.role == "train" else ServeCut)(cell,
                                                                   seed)
            try:
                profiling.reset()
                cut.window(WINDOW)
                host = profiling.snapshot()
                g, out = cut.graph(), None
                for settle in SETTLE_S:
                    out = attribute(profiled(lambda: cut.window(1), settle),
                                    g.nodes, g.owners, cut.units)
                    if out is not None:
                        break
            finally:
                cut.close()
        finally:
            profiling.reset()
            program.free("cuda")
    if out is not None:
        out.update(host=host, unit=cut.unit)
    report(cell.name, out)
    return out


def _context(cell, seed):
    return Context(cell=cell, seed=seed, seconds=0.0, trace=True,
                   device="cuda", t0=time.perf_counter())


class TrainCut:
    """The training cell set up by its driver's ``Setup``, over a stream
    cut to the steps this reading takes, through its first steps (the
    eager one, then the capture of the chunk graph)."""

    unit = "step"

    def __init__(self, cell, seed):
        drv = cell.driver()
        self.unroll = cell.traffic["unroll"]
        self.n = cell.params["trace_chunks"]
        self.units = self.n * self.unroll
        steps = drv.first_steps(cell) + (WINDOW + len(SETTLE_S)) * self.units
        examples = int(1.25 * steps * cell.config["data"]["batch_size"])
        small = dataclasses.replace(
            cell, params=dict(cell.params, train_examples=examples))
        self.setup = drv.Setup(_context(small, seed))
        self.setup.first_steps()
        program.synchronize("cuda")

    def window(self, k):
        """``k`` profiled windows' chunks, synchronised."""
        for _ in range(k * self.n):
            self.setup.runner.run_chunk(next(self.setup.chunks))
        program.synchronize("cuda")

    def graph(self):
        return self.setup.runner.graphs[self.unroll]

    def close(self):
        self.setup.close()


class ServeCut:
    """The serving cell set up by its driver's ``Server``, through its
    eager request and the one that captures the graph."""

    unit = "request"

    def __init__(self, cell, seed):
        self.server = cell.driver().Server(_context(cell, seed))
        self.units = cell.params["trace_requests"]
        self.quiet = Spans()
        self._requests(2)

    def _requests(self, k):
        for _ in range(k):
            self.server.request(self.quiet)
        program.synchronize("cuda")

    def window(self, k):
        self._requests(k * self.units)

    def graph(self):
        return self.server.step.graph

    def close(self):
        self.server = None


def profiled(fn, settle):
    """The Chrome trace (a dict) of ``fn()`` under ``torch.profiler``
    inside a ``RANGE`` range, held open ``settle`` seconds after it."""
    import torch
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(RANGE):
            fn()
        time.sleep(settle)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


# -- reading a trace --------------------------------------------------------


def _x(trace):
    return [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]


def replays(trace):
    """``[(tid of the launch, [device event])]`` of each
    ``cudaGraphLaunch`` in the trace, its events sorted by start."""
    events = _x(trace)
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime"
                and e["name"].startswith("cudaGraphLaunch")}
    groups = {c: [] for c in launches}
    for e in events:
        c = e.get("args", {}).get("correlation")
        if e.get("cat") in DEVICE_CATS and c in groups:
            groups[c].append(e)
    order = sorted(launches, key=lambda c: float(launches[c]["ts"]))
    return [(launches[c]["tid"], sorted(groups[c], key=lambda e:
                                        float(e["ts"]))) for c in order]


def attribute(trace, nodes, owners, units):
    """The device's time in ``trace`` by owner: ``{"device_ms", "idle_ms",
    "other_share", "replays", "nodes", "units", "kernels"}`` (ms a unit
    of ``units``; ``kernels``: by owner, ms a unit by kernel name), or
    None where there is no replay, one does not hold ``nodes`` events,
    or one's event names in start order are not the first's."""
    groups = replays(trace)
    if not groups or nodes is None or any(len(ev) != nodes
                                          for _, ev in groups):
        return None
    first = [e["name"] for e in groups[0][1]]
    if any([e["name"] for e in ev] != first for _, ev in groups[1:]):
        return None
    owner = [(OTHER, "fwd")] * nodes
    for o in owners:
        owner[o.first:o.end] = [(o.span, o.direction)] * (o.end - o.first)
    dev, names = {}, {}

    def add(who, e):
        dev[who] = dev.get(who, 0.0) + float(e["dur"])
        by = names.setdefault(who, {})
        by[e["name"]] = by.get(e["name"], 0.0) + float(e["dur"])
    for _, ev in groups:
        for who, e in zip(owner, ev):
            add(who, e)
    tid = groups[0][0]
    events = _x(trace)
    (w,) = [e for e in events if e.get("cat") == "user_annotation"
            and e["name"] == RANGE]
    ranges = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
              if e.get("cat") == "user_annotation" and e["tid"] == tid
              and e["name"] != RANGE]
    in_replay = {id(e) for _, ev in groups for e in ev}
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") == "cuda_runtime" and "correlation" in
             e.get("args", {})}
    device = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        device.append((e["name"], float(e["ts"]), float(e["dur"])))
        if id(e) in in_replay:
            continue
        call = calls.get(e.get("args", {}).get("correlation"))
        at = float(call["ts"]) if call else float(e["ts"])
        add((innermost(ranges, at), "launch"), e)
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    inside = [d for d in device if d[1] >= w0 and d[1] < w1]
    idle = {}
    if inside:
        start = min(ts for _, ts, _ in inside)
        for a, b in gaps(union(inside), start, w1):
            name = innermost(ranges, (a + b) / 2)
            idle[name] = idle.get(name, 0.0) + (b - a)
    replayed = sum(v for (s, d), v in dev.items() if d != "launch")
    return {"units": units, "replays": len(groups), "nodes": nodes,
            "device_ms": {k: v / 1e3 / units for k, v in dev.items()},
            "idle_ms": {k: v / 1e3 / units for k, v in idle.items()},
            "other_share": dev.get((OTHER, "fwd"), 0.0) / replayed
            if replayed else 0.0,
            "kernels": {f"{s}.{d}": {n: v / 1e3 / units for n, v in
                                     by.items()}
                        for (s, d), by in names.items()}}


def short(name):
    """A kernel's name without its namespaces and parameters, at most 80
    characters."""
    for cut in ("void ", "(anonymous namespace)::", "at::native::",
                "at_cuda_detail::", "std::"):
        name = name.replace(cut, "")
    return name.split("(", 1)[0].strip()[:80]


def report(cell, out):
    """The reading's table, on standard error."""
    err = sys.stderr
    if out is None:
        print(f"owners {cell}: no reading (no capture map, or a replay "
              "that does not match it or the first replay)", file=err,
              flush=True)
        return
    unit = out["unit"]
    print(f"owners {cell}: {out['replays']} replays of a graph of "
          f"{out['nodes']} device nodes, {out['units']} "
          f"{unit}s; unowned share of replayed device time "
          f"{out['other_share'] * 100:.3f}%", file=err)
    for (s, d), ms in sorted(out["device_ms"].items(), key=lambda kv:
                             -kv[1]):
        print(f"  device ms a {unit}: {s} {d} {ms:.4f}", file=err)
    for s, ms in sorted(out["idle_ms"].items(), key=lambda kv: -kv[1]):
        print(f"  idle ms a {unit} under {s}: {ms:.4f}", file=err)
    for s, v in out["host"]["spans"].items():
        per = v["seconds"] / v["calls"] * 1e3 if v["calls"] else 0.0
        print(f"  host span {s}: {v['calls']} calls, {per:.4f} ms a call",
              file=err)
    for c, n in sorted(out["host"]["counts"].items()):
        print(f"  counter {c}: {n}", file=err)
    for who, by in sorted(out["kernels"].items()):
        top = sorted(by.items(), key=lambda kv: -kv[1])[:4]
        print(f"  kernels of {who}: {len(by)} names; largest "
              + "; ".join(f"{short(n)} {ms:.4f}" for n, ms in top),
              file=err)
    for tag in ("xent_", "indexing_backward_kernel"):
        where = {who: sum(ms for n, ms in by.items() if tag in n)
                 for who, by in out["kernels"].items()}
        print(f"  {tag} kernels (ms a {unit}) under: "
              + ", ".join(f"{w} {ms:.4f}" for w, ms in sorted(where.items())
                          if ms > 0), file=err)
    err.flush()
