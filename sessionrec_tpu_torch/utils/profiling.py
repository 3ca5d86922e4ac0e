"""The port's spans and counters, CUDA-graph capture maps, and where the
time of a training step goes on the card.

Tracing is off by default and ``enable(True)`` turns it on for the
process.  Off, ``span(name)`` returns one shared no-op context manager
after a single flag test and ``count(name)`` returns at once.  On:

* ``span(name)`` adds its host seconds (``time.perf_counter``) and
  calls to ``name`` in one process-wide registry, which the
  loader's prefetch thread writes to as well; while a ``torch.profiler``
  is active it is also a ``record_function`` range, on the timeline of
  the device's kernels;
* ``count(name, n=1)`` adds ``n`` to a counter of the same registry;
* ``snapshot()`` copies the registry (``{"spans": {name: {"seconds",
  "calls"}}, "counts": {name: n}}``) and ``reset()`` empties it;
* while a CUDA graph is captured (``capturing()``, which the runner's
  ``_capture`` opens), each span of the capturing thread marks the
  graph's count of nodes (``csrc/capture.cu``) at its start and end,
  which index its device work (kernel, memcpy and memset nodes) where
  the graph has no other node.  A span's backward part is
  bounded by autograd hooks that launch nothing: it opens at the
  pre-hook of its outputs' ``grad_fn`` (``.outputs(...)``) and closes
  once the gradients of its non-leaf inputs (``.inputs(...)``) have been
  produced, or, with none, after its outputs' ``grad_fn`` has run.  The
  innermost open span owns a node, ``"other"`` the nodes under none.
  A single-stream capture is a chain, so node ``i`` is the ``i``-th
  device event of every replay: ``CaptureMap.owners`` (kept by the
  runner's ``StepGraph``) names the owner of each.

The program's spans: ``model.embed`` (the table gather), ``model.graph``
(expander, dropout, MSHGNN layers), ``model.readout`` (readout,
``fc_sr``, the norms, the REnorm gate), ``loss`` (K1/K2 or K3/K4 and
their reductions), ``step.optimizer`` (``zero_grad``, Adam, the table's
update, the schedule, the projection), ``serve.score`` and
``serve.topk``; on the host ``runner.stage``, ``runner.replay``,
``loader.build`` (prefetch thread), ``loader.wait`` and
``serving.build``.  Counters: ``runner.staged_bytes``,
``loader.queue_empty``, ``graph.capture.<key>``, ``graph.replay.<key>``
and the kernel wrappers' ``xent.fwd``, ``xent.bwd``, ``xent_multi.fwd``,
``xent_multi.bwd`` and ``embed.bwd``.

``trace(log_dir)`` records a ``torch.profiler`` trace of a block, with
tracing on inside it (the CLI's ``--profile-dir``).  Run as a module,
this file is the step-breakdown tool:

    python -m sessionrec_tpu_torch.utils.profiling [--steps 24] [--warmup 16]
        [--model msgifsr|srgnn|niser|lessr] [--order 3 --extra --fusion]
        [--table-dtype bfloat16 --compute-dtype bfloat16] [--unroll 8]

Runs the main path's configuration (MSGIFSR order 1, d=256, 1 layer, batch
512, tiers (4, 8), feat_drop 0.1, datasets/sample), with ``--order 3
--extra --fusion`` the WSDM'22 paper head at the same widths, or with
``--model`` SRGNN, NISER or LESSR at its preset, tiers (4, 8), in the
table and compute dtypes asked for (float32 by default), through the
runner's default loop (``run_chunk``: the native batch builder, ``unroll``
steps per CUDA-graph replay), and prints JSON lines:

* ``host``    — which loop ran (``loop``: graph or plain, ``unroll``,
  ``native`` builder or not); milliseconds per batch to build it on the
  host (the loader's builder alone, no prefetch thread), per step to wait
  for the batches in the training loop, and per step to run them
  synchronised (chunks of ``unroll`` steps: staging, replay), with the
  examples/s of that loop;
* ``profile`` — a ``torch.profiler`` window over the same loop without
  per-chunk synchronisation: the wall time, the device's busy time and
  idle share, its events a step, and device time by kernel name, the
  largest first.  Busy time is the union of the intervals of the trace's
  kernel, memcpy and memset events; annotated ranges
  (``Optimizer.step#Adam.step``, ``ProfilerStep``), which span kernels
  that are counted on their own, are left out.  ``kernels_a_step`` is the
  number of kernel events a step: near the eager step's count when the
  trace sees the kernels inside graph replays, near 0 when it does not.

Warm-up and timed windows are whole chunks (``--steps`` and ``--warmup``
round down to multiples of ``unroll``); the first warm-up chunk runs
eagerly and the next captures the graph.  It needs a CUDA device; there
is no CPU fallback.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import tempfile
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple

import torch

from sessionrec_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

REPO = Path(__file__).resolve().parents[2]


_on = False
_lock = threading.Lock()
_seconds = defaultdict(float)
_calls = defaultdict(int)
_counts = defaultdict(int)
_map = None           # the CaptureMap of the capture in progress


def enable(on: bool = True):
    """Turn the spans and counters on or off for the process."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def snapshot() -> dict:
    """A copy of the registry: ``{"spans": {name: {"seconds", "calls"}},
    "counts": {name: n}}``."""
    with _lock:
        return {"spans": {n: {"seconds": _seconds[n], "calls": _calls[n]}
                          for n in _seconds},
                "counts": dict(_counts)}


def reset():
    """Empty the registry."""
    with _lock:
        for d in (_seconds, _calls, _counts):
            d.clear()


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name`` (tracing on)."""
    if not _on:
        return
    with _lock:
        _counts[name] += n


class _Off:
    """The span of tracing off: enters, exits and marks nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def inputs(self, x):
        return x

    def outputs(self, x):
        return x


_OFF = _Off()


def span(name: str):
    """A context manager that times its block under ``name`` (tracing on;
    see the module docstring).  ``.inputs(x)`` and ``.outputs(x)`` (a
    tensor or a sequence of them, returned as given) bound the span's
    backward part in a capture map."""
    if not _on:
        return _OFF
    return _Span(name)


class _Span:
    __slots__ = ("name", "_t", "_range", "_map", "pending", "closed")

    def __init__(self, name):
        self.name = name
        self._range = None
        self._map = None
        self.pending = 0        # non-leaf inputs whose gradient is due
        self.closed = False     # its backward part has closed

    def __enter__(self):
        if torch._C._autograd._profiler_enabled():     # a torch.profiler
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        m = _map
        if m is not None and m.thread == threading.get_ident():
            self._map = m
            m.open(self, "fwd")
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t
        if self._map is not None:
            self._map.close(self, "fwd")
        if self._range is not None:
            self._range.__exit__(*exc)
        with _lock:
            _seconds[self.name] += dt
            _calls[self.name] += 1
        return False

    def inputs(self, x):
        if self._map is not None and torch.is_grad_enabled():
            self._map.watch_inputs(self, _tensors(x))
        return x

    def outputs(self, x):
        if self._map is not None and torch.is_grad_enabled():
            self._map.watch_outputs(self, _tensors(x))
        return x


def _tensors(x):
    return [x] if isinstance(x, torch.Tensor) else [
        t for t in x if isinstance(t, torch.Tensor)]


class Owner(NamedTuple):
    """Nodes ``first .. end - 1`` of a captured graph belong to ``span``'s
    ``direction`` ("fwd" or "bwd")."""

    span: str
    direction: str
    first: int
    end: int


class CaptureMap:
    """Which span owns each device node of a graph under capture.

    ``nodes()`` gives the nodes captured so far, and ``device_nodes()``
    (by default ``nodes``) those of them that are device work.  Open spans
    form a stack, the innermost owning what is captured; a span's
    backward part may close below the top (autograd interleaves the
    backward of sibling spans).  ``marks`` records ``(node, owner)``
    wherever the owner changes; ``finish()`` turns them into ``owners``
    and records the graph's device nodes (``total``) and the counters'
    growth during the capture (``counts``).  The marks count every node,
    which is cheap; they are the device nodes' indices only where the
    finished graph has no other node, so otherwise ``owners`` stays
    empty."""

    def __init__(self, nodes, device_nodes=None):
        self.nodes = nodes
        self.device_nodes = device_nodes or nodes
        self.thread = threading.get_ident()
        self.lock = threading.Lock()
        self.stack = []       # [(span, direction)], innermost last
        self.marks = [(0, None)]
        with _lock:
            self._counts0 = dict(_counts)
        self.owners, self.total, self.counts = [], None, {}

    def _mark(self):
        who = None
        if self.stack:
            sp, direction = self.stack[-1]
            who = (sp.name, direction)
        self.marks.append((self.nodes(), who))

    def open(self, sp, direction):
        with self.lock:
            if direction == "bwd" and (sp.closed or any(
                    s is sp and d == "bwd" for s, d in self.stack)):
                return
            self.stack.append((sp, direction))
            self._mark()

    def close(self, sp, direction):
        with self.lock:
            for i in range(len(self.stack) - 1, -1, -1):
                s, d = self.stack[i]
                if s is sp and d == direction:
                    del self.stack[i]
                    if direction == "bwd":
                        sp.closed = True
                    self._mark()
                    return

    def watch_inputs(self, sp, tensors):
        live = [t for t in tensors if t.requires_grad and t.grad_fn]
        sp.pending += len(live)

        def arrived(_grad):
            with self.lock:
                sp.pending -= 1
                last = sp.pending == 0
            if last:
                self.close(sp, "bwd")
        for t in live:
            t.register_hook(arrived)

    def watch_outputs(self, sp, tensors):
        fns = [t.grad_fn for t in tensors if t.grad_fn is not None]
        for fn in fns:
            fn.register_prehook(lambda _g: self.open(sp, "bwd"))
        if sp.pending or not fns:
            return
        left = [len(fns)]

        def ran(_gi, _go):
            left[0] -= 1
            if left[0] == 0:
                self.close(sp, "bwd")
        for fn in fns:
            fn.register_hook(ran)

    def finish(self):
        """Close the map at the capture's end."""
        end = self.nodes()
        self.total = self.device_nodes()
        marks = self.marks + [(end, None)] if self.total == end else []
        owners = []
        for (a, who), (b, _) in zip(marks, marks[1:]):
            if who is None or b <= a:
                continue
            if owners and owners[-1][:2] == who and owners[-1].end == a:
                owners[-1] = owners[-1]._replace(end=b)
            else:
                owners.append(Owner(who[0], who[1], a, b))
        self.owners = owners
        with _lock:
            self.counts = {k: n - self._counts0.get(k, 0)
                           for k, n in _counts.items()
                           if n != self._counts0.get(k, 0)}


def _stream_nodes(stream, device_only):
    """``nodes()`` of the graph ``stream`` is capturing into, all of them
    or its device work, from the kernel library's
    ``srt_capture_nodes``."""
    from sessionrec_tpu_torch.ops import cuda_build
    fn = cuda_build.library().srt_capture_nodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    handle = stream.cuda_stream

    def nodes():
        n = fn(handle, int(device_only))
        if n < 0:
            raise RuntimeError(f"no capture on the stream to count ({n})")
        return n
    return nodes


@contextlib.contextmanager
def capturing(nodes=None):
    """The ``CaptureMap`` of the capture the block runs (tracing on; else
    None): ``nodes`` counts its nodes, by default those of the graph the
    current CUDA stream captures into."""
    global _map
    if not _on:
        yield None
        return
    if nodes is None:
        stream = torch.cuda.current_stream()
        m = CaptureMap(_stream_nodes(stream, False),
                       _stream_nodes(stream, True))
    else:
        m = CaptureMap(nodes)
    prev, _map = _map, m
    try:
        yield m
    finally:
        _map = prev
    m.finish()


@contextlib.contextmanager
def tracing():
    """Tracing on inside the block, from an empty registry; as it was
    before after the block (the registry is kept for reading)."""
    was = _on
    reset()
    enable(True)
    try:
        yield
    finally:
        enable(was)


@contextlib.contextmanager
def trace(log_dir):
    """Record a ``torch.profiler`` trace of everything inside the block
    (the host, and the card where there is one), with tracing on, and
    write it to ``log_dir`` as a Chrome trace (TensorBoard / Perfetto).
    No-op when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    log.info("profiling to %s", log_dir)
    was = _on
    enable(True)
    try:
        with profile(activities=acts,
                     on_trace_ready=tensorboard_trace_handler(str(log_dir))):
            yield
    finally:
        enable(was)
    log.info("wrote profiler trace to %s", log_dir)


# MSGIFSR runs at the reference's widths (main_msgifsr.py:36-111, start.sh:10
# at order 1); the other models at their presets
WIDTHS = {"msgifsr": dict(embedding_dim=256, num_layers=1, feat_drop=0.1,
                          batch_size=512)}


def run_config(model, seed, dataset_dir, **overrides):
    """The profiled (and ``chip_smoke.py``'s) configuration of ``model``
    on ``dataset_dir``: its widths, tiers (4, 8), then ``overrides``
    (config fields)."""
    from sessionrec_tpu_torch.utils.config import preset
    return preset(model, **{**WIDTHS.get(model, {}), "split_len": (4, 8),
                            "dataset_dir": str(dataset_dir), "seed": seed,
                            **overrides})


def setup_runner(cfg, unroll=8):
    """(train loader, TrainRunner) of ``cfg`` on the card, with no initial
    eval; the loader yields host batches."""
    from sessionrec_tpu_torch.models import build_model
    from sessionrec_tpu_torch.train.runner import TrainRunner
    from sessionrec_tpu_torch.train.session import make_loaders
    m = cfg.model
    train, test, num_items, _ = make_loaders(cfg.data, m.name, m.order)
    model = build_model(m, num_items)
    runner = TrainRunner(model, train, test, seed=cfg.train.seed,
                         device="cuda", eval_before_train=False,
                         unroll=unroll)
    return train, runner


def _chunk_stream(train, runner):
    """Endless chunks of ``runner.unroll`` host batches over the epochs."""
    from sessionrec_tpu_torch.train.runner import chunks
    while True:
        yield from chunks(train, runner.unroll)


def host_breakdown(train, runner, warmup, steps):
    bs = train.batch_size
    G = runner.unroll
    t0 = time.perf_counter()
    for k in range(steps):
        train._build(range(k * bs, (k + 1) * bs))
    build_ms = (time.perf_counter() - t0) / steps * 1e3

    stream = _chunk_stream(train, runner)
    for _ in range(max(warmup // G, 2)):
        runner.run_chunk(next(stream))
    torch.cuda.synchronize()
    n = max(steps // G, 1)
    wait = step = 0.0
    for _ in range(n):
        t0 = time.perf_counter()
        chunk = next(stream)
        t1 = time.perf_counter()
        runner.run_chunk(chunk)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        wait += t1 - t0
        step += t2 - t1
    stream.close()
    return {"phase": "host", "loop": "graph" if runner.uses_graph
            else "plain", "unroll": G, "native": train.use_native,
            "steps": n * G, "build_ms": build_ms,
            "wait_ms": wait / (n * G) * 1e3, "step_ms": step / (n * G) * 1e3,
            "examples_per_s": n * G * bs / (wait + step)}


# trace categories of work the device does; "gpu_user_annotation" ranges
# cover kernels already listed and would count them twice
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(trace):
    """(name, start_us, dur_us) of the device's own work in a Chrome trace
    exported by ``torch.profiler``."""
    return [(e["name"], float(e["ts"]), float(e["dur"]))
            for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def profiled_device_events(prof):
    """``device_events`` of a finished ``torch.profiler.profile``."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return device_events(json.loads(path.read_text()))


def busy_us(events):
    """Length of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for _, ts, dur in sorted(events, key=lambda e: e[1]):
        if ts + dur <= end:
            continue
        total += ts + dur - max(ts, end)
        end = ts + dur
    return total


def device_breakdown(train, runner, warmup, steps, top):
    from torch.profiler import ProfilerActivity, profile
    G = runner.unroll
    stream = _chunk_stream(train, runner)
    for _ in range(max(warmup // G, 2)):
        runner.run_chunk(next(stream))
    torch.cuda.synchronize()
    n = max(steps // G, 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            runner.run_chunk(next(stream))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stream.close()
    steps = n * G
    events = profiled_device_events(prof)
    kernels = {}
    for name, _, dur in events:
        kernels[name] = kernels.get(name, 0.0) + dur
    busy_ms = busy_us(events) / 1e3
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    return {"phase": "profile", "steps": steps, "wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms, "device_events": len(events),
            "events_a_step": len(events) / steps,
            "kernels_a_step": sum(1 for e in events if not
                                  e[0].startswith("Mem")) / steps,
            "idle_share": 1.0 - busy_ms / (wall * 1e3),
            "per_step_ms": {"wall": wall * 1e3 / steps,
                            "device": busy_ms / steps},
            "top_kernels_ms_per_step": [
                [name[:80], us / 1e3 / steps] for name, us in ranked[:top]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--warmup", type=int, default=16)
    ap.add_argument("--unroll", type=int, default=8)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset-dir", default=str(REPO / "datasets" / "sample"))
    ap.add_argument("--model", default="msgifsr",
                    choices=["msgifsr", "srgnn", "niser", "lessr"])
    ap.add_argument("--order", type=int, default=1)
    ap.add_argument("--extra", action="store_true", help="MSGIFSR REnorm")
    ap.add_argument("--fusion", action="store_true", help="MSGIFSR IFR")
    ap.add_argument("--table-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    mkw = dict(order=args.order, extra=args.extra, fusion=args.fusion) \
        if args.model == "msgifsr" else {}
    mkw.update(table_dtype=args.table_dtype, compute_dtype=args.compute_dtype)
    train, runner = setup_runner(
        run_config(args.model, args.seed, args.dataset_dir, **mkw),
        args.unroll)
    print(json.dumps({"phase": "device",
                      "name": torch.cuda.get_device_name(0),
                      "model": args.model, **mkw}), flush=True)
    print(json.dumps(host_breakdown(train, runner, args.warmup,
                                    args.steps)), flush=True)
    print(json.dumps(device_breakdown(train, runner, args.warmup, args.steps,
                                      args.top)), flush=True)


if __name__ == "__main__":
    main()
