"""Profiling hooks, and where the time of a training step goes on the card.

The hooks are the counterparts of ``sessionrec_tpu/utils/profiling.py``
(the reference has none, SURVEY.md §5): ``trace(log_dir)`` records a
``torch.profiler`` trace of a block (the CLI's ``--profile-dir``),
``annotate(name)`` names a range in it, and ``StepTimer`` records host
wall times.  Run as a module, this file is the step-breakdown tool:

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
import json
import tempfile
import time
from pathlib import Path

import torch

from sessionrec_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

REPO = Path(__file__).resolve().parents[2]


@contextlib.contextmanager
def trace(log_dir):
    """Record a ``torch.profiler`` trace of everything inside the block
    (the host, and the card where there is one) and write it to
    ``log_dir`` as a Chrome trace (TensorBoard / Perfetto).  No-op when
    ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    log.info("profiling to %s", log_dir)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield
    log.info("wrote profiler trace to %s", log_dir)


def annotate(name: str):
    """Named range in the profiler trace."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Cheap wall-clock step timer; records (name, dt) pairs."""

    def __init__(self):
        self.records = []

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        yield
        self.records.append((name, time.perf_counter() - t0))

    def summary(self):
        out = {}
        for name, dt in self.records:
            tot, n = out.get(name, (0.0, 0))
            out[name] = (tot + dt, n + 1)
        return {k: {"total_s": t, "count": n, "mean_s": t / n}
                for k, (t, n) in out.items()}


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
