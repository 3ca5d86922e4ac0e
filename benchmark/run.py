"""Run one cell of the benchmark of ``sessionrec_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix
and metrics are found by name in ``BENCHMARK.json``.  The run makes its
sessions and weights from ``--seed``, sets the program up and warms
every shape the cell uses (``setup_s``, from the start of this process to
the first timed step), measures for ``--seconds``, checks what the timed
path produced against the plain reference, and prints one JSON line as
the last line of its standard output: ``--trace 0`` gives the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics (read from the
untraced window's spans and a short profiled sub-window after it) with
the device's busy and window seconds and a ``breakdown``.  The numbers
compared are the last lines of standard error and the last key of the
result.

It exits with another code than 0, and prints no result, without as
many CUDA devices as the cell asks for, without the program beside it,
or when the process holds JAX or the JAX package once the window has
closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HOME = Path(__file__).resolve().parent
ROOT = HOME.parent
for p in (str(HOME), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import check, imports  # noqa: E402
from harness.cells import Bench  # noqa: E402
from harness.outcome import Context, Run  # noqa: E402


def few_threads():
    """One process with few threads: the host's OpenMP and BLAS pools held
    to one thread each (before numpy or torch loads), so that a run's host
    work does not spread over the cores its host shares."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def device_info(device, chips, peak):
    import torch
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": int(peak)}


def run_cell(cell, seed, seconds, trace, device="cuda", t0=None):
    """One run of ``cell``: the result line's object, or None where the
    process holds a forbidden module after the window (named on
    standard error)."""
    ctx = Context(cell=cell, seed=int(seed), seconds=float(seconds),
                  trace=bool(trace), device=device,
                  t0=T0 if t0 is None else t0)
    out = cell.driver().run(ctx)
    gc.collect()
    found = imports.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr, flush=True)
        return None
    units = {m["name"]: m["unit"] for m in
             (cell.per_layer if trace else cell.end_to_end)}
    if trace:
        run = Run(cell=cell, outcome=out, spans=ctx.spans)
        values = {name: cell.reader(name).read(run) for name in units}
    else:
        values = {name: out.metrics[name] for name in units}
    dev = device_info(device, cell.chips, out.memory_peak_bytes)
    result = {"correct": check.passed(out.checks) and out.failed == 0,
              "attempted": out.attempted, "failed": out.failed,
              "metrics": {n: {"value": float(v), "unit": units[n]}
                          for n, v in values.items() if v is not None},
              "device": dev}
    if trace:
        dev["busy_s"] = out.profile.busy_s
        dev["window_s"] = out.profile.window_s
        result["breakdown"] = out.profile.breakdown
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in out.checks}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    few_threads()
    cell = Bench(ROOT).cell(args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        sys.exit(f"cell {cell.name} needs {cell.chips} CUDA device(s); "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                 " visible")
    result = run_cell(cell, args.seed, args.seconds, args.trace)
    if result is None:
        sys.exit(4)
    checks = [(n, c["value"], c["limit"])
              for n, c in result["checks"].items()]
    sys.stdout.flush()
    check.print_checks(checks)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
