"""Readings that set the check's limits: the program's, the control's and
the faults', at a cell's own size, many seeds in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --mode program|control|faults

* ``program``: what a run compares, from the program's timed path and
  feed (a training cell's set-up steps, the eager first one and the
  first full chunk; a serving cell's sampled requests after a short
  closed loop), against the reference.
* ``control``: the reference put in the program's place, its products
  in TF32 (the precision below the configuration's float32 with TF32
  off), and in bfloat16 as a second witness.
* ``faults``: a training cell's half batch (the second half of each
  batch left out, the mean over the rest), in the reference put in the
  program's place; a serving cell's answer altered where it is produced
  (each session's first id off by one).  A training step that leaves its
  state unchanged reads 1 on ``change_gap`` by its definition.

One JSON line a seed and reading.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HOME = Path(__file__).resolve().parent
ROOT = HOME.parent
for _p in (str(HOME), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import check, program  # noqa: E402
from harness.cells import Bench  # noqa: E402
from harness.outcome import Context  # noqa: E402
from harness.spans import Spans  # noqa: E402


def train_readings(ctx, mode):
    drv = ctx.cell.driver()
    if mode == "program":
        setup = drv.Setup(ctx)
        prog = setup.first_steps()
        setup.close()
        del setup.runner
        program.free(ctx.device)
        ref = drv.reference_readings(ctx, setup.stream)
        yield "program", check.train_numbers(prog, ref)
        return
    stream = drv.make_stream(ctx)
    ref = drv.reference_readings(ctx, stream)
    if mode == "control":
        for precision in ("tf32", "bfloat16"):
            low = drv.reference_readings(ctx, stream, precision=precision)
            yield precision, check.train_numbers(low, ref)
    else:
        half = drv.reference_readings(ctx, stream, fault="half")
        yield "half", check.train_numbers(half, ref)


def serve_readings(ctx, mode):
    import torch
    drv = ctx.cell.driver()
    server = drv.Server(ctx)
    warm = Spans()
    for _ in range(2):
        server.request(warm)
    n = ctx.cell.params["check_requests"] + 4
    answers = {}
    for _ in range(n):
        i, ids, scores = server.request(warm)
        answers[i] = (ids, scores)
    keep = drv.sample(server, sorted(answers), ctx.seed,
                      ctx.cell.params["check_requests"])
    picked = {i: answers[i] for i in keep}
    del server.step, server.model
    program.free(ctx.device)
    if mode == "program":
        yield "program", drv.reference_numbers(ctx, server, picked)
        return
    if mode == "faults":
        bad = {}
        for i, (ids, s) in picked.items():
            ids = ids.clone()
            ids[:, 0] = (ids[:, 0] + 1) % server.n_items
            bad[i] = (ids, s)
        yield "altered", drv.reference_numbers(ctx, server, bad)
        return
    ref = ctx.cell.reference()
    weights = ref.init_params(ctx.cell.config, ctx.seed, ctx.device)
    k = ctx.cell.traffic["k"]
    for precision in ("tf32", "bfloat16"):
        low = {}
        for i in picked:
            lp = ref.serve_log_probs(ctx.cell.config, weights,
                                     server.sessions_of(i), device=ctx.device,
                                     precision=precision)
            vals, ids = torch.topk(lp, k, dim=1)
            low[i] = (ids.cpu(), vals.cpu())
        yield precision, drv.reference_numbers(ctx, server, low)


def readings(cell, seed, mode, device):
    ctx = Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                  device=device, t0=time.perf_counter())
    fn = train_readings if cell.traffic["driver"] == "train" \
        else serve_readings
    yield from fn(ctx, mode)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", choices=("program", "control", "faults"),
                    required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("control readings need a CUDA device")
    cell = Bench(ROOT).cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        for what, numbers in readings(cell, seed, args.mode, "cuda"):
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "reading": what, "numbers": numbers,
                              "seconds": time.perf_counter() - t}),
                  flush=True)


if __name__ == "__main__":
    main()
