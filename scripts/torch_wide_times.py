#!/usr/bin/env python3
"""K1-K4's times and two paths' steps of one tree, on a card.

    python scripts/torch_wide_times.py [--tree DIR] [--seed 0] [--set wide]

Imports ``chip_smoke.py`` and ``sessionrec_tpu_torch`` from ``DIR`` (by
default the repository this script is in; the kernels build into
``DIR/build``) and runs, one JSON line each: the card's name and power
limit, then the set's kernel phases and, for each of its paths,
``chip_smoke.phase_graph_vs_plain`` on ``DIR/datasets/sample`` (8 graph
steps against 8 plain ones, then the ``host`` line: the synchronised ms
a step of the graph loop) and the ``profile`` line of 24 more steps
under ``torch.profiler`` (the device's busy ms, its idle share, its
largest kernels).  The sets:

* ``wide`` (D 512): ``chip_smoke.phase_wide_times`` (``kernel_time``,
  ``k1_launch``, ``k2_launch`` and ``multi_launch`` lines at D 512 on the
  path and north-star catalogs, float32 and bfloat16: the slab kernels in
  both types); paths ``o1_wide``, ``paper_wide`` and ``o1_wide_bf16``
  (the o1 head at D 512 in full bfloat16: K1's and K2's slab kernels on
  the tensor cores).
* ``d256`` (D 256, B 512, scale 12, normalised): ``phase_kernel_times``
  (K1/K2 on both catalogs in float32 and bfloat16),
  ``phase_bf16_path_times`` (K1/K2 at the o1_bf16 path's shape) and
  ``phase_multi_times`` (K3/K4 on both catalogs and types); paths
  ``o1_bf16``, ``paper_bf16``.

Two trees are compared on one card by running it on each in turns, as
parent, change, change, parent, each run its own process; ``tree`` in
the first line names the tree: run each tree's own copy of this script
(a tree before ``o1_wide_bf16`` runs its two wide paths).  Exits 2
without a CUDA device.
"""

import argparse
import sys
from pathlib import Path

PATHS = {"wide": ("o1_wide", "paper_wide", "o1_wide_bf16"),
         "d256": ("o1_bf16", "paper_bf16")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", choices=sorted(PATHS), default="wide")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("torch_wide_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from sessionrec_tpu_torch.ops import cuda_build, xent
    from sessionrec_tpu_torch.ops import xent_multi as xm
    from sessionrec_tpu_torch.train.runner import set_precision
    from sessionrec_tpu_torch.utils.profiling import (device_breakdown,
                                                      setup_runner)
    set_precision()
    smi = cs.phase_device(torch)
    cs.emit({"phase": "tree", "tree": str(tree), "set": args.set,
             "library": cuda_build.build_library().name})
    xm._library()
    if args.set == "wide":
        cs.phase_wide_times(torch, xent, xm, args.seed, smi,
                            (torch.float32, torch.bfloat16))
    else:
        cs.phase_kernel_times(torch, xent, args.seed, smi)
        cs.phase_bf16_path_times(torch, xent, args.seed, smi)
        cs.phase_multi_times(torch, xm, args.seed, smi)
    data = str(tree / "datasets" / "sample")
    for name in PATHS[args.set]:
        cs.phase_graph_vs_plain(torch, name, args.seed, data, smi)
        train, runner = setup_runner(cs.path_config(name, args.seed, data))
        cs.emit(dict(device_breakdown(train, runner, 16, 24, 12), path=name))
        del train, runner
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
