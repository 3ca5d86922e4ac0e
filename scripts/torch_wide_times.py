#!/usr/bin/env python3
"""K1-K4's times at D 512 and the wide paths' steps of one tree, on a card.

    python scripts/torch_wide_times.py [--tree DIR] [--seed 0]

Imports ``chip_smoke.py`` and ``sessionrec_tpu_torch`` from ``DIR`` (by
default the repository this script is in; the kernels build into
``DIR/build``) and runs, one JSON line each: the card's name and power
limit, ``chip_smoke.phase_wide_times`` (``kernel_time``, ``k1_launch``,
``k2_launch`` and ``multi_launch`` lines at D 512 on the path and
north-star catalogs) and ``chip_smoke.phase_graph_vs_plain`` for
``o1_wide`` and ``paper_wide`` on ``DIR/datasets/sample`` (8 graph steps
against 8 plain ones, then the ``host`` line: the synchronised ms a
step of the graph loop) and the ``profile`` line of 24 more steps under
``torch.profiler`` (the device's busy ms, its idle share, its largest
kernels).  Two trees are compared on one card by running
it on each in turns, as parent, change, change, parent, each run its own
process; ``tree`` in the first line names the tree.  Exits 2 without a
CUDA device.
"""

import argparse
import sys
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seed", type=int, default=0)
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
    cs.emit({"phase": "tree", "tree": str(tree),
             "library": cuda_build.build_library().name})
    xm._library()
    cs.phase_wide_times(torch, xent, xm, args.seed, smi)
    data = str(tree / "datasets" / "sample")
    for name in ("o1_wide", "paper_wide"):
        cs.phase_graph_vs_plain(torch, name, args.seed, data, smi)
        train, runner = setup_runner(cs.path_config(name, args.seed, data))
        cs.emit(dict(device_breakdown(train, runner, 16, 24, 12), path=name))
        del train, runner
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
