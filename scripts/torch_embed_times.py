"""The gather's backward (csrc/embed_bwd.cu) at the benchmark's training
cells' steps, on the card.

    python scripts/torch_embed_times.py [--cells o1-yc4-train paper-yc4-train]
        [--seed 2147483649] [--steps 3]

For each cell, the seed's training stream (``benchmark/harness/data.py``,
the cell's sessions) through the cell's ``BatchLoader`` (the ccs graphs,
batch 512, max_len 20, tiers (4, 8), in the stream's order): for
each of the first ``--steps`` steps the ids of its gathers (every tier's
levels) and their run profile (``step_profile``: slots, slots on row 0,
the longest run of any other row), then ``chip_smoke.py``'s
``embed_check`` (the kernel's bits against its plain version, a float64
sum) and ``embed_time`` (the kernel with its sort; torch's index backward
of one gather a tier and level summed by autograd, the path it replaced;
``F.embedding``'s backward of the flat ids; the plain version; the byte
bound) at those ids on the cell's padded catalog, at its width, float32.
JSON lines on stdout, the card's name and power limit on each timed one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+",
                    default=["o1-yc4-train", "paper-yc4-train"])
    ap.add_argument("--seed", type=int, default=2147483649)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "benchmark"))
    import torch

    import chip_smoke as cs
    from harness import data
    from harness.cells import Bench
    from sessionrec_tpu_torch.data.loader import BatchLoader
    from sessionrec_tpu_torch.ops import embed
    from sessionrec_tpu_torch.ops.scoring import pad_catalog
    from sessionrec_tpu_torch.train.runner import set_precision

    if not torch.cuda.is_available():
        print("torch_embed_times: no CUDA device", file=sys.stderr)
        return 2
    set_precision()
    smi = cs.phase_device(torch)
    bench = Bench(REPO)
    for name in args.cells:
        cell = bench.cell(name)
        cfg, mix = cell.config, cell.traffic
        d, m = cfg["data"], cfg["model"]
        lengths = data.load_profile(mix["lengths"])
        n = data.sessions_for_examples(lengths,
                                       cell.params["train_examples"])
        sessions = data.make_sessions(args.seed, "train", n,
                                      cfg["catalog"]["num_items"], lengths,
                                      data.load_profile(mix["items"]))
        loader = BatchLoader(sessions, "ccs", d["batch_size"], d["max_len"],
                             shuffle=False, order=m["order"], prefetch=0,
                             split_len=tuple(d["tiers"]))
        P = pad_catalog(cfg["catalog"]["num_items"])
        for step, batch in enumerate(cs.first_batches(loader, args.steps)):
            ids = cs.step_ids(batch.to("cpu"))
            n_slots, row0, rest = cs.run_profile(torch, ids)
            print(json.dumps({"phase": "step_profile", "cell": name,
                              "step": step, "gathers": len(ids),
                              "slots": n_slots, "row0_slots": row0,
                              "longest_other_run": rest}), flush=True)
            tags = dict(cell=name, step=step, stream_seed=args.seed)
            cs.embed_check(torch, embed, ids, P, m["embedding_dim"],
                           torch.float32, args.seed, **tags)
            cs.embed_times(torch, embed, ids, P, m["embedding_dim"],
                           torch.float32, args.seed, smi, **tags)
    return 0


if __name__ == "__main__":
    sys.exit(main())
