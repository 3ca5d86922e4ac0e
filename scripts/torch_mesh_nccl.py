"""`cli train` on a 2 x 2 mesh (NCCL, a process a card) against one card.

    python scripts/torch_mesh_nccl.py          # on a host with 4 cards
    python scripts/torch_mesh_nccl.py --cpu    # gloo, on the CPU, d 16

For o1 (MSGIFSR order 1), the paper head and LESSR at their presets:
8 steps each (``--unroll 1``, so every step's loss is logged), then the
test split's eval, once on one card and once on the mesh; prints one
JSON line a model with both runs' logged losses, examples/s and final
metrics, and the losses' largest relative gap.  Needs no JAX.
"""
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
cpu = "--cpu" in sys.argv
BASE = ["train", "--dataset-dir", str(REPO / "datasets" / "sample"),
        "--epochs", "1", "--max-epoch-batches", "8", "--log-interval", "1",
        "--unroll", "1"]
if cpu:
    BASE += ["--device", "cpu", "--embedding-dim", "16", "--batch-size", "64",
             "--valid-split", "0.01"]
HEADS = {"o1": ["--model", "msgifsr", "--order", "1"],
         "paper": ["--model", "msgifsr", "--order", "3", "--extra", "--fusion"],
         "lessr": ["--model", "lessr"]}
STEP = re.compile(r"step (\d+): loss = ([\d.]+), ([\d.]+) examples/s")
FINAL = re.compile(r"^([\d.]+)%\t([\d.]+)%\s*$", re.M)


def run(extra):
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "sessionrec_tpu_torch.cli",
                        *BASE, *extra], capture_output=True, text=True,
                       timeout=600, cwd=REPO)
    out = p.stdout + p.stderr
    if p.returncode != 0:
        print(out[-4000:])
        raise SystemExit(f"rc {p.returncode}: {extra}")
    steps = [(int(a), float(b), float(c)) for a, b, c in STEP.findall(out)]
    final = [tuple(map(float, m)) for m in FINAL.findall(out)]
    return dict(losses=[s[1] for s in steps], rates=[s[2] for s in steps],
                final=final, seconds=time.perf_counter() - t0,
                staged="gloo stages" in out, lines=out.count("MRR@20"))


if not cpu:
    from sessionrec_tpu_torch.ops import cuda_build
    from sessionrec_tpu_torch.data import native_collate
    cuda_build.build_library()
    native_collate.library()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout, flush=True)
for name, head in HEADS.items():
    one = run(head)
    mesh = run(head + ["--data-parallel", "2", "--model-parallel", "2"])
    gap = max(abs(a - b) / b for a, b in zip(mesh["losses"], one["losses"]))
    print(json.dumps({"phase": f"nccl_{name}", "one": one, "mesh": mesh,
                      "loss_max_rel_gap": gap}), flush=True)
