#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--steps 40]

Phases, one JSON line each on stdout:

1. device  — the card's name and power limit (nvidia-smi).
2. build   — compile the CUDA kernels (csrc/xent.cu) for sm_90a.
3. kernels — hold K1 (xent_fwd) and K2 (xent_bwd) against their plain
   PyTorch versions on the card at B=512, D=256, catalogs of 3,429 and
   37,484 items, float32 and bfloat16, with the table normalised and not,
   including a masked row, a zero-norm and a large-norm table row; then
   time each kernel, its plain version and one PyTorch call that computes
   the same function (``library_ms``, a yardstick the port never calls).
4. path    — train MSGIFSR order 1 at d=256, 1 layer, batch 512, tiers
   (4, 8), feat_drop 0.1 on datasets/sample through ``run_training``: an
   initial eval, ``--steps`` optimizer steps, a final eval.  The kernels'
   launch counts are set to 0 just before and read just after, and must
   equal the step count.  The loss must be finite and fall, HR@20 and
   MRR@20 finite, and one batch's loss and gradients must agree with the
   plain-PyTorch path on the CPU from the same parameters.

Then the ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
...}``.  Any failure exits non-zero before the last line.  Without a CUDA
device, or without the package beside this file, it exits 2.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

B, D, SCALE = 512, 256, 12.0
CATALOGS = (3429, 37484)      # datasets/sample; yoochoose-1/4 (bench.py:47)
PATH_ITEMS = 3429
ZERO_ROW = 5                  # the table row set to zero in the checks
LARGE_ROW = 7                 # the table row of norm ~50 in the checks
# published H100 SXM peaks (NVIDIA data sheet), dense, at 700 W
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
# tolerances, as a share of the reference's largest magnitude (max-abs
# error <= tol * max(1, max |ref|) for K1, tol * max |ref| for K2, where
# d_table is held group by group: rows hit by a label, the other catalog
# rows (softmax term only, orders of magnitude smaller), padding rows
# (exactly 0), the zero-norm row and the norm-50 row, each to its own
# largest magnitude): K1 accumulates the same products in float32 on both
# sides, only in another order; K2 rounds dz and, for bfloat16 tables,
# d_table to bfloat16, where an order difference can flip one rounding
# (2^-8 relative)
TOL = {("fwd", "float32"): 1e-5, ("fwd", "bfloat16"): 1e-5,
       ("bwd", "float32"): 1e-3, ("bwd", "bfloat16"): 1e-2}


def emit(obj):
    print(json.dumps(obj), flush=True)


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": line,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return line


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions, and timings
# ---------------------------------------------------------------------------

def make_inputs(torch, n_items, P, dtype, seed, dev="cuda"):
    """sr rows unit-norm (as the model emits them), table rows inside the
    max-norm ball except one zero row and one of norm ~50; row 3 is a
    masked row (g = 0, label -1)."""
    gen = torch.Generator().manual_seed(seed)
    sr = torch.randn(B, D, generator=gen)
    sr = sr / sr.norm(dim=1, keepdim=True)
    tab = (torch.rand(P, D, generator=gen) * 2 - 1) / math.sqrt(D)
    tab[ZERO_ROW] = 0.0
    tab[LARGE_ROW] *= 50.0
    labels = torch.randint(0, n_items, (B,), generator=gen,
                           dtype=torch.int32)
    labels[3] = -1
    valid = torch.ones(B)
    valid[3] = 0.0
    g = valid / valid.sum()
    return (sr.to(dev, dtype), tab.to(dev, dtype), labels.to(dev),
            g.to(dev))


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def dtable_groups(torch, labels, n_items, P):
    """Boolean row masks of d_table, each held to its own scale."""
    rows = torch.arange(P, device=labels.device)
    special = (rows == ZERO_ROW) | (rows == LARGE_ROW)
    hit = torch.zeros(P, dtype=torch.bool, device=labels.device)
    hit[labels[labels >= 0].long()] = True
    groups = {"labelled": hit & ~special,
              "unlabelled": ~hit & ~special & (rows < n_items),
              "zero_row": rows == ZERO_ROW, "large_row": rows == LARGE_ROW}
    if P > n_items:
        groups["padding"] = rows >= n_items
    return groups


def dtable_errors(torch, got, want, labels, n_items, tol):
    """{group: [max abs err, tolerance]} of d_table, each group of rows
    held to tol times its own largest reference magnitude."""
    return {name: [max_err(got[rows], want[rows]),
                   tol * float(want[rows].float().abs().max())]
            for name, rows in dtable_groups(torch, labels, n_items,
                                            want.shape[0]).items()}


def phase_kernel_checks(torch, xent, seed):
    cases = []
    for n_items in CATALOGS:
        from sessionrec_tpu_torch.ops.scoring import pad_catalog
        for P in (pad_catalog(n_items), n_items):
            for dtype in (torch.float32, torch.bfloat16):
                for norm in (True, False):
                    cases.append((n_items, P, dtype, norm))
    worst = {"xent_fwd": 0.0, "xent_bwd": 0.0}
    for i, (n_items, P, dtype, norm) in enumerate(cases):
        sr, tab, labels, g = make_inputs(torch, n_items, P, dtype, seed + i)
        kw = dict(scale=SCALE, normalize_table=norm)
        loss_k, lse_k = xent._fwd_cuda(sr, tab, labels, n_items, 0, **kw)
        m, s, zl = xent._fwd_plain(sr, tab, labels, n_items, 0, **kw)
        lse_p = xent._finish_lse(m, s)
        loss_p = lse_p - zl
        dsr_k, dtab_k = xent._bwd_cuda(g, sr, tab, labels, lse_p, n_items,
                                       0, **kw)
        dsr_p, dtab_p = xent._bwd_plain(g, sr, tab, labels, lse_p, n_items,
                                        0, **kw)
        torch.cuda.synchronize()
        dname = str(dtype).split(".")[-1]
        e_fwd = max(max_err(loss_k, loss_p), max_err(lse_k, lse_p))
        ref_fwd = max(1.0, float(lse_p.abs().max()))
        tol = TOL[("bwd", dname)]
        e_dsr = max_err(dsr_k, dsr_p)
        # the zero-norm row's gradient is G / eps, about 1e12 times the
        # others, and rows with no label carry only the softmax term
        dtab = dtable_errors(torch, dtab_k, dtab_p, labels, n_items, tol)
        row = {"phase": "kernel_check", "items": n_items, "P": P,
               "dtype": dname, "normalize_table": norm,
               "fwd_max_abs_err": e_fwd, "dsr_max_abs_err": e_dsr,
               "fwd_tol": TOL[("fwd", dname)] * ref_fwd,
               "dsr_tol": tol * float(dsr_p.abs().max()),
               "dtable_err_tol": dtab}
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (loss_k, lse_k, dsr_k, dtab_k))
        row["ok"] = (finite and e_fwd <= row["fwd_tol"]
                     and e_dsr <= row["dsr_tol"]
                     and all(e <= t for e, t in dtab.values()))
        emit(row)
        check(row["ok"], f"kernel disagrees with its plain version: {row}")
        if P == pad_catalog(PATH_ITEMS) and dtype == torch.float32 and norm:
            worst["xent_fwd"] = e_fwd
            worst["xent_bwd"] = max(
                [e_dsr] + [e for name, (e, _) in dtab.items()
                           if name != "zero_row"])
    return worst


def time_ms(torch, fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bounds(n_bytes, n_ops, dname):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_OPS[dname] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def phase_kernel_times(torch, xent, seed, smi):
    """Times at B=512, D=256, normalised table, both catalogs and types."""
    import torch.nn.functional as F
    from sessionrec_tpu_torch.ops.scoring import pad_catalog
    rows = {}
    for n_items in CATALOGS:
        P = pad_catalog(n_items)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            sr, tab, labels, g = make_inputs(torch, n_items, P, dtype, seed)
            kw = dict(scale=SCALE, normalize_table=True)
            iters = 50 if P < 10000 else 10
            _, lse = xent._fwd_cuda(sr, tab, labels, n_items, 0, **kw)

            def plain_fwd():
                m, s, zl = xent._fwd_plain(sr, tab, labels, n_items, 0, **kw)
                return xent._finish_lse(m, s) - zl

            lbl = labels.clamp(min=0).long()
            imask = torch.arange(P, device="cuda") < n_items
            # in the operands' own type: a bfloat16 product accumulates in
            # float32 inside cuBLAS, as the kernels do
            srl = sr.detach().clone().requires_grad_(True)
            tabl = tab.detach().clone().requires_grad_(True)

            def lib_fwd():
                z = SCALE * srl @ F.normalize(tabl, dim=1).T
                z = torch.where(imask, z, -1e30)
                return F.cross_entropy(z, lbl, reduction="none")

            lib_loss = lib_fwd()

            g_lib = g.to(lib_loss.dtype)

            def lib_bwd():
                return torch.autograd.grad(lib_loss, (srl, tabl), g_lib,
                                           retain_graph=True)

            ops_f = 2 * B * P * D + 2 * P * D
            esz = sr.element_size()
            bytes_f = (B * D + P * D) * esz + B * 4 + 2 * B * 4
            ops_b = 3 * 2 * B * P * D + 2 * P * D
            bytes_b = (B * D + 2 * P * D) * esz + 3 * B * 4 + B * D * 4
            bf, byf = bounds(bytes_f, ops_f, dname)
            bb, byb = bounds(bytes_b, ops_b, dname)
            res = {
                "xent_fwd": {
                    "ms": time_ms(torch, lambda: xent._fwd_cuda(
                        sr, tab, labels, n_items, 0, **kw), iters),
                    "plain_ms": time_ms(torch, plain_fwd, iters),
                    "library_ms": time_ms(torch, lib_fwd, iters),
                    "bound_ms": bf, "bound_by": byf},
                "xent_bwd": {
                    "ms": time_ms(torch, lambda: xent._bwd_cuda(
                        g, sr, tab, labels, lse, n_items, 0, **kw), iters),
                    "plain_ms": time_ms(torch, lambda: xent._bwd_plain(
                        g, sr, tab, labels, lse, n_items, 0, **kw), iters),
                    "library_ms": time_ms(torch, lib_bwd, iters),
                    "bound_ms": bb, "bound_by": byb},
            }
            for name, r in res.items():
                emit({"phase": "kernel_time", "kernel": name,
                      "items": n_items, "P": P, "B": B, "D": D,
                      "dtype": dname, "normalize_table": True, **r,
                      "card": smi})
            rows[(n_items, dname)] = res
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def phase_path(torch, xent, steps, seed, dataset_dir, smi):
    from sessionrec_tpu_torch.train.runner import make_loss
    from sessionrec_tpu_torch.train.session import run_training
    from sessionrec_tpu_torch.utils.config import preset

    cfg = preset("msgifsr", order=1, embedding_dim=256, num_layers=1,
                 feat_drop=0.1, batch_size=512, split_len=(4, 8),
                 dataset_dir=str(dataset_dir), epochs=1, seed=seed,
                 log_interval=10, device="cuda")
    xent.reset_launches()
    t0 = time.perf_counter()
    runner = run_training(cfg, max_epoch_batches=steps)
    mrr, hit = runner.max_mrr, runner.max_hit
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"xent_fwd": xent.fwd_launches, "xent_bwd": xent.bwd_launches}

    losses = runner.losses
    n = runner.steps
    head, tail = losses[:5], losses[-5:]
    row = {"phase": "path", "model": "msgifsr", "order": 1, "dim": 256,
           "layers": 1, "batch": 512, "tiers": [4, 8], "steps": n,
           "launches": launches, "first_losses": head, "last_losses": tail,
           "mrr20": mrr, "hr20": hit,
           "train_examples": runner.train_examples,
           "train_seconds": runner.train_seconds,
           "examples_per_s": runner.train_examples
           / max(runner.train_seconds, 1e-9),
           "wall_seconds": wall, "card": smi}
    emit(row)
    check(n == steps, f"ran {n} steps, expected {steps}")
    check(launches["xent_fwd"] == n and launches["xent_bwd"] == n,
          f"kernel launches {launches} != steps {n}")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    check(sum(tail) / len(tail) < sum(head) / len(head),
          f"loss did not fall: {head} -> {tail}")
    check(math.isfinite(mrr) and math.isfinite(hit), "non-finite metrics")

    # one batch through the kernels against the plain path on the CPU
    model = runner.model
    batch = next(iter(runner.test_loader))
    model.zero_grad(set_to_none=True)
    loss_gpu = make_loss(model, batch, None)
    loss_gpu.backward()
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu_model.zero_grad(set_to_none=True)
    loss_cpu = make_loss(cpu_model, batch.to("cpu"), None)
    loss_cpu.backward()
    errs = {"loss": abs(float(loss_gpu.detach()) - float(loss_cpu.detach()))}
    ok = errs["loss"] <= 1e-4 * abs(float(loss_cpu.detach()))
    for name in ("embedding", "fc_sr.0.weight",
                 "layers.0.conv1.intra1.fc"):
        pg = dict(model.named_parameters())[name].grad.cpu()
        pc = dict(cpu_model.named_parameters())[name].grad
        errs[name] = max_err(pg, pc)
        ok = ok and errs[name] <= 1e-3 * float(pc.abs().max())
    emit({"phase": "path_vs_cpu", "max_abs_err": errs, "ok": ok})
    check(ok, f"GPU path disagrees with the CPU plain path: {errs}")
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--dataset-dir", default=str(HERE / "datasets" / "sample"))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (HERE / "sessionrec_tpu_torch" / "csrc" / "xent.cu").is_file():
        print("chip_smoke: sessionrec_tpu_torch not found beside this file",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from sessionrec_tpu_torch.ops import xent
    from sessionrec_tpu_torch.train.runner import set_precision
    set_precision()

    try:
        smi = phase_device(torch)
        t0 = time.perf_counter()
        lib = xent.build_library()
        xent._library()
        emit({"phase": "build", "library": lib.name,
              "seconds": time.perf_counter() - t0})
        errs = phase_kernel_checks(torch, xent, args.seed)
        times = phase_kernel_times(torch, xent, args.seed, smi)
        launches = phase_path(torch, xent, args.steps, args.seed,
                              args.dataset_dir, smi)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    path = times[(PATH_ITEMS, "float32")]
    replaces = {"xent_fwd": "sessionrec_tpu/ops/xent.py:71",
                "xent_bwd": "sessionrec_tpu/ops/xent.py:164"}
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": "sessionrec_tpu_torch/csrc/xent.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": path[name]["ms"],
         "plain_ms": path[name]["plain_ms"],
         "bound_ms": path[name]["bound_ms"],
         "bound_by": path[name]["bound_by"],
         "library_ms": path[name]["library_ms"]}
        for name in ("xent_fwd", "xent_bwd")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
