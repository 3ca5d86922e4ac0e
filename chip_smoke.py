#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed 0] [--steps 40]

Phases, one JSON line each on stdout:

1. device  — the card's name and power limit (nvidia-smi).
2. build   — compile the CUDA kernels (csrc/*.cu) for sm_90a.
3. kernels — hold K1 (xent_fwd) and K2 (xent_bwd) against their plain
   PyTorch versions on the card at B=512, D=256, catalogs of 3,429 and
   37,484 items, float32 and bfloat16, with the table normalised and not,
   including a masked row, a zero-norm and a large-norm table row, plus
   one ragged case of B=509 rows on the unpadded 37,484-row catalog, and
   the SRGNN/NISER and LESSR paths' shapes (B=128, D=64 and B=512, D=32)
   on both catalogs, padded and not, float32, normalised and not; K1 and
   K2 run twice on every case and must give the same bits both times; then K3
   (xent_multi_fwd) and K4 (xent_multi_bwd) at K=3 orders of the D=256
   rows, with session item lists of up to 19 ids (-1 padded), a row with
   none, labels inside and outside the session, and the cotangents of the
   paper head's loss, plus the ragged batch on the unpadded north-star
   catalog; K3 and K4 too run twice on every case and must repeat their
   bits.
   Then time each kernel, its plain version and the PyTorch expression of
   the same function (``library_ms``, a yardstick the port never calls,
   timed by CUDA events; ``library_kernel_ms``, its device time under
   ``torch.profiler``, summed over its kernels), with K1's launch shape
   (``k1_launch``), K2's (``k2_launch``) and K3's and K4's
   (``multi_launch``) at each timed shape: blocks, splits, resident
   blocks per SM, the product kernels' registers and local memory, K1's
   and K3's shared memory and staging stages (``ring_stages``), and
   each kernel's device time under ``torch.profiler`` with their sum
   against the events time of the same calls (``trace``; the
   ``kernel_time`` lines hold the library's the same way,
   ``library_trace``); K1 and K2 also at
   each family path's rows, width, normalisation and scale on the path
   catalog, and in bf16 at the o1_bf16 path's shape, the raw table (the
   normalisation folded in, as the path calls them) against one
   normalised before the call (``"path": "o1_bf16"``).  ``sround_time``:
   ``stochastic_round_bf16`` on the card gives the CPU's bits at 3,584 and
   37,888 rows of D, and its time and that of the whole bf16 table update
   of a step (``runner.apply_table_update``), with their byte bounds.
   ``embed_check``: the gather's backward (``embed_bwd``,
   csrc/embed_bwd.cu) gives the bits of its plain version on the card,
   twice, and a float64 sum to ``EMBED_TOL``, at the o1 and paper paths'
   first step (every tier's and level's ids) and at a padding run of
   16,384 slots, on both catalogs, float32 and bfloat16; ``embed_time``:
   its times at the two steps (events, and each kernel's device ms, the
   sort's included) beside torch's index backward of one gather a tier
   and level (``torch_ms``, the path it replaced), ``F.embedding``'s
   backward of the flat ids (``library_ms``), the plain version and the
   byte bound.
4. path    — train MSGIFSR order 1 at d=256, 1 layer, batch 512, tiers
   (4, 8), feat_drop 0.1 on datasets/sample through ``run_training`` at
   the defaults (the native batch builder, ``unroll`` 8), with a
   checkpoint directory and a metrics file: an initial eval, ``--steps``
   optimizer steps (the first 8 eager, the rest as replays of one
   captured 8-step CUDA graph), a final eval and a checkpoint, whose
   ``epoch_0000/params.pt``, ``train.pt`` and sidecar must exist, as
   must ``train`` and ``eval`` events with the JAX package's keys.  The
   kernel wrappers' counters (``xent.fwd``, ``xent.bwd``,
   ``xent_multi.fwd``, ``xent_multi.bwd`` of ``utils/profiling.py``,
   tracing on for the whole run) are emptied just before and read just
   after: K1, K2 and the gather's backward (``embed.bwd``) must have
   launched, K3 and K4 not.  The wrappers
   count the eager launches and the captured ones (a capture records a
   launch, a replay runs it without calling the wrapper; a ``StepGraph``
   keeps its capture's ``counts``), so the device's launches are counted
   two ways: the run's eager launches plus ``runner.launches`` of each
   graph (captured times replays), which must give K1, K2 and
   ``embed_bwd`` once per step and K3 and K4 never; and by kernel name in a
   ``torch.profiler`` trace of one more chunk of replays
   (``launch_count_method`` says which held; the second where the trace
   sees no kernels inside replays).  The loss must be finite and fall,
   HR@20 and MRR@20 finite, and one batch's loss and gradients must
   agree with the plain-PyTorch path on the CPU from the same parameters
   (``path_vs_cpu``), and every ``torch.relu`` input to RELU_GAP of its
   call's largest (``relu_gap``); at an input that takes the other branch
   on the card (``relu_flips``, so a tie within RELU_GAP of 0) the card
   may instead agree with the CPU run again with the other branch there
   (``at_ties``), and a failing check adds ``plain_on_card``: the same
   gradients with K1-K4's plain versions run on the card.
   Then ``o1_serve``: ``train.pt`` is deleted and the parameters alone
   restore into a fresh model, bit for bit; ``recommend`` over the test
   split's full sessions at batch 512 and k 20 gives the CPU's ids at
   every position whose CPU score is more than 1e-5 from its
   neighbours', and its scores to 1e-4; one recommend step is timed
   (sessions/s, median and p99 ms a batch, whether its CUDA graph ran).
   ``o1_eval``: the test split through an eager sweep and through the
   runner's eval graphs gives (hit, mrr, n) sums equal to 1e-6, with ms
   a batch of each.
   Then ``path_graph_vs_plain``: from one copy of the parameters, Adam's
   state, the schedule and the dropout counter, 8 batches through the
   graph and the same 8 through the plain ``train_step`` on the card
   give the same losses (rtol 1e-4) and parameters (atol 1e-5), and a
   ``host`` line: ms per step building, waiting for and running the
   batches, and examples/s, of the graph loop.
5. paper   — the same for the WSDM'22 paper head (order 3, REnorm,
   fusion) at the same widths: K3, K4 and ``embed_bwd`` launch once per
   step, K1 and K2 never; ``paper_serve``, ``paper_eval``.
6. srgnn, niser, lessr — the same for SRGNN (d=64, 2 layers, batch 128,
   feat_drop 0.5, shuffled), NISER+ (the same, normalised, scale 12) and
   LESSR (d=32, 3 layers EOPA/SGAT/EOPA, batch 512, feat_drop 0.2,
   BatchNorm), each at its preset with tiers (4, 8): K1 and K2 once per
   step, K3 and K4 never; ``*_vs_cpu`` holds LESSR's BatchNorm buffers
   after the forward too (1e-5 of their scale), and serving, eval and
   ``*_graph_vs_plain`` restore and compare the buffers with the
   parameters.
7. o1_bf16, paper_bf16 — the two MSGIFSR paths with a bfloat16 table
   and bfloat16 compute (the paper head 16 steps): K1/K2's (K3/K4's) bf16
   branches once per step, counted both ways and, in the traced replay,
   by their bf16 instantiation; the table bf16 after the run, its Adam
   moments float32, its step count the run's; ``*_vs_cpu`` holds the card
   against the CPU in bf16 (``vs_cpu_bf16``: the loss to 1e-2, each
   gradient's error against the CPU's float32-compute gradient within 3
   times the CPU bf16 run's, or 9e-2); serving's ids and scores against
   the CPU's at bf16's ties (``BF16_TIE``, ``BF16_SCORE``); graph and
   plain steps bit-identical, stochastic rounding included.
8. o1_resume, lessr_resume, o1_bf16_resume — 2 epochs of 16 batches
   uninterrupted, against 1 epoch and then a fresh runner that resumes
   from its checkpoint for the second: losses to rtol 1e-4, parameters and
   buffers to atol 1e-5, max_mrr / max_hit to 1e-5, bad_counter equal;
   ``bit_identical`` says whether every loss and state tensor came out
   equal (required of o1_bf16).

9. niser_1m, paper_1m — the JAX package's million-item configurations
   (bench.py:93, :149) on a split written from ``--seed`` (2^20 items,
   ids uniform, session lengths drawn from datasets/sample's train
   sessions; 3,000 train and 640 test sessions).  Before the paths, K1
   and K2 at niser_1m's shape (B 512, D 64, P 2^20, normalised, scale 12)
   and K3 and K4 at paper_1m's (B 64, K 3, D 256, P 2^20) against their
   plain versions on the card, and their times (K3/K4 also at B 512).
   ``*_train``: NISER+ (batch 512, d 64, 2 layers, feat_drop 0.5) 16
   steps, the paper head (order 3, REnorm, fusion, d 256) 8, through
   ``run_training`` with its evals at the auto policy: the path's kernels
   once a step, the others never, and the device ms a step of one more
   traced chunk.  ``*_eval``: the runner's sweep (niser_1m materialises,
   paper_1m streams), then each method through a one-batch eval graph
   (capture seconds, replay ms a batch, peak memory): streamed against
   materialised (paper_1m at batch 64, where ``[B, K, P]`` fits),
   HR@20/MRR@20 to 1e-6 and ranks equal on every row whose label is not
   within 1e-5 (relative) of another item's score, on the test labels
   and on labels placed at ranks 1..30 with exact ties from a copied
   table row; the ``topk`` rank method on one batch; niser_1m also a
   batch of 1,024 examples (1,056 rows with its tiers' padding), which
   the auto policy streams.  ``niser_1m_serve``
   as the other paths serve (from the checkpoint, against the CPU);
   ``paper_1m_serve`` auto-streamed at the tile of 32,768 and at 2,048,
   ids against the materialised top-k at batch 64.  Every phase prints
   its peak memory.

10. mesh — the (data, model) mesh (``sessionrec_tpu_torch/parallel/``).
   Before the paths, K1-K4 against their plain versions on a catalog
   shard: rank (0, 1) of a (2, 2) mesh on the padded path catalog (rows
   1,792.. of 3,584, 1,637 real), 256 rows a rank, with the operands the
   mesh's losses give them (``col_offset`` 1,792, ``n_valid`` at the
   shard's last item, off-shard labels -1), float32 and bfloat16,
   normalised and not (``kernel_check`` / ``multi_kernel_check`` lines
   with ``"mesh_shard": true``), and their times at that shape
   (``kernel_time`` lines with ``"path": "mesh_shard"``).  Then o1 and
   the paper head at full width: each first on the card alone (4 eager
   steps, dropout on, its state and gradients after each step, its eval
   sweep, the full ranks of the test split at its final parameters),
   then on 4 ranks on this one card (``--mesh-worker``, one process a
   rank, gloo, ``[cuda:0] x 4``; the kernel library is built before they
   start): the same 4 steps from the same seed, each rank its data
   position's rows of every tier and its model position's shard of the
   table, step 1 from the mesh's own initial state and each later step
   from the card's state before it (so each step is held on its own,
   with no drift carried from the steps before).  ``mesh_o1`` /
   ``mesh_paper``: the losses (rtol 1e-4), the gathered state after each
   step (rtol 1e-4, atol 1e-5): the table and its Adam moments with no
   exception; the replicated graph side on at most 2e-4 of all the
   state's elements, each within lr of the card's (``MESH_SHARE``; with
   the card's gradient of each such element, to show its cause), HR@20
   and MRR@20 of each side's own
   parameters within 2 rows of the test split, the full ranks at the
   card's parameters equal on every row but near ties (``REL_TIE``,
   counted as ``excluded``) and exact ties on the card alone (counted as
   ``mismatched_at_tie``), and K1/K2 (K3/K4) once a step on every rank,
   the others never (``embed_bwd`` too: the mesh gathers through its own
   lookup); with which collectives gloo staged through host
   memory and the seconds a step (gloo on one card: not a speed figure;
   NCCL, which needs a card a rank, is not run).

11. wide — K1-K4 past 256 features, the slab kernels (csrc/tiles.cuh's
   slab path): against their plain versions at D = 258 (no multiple of
   4: staged by plain loads), 512 and 1,000, B 512 on the padded path
   catalog, float32 and bfloat16, normalised and not, the backward
   kernels twice with their bits repeated (``kernel_check`` /
   ``multi_kernel_check`` lines with ``"wide": true``); K2 and K4 at D 512
   and 1,000 with the dz scratch cap lowered so that their catalog goes in
   3 and 10 chunks (``"forced_chunks"``); K3/K4 with item
   lists of 300 and 1,024 ids at D 256 and 512 (``"long_items": true``);
   K1-K4 on the mesh's catalog shard (column offset 1,792) at D 512; and
   their times at D 512 on the path and north-star catalogs
   (``kernel_time``, ``k1_launch``, ``k2_launch``, ``multi_launch`` lines
   with ``"D": 512``; the launch lines split each call by kernel: dz, the
   two products, the two reduces).

12. raw clicks to a trained model — ``preprocess``: a gowalla-shaped log
   of 500,000 check-ins from ``--seed`` (``gowalla_log``), through
   ``python -c ... cli preprocess --dataset gowalla`` in a subprocess with
   pandas blocked, its seconds, events/s, sessions and items, and the
   sha256 of its three files against the JAX package's (PRE_SHA256, seed
   0).  ``gowalla_o1``: MSGIFSR order 1 at its preset on that output, 16
   steps (8 eager, one 8-step replay), as phase 4 runs a path (K1/K2 once a
   step, K3/K4 never, ``*_vs_cpu``, serving and eval against the CPU and
   the eager sweep, 8 graph steps against 8 plain ones).  ``o1_wide`` and
   ``paper_wide``: the o1 and paper heads at ``--embedding-dim 512`` on
   datasets/sample, 16 and 8 steps, the same way but without serving;
   ``o1_wide_bf16``: the o1 head at 512 in full bfloat16, 16 steps, the
   same way (K1's and K2's slab kernels on the tensor cores, counted in
   the trace as their bfloat16 instantiations, ``vs_cpu_bf16``).
   ``late_seconds`` gives each of these phases' seconds.

Then the ``{"kernels": [...]}`` line (each kernel's ``mesh_launches``
summed over the ranks) and, last, ``{"ok": true, "device":
...}``.  Any failure exits non-zero before the last line.  Without a CUDA
device, or without the package beside this file, it exits 2.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

B, D, SCALE = 512, 256, 12.0
K = 3                         # orders of the paper head
NS = 19                       # longest session item list on datasets/sample
CATALOGS = (3429, 37484)      # datasets/sample; yoochoose-1/4 (bench.py:47)
RAGGED_B = 509                # rows of the ragged K1-K4 checks
# K1/K2 on the SRGNN, NISER and LESSR paths (their presets): rows, width,
# table normalised, logit scale
FAMILY_XENT = {"srgnn": (128, 64, False, 1.0), "niser": (128, 64, True, 12.0),
               "lessr": (512, 32, False, 1.0)}
FAMILY_SHAPES = {k: v[:2] for k, v in FAMILY_XENT.items()}
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
# K3's five stats are held element by element to 1e-5 (TOL "fwd") of their
# scale (stats_errors), K4 as K2, with d_table's rows hit only by session
# items (p_in terms) a group of their own
STATS = ("m_in", "s_in", "m_ex", "s_ex", "zl")
# the metrics events' keys, in order: the JAX package's schema
# (sessionrec_tpu/train/runner.py:668-689, tests/test_torch_metrics.py)
EVENT_KEYS = {"train": ["ts", "kind", "step", "epoch", "loss",
                        "examples_per_s"],
              "eval": ["ts", "kind", "step", "epoch", "mrr", "hit",
                       "examples_per_s"]}
# phase-name prefix of each path
SHORT = {"path": "o1", "paper": "paper", "srgnn": "srgnn", "niser": "niser",
         "lessr": "lessr", "o1_bf16": "o1_bf16", "paper_bf16": "paper_bf16",
         "niser_1m": "niser_1m", "gowalla_o1": "gowalla_o1",
         "o1_wide": "o1_wide", "paper_wide": "paper_wide",
         "o1_wide_bf16": "o1_wide_bf16"}
TOPK = 20                                  # serving's k
SCORE_TIE = 1e-5     # adjacent CPU scores closer than this may swap ids
SCORE_ATOL = 1e-4    # card against CPU serving scores
SUMS_ATOL = 1e-6     # eval graph against the eager sweep, (hit, mrr, n)
# float32 paths, card against CPU: every ``torch.relu`` input (MSGIFSR's
# REnorm gate) to RELU_GAP of its call's largest CPU magnitude.  On an
# H100 the gate's inputs differ by up to 1.11e-6 of it (paper_wide,
# PERF.md section 6); a wrong gate layer, bf16 weights or one input moved,
# by more than 9x RELU_GAP (tests/test_torch_smoke_checks.py).  An input
# that close to 0 is a tie, whose two branches are both right
RELU_GAP = 1e-5
# bf16 paths, card against CPU: both run every layer in bf16, rounding
# each op's output (8 mantissa bits), in another order.  Serving scores
# are held to BF16_SCORE of each row's largest magnitude, ids where the
# CPU's neighbours lie more than BF16_TIE of it apart (the JAX package's
# and the port's bf16 scores differ by up to 0.9% on the CPU,
# tests/test_torch_bf16.py); the loss to BF16_LOSS relative; a gradient's
# error against the CPU's float32-compute gradient to BF16_GRAD times the
# CPU bf16 run's own error, or BF16_GRAD * BF16_FLOOR where that is less
# (tests/test_torch_bf16_heads.py)
BF16_TIE = 1.5e-2
BF16_SCORE = 3e-2
BF16_LOSS = 1e-2
BF16_GRAD, BF16_FLOOR = 3.0, 3e-2
# catalogs of the stochastic-rounding pass: the path's table and the
# north star's, both D wide
SROUND_ROWS = (3584, 37888)


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

def make_inputs(torch, n_items, P, dtype, seed, dev="cuda", rows=B, dim=D):
    """``rows`` sr rows of width ``dim``, unit-norm (as the model emits
    them), table rows inside the max-norm ball except one zero row and one
    of norm ~50; row 3 is a masked row (g = 0, label -1)."""
    gen = torch.Generator().manual_seed(seed)
    sr = torch.randn(rows, dim, generator=gen)
    sr = sr / sr.norm(dim=1, keepdim=True)
    tab = (torch.rand(P, dim, generator=gen) * 2 - 1) / math.sqrt(dim)
    tab[ZERO_ROW] = 0.0
    tab[LARGE_ROW] *= 50.0
    labels = torch.randint(0, n_items, (rows,), generator=gen,
                           dtype=torch.int32)
    labels[3] = -1
    valid = torch.ones(rows)
    valid[3] = 0.0
    g = valid / valid.sum()
    return (sr.to(dev, dtype), tab.to(dev, dtype), labels.to(dev),
            g.to(dev))


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def fwd_errors(got, want, tol):
    """[max abs err, tolerance] of K1's (loss, lse), held to tol times the
    reference's largest log-partition magnitude (at least 1)."""
    err = max(max_err(a, b) for a, b in zip(got, want))
    return [err, tol * max(1.0, float(want[1].abs().max()))]


def dsr_errors(got, want, tol):
    """[max abs err, tolerance] of d_sr, held to tol times the reference's
    largest magnitude."""
    return [max_err(got, want), tol * float(want.abs().max())]


def dtable_groups(torch, labels, n_items, P, iids=None):
    """Boolean row masks of d_table, each held to its own scale: rows hit
    by a label, rows hit only by a session item (given ``iids``), the
    other catalog rows, padding rows, the zero-norm and norm-50 rows."""
    rows = torch.arange(P, device=labels.device)
    special = (rows == ZERO_ROW) | (rows == LARGE_ROW)
    hit = torch.zeros(P, dtype=torch.bool, device=labels.device)
    hit[labels[labels >= 0].long()] = True
    groups = {"labelled": hit & ~special}
    if iids is not None:
        sess = torch.zeros(P, dtype=torch.bool, device=labels.device)
        sess[iids[iids >= 0].long()] = True
        groups["session"] = sess & ~hit & ~special
        hit = hit | sess
    groups.update({"unlabelled": ~hit & ~special & (rows < n_items),
                   "zero_row": rows == ZERO_ROW,
                   "large_row": rows == LARGE_ROW})
    if P > n_items:
        groups["padding"] = rows >= n_items
    return groups


def dtable_errors(torch, got, want, labels, n_items, tol, iids=None):
    """{group: [max abs err, tolerance]} of d_table, each group of rows
    held to tol times its own largest reference magnitude; a group with no
    row (long session item lists can hit every catalog row) is left out."""
    return {name: [max_err(got[rows], want[rows]),
                   tol * float(want[rows].float().abs().max())]
            for name, rows in dtable_groups(torch, labels, n_items,
                                            want.shape[0], iids).items()
            if bool(rows.any())}


def check_cases(torch):
    """(items, table rows, type, normalised) of every kernel check: both
    catalogs, padded and not, float32 and bfloat16, normalised and not."""
    from sessionrec_tpu_torch.ops.scoring import pad_catalog
    return [(n_items, P, dtype, norm) for n_items in CATALOGS
            for P in (pad_catalog(n_items), n_items)
            for dtype in (torch.float32, torch.bfloat16)
            for norm in (True, False)]


def xent_check_cases(torch):
    """(items, table rows, type, normalised, batch rows, width) of the
    K1-K4 checks: ``check_cases`` at B rows of width D, a ragged batch on
    the unpadded north-star catalog, whose row and catalog edges fall
    inside tiles, and K1/K2's shapes on the SRGNN/NISER and LESSR paths
    (``FAMILY_SHAPES``) on both catalogs, padded and not, float32, the
    table normalised and not; K3/K4 take only the width-D cases."""
    from sessionrec_tpu_torch.ops.scoring import pad_catalog
    return ([case + (B, D) for case in check_cases(torch)]
            + [(CATALOGS[1], CATALOGS[1], torch.float32, True, RAGGED_B, D)]
            + [(n_items, P, torch.float32, norm, rows, dim)
               for rows, dim in sorted(set(FAMILY_SHAPES.values()))
               for n_items in CATALOGS
               for P in (pad_catalog(n_items), n_items)
               for norm in (True, False)])


def xent_check(torch, xent, case, seed, **tags):
    """K1 and K2 against their plain versions at one case of
    ``xent_check_cases``: emits the ``kernel_check`` line, fails on a
    disagreement, and returns (K1's error, K2's largest error but the
    zero-norm row's)."""
    n_items, P, dtype, norm, rows, dim = case
    sr, tab, labels, g = make_inputs(torch, n_items, P, dtype, seed,
                                     rows=rows, dim=dim)
    kw = dict(scale=SCALE, normalize_table=norm)
    loss_k, lse_k = xent._fwd_cuda(sr, tab, labels, n_items, 0, **kw)
    loss_k2, lse_k2 = xent._fwd_cuda(sr, tab, labels, n_items, 0, **kw)
    m, s, zl = xent._fwd_plain(sr, tab, labels, n_items, 0, **kw)
    lse_p = xent._finish_lse(m, s)
    loss_p = lse_p - zl
    dsr_k, dtab_k = xent._bwd_cuda(g, sr, tab, labels, lse_p, n_items,
                                   0, **kw)
    dsr_k2, dtab_k2 = xent._bwd_cuda(g, sr, tab, labels, lse_p,
                                     n_items, 0, **kw)
    dsr_p, dtab_p = xent._bwd_plain(g, sr, tab, labels, lse_p, n_items,
                                    0, **kw)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    e_fwd, fwd_tol = fwd_errors((loss_k, lse_k), (loss_p, lse_p),
                                TOL[("fwd", dname)])
    tol = TOL[("bwd", dname)]
    e_dsr, dsr_tol = dsr_errors(dsr_k, dsr_p, tol)
    # the zero-norm row's gradient is G / eps, about 1e12 times the
    # others, and rows with no label carry only the softmax term
    dtab = dtable_errors(torch, dtab_k, dtab_p, labels, n_items, tol)
    same = torch.equal(dsr_k, dsr_k2) and torch.equal(dtab_k, dtab_k2)
    same_fwd = torch.equal(loss_k, loss_k2) and torch.equal(lse_k, lse_k2)
    row = {"phase": "kernel_check", "items": n_items, "P": P,
           "B": rows, "D": dim, "dtype": dname, "normalize_table": norm,
           **tags, "fwd_max_abs_err": e_fwd, "dsr_max_abs_err": e_dsr,
           "fwd_tol": fwd_tol, "dsr_tol": dsr_tol, "dtable_err_tol": dtab,
           "k1_repeat_bit_identical": same_fwd,
           "k2_repeat_bit_identical": same}
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (loss_k, lse_k, dsr_k, dtab_k))
    row["ok"] = (finite and same and same_fwd and e_fwd <= row["fwd_tol"]
                 and e_dsr <= row["dsr_tol"]
                 and all(e <= t for e, t in dtab.values()))
    emit(row)
    check(row["ok"], f"kernel disagrees with its plain version: {row}")
    return e_fwd, max([e_dsr] + [e for name, (e, _) in dtab.items()
                                 if name != "zero_row"])


def phase_kernel_checks(torch, xent, seed):
    from sessionrec_tpu_torch.ops.scoring import pad_catalog
    worst = {"xent_fwd": 0.0, "xent_bwd": 0.0}
    for i, case in enumerate(xent_check_cases(torch)):
        errs = xent_check(torch, xent, case, seed + i)
        _, P, dtype, norm, rows, dim = case
        if (P == pad_catalog(PATH_ITEMS) and dtype == torch.float32 and norm
                and rows == B and dim == D):
            worst["xent_fwd"], worst["xent_bwd"] = errs
    return worst


def make_multi_inputs(torch, xm, n_items, P, dtype, seed, norm=True,
                      dev="cuda", rows=B, dim=D, ns=NS):
    """K3/K4 inputs: sr3 [K, rows, dim] of unit rows, the K1 checks' table
    and labels (row 3 masked), session item lists iids [rows, ns] of 1 to
    ns ids (-1 padded; none on row 1; the label inside the session on the
    other even rows), and the cotangents (gz, gin, gex) that the paper
    head's loss (REnorm and fusion, random phi and alpha, masked mean)
    gives the plain stats, with those stats' (lse_in, lse_ex)."""
    gen = torch.Generator().manual_seed(seed + 1000)
    _, tab, labels, _ = make_inputs(torch, n_items, P, dtype, seed, dev,
                                    rows, dim)
    sr3 = torch.randn(K, rows, dim, generator=gen)
    sr3 = (sr3 / sr3.norm(dim=-1, keepdim=True)).to(dev, dtype)
    iids = torch.randint(0, n_items, (rows, ns), generator=gen,
                         dtype=torch.int32)
    lens = torch.randint(1, ns + 1, (rows,), generator=gen)
    iids[torch.arange(ns)[None, :] >= lens[:, None]] = -1
    iids[1] = -1
    iids = iids.to(dev)
    even = torch.arange(rows, device=dev) % 2 == 0
    labels = torch.where(even & (labels >= 0), iids[:, 0], labels)
    valid = (labels >= 0).float()
    m_in, s_in, m_ex, s_ex, zl = xm._fwd_plain(
        sr3, tab, labels, iids, n_items, 0, scale=SCALE,
        normalize_table=norm)
    stats = [t.detach().requires_grad_(True)
             for t in (zl, xm._finish(m_in, s_in), xm._finish(m_ex, s_ex))]
    phi = torch.softmax(torch.randn(rows, K, 2, generator=gen), -1).to(dev)
    alpha = torch.randn(K, generator=gen).to(dev)
    lbl_in = torch.any(iids == labels[:, None], dim=1)
    per_row = xm.combine_stats(*stats, phi, alpha, lbl_in, extra=True,
                               fusion=True)
    loss = torch.sum(per_row * valid) / valid.sum()
    cot = torch.autograd.grad(loss, stats)
    return sr3, tab, labels, iids, cot, tuple(t.detach() for t in stats[1:])


def stats_errors(torch, got, want, tol):
    """{stat: [max error, tolerance]} of K3's five stats.  A logit is a
    float32 dot product whose rounding scales with its terms, not with its
    value, so m_in, m_ex and zl are held to tol times the case's largest
    logit magnitude z (at least 1), absolutely; an error d in a logit moves
    exp(z - m) by a factor e^d, so s_in and s_ex are held relatively, each
    element to tol * z times its own value (an empty partition's 0 exactly).
    """
    m_in, _, m_ex, _, _ = want
    live = torch.cat([m[m > -1e29] for m in (m_in, m_ex)])
    zmax = max(1.0, float(live.abs().max()))
    errs = {}
    for name, g, w in zip(STATS, got, want):
        d = (g - w).abs()
        if name.startswith("s_"):
            rel = torch.where(d == 0, 0.0, d / w.abs().clamp(min=1e-30))
            errs[name] = [float(rel.max()), tol * zmax]
        else:
            errs[name] = [float(d.max()), tol * zmax]
    return errs


def multi_check(torch, xm, case, seed, ns=NS, **tags):
    """K3 and K4 against their plain versions at one case of
    ``xent_check_cases`` (or ``wide_check_cases``), with item lists of up
    to ``ns`` ids: emits the ``multi_kernel_check`` line, fails on a
    disagreement, and returns (K3's error, K4's largest error but the
    zero-norm row's)."""
    n_items, P, dtype, norm, rows, dim = case
    sr3, tab, labels, iids, cot, lse = make_multi_inputs(
        torch, xm, n_items, P, dtype, seed, norm, rows=rows, dim=dim, ns=ns)
    kw = dict(scale=SCALE, normalize_table=norm)
    got = xm._fwd_cuda(sr3, tab, labels, iids, n_items, 0, **kw)
    got2 = xm._fwd_cuda(sr3, tab, labels, iids, n_items, 0, **kw)
    want = xm._fwd_plain(sr3, tab, labels, iids, n_items, 0, **kw)
    dsr_k, dtab_k = xm._bwd_cuda(*cot, sr3, tab, labels, iids, *lse,
                                 n_items, 0, **kw)
    dsr_k2, dtab_k2 = xm._bwd_cuda(*cot, sr3, tab, labels, iids, *lse,
                                   n_items, 0, **kw)
    dsr_p, dtab_p = xm._bwd_plain(*cot, sr3, tab, labels, iids, *lse,
                                  n_items, 0, **kw)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    stats = stats_errors(torch, got, want, TOL[("fwd", dname)])
    e_fwd = max(max_err(a, b) for a, b in zip(got, want))
    tol = TOL[("bwd", dname)]
    e_dsr, dsr_tol = dsr_errors(dsr_k, dsr_p, tol)
    dtab = dtable_errors(torch, dtab_k, dtab_p, labels, n_items, tol, iids)
    same = torch.equal(dsr_k, dsr_k2) and torch.equal(dtab_k, dtab_k2)
    same_fwd = all(torch.equal(a, b) for a, b in zip(got, got2))
    row = {"phase": "multi_kernel_check", "items": n_items, "P": P,
           "K": K, "B": rows, "D": dim, "Ns": ns, "dtype": dname,
           "normalize_table": norm, **tags, "stats_err_tol": stats,
           "stats_max_abs_err": e_fwd,
           "dsr_max_abs_err": e_dsr, "dsr_tol": dsr_tol,
           "dtable_err_tol": dtab, "k3_repeat_bit_identical": same_fwd,
           "k4_repeat_bit_identical": same}
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (*got[1::2], dsr_k, dtab_k))
    row["ok"] = (finite and same and same_fwd
                 and all(e <= t for e, t in stats.values())
                 and e_dsr <= row["dsr_tol"]
                 and all(e <= t for e, t in dtab.values()))
    emit(row)
    check(row["ok"], f"multi kernel disagrees with its plain version: "
          f"{row}")
    return e_fwd, max([e_dsr] + [e for name, (e, _) in dtab.items()
                                 if name != "zero_row"])


def phase_multi_checks(torch, xm, seed):
    """K3 and K4 against their plain versions, on the K1/K2 checks' cases
    (``xent_check_cases``); returns the largest errors of the main path's
    case (padded path catalog, float32, normalised)."""
    from sessionrec_tpu_torch.ops.scoring import pad_catalog
    worst = {}
    for i, case in enumerate(xent_check_cases(torch)):
        _, P, dtype, norm, rows, dim = case
        if dim != D:
            continue
        errs = multi_check(torch, xm, case, seed + i)
        if (P == pad_catalog(PATH_ITEMS) and dtype == torch.float32 and norm
                and rows == B):
            worst["xent_multi_fwd"], worst["xent_multi_bwd"] = errs
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


def kernel_ms(torch, fn, calls):
    """({kernel name: device ms per call} of the kernels ``fn`` launches,
    seconds the trace was held open) from a ``torch.profiler`` trace of
    ``calls`` calls.  The trace is held open ``TRACE_SETTLE_S`` around the
    calls, as the path traces are, and traced again held open for each of
    TRACE_RETRY_S in turn while some kernel's records are not a multiple
    of ``calls`` (``records_complete``)."""
    def run():
        for _ in range(calls):
            fn()        # each call's output freed before the next

    for settle in (TRACE_SETTLE_S,) + TRACE_RETRY_S:
        events = traced_events(torch, run, settle)
        if records_complete(events, calls):
            break
    out = {}
    for name, _, dur in events:
        name = name.replace("void ", "").replace("(anonymous namespace)::", "")
        name = name.split("(")[0]
        out[name] = out.get(name, 0.0) + dur / 1e3 / calls
    return out, settle


def records_complete(events, calls):
    """Whether a trace of ``calls`` calls of one function holds every
    call's records: some, and each kernel's a multiple of ``calls``."""
    names = [n for n, _, _ in events]
    return bool(names) and all(names.count(n) % calls == 0
                               for n in set(names))


# a trace whose kernels sum to within this share of the CUDA-events time of
# the same calls counts as complete
TRACE_AGREE = 0.1


def trace_coverage(kernel_sum_ms, events_ms):
    """How a trace's per-call kernel sum compares with the events time of
    the same calls: ``coverage`` their ratio, ``complete`` whether it is
    within TRACE_AGREE of 1.  A trace that lost records shows as
    incomplete, as does a call whose gaps between launches pass the
    share."""
    coverage = kernel_sum_ms / events_ms if events_ms > 0 else 0.0
    return {"kernel_sum_ms": kernel_sum_ms, "events_ms": events_ms,
            "coverage": coverage,
            "complete": abs(coverage - 1.0) <= TRACE_AGREE}


def emit_launch(torch, phase, shape, fn, calls, smi, **dims):
    """A launch line at ``dims``: the launch ``shape`` (blocks, splits,
    resident blocks per SM, registers and local memory of the product
    kernels), the device ms per call of each kernel that ``fn`` launches,
    and their sum against the events time of ``fn`` (``trace``)."""
    events = time_ms(torch, fn, calls)
    kms, settle = kernel_ms(torch, fn, calls)
    emit({"phase": phase, **dims, **shape, "kernel_ms": kms,
          "trace": dict(trace_coverage(sum(kms.values()), events),
                        settle_s=settle), "card": smi})


def library_kernel_ms(torch, fn, calls):
    """Device ms per call of the library yardstick ``fn``: the sum over the
    kernels it launches, from a ``torch.profiler`` trace."""
    return sum(kernel_ms(torch, fn, calls)[0].values())


def bounds(n_bytes, n_ops, dname):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_OPS[dname] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def xent_times(torch, xent, n_items, P, dtype, seed, smi, rows=B, dim=D,
               norm=True, scale=SCALE, prenormalised=False, **tags):
    """K1's and K2's times, their plain versions', their bounds and the
    library's, at ``rows`` rows of width ``dim`` against a ``P``-row table
    (``prenormalised``: rows l2-normalised before the call); emits the
    ``kernel_time``, ``k1_launch`` and ``k2_launch`` lines, with ``tags``,
    and returns {kernel: times}."""
    import torch.nn.functional as F
    dname = str(dtype).split(".")[-1]
    sr, tab, labels, g = make_inputs(torch, n_items, P, dtype, seed,
                                     rows=rows, dim=dim)
    if prenormalised:
        tab = F.normalize(tab.float(), dim=1).to(dtype)
    kw = dict(scale=scale, normalize_table=norm)
    iters = 50 if P < 10000 else 10
    _, lse = xent._fwd_cuda(sr, tab, labels, n_items, 0, **kw)

    def plain_fwd():
        m, s, zl = xent._fwd_plain(sr, tab, labels, n_items, 0, **kw)
        return xent._finish_lse(m, s) - zl

    lbl = labels.clamp(min=0).long()
    imask = torch.arange(P, device="cuda") < n_items
    # in the operands' own type: a bfloat16 product accumulates in float32
    # inside cuBLAS, as the kernels do
    srl = sr.detach().clone().requires_grad_(True)
    tabl = tab.detach().clone().requires_grad_(True)

    def lib_fwd():
        t = F.normalize(tabl, dim=1) if norm else tabl
        z = torch.where(imask, scale * srl @ t.T, -1e30)
        return F.cross_entropy(z, lbl, reduction="none")

    lib_loss = lib_fwd()
    g_lib = g.to(lib_loss.dtype)

    def lib_bwd():
        return torch.autograd.grad(lib_loss, (srl, tabl), g_lib,
                                   retain_graph=True)

    # the work the function needs: the n_items real rows (padding and
    # other shards' rows are masked), read once; d_table written whole
    nrm = 2 * n_items * dim if norm else 0
    ops_f = 2 * rows * n_items * dim + nrm
    esz = sr.element_size()
    bytes_f = (rows * dim + n_items * dim) * esz + rows * 4 + 2 * rows * 4
    ops_b = 3 * 2 * rows * n_items * dim + nrm
    bytes_b = ((rows * dim + (n_items + P) * dim) * esz + 3 * rows * 4
               + rows * dim * 4)
    bf, byf = bounds(bytes_f, ops_f, dname)
    bb, byb = bounds(bytes_b, ops_b, dname)

    def k1():
        return xent._fwd_cuda(sr, tab, labels, n_items, 0, **kw)

    def k2():
        return xent._bwd_cuda(g, sr, tab, labels, lse, n_items, 0, **kw)

    res = {
        "xent_fwd": {
            "ms": time_ms(torch, k1, iters),
            "plain_ms": time_ms(torch, plain_fwd, iters),
            "library_ms": time_ms(torch, lib_fwd, iters),
            "library_kernel_ms": library_kernel_ms(torch, lib_fwd, iters),
            "bound_ms": bf, "bound_by": byf},
        "xent_bwd": {
            "ms": time_ms(torch, k2, iters),
            "plain_ms": time_ms(torch, lambda: xent._bwd_plain(
                g, sr, tab, labels, lse, n_items, 0, **kw), iters),
            "library_ms": time_ms(torch, lib_bwd, iters),
            "library_kernel_ms": library_kernel_ms(torch, lib_bwd, iters),
            "bound_ms": bb, "bound_by": byb},
    }
    dims = dict(P=P, B=rows, D=dim, dtype=dname, **tags)
    for name, r in res.items():
        emit({"phase": "kernel_time", "kernel": name, "items": n_items,
              **dims, "normalize_table": norm, "scale": scale, **r,
              "library_trace": trace_coverage(r["library_kernel_ms"],
                                              r["library_ms"]),
              "card": smi})
    emit_launch(torch, "k1_launch", xent.fwd_launch_shape(sr, P), k1,
                iters, smi, **dims)
    emit_launch(torch, "k2_launch", xent.bwd_launch_shape(sr, P), k2,
                iters, smi, **dims)
    return res


def phase_kernel_times(torch, xent, seed, smi):
    """Times at B=512, D=256, normalised table, both catalogs and types."""
    from sessionrec_tpu_torch.ops.scoring import pad_catalog
    return {(n_items, str(dtype).split(".")[-1]): xent_times(
                torch, xent, n_items, pad_catalog(n_items), dtype, seed, smi)
            for n_items in CATALOGS
            for dtype in (torch.float32, torch.bfloat16)}


def phase_family_times(torch, xent, seed, smi):
    """K1's and K2's times at each family path's rows, width, table
    normalisation and scale (``FAMILY_XENT``), float32, on the path's
    padded catalog."""
    from sessionrec_tpu_torch.ops.scoring import pad_catalog
    return {name: xent_times(torch, xent, PATH_ITEMS, pad_catalog(PATH_ITEMS),
                             torch.float32, seed, smi, rows=rows, dim=dim,
                             norm=norm, scale=scale)
            for name, (rows, dim, norm, scale) in FAMILY_XENT.items()}


def phase_bf16_path_times(torch, xent, seed, smi):
    """K1's and K2's bf16 times at the o1_bf16 path's shape (B=512, D=256,
    the padded path catalog, scale 12): the raw table with the
    normalisation folded in, as the path calls them, against a table
    normalised before the call."""
    from sessionrec_tpu_torch.ops.scoring import pad_catalog
    P = pad_catalog(PATH_ITEMS)
    return {table: xent_times(torch, xent, PATH_ITEMS, P, torch.bfloat16,
                              seed, smi, norm=table == "raw",
                              prenormalised=table == "normalised",
                              path="o1_bf16", table=table)
            for table in ("raw", "normalised")}


def phase_sround(torch, seed, smi):
    """``stochastic_round_bf16`` on the card against the CPU, bit for bit,
    and its time, at SROUND_ROWS x D (the path's table and the north
    star's); and the time of the whole bf16 table update of a step
    (``runner.apply_table_update``: the float32 add, the max-norm
    projection, the rounding).  Bounds: the bytes each must move (the
    rounding reads 4 and writes 2 a element; the update reads the table
    and the float32 update and writes the table, 8) at PEAK_BYTES."""
    import types
    from sessionrec_tpu_torch.models.lessr import renorm_rows
    from sessionrec_tpu_torch.ops.sround import (stochastic_round_bf16,
                                                 stochastic_round_bf16_bits)
    from sessionrec_tpu_torch.train.runner import apply_table_update
    for P in SROUND_ROWS:
        gen = torch.Generator().manual_seed(seed + P)
        x = (torch.randn(P, D, generator=gen) * 0.06)
        s_dev = torch.tensor(seed + 12345, dtype=torch.int64, device="cuda")
        bits = stochastic_round_bf16_bits(x.cuda(), s_dev)
        same = torch.equal(bits.cpu(), stochastic_round_bf16_bits(
            x, seed + 12345))
        xc = x.cuda()
        table = torch.nn.Parameter(xc.to(torch.bfloat16))
        model = types.SimpleNamespace(
            embedding=table, project_table=lambda t: renorm_rows(t, 1.0))
        upd = torch.randn(P, D, generator=gen).cuda() * 1e-3

        def sround():
            return stochastic_round_bf16(xc, s_dev)

        def update():
            apply_table_update(model, upd, s_dev)

        n = P * D
        row = {"phase": "sround_time", "P": P, "D": D,
               "bit_identical_to_cpu": same,
               "ms": time_ms(torch, sround, 50),
               "device_ms": library_kernel_ms(torch, sround, 20),
               "bound_ms": n * 6 / PEAK_BYTES * 1e3,
               "table_update_ms": time_ms(torch, update, 50),
               "table_update_device_ms": library_kernel_ms(torch, update, 20),
               "table_update_bound_ms": n * 8 / PEAK_BYTES * 1e3,
               "card": smi}
        emit(row)
        check(same, f"stochastic rounding on the card differs from the "
              f"CPU's at P={P}")


def multi_times(torch, xm, n_items, P, dtype, seed, smi, rows=B, dim=D,
                **tags):
    """K3's and K4's times at ``rows`` rows of K orders against a ``P``-row
    normalised table, their plain versions', their bounds and the
    library's; emits the ``kernel_time`` and ``multi_launch`` lines, with
    ``tags``, and returns {kernel: times}.  The yardstick is the shortest
    PyTorch expression of the same function, several calls: one batched
    product, the membership mask (built once, outside the timing) in
    ``torch.where``, two ``logsumexp`` and a gather; for K4 its autograd
    backward."""
    import torch.nn.functional as F
    dname = str(dtype).split(".")[-1]
    sr3, tab, labels, iids, cot, lse = make_multi_inputs(
        torch, xm, n_items, P, dtype, seed, rows=rows, dim=dim)
    kw = dict(scale=SCALE, normalize_table=True)
    iters = 50 if P < 10000 else 10
    member = xm._member(iids, P, 0)
    imask = torch.arange(P, device="cuda") < n_items
    lbl = labels.clamp(min=0).long()[None, :, None].expand(K, rows, 1)
    srl = sr3.detach().clone().requires_grad_(True)
    tabl = tab.detach().clone().requires_grad_(True)

    def lib_fwd():
        z = SCALE * torch.matmul(srl, F.normalize(tabl, dim=1).T)
        z = torch.where(imask, z, -1e30)
        return (torch.gather(z, 2, lbl)[..., 0],
                torch.logsumexp(torch.where(member, z, -1e30), -1),
                torch.logsumexp(torch.where(member, -1e30, z), -1))

    lib_out = lib_fwd()
    lib_cot = tuple(c.to(dtype) for c in cot)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (srl, tabl), lib_cot,
                                   retain_graph=True)

    esz = sr3.element_size()
    small = rows * 4 + rows * NS * 4                 # labels, iids
    # over the n_items real rows, as ``xent_times`` counts them
    ops_f = 2 * K * rows * n_items * dim + 2 * n_items * dim
    bytes_f = (K * rows * dim + n_items * dim) * esz + small \
        + 5 * K * rows * 4
    ops_b = 3 * 2 * K * rows * n_items * dim + 2 * n_items * dim
    bytes_b = ((K * rows * dim + (n_items + P) * dim) * esz + small
               + 5 * K * rows * 4 + K * rows * dim * 4)
    bf, byf = bounds(bytes_f, ops_f, dname)
    bb, byb = bounds(bytes_b, ops_b, dname)

    def k3():
        return xm._fwd_cuda(sr3, tab, labels, iids, n_items, 0, **kw)

    def k4():
        return xm._bwd_cuda(*cot, sr3, tab, labels, iids, *lse, n_items, 0,
                            **kw)

    res = {
        "xent_multi_fwd": {
            "ms": time_ms(torch, k3, iters),
            "plain_ms": time_ms(torch, lambda: xm._fwd_plain(
                sr3, tab, labels, iids, n_items, 0, **kw), iters),
            "library_ms": time_ms(torch, lib_fwd, iters),
            "library_kernel_ms": library_kernel_ms(torch, lib_fwd, iters),
            "bound_ms": bf, "bound_by": byf},
        "xent_multi_bwd": {
            "ms": time_ms(torch, k4, iters),
            "plain_ms": time_ms(torch, lambda: xm._bwd_plain(
                *cot, sr3, tab, labels, iids, *lse, n_items, 0, **kw),
                iters),
            "library_ms": time_ms(torch, lib_bwd, iters),
            "library_kernel_ms": library_kernel_ms(torch, lib_bwd, iters),
            "bound_ms": bb, "bound_by": byb},
    }
    for name, r in res.items():
        emit({"phase": "kernel_time", "kernel": name, "items": n_items,
              "P": P, "K": K, "B": rows, "D": dim, "dtype": dname,
              "normalize_table": True, **tags, **r,
              "library_trace": trace_coverage(r["library_kernel_ms"],
                                              r["library_ms"]),
              "card": smi})
    emit_launch(torch, "multi_launch", xm.multi_launch_shape(sr3, P),
                lambda: (k3(), k4()), iters, smi, P=P, K=K, B=rows, D=dim,
                dtype=dname, **tags)
    return res


def phase_multi_times(torch, xm, seed, smi):
    """K3/K4 times at B=512, K=3, D=256, normalised table, both catalogs
    and types (``multi_times``)."""
    from sessionrec_tpu_torch.ops.scoring import pad_catalog
    return {(n_items, str(dtype).split(".")[-1]): multi_times(
                torch, xm, n_items, pad_catalog(n_items), dtype, seed, smi)
            for n_items in CATALOGS
            for dtype in (torch.float32, torch.bfloat16)}


# ---------------------------------------------------------------------------
# phase 3b: the gather's backward (csrc/embed_bwd.cu)
# ---------------------------------------------------------------------------

def step_ids(batch):
    """The id tensors of a training step's gathers, in the order the
    model hands them to ``ops/embed.py``: every tier's levels (MSGIFSR)
    or node ids, shortest tier first."""
    from sessionrec_tpu_torch.graph.batch import flatten_blocks
    blocks = flatten_blocks(batch)
    if hasattr(blocks[0], "levels"):
        return [lv.iid for b in blocks for lv in b.levels]
    return [b.node_iid for b in blocks]


def run_profile(torch, ids):
    """(slots, slots on row 0, the longest run of any other row) of a
    step's ids."""
    flat = torch.cat([i.reshape(-1) for i in ids]).long()
    counts = torch.bincount(flat)
    rest = int(counts[1:].max()) if counts.numel() > 1 else 0
    return flat.numel(), int(counts[0]), rest


def embed_inputs(torch, ids, P, dim, dtype, seed):
    """Random gradient rows for the id tensors ``ids`` (one tensor of
    ``[*ids.shape, dim]`` each, on the card) and the flat ids."""
    gen = torch.Generator().manual_seed(seed + 2000)
    grads = [torch.randn(*i.shape, dim, generator=gen).to("cuda", dtype)
             for i in ids]
    flat = torch.cat([i.reshape(-1) for i in ids]).to("cuda")
    return grads, flat


def embed_check(torch, embed, ids, P, dim, dtype, seed, **tags):
    """The kernel against its plain version on the card (the bits, twice)
    and against a float64 sum (its largest error, over the largest
    summed magnitude); emits the ``embed_check`` line, fails on a
    disagreement, returns the error."""
    grads, flat = embed_inputs(torch, ids, P, dim, dtype, seed)
    got = embed._bwd_cuda(grads, flat, P)
    again = embed._bwd_cuda(grads, flat, P)
    plain = embed._bwd_plain(grads, flat, P)
    g64 = torch.cat([g.reshape(-1, dim) for g in grads]).double()
    want = torch.zeros(P, dim, dtype=torch.float64, device="cuda")
    absum = torch.zeros_like(want)
    want.index_put_((flat.long(),), g64, accumulate=True)
    absum.index_put_((flat.long(),), g64.abs(), accumulate=True)
    err = float((got.double() - want).abs().max())
    scale = float(absum.max())
    tol = EMBED_TOL[str(dtype).split(".")[-1]] * scale
    n, row0, rest = run_profile(torch, ids)
    row = {"phase": "embed_check", "P": P, "D": dim,
           "dtype": str(dtype).split(".")[-1], "pieces": len(ids),
           "slots": n, "row0_slots": row0, "longest_other_run": rest,
           **tags, "max_abs_err": err, "tol": tol,
           "plain_bit_identical": bool(torch.equal(got, plain)),
           "repeat_bit_identical": bool(torch.equal(got, again))}
    row["ok"] = (row["plain_bit_identical"] and row["repeat_bit_identical"]
                 and err <= tol)
    emit(row)
    check(row["ok"], f"embed_bwd disagrees with its plain version: {row}")
    return err


def embed_times(torch, embed, ids, P, dim, dtype, seed, smi, calls=20,
                **tags):
    """The gather's backward at the id tensors ``ids`` of one step: the
    kernel (with its sort), torch's index backward of one gather a tensor
    summed by autograd (the path it replaces), ``F.embedding``'s backward
    of the flat ids (the library), the plain version, and the byte bound;
    CUDA events over ``calls`` calls and device time under the profiler.
    Emits the ``embed_time`` line and returns its times."""
    dname = str(dtype).split(".")[-1]
    grads, flat = embed_inputs(torch, ids, P, dim, dtype, seed)
    table = torch.zeros(P, dim, dtype=dtype, device="cuda",
                        requires_grad=True)
    rows = [table[i.to("cuda").long()] for i in ids]
    g_flat = torch.cat([g.reshape(-1, dim) for g in grads])
    flat64 = flat.long()

    def kernel():
        return embed._bwd_cuda(grads, flat, P)

    def torch_path():
        return torch.autograd.grad(rows, table, grads, retain_graph=True)

    def library():
        return torch.ops.aten.embedding_dense_backward(
            g_flat, flat64, P, -1, False)

    n, row0, rest = run_profile(torch, ids)
    esz = torch.empty((), dtype=dtype).element_size()
    bound, by = bounds(n * dim * esz + n * 4 + P * dim * esz, 0, dname)
    kms, settle = kernel_ms(torch, kernel, calls)
    res = {"ms": time_ms(torch, kernel, calls),
           "kernel_ms": kms, "kernel_device_ms": sum(kms.values()),
           "torch_ms": time_ms(torch, torch_path, calls),
           "torch_device_ms": library_kernel_ms(torch, torch_path, calls),
           "library_ms": time_ms(torch, library, calls),
           "library_kernel_ms": library_kernel_ms(torch, library, calls),
           "plain_ms": time_ms(torch, lambda: embed._bwd_plain(
               grads, flat, P), 2),
           "bound_ms": bound, "bound_by": by}
    emit({"phase": "embed_time", "P": P, "D": dim, "dtype": dname,
          "pieces": len(ids), "slots": n, "row0_slots": row0,
          "longest_other_run": rest, **tags, **res, "settle_s": settle,
          "attrs": embed.kernel_attrs(dtype), "card": smi})
    return res


# embed_bwd against a float64 sum: its order is at most ~200 terms deep
# (ops/embed.py: a tile, the partials over the ways, the ways), so float32
# is held to 200 eps of the largest summed magnitude, bfloat16 adds its
# rounding of the result
EMBED_TOL = {"float32": 200 * 2.0 ** -23, "bfloat16": 2.0 ** -8}


def phase_embed(torch, embed, seed, dataset_dir, smi):
    """The gather's backward against its plain version and a float64 sum
    at the o1 and paper paths' first step (datasets/sample, batch 512,
    tiers (4, 8)) on the path and north-star catalogs, float32 and
    bfloat16, and at a padding run of 16,384 slots; its times at the two
    steps on both catalogs.  Returns (the largest float32 error at the o1
    step on the path catalog, its times there)."""
    from sessionrec_tpu_torch.ops.scoring import pad_catalog
    from sessionrec_tpu_torch.train.session import make_loaders
    steps = {}
    for name in ("path", "paper"):
        cfg = path_config(name, seed, dataset_dir, dev="cpu")
        train, _, _, _ = make_loaders(cfg.data, cfg.model.name,
                                      cfg.model.order)
        steps[name] = step_ids(first_batches(train, 1)[0].to("cpu"))
    gen = torch.Generator().manual_seed(seed)
    pad = torch.cat([torch.zeros(16384, dtype=torch.int32),
                     torch.randint(1, CATALOGS[0], (4096,), generator=gen,
                                   dtype=torch.int32)])
    steps["pad16384"] = [pad[torch.randperm(pad.numel(), generator=gen)]]
    err = times = None
    for name, ids in steps.items():
        for n_items in CATALOGS:
            P = pad_catalog(n_items)
            for dtype in (torch.float32, torch.bfloat16):
                e = embed_check(torch, embed, ids, P, D, dtype, seed,
                                path=name)
                if (name, n_items, dtype) == ("path", PATH_ITEMS,
                                              torch.float32):
                    err = e
    for name in ("path", "paper"):
        for n_items in CATALOGS:
            t = embed_times(torch, embed, steps[name], pad_catalog(n_items),
                            D, torch.float32, seed, smi, path=name)
            if (name, n_items) == ("path", PATH_ITEMS):
                times = t
    return err, times


# ---------------------------------------------------------------------------
# phases 4 and 5: the paths
# ---------------------------------------------------------------------------

# the paths: the model's preset and options, the kernels that must launch
# once per step (the others never), and the parameters whose gradients are
# held against the CPU (SRGNN's and NISER's GNN layers reach nothing under
# the reference's readout-on-embedding quirk, so theirs are 0 on both)
# (every training path gathers its step's rows once: embed_bwd once a step)
K12 = ("xent_fwd", "xent_bwd", "embed_bwd")
K34 = ("xent_multi_fwd", "xent_multi_bwd", "embed_bwd")
BF16 = dict(table_dtype="bfloat16", compute_dtype="bfloat16")
PATHS = {
    "path": dict(preset="msgifsr", model=dict(order=1), kernels=K12,
                 grads=("embedding", "fc_sr.0.weight",
                        "layers.0.conv1.intra1.fc")),
    "paper": dict(preset="msgifsr",
                  model=dict(order=3, extra=True, fusion=True),
                  kernels=K34,
                  grads=("embedding", "alpha", "sc_sr.0.l1.weight",
                         "expander.grus.0.w_ih")),
    "srgnn": dict(preset="srgnn", model={}, kernels=K12,
                  grads=("embedding", "fc_sr.weight", "readout.fc_u.weight",
                         "readout.fc_v.bias", "layers.0.gru.w_ih")),
    "niser": dict(preset="niser", model={}, kernels=K12,
                  grads=("embedding", "fc_sr.weight", "readout.fc_u.weight",
                         "readout.fc_v.bias", "layers.0.gru.w_ih")),
    "lessr": dict(preset="lessr", model={}, kernels=K12,
                  grads=("embedding", "fc_sr.weight", "bn.scale",
                         "layers.0.gru.w_ih", "layers.1.fc_q.weight",
                         "layers.2.fc_neigh.weight", "readout.fc_out.weight")),
    # the two MSGIFSR heads with a bfloat16 table and bfloat16 compute:
    # K1/K2's or K3/K4's bf16 branches; the paper head 16 steps
    "o1_bf16": dict(preset="msgifsr", model=dict(order=1, **BF16),
                    kernels=K12, grads=("embedding", "fc_sr.0.weight",
                                        "layers.0.conv1.intra1.fc")),
    "paper_bf16": dict(preset="msgifsr",
                       model=dict(order=3, extra=True, fusion=True, **BF16),
                       kernels=K34,
                       grads=("embedding", "alpha", "sc_sr.0.l1.weight",
                              "expander.grus.0.w_ih"), steps=16),
}

# the kernels by which a trace counts each wrapper's launches, one per
# wrapper call up to 256 features and past: the forward's main product (in
# bfloat16 past 256 features too, xent_fwd_slab and xent_multi_fwd_slab
# keep their names on the tensor cores); the backward's d_table product
# (K2's and K4's in bfloat16 on the tensor cores, xent_bwd_dtable_tc and
# xent_multi_bwd_dtable_tc), and past 256 features its finish kernel (the
# slab path's dz kernel runs once a catalog chunk, its products, in
# bfloat16 xent_slab_dtable_tc and xent_slab_dsr_tc, are K2's and K4's
# alike, so none of them counts)
TRACE_KERNEL = {"xent_fwd": ("xent_fwd_partial", "xent_fwd_slab"),
                "xent_bwd": ("xent_bwd_dtable", "xent_bwd_dtable_tc",
                             "xent_bwd_finish_slab"),
                "xent_multi_fwd": ("xent_multi_fwd_partial",
                                   "xent_multi_fwd_slab"),
                "xent_multi_bwd": ("xent_multi_bwd_dtable",
                                   "xent_multi_bwd_dtable_tc",
                                   "xent_multi_bwd_finish_slab"),
                "embed_bwd": ("embed_bwd_rows",)}


def kernel_base_name(name):
    """``void ns::xent_fwd_partial<float>(...)`` -> ``xent_fwd_partial``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip()


# seconds the profiler stays open around the traced work: on an H100,
# traces closed right after the device finished an 8-step paper-head
# replay (82,833 kernels) lost runs of its kernel records, 2 and 7
# steps' worth in 2 of 5 traces, where 4 traces that waited 0.2 s lost
# none
TRACE_SETTLE_S = 0.5
# the longer holds of kernel_ms's retraces: the device's records reach a
# trace later as the process ages.  On an H100 the launch lines of this
# script's first phases are complete at 0.5 s; late in the run the same
# kind of trace loses some or all of its records at 0.5 s and keeps them
# at 2 s (the launch lines' ``settle_s``).
TRACE_RETRY_S = (2.0, 8.0)


def traced_events(torch, fn, settle=TRACE_SETTLE_S):
    """(name, start us, duration us) of the device's work in a
    ``torch.profiler`` trace of ``fn()``, held open ``settle`` seconds
    before and after it."""
    from torch.profiler import ProfilerActivity, profile
    from sessionrec_tpu_torch.utils.profiling import profiled_device_events
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(settle)
        fn()
        torch.cuda.synchronize()
        time.sleep(settle)
    return profiled_device_events(prof)


def count_launches(events):
    """({wrapper: launches counted by kernel name}, {wrapper: those of
    its bfloat16 instantiation}, kernel events) among trace ``events``."""
    full = [n for n, _, _ in events if not n.startswith("Mem")]
    names = [kernel_base_name(n) for n in full]
    bf16 = [b for n, b in zip(full, names) if "bfloat16" in n]
    return ({k: sum(map(names.count, v)) for k, v in TRACE_KERNEL.items()},
            {k: sum(map(bf16.count, v)) for k, v in TRACE_KERNEL.items()},
            len(names))


def trace_launches(torch, fn):
    """``count_launches`` of a ``torch.profiler`` trace of ``fn()``."""
    return count_launches(traced_events(torch, fn))


# the kernel wrappers' counters (utils/profiling.py) by this script's
# names of K1-K4
COUNTERS = {"xent_fwd": "xent.fwd", "xent_bwd": "xent.bwd",
            "xent_multi_fwd": "xent_multi.fwd",
            "xent_multi_bwd": "xent_multi.bwd", "embed_bwd": "embed.bwd"}


def wrapper_launches():
    """{kernel: its wrapper's launches since ``profiling.reset()``}."""
    from sessionrec_tpu_torch.utils import profiling
    counts = profiling.snapshot()["counts"]
    return {k: counts.get(c, 0) for k, c in COUNTERS.items()}


def device_launches(launches, graphs):
    """The device's launches of a run from its wrapper counts: each
    graph's capture counted its launches once and ran none; its replays
    ran them ``runner.launches(graph)`` times."""
    from sessionrec_tpu_torch.train.runner import launches as replayed
    return {k: n + sum(replayed(g).get(COUNTERS[k], 0)
                       - g.counts.get(COUNTERS[k], 0)
                       for g in graphs.values())
            for k, n in launches.items()}


def launch_errors(counts, steps, kernels):
    """{kernel: [counted, expected]} where a path's device launches break
    the rule: each of ``kernels`` once per real step, the others never."""
    want = {k: (steps if k in kernels else 0) for k in counts}
    return {k: [counts[k], want[k]] for k in counts if counts[k] != want[k]}


def first_batches(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def path_spec(name):
    """The entry of PATHS or LATE_PATHS for path ``name``."""
    return PATHS.get(name) or LATE_PATHS[name]


def path_config(name, seed, dataset_dir, dev="cuda", dim=None, **train):
    """The path's configuration on ``dataset_dir``: MSGIFSR at the
    reference's widths (d=256, 1 layer, batch 512, feat_drop 0.1), the
    other models at their presets, tiers (4, 8) (``utils/profiling.py:
    run_config``); ``dim`` another width (default the path's own, if it
    has one); ``train`` sets TrainConfig fields (epochs 1 unless given)."""
    from sessionrec_tpu_torch.utils.profiling import run_config
    spec = path_spec(name)
    kw = dict(dict(epochs=1, log_interval=10), **spec["model"], **train)
    dim = spec.get("dim") if dim is None else dim
    if dim is not None:
        kw["embedding_dim"] = dim
    return run_config(spec["preset"], seed, dataset_dir, device=dev, **kw)


def check_run_files(ckpt_dir, metrics_file):
    """{what: found} of a path run's checkpoint and metrics: epoch 0's
    ``params.pt``, ``train.pt`` and sidecar, and the metrics file's
    events by kind, each with the JAX package's keys."""
    ep = Path(ckpt_dir) / "epoch_0000"
    files = {f: (ep / f).is_file() for f in ("params.pt", "train.pt")}
    files["epoch_0000.json"] = (Path(ckpt_dir) / "epoch_0000.json").is_file()
    events = [json.loads(line) for line in
              Path(metrics_file).read_text().splitlines()]
    kinds = {k: sum(e["kind"] == k for e in events) for k in EVENT_KEYS}
    keys_ok = all(list(e) == EVENT_KEYS[e["kind"]] for e in events)
    return {"checkpoint_files": files, "metrics_events": kinds,
            "metrics_keys_ok": keys_ok}


def phase_path(torch, name, steps, seed, dataset_dir, smi, tmp):
    """The path's run (see the module docstring), with a checkpoint
    directory and a metrics file under ``tmp``; returns (wrapper launches,
    device launches, the runner, its config, the parameters it saved)."""
    from sessionrec_tpu_torch.train.session import run_training
    from sessionrec_tpu_torch.utils import profiling

    spec = path_spec(name)
    steps = spec.get("steps", steps)
    # a train event at least once (every 10 steps, or at the last of fewer)
    cfg = path_config(name, seed, dataset_dir, log_interval=min(10, steps),
                      checkpoint_dir=str(Path(tmp) / name / "ckpt"),
                      metrics_file=str(Path(tmp) / name / "metrics.jsonl"))
    Path(tmp, name).mkdir(parents=True, exist_ok=True)
    profiling.reset()
    t0 = time.perf_counter()
    runner = run_training(cfg, max_epoch_batches=steps)
    mrr, hit = runner.max_mrr, runner.max_hit
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the parameters and buffers the run saved, before the traced chunk
    # trains on
    saved = {n: t.clone() for n, t in runner.model.state_dict().items()}
    launches = wrapper_launches()
    on_device = device_launches(launches, runner.graphs)
    graphs = {s: {"counts": g.counts, "replays": g.replays,
                  "nodes": g.nodes}
              for s, g in runner.graphs.items()}
    dtypes = table_state(torch, runner)

    losses = runner.losses
    n = runner.steps
    head, tail = losses[:5], losses[-5:]
    G = runner.unroll
    # one more chunk of replays, traced: the kernels by name
    chunk = first_batches(runner.train_loader, G)
    traced, traced_bf16, kernel_events = trace_launches(
        torch, lambda: runner.run_chunk(chunk))
    method = "trace" if kernel_events else "captured_x_replays"
    m = cfg.model
    row = {"phase": name, "model": m.name, **spec["model"],
           "dim": m.embedding_dim, "layers": m.num_layers,
           "batch": cfg.data.batch_size, "tiers": list(cfg.data.split_len),
           "feat_drop": m.feat_drop, "steps": n,
           "unroll": G, "native_collate": cfg.data.use_native_collate,
           "launches": launches, "device_launches": on_device,
           "graphs": graphs,
           "traced_chunk_launches": traced,
           "traced_bf16_launches": traced_bf16,
           "traced_kernel_events": kernel_events, "table": dtypes,
           "launch_count_method": method,
           "first_losses": head, "last_losses": tail,
           "mrr20": mrr, "hr20": hit,
           "train_examples": runner.train_examples,
           "train_seconds": runner.train_seconds,
           "examples_per_s": runner.train_examples
           / max(runner.train_seconds, 1e-9),
           "wall_seconds": wall, "card": smi,
           **check_run_files(cfg.train.checkpoint_dir,
                             cfg.train.metrics_file)}
    emit(row)
    check(all(row["checkpoint_files"].values()),
          f"checkpoint files missing: {row['checkpoint_files']}")
    check(all(row["metrics_events"].values()) and row["metrics_keys_ok"],
          f"metrics file lacks a train or eval event with the JAX keys: "
          f"{row['metrics_events']}")
    check(n == steps, f"ran {n} steps, expected {steps}")
    check(graphs.get(G, {}).get("replays", 0) == steps // G - 1,
          f"expected {steps // G - 1} replays of the {G}-step graph: "
          f"{graphs}")
    check(all((launches[k] > 0) == (k in spec["kernels"]) for k in launches),
          f"wrapper launches {launches}: the path's kernels must launch, "
          "the others not")
    bad = launch_errors(on_device, n, spec["kernels"])
    check(not bad, f"device launches {bad} [counted, expected]")
    if method == "trace":
        bad = launch_errors(traced, G, spec["kernels"])
        check(not bad, f"traced launches {bad} [counted, expected] in "
              f"{G} steps")
        want = traced if is_bf16(name) else dict.fromkeys(traced, 0)
        check(traced_bf16 == want, f"traced bf16 launches {traced_bf16}, "
              f"expected {want}")
    want = dict(dtype="torch.bfloat16" if is_bf16(name) else "torch.float32",
                moments="torch.float32", step=float(n))
    check(dtypes == want, f"table after the run {dtypes}, expected {want}")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    check(sum(tail) / len(tail) < sum(head) / len(head),
          f"loss did not fall: {head} -> {tail}")
    check(math.isfinite(mrr) and math.isfinite(hit), "non-finite metrics")

    errs, ok = (vs_cpu_bf16 if is_bf16(name) else vs_cpu)(
        torch, runner.model, next(iter(runner.test_loader)).to("cuda"),
        spec["grads"])
    emit({"phase": f"{name}_vs_cpu", "max_abs_err": errs, "ok": ok})
    check(ok, f"GPU {name} disagrees with the CPU plain path: {errs}")
    return {k: launches[k] for k in spec["kernels"]}, \
        {k: on_device[k] for k in spec["kernels"]}, runner, cfg, saved


def is_bf16(name):
    """True for a path with a bfloat16 table and bfloat16 compute."""
    spec = PATHS.get(name) or LATE_PATHS.get(name) or MILLION_PATHS[name]
    return spec["model"].get("table_dtype") == "bfloat16"


def table_state(torch, runner):
    """The table's type, its Adam moments' type and its step count."""
    st = runner.named_state()
    moments = {str(st[f"adam/embedding/{k}"].dtype)
               for k in ("exp_avg", "exp_avg_sq")}
    return {"dtype": str(runner.model.embedding.dtype),
            "moments": moments.pop() if len(moments) == 1 else "mixed",
            "step": float(st["adam/embedding/step"])}


def grad_or_zeros(torch, p):
    """``p``'s gradient, zeros where the loss did not reach it."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


class relu_inputs:
    """``torch.relu`` made to keep a copy of each call's input on the CPU,
    in call order (``inputs``), and to compute as before."""

    def __init__(self, torch):
        self.torch, self.inputs = torch, []

    def __call__(self, x):
        self.inputs.append(x.detach().float().cpu())
        return self.relu(x)

    def __enter__(self):
        self.relu, self.torch.relu = self.torch.relu, self
        return self

    def __exit__(self, *exc):
        self.torch.relu = self.relu


def relu_flips(first, second):
    """[inputs, the largest relative]: the ``relu_inputs`` of two runs of
    one model whose sign (> 0) differs, and the largest magnitude among
    them, either run's, over its call's largest input in ``first``."""
    n, worst = 0, 0.0
    for a, b in zip(first, second):
        flip = (a > 0) != (b > 0)
        if bool(flip.any()):
            n += int(flip.sum())
            top = max(float(a.abs().max()), 1e-30)
            worst = max(worst, float(a[flip].abs().max()) / top,
                        float(b[flip].abs().max()) / top)
    return [n, worst]


def relu_gap(first, second):
    """The largest gap between two runs' ``relu_inputs``, each call's over
    its largest magnitude in ``second``: NaN where an input is NaN, inf
    where the calls or their shapes differ."""
    if len(first) != len(second) or any(a.shape != b.shape
                                        for a, b in zip(first, second)):
        return math.inf
    worst = 0.0
    for a, b in zip(first, second):
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if math.isnan(rel):
            return rel
        worst = max(worst, rel)
    return worst


class relu_branches:
    """``torch.relu`` made to take, in its k-th call, the other branch at
    the inputs where ``flip[k]`` is True: ``x - relu(x)``, 0 for an input
    > 0 and the input itself otherwise (their gradients likewise)."""

    def __init__(self, torch, flip):
        self.torch, self.flip, self.calls = torch, flip, 0

    def __call__(self, x):
        y = self.relu(x)
        flip = self.flip[self.calls]
        self.calls += 1
        return self.torch.where(flip, x - y, y)

    def __enter__(self):
        self.relu, self.torch.relu = self.torch.relu, self
        return self

    def __exit__(self, *exc):
        self.torch.relu = self.relu


class plain_kernels:
    """K1-K4's wrappers made to run their plain versions on CUDA tensors
    too (``vs_cpu``'s witness where it fails; launches no kernel)."""

    def __enter__(self):
        from sessionrec_tpu_torch.ops import xent
        from sessionrec_tpu_torch.ops import xent_multi as xm

        def k1(sr, table, labels, n_valid, col_offset, **kw):
            m, s, zl = xent._fwd_plain(sr, table, labels, n_valid,
                                       col_offset, **kw)
            lse = xent._finish_lse(m, s)
            return lse - zl, lse

        self.saved = [(mod, mod._fwd_cuda, mod._bwd_cuda)
                      for mod in (xent, xm)]
        xent._fwd_cuda, xent._bwd_cuda = k1, xent._bwd_plain
        xm._fwd_cuda, xm._bwd_cuda = xm._fwd_plain, xm._bwd_plain
        return self

    def __exit__(self, *exc):
        for mod, fwd, bwd in self.saved:
            mod._fwd_cuda, mod._bwd_cuda = fwd, bwd


def held_to_cpu(torch, model, cpu_model, loss_gpu, loss_cpu, grads):
    """({what: max abs err}, ok) of ``vs_cpu``'s bars: the loss to rtol
    1e-4, each parameter of ``grads``' gradient to 1e-3 of its largest
    magnitude on the CPU, each buffer to 1e-5 of max(1, its largest)."""
    errs = {"loss": abs(float(loss_gpu.detach()) - float(loss_cpu.detach()))}
    ok = errs["loss"] <= 1e-4 * abs(float(loss_cpu.detach()))
    gpu_p, cpu_p = dict(model.named_parameters()), \
        dict(cpu_model.named_parameters())
    for pname in grads:
        pc = grad_or_zeros(torch, cpu_p[pname])
        errs[pname] = max_err(grad_or_zeros(torch, gpu_p[pname]).cpu(), pc)
        ok = ok and errs[pname] <= 1e-3 * float(pc.abs().max())
    cpu_b = dict(cpu_model.named_buffers())
    for bname, t in model.named_buffers():
        errs[bname] = max_err(t.cpu(), cpu_b[bname])
        ok = ok and errs[bname] <= 1e-5 * max(
            1.0, float(cpu_b[bname].abs().max()))
    return errs, ok


def vs_cpu(torch, model, batch, grads):
    """({what: max abs err}, ok): one training forward and backward of
    ``batch`` through the kernels against the plain path on the CPU, from
    a copy taken before it, to ``held_to_cpu``'s bars, and every
    ``torch.relu`` input to RELU_GAP (``relu_gap``).  ``relu_flips``: the
    inputs whose sign differs between the card and the CPU, so within
    RELU_GAP of 0.  Where they exist and the CPU's own branches miss the
    bars, the CPU runs again from the copy with the other branch at those
    inputs (``relu_branches``), and the card must meet the bars against
    that run (``at_ties``).  Where the check fails, ``plain_on_card``
    holds each of ``grads``' [error against the CPU's last run, error
    against the kernels' run] of the same forward and backward on the
    card through K1-K4's plain versions (``plain_kernels``): a gap that
    they share is not the kernels'."""
    from sessionrec_tpu_torch.train.runner import make_loss
    model.zero_grad(set_to_none=True)
    start = copy.deepcopy(model).to("cpu")

    def on_cpu(relu):
        cpu_model = copy.deepcopy(start)
        with relu:
            loss = make_loss(cpu_model, batch.to("cpu"), None)
        loss.backward()
        return cpu_model, loss

    with relu_inputs(torch) as card:
        loss_gpu = make_loss(model, batch, None)
    loss_gpu.backward()
    cpu = relu_inputs(torch)
    cpu_model, loss_cpu = on_cpu(cpu)
    errs, ok = held_to_cpu(torch, model, cpu_model, loss_gpu, loss_cpu, grads)
    gap = relu_gap(card.inputs, cpu.inputs)
    errs.update(relu_gap=gap, relu_flips=relu_flips(card.inputs, cpu.inputs))
    within = gap <= RELU_GAP
    if within and errs["relu_flips"][0] and not ok:
        flip = [(a > 0) != (b > 0) for a, b in zip(card.inputs, cpu.inputs)]
        cpu_model, loss_cpu = on_cpu(relu_branches(torch, flip))
        errs["at_ties"], ok = held_to_cpu(torch, model, cpu_model, loss_gpu,
                                          loss_cpu, grads)
    ok = ok and within
    if not ok:
        gpu_p, cpu_p = dict(model.named_parameters()), \
            dict(cpu_model.named_parameters())
        kern = {p: grad_or_zeros(torch, gpu_p[p]).cpu() for p in grads}
        model.zero_grad(set_to_none=True)
        with plain_kernels():
            make_loss(model, batch, None).backward()
        errs["plain_on_card"] = plain = {}
        for p in grads:
            g = grad_or_zeros(torch, gpu_p[p]).cpu()
            plain[p] = [max_err(g, grad_or_zeros(torch, cpu_p[p])),
                        max_err(g, kern[p])]
    return errs, ok


def vs_cpu_bf16(torch, model, batch, grads):
    """``vs_cpu`` of a bf16 path: the same forward and backward on the card
    and on the CPU (both bf16, the kernels' plain versions on the CPU),
    and on the CPU in float32 compute from the same bf16 table; the loss
    to BF16_LOSS of the CPU's; each parameter of ``grads``' gradient
    [card error, CPU bf16 error], each against the float32-compute
    gradient, as a share of its largest magnitude: the card's at most
    BF16_GRAD times the CPU's, or than BF16_FLOOR where that is larger."""
    from sessionrec_tpu_torch.train.runner import make_loss
    cpu = copy.deepcopy(model).to("cpu")
    cpu32 = copy.deepcopy(cpu)
    cpu32.compute_dtype = "float32"
    loss = {}
    for key, m, b in (("card", model, batch), ("cpu", cpu, batch.to("cpu")),
                      ("cpu32", cpu32, batch.to("cpu"))):
        m.zero_grad(set_to_none=True)
        out = make_loss(m, b, None)
        out.backward()
        loss[key] = float(out.detach())
    errs = {"loss": abs(loss["card"] - loss["cpu"])}
    ok = errs["loss"] <= BF16_LOSS * abs(loss["cpu"])
    params = {k: dict(m.named_parameters())
              for k, m in (("card", model), ("cpu", cpu), ("cpu32", cpu32))}
    for pname in grads:
        ref = grad_or_zeros(torch, params["cpu32"][pname]).float()
        scale = max(float(ref.abs().max()), 1e-30)
        e_card, e_cpu = (
            max_err(grad_or_zeros(torch, params[k][pname]).cpu(), ref)
            / scale for k in ("card", "cpu"))
        errs[pname] = [e_card, e_cpu]
        ok = ok and e_card <= BF16_GRAD * max(e_cpu, BF16_FLOOR)
    return errs, ok


def graph_vs_plain(torch, runner, batches):
    """(graph losses, plain losses, {parameter or buffer: max abs gap}):
    ``batches`` through the runner's captured graph and then, from the
    same state, through the plain ``train_step``."""
    start = [t.clone() for t in runner.state_tensors()]
    got = runner.run_chunk(batches)
    after = {n: t.clone() for n, t in runner.model.state_dict().items()}
    for t, v in zip(runner.state_tensors(), start):
        t.copy_(v)
    want = torch.stack([runner.train_step(b.to(runner.device))
                        for b in batches])
    torch.cuda.synchronize()
    gaps = {n: max_err(after[n], t) for n, t in
            runner.model.state_dict().items()}
    return got, want, gaps


def phase_graph_vs_plain(torch, name, seed, dataset_dir, smi):
    """From one state, 8 steps through the graph and 8 plain steps on the
    card: losses to rtol 1e-4, every parameter and buffer to atol 1e-5
    (the bars of tests/test_torch_train.py); then the graph loop's host
    line."""
    from sessionrec_tpu_torch.utils.profiling import (host_breakdown,
                                                      setup_runner)
    train, runner = setup_runner(path_config(name, seed, dataset_dir))
    G = runner.unroll
    batches = first_batches(train, 2 * G)
    runner.run_chunk(batches[:G])            # eager: Adam's state exists
    got, want, gaps = graph_vs_plain(torch, runner, batches[G:])
    rel = float(((got - want).abs() / want.abs()).max())
    worst = max(gaps, key=gaps.get)
    bit = bool(torch.equal(got, want)) and gaps[worst] == 0.0
    row = {"phase": f"{name}_graph_vs_plain", "steps": G,
           "graph_losses": got.tolist(), "plain_losses": want.tolist(),
           "loss_max_rel_gap": rel, "param_max_abs_gap": gaps[worst],
           "param_worst": worst, "bit_identical": bit,
           "ok": rel <= 1e-4 and gaps[worst] <= 1e-5
           and (bit or not is_bf16(name))}
    emit(row)
    check(row["ok"], f"graph and plain steps disagree: {row}")
    emit(dict(host_breakdown(train, runner, 2 * G, 3 * G), path=name,
              card=smi))


def clear_positions(np, scores, tie=SCORE_TIE):
    """[n, k] mask of the positions of descending [n, k + 1] score lists
    that lie more than ``tie`` from both neighbours."""
    gap = np.abs(np.diff(scores, axis=1))
    left = np.concatenate([np.full((len(scores), 1), np.inf), gap[:, :-1]],
                          axis=1)
    return (gap > tie) & (left > tie)


def compare_recommendations(np, got, want, bf16=False):
    """{ok, ...}: card lists ``got`` (k ids) against CPU lists ``want``
    (k + 1 ids, so the last position has a right neighbour): ids equal
    at every clear position, scores to SCORE_ATOL; with ``bf16``, ids
    where the neighbours lie more than BF16_TIE of the row's largest score
    magnitude apart, scores to BF16_SCORE of it."""
    g_ids = np.array([ids for _, ids, _ in got])
    g_sc = np.array([v for _, _, v in got], np.float64)
    w_ids = np.array([ids for _, ids, _ in want])[:, :-1]
    w_sc = np.array([v for _, _, v in want], np.float64)
    scale = np.abs(w_sc).max(axis=1, keepdims=True) if bf16 else 1.0
    tie, atol = (BF16_TIE, BF16_SCORE) if bf16 else (SCORE_TIE, SCORE_ATOL)
    clear = clear_positions(np, w_sc / scale, tie)
    id_mismatch = int((g_ids != w_ids)[clear].sum())
    score_err = float((np.abs(g_sc - w_sc[:, :-1]) / scale).max())
    return {"sessions": len(got), "clear_positions": int(clear.sum()),
            "tied_positions": int((~clear).sum()),
            "id_mismatches": id_mismatch, "score_max_abs_err": score_err,
            "ok": (len(got) == len(want) and id_mismatch == 0
                   and score_err <= atol)}


def phase_serve(torch, name, trained, cfg, smi, dev="cuda"):
    """Serving from the path run's checkpoint: with ``train.pt`` deleted,
    the parameters and buffers alone restore into a fresh model, bit for
    bit equal to ``trained``, the run's when it saved;
    ``recommend`` over the whole test split at batch 512 and k 20 on the
    card agrees with ``recommend`` on the CPU from the same parameters;
    then one recommend step is timed over the split (synchronised host
    wall per batch, the ids and scores read back)."""
    import numpy as np
    from sessionrec_tpu_torch import serving
    from sessionrec_tpu_torch.data.io import max_session_len, read_dataset
    from sessionrec_tpu_torch.models import build_model

    ckpt = Path(cfg.train.checkpoint_dir)
    (ckpt / "epoch_0000" / "train.pt").unlink()
    held = reset_peak(torch) if dev == "cuda" else None
    train, test, num_items = read_dataset(cfg.data.dataset_dir)
    max_len = max(max_session_len(train), max_session_len(test))
    model = serving.restore_params(build_model(cfg.model, num_items), ckpt,
                                   dev)
    same = all(torch.equal(t, trained[n]) for n, t in
               model.state_dict().items())
    order = cfg.model.order
    kw = dict(max_len=max_len, batch_size=cfg.data.batch_size, order=order)
    got = list(serving.recommend(model, test, k=TOPK, **kw))
    cpu_model = serving.restore_params(build_model(cfg.model, num_items),
                                       ckpt, "cpu")
    want = list(serving.recommend(cpu_model, test, k=TOPK + 1, **kw))
    cmp = compare_recommendations(np, got, want, is_bf16(name))

    t0 = time.perf_counter()
    batches = list(serving.session_batches(
        test, model.graph_kind, kw["batch_size"], max_len, order))
    build_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    step = serving.make_recommend_step(model, TOPK)
    times = []
    for rep in range(6):                 # the first pass warms up, captures
        for batch, n in batches:
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            vals, ids = step(batch)
            vals, ids = vals[:n].cpu(), ids[:n].cpu()
            if rep:
                times.append(time.perf_counter() - t0)
    ms = np.array(times) * 1e3
    g = step.graph
    row = {"phase": f"{SHORT[name]}_serve", "sessions": len(test),
           "batch": kw["batch_size"], "k": TOPK, "batches": len(batches),
           "timed_batches": len(times), "restored_bit_identical": same,
           **cmp, "graph": g is not None and g.replays > 0,
           "graph_replays": g.replays if g is not None else 0,
           "ms_per_batch_median": float(np.median(ms)),
           "ms_per_batch_p99": float(np.percentile(ms, 99)),
           "sessions_per_s": 5 * len(test) / (ms.sum() / 1e3),
           "build_ms_per_batch": build_ms,
           "peak_gib": peak_gib(torch) if dev == "cuda" else None,
           "held_before_gib": held,
           "card": smi, "ok": same and cmp["ok"]}
    emit(row)
    check(same, "parameters or buffers restored without train.pt differ "
          "from the trained runner's")
    check(cmp["ok"], f"card and CPU recommendations disagree: {cmp}")
    check(dev != "cuda" or row["graph"], "the recommend step ran no graph")


def phase_eval(torch, name, runner, smi, dev="cuda"):
    """One eval sweep eager, batch by batch, and one through the runner's
    eval graphs, over the same host batches of the test split: the
    (hit, mrr, n) sums agree to SUMS_ATOL; ms per batch of each
    (synchronised host wall over the sweep)."""
    from sessionrec_tpu_torch.train.runner import eager_sums, sweep_metrics
    loader = runner.test_loader
    batches = list(loader)

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def eager():
        return eager_sums(runner.model, batches, runner.cutoff, dev)

    runner.test_loader = batches
    try:
        out = {}
        for what, fn in (("eager", eager), ("graph", runner.eval_sweep)):
            fn()                              # warm
            sync()
            t0 = time.perf_counter()
            for _ in range(3):
                sums = fn()
            sync()
            out[what] = (sums, (time.perf_counter() - t0) / 3
                         / len(batches) * 1e3)
    finally:
        runner.test_loader = loader
    (e_sums, e_ms), (g_sums, g_ms) = out["eager"], out["graph"]
    gap = float((e_sums - g_sums).abs().max())
    graphs = {n: g.replays for n, g in runner.eval_graphs.items()}
    row = {"phase": f"{SHORT[name]}_eval", "batches": len(batches),
           "unroll": runner.unroll, "eager_sums": e_sums.tolist(),
           "graph_sums": g_sums.tolist(), "sums_max_abs_gap": gap,
           "bit_identical": bool(torch.equal(e_sums, g_sums)),
           "mrr20": sweep_metrics(g_sums)[0],
           "hr20": sweep_metrics(g_sums)[1],
           "eager_ms_per_batch": e_ms, "graph_ms_per_batch": g_ms,
           "eval_graph_replays": graphs, "card": smi,
           "ok": gap <= SUMS_ATOL}
    emit(row)
    check(row["ok"], f"eval graph and eager sweep disagree: {row}")
    check(dev != "cuda" or graphs.get(runner.unroll),
          f"no replay of the {runner.unroll}-batch eval graph: {graphs}")


def phase_resume(torch, seed, dataset_dir, smi, tmp, dev="cuda", dim=None,
                 batches=16, name="path"):
    """Path ``name``: 2 epochs of ``batches`` capped batches uninterrupted,
    against 1 epoch, then a fresh runner that resumes from its checkpoint
    for the second: losses to rtol 1e-4, parameters and buffers to atol
    1e-5 (the bars of ``graph_vs_plain``), max_mrr / max_hit to atol 1e-5
    and bad_counter equal; ``bit_identical`` says whether every loss and
    every tensor of ``named_state`` came out equal."""
    from sessionrec_tpu_torch.train.session import run_training

    def run(sub, epochs, resume=False):
        cfg = path_config(name, seed, dataset_dir, dev=dev, dim=dim,
                          epochs=epochs, resume=resume,
                          log_interval=10 ** 9,
                          checkpoint_dir=str(Path(tmp) / f"resume_{name}"
                                             / sub))
        return run_training(cfg, max_epoch_batches=batches)

    t0 = time.perf_counter()
    full = run("full", 2)
    run("ab", 1)
    b = run("ab", 2, resume=True)
    wall = time.perf_counter() - t0
    got = torch.tensor(b.losses)
    want = torch.tensor(full.losses[batches:])
    rel = float(((got - want).abs() / want.abs()).max())
    mine, ref = b.named_state(), full.named_state()
    gaps = {n: max_err(mine[n], t) for n, t in
            full.model.state_dict().items()}
    worst = max(gaps, key=gaps.get)
    metric_gap = max(abs(b.max_mrr - full.max_mrr),
                     abs(b.max_hit - full.max_hit))
    bit = (torch.equal(got, want) and set(mine) == set(ref)
           and all(torch.equal(mine[k], ref[k]) for k in ref))
    row = {"phase": f"{SHORT[name]}_resume", "epochs": 2,
           "batches_per_epoch": batches,
           "steps": [full.steps, b.steps], "resumed_losses": b.losses,
           "loss_max_rel_gap": rel, "param_max_abs_gap": gaps[worst],
           "param_worst": worst, "max_mrr": [full.max_mrr, b.max_mrr],
           "max_hit": [full.max_hit, b.max_hit],
           "bad_counter": [full.bad_counter, b.bad_counter],
           "bit_identical": bit, "graphs": sorted(b.graphs),
           "wall_seconds": wall, "card": smi,
           "ok": (len(got) == len(want) == batches and rel <= 1e-4
                  and gaps[worst] <= 1e-5 and metric_gap <= 1e-5
                  and b.bad_counter == full.bad_counter
                  and b.steps == full.steps and (bit or not is_bf16(name)))}
    emit(row)
    check(row["ok"], f"the resumed run differs from the uninterrupted one: "
          f"{row}")

# ---------------------------------------------------------------------------
# phase 9: million-item catalogs (bench.py:93 niser-1m, :149 msgifsr-o3-1m)
# ---------------------------------------------------------------------------

MILLION = 1 << 20
# sessions of the synthetic split: about 9,300 train examples (18 batches
# of 512) and 2,000 test examples (4 batches; a 1,024-row batch fits)
M_SESSIONS = {"train": 3000, "test": 640}
# the paper head's batch where its [B, K, P] scores are materialised too
# (3 x 64 x 2^20 float32, 0.75 GiB a tensor), and how many of them
M_SMALL_B, M_SMALL_BATCHES = 64, 8
REL_TIE = 1e-5      # a score this close (relative) to the label's may swap
PLACED = 30         # labels placed at ranks 1 .. PLACED of the scores
MILLION_PATHS = {
    # NISER+ at bench.py:93: batch 512, d 64, 2 layers, feat_drop 0.5,
    # normalised table, scale 12; 16 steps (8 eager, one 8-step replay)
    "niser_1m": dict(preset="niser", model=dict(batch_size=512),
                     kernels=K12, steps=16),
    # the paper head at bench.py:149: order 3, REnorm, fusion, d 256,
    # batch 512, feat_drop 0.1, "real" lengths, tiers (4, 8); 8 steps
    "paper_1m": dict(preset="msgifsr",
                     model=dict(order=3, extra=True, fusion=True),
                     kernels=K34, steps=8),
}


def reset_peak(torch):
    """Reset the card's peak-memory counter; returns the GiB allocated
    now (tensors of earlier phases still alive), which every later peak
    includes."""
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2 ** 30


def peak_gib(torch):
    """The card's peak allocated memory since the last reset, GiB."""
    return torch.cuda.max_memory_allocated() / 2 ** 30


def million_dataset(np, root, seed, dataset_dir):
    """A dataset of MILLION items under ``root``: ids uniform over the
    catalog, session lengths drawn from ``dataset_dir``'s train sessions,
    so that the prefixes follow its train prefix lengths (the "real"
    lengths of bench.py:154-167, which draws those prefix lengths)."""
    from sessionrec_tpu_torch.data.io import read_sessions
    lens = np.array([len(s) for s in
                     read_sessions(Path(dataset_dir) / "train.txt")])
    rng = np.random.default_rng(seed)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    for split, n in M_SESSIONS.items():
        ls = rng.choice(lens[lens >= 2], size=n)
        ids = rng.integers(0, MILLION, size=int(ls.sum())).tolist()
        ends = np.cumsum(ls).tolist()
        lines = [",".join(map(str, ids[e - l:e])) for l, e in zip(ls, ends)]
        (root / f"{split}.txt").write_text("\n".join(lines) + "\n")
    (root / "num_items.txt").write_text(f"{MILLION}\n")
    return root


def million_config(name, seed, data_dir, **train):
    from sessionrec_tpu_torch.utils.profiling import run_config
    spec = MILLION_PATHS[name]
    return run_config(spec["preset"], seed, data_dir, device="cuda",
                      epochs=1, log_interval=10 ** 9, **spec["model"],
                      **train)


def with_labels(batch, labels):
    """``batch`` with its (row-concatenated) labels replaced, tier by
    tier."""
    import dataclasses
    from sessionrec_tpu_torch.graph.batch import flatten_blocks, nest_blocks
    blocks, start = [], 0
    for b in flatten_blocks(batch):
        n = b.labels.shape[0]
        blocks.append(dataclasses.replace(b, labels=labels[start:start + n]))
        start += n
    return nest_blocks(blocks)


def phase_million_train(torch, name, seed, data_dir, smi, tmp):
    """Train path ``name`` for its steps through ``run_training`` (an
    initial and a final eval at the auto policy; niser_1m checkpoints):
    the path's kernels once a step, counted as the other paths count them,
    the others never; a finite, falling loss; then one more chunk traced,
    whose device ms a step is the train step's.  Returns (wrapper
    launches, device launches, runner, config, the parameters saved in
    the checkpoint or None)."""
    from sessionrec_tpu_torch.train.session import run_training
    from sessionrec_tpu_torch.utils import profiling
    from sessionrec_tpu_torch.utils.profiling import busy_us
    spec = MILLION_PATHS[name]
    steps = spec["steps"]
    ckpt = {"checkpoint_dir": str(Path(tmp) / name / "ckpt")} \
        if name == "niser_1m" else {}
    cfg = million_config(name, seed, data_dir, **ckpt)
    held = reset_peak(torch)
    profiling.reset()
    t0 = time.perf_counter()
    runner = run_training(cfg, max_epoch_batches=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wrapper_launches()
    on_device = device_launches(launches, runner.graphs)
    peak = peak_gib(torch)
    n = runner.steps
    # the parameters the checkpoint holds, before the traced chunk
    saved = {k: t.clone() for k, t in runner.model.state_dict().items()} \
        if ckpt else None
    G = runner.unroll
    chunk = first_batches(runner.train_loader, G)
    t0 = time.perf_counter()
    events = traced_events(torch, lambda: runner.run_chunk(chunk))
    traced, _, kernel_events = count_launches(events)
    busy_ms = busy_us(events) / 1e3
    traced_s = time.perf_counter() - t0 - 2 * TRACE_SETTLE_S
    losses = runner.losses
    m = cfg.model
    row = {"phase": f"{name}_train", "model": m.name, "items": MILLION,
           "P": runner.model.padded_items, "dim": m.embedding_dim,
           "layers": m.num_layers, "order": m.order, "extra": m.extra,
           "fusion": m.fusion, "batch": cfg.data.batch_size,
           "tiers": list(cfg.data.split_len), "feat_drop": m.feat_drop,
           "steps": n, "launches": launches, "device_launches": on_device,
           "graphs": {n: g.replays for n, g in runner.graphs.items()},
           "traced_chunk_launches": traced,
           "traced_kernel_events": kernel_events,
           "traced_chunk_s": traced_s,
           "device_ms_a_step": busy_ms / G if kernel_events else None,
           "first_losses": losses[:4], "last_losses": losses[-4:],
           "mrr20": runner.max_mrr, "hr20": runner.max_hit,
           "train_examples": runner.train_examples,
           "train_seconds": runner.train_seconds, "wall_seconds": wall,
           "peak_gib": peak, "held_before_gib": held, "card": smi}
    emit(row)
    check(n == steps, f"{name}: ran {n} steps, expected {steps}")
    bad = launch_errors(on_device, steps, spec["kernels"])
    check(not bad, f"{name}: device launches {bad} [counted, expected]")
    check(all((launches[k] > 0) == (k in spec["kernels"]) for k in launches),
          f"{name}: wrapper launches {launches}")
    if kernel_events:
        bad = launch_errors(traced, G, spec["kernels"])
        check(not bad, f"{name}: traced launches {bad} in {G} steps")
    check(all(math.isfinite(x) for x in losses), f"{name}: non-finite loss")
    check(sum(losses[-4:]) < sum(losses[:4]),
          f"{name}: loss did not fall: {losses}")
    return ({k: launches[k] for k in spec["kernels"]},
            {k: on_device[k] for k in spec["kernels"]}, runner, cfg, saved)


def graph_ranks(torch, model, batches, cutoff=TOPK, **kw):
    """``eval_ranks(model, batch, cutoff, **kw)`` of each host batch
    through a one-batch CUDA graph over a static slot (after one eager
    batch): (ranks per batch, capture seconds, ms a batch per replay,
    staging the batch and reading nothing back)."""
    from sessionrec_tpu_torch.train.runner import (_capture, _on_side_stream,
                                                   _Slots, eval_ranks)
    slots = _Slots(torch.device("cuda"))
    _on_side_stream(slots.device, lambda: eval_ranks(
        model, slots.stage(0, batches[0]), cutoff, **kw))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g, _ = _capture({}, 1, None,
                    lambda: eval_ranks(model, slots[0], cutoff, **kw), "eval")
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    ranks, ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        slots.stage(0, b)
        g.graph.replay()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        ranks.append(g.out.clone())
    return ranks, capture_s, ms


def rank_metrics(torch, ranks, batches):
    """(MRR@20, HR@20) of per-batch label ranks over the batches' valid
    rows, in float64."""
    hit = mrr = n = 0.0
    for r, b in zip(ranks, batches):
        v = torch.as_tensor(b.valid, dtype=torch.float64).to(r.device)
        r = r.to(torch.float64)
        hit += float(torch.sum((r > 0) * v))
        mrr += float(torch.sum(torch.where(r > 0, 1.0 / r.clamp(min=1),
                                           0.0) * v))
        n += float(v.sum())
    return mrr / max(n, 1.0), hit / max(n, 1.0)


def ranked_scores(torch, model, batch):
    """The materialised scores whose order the rankers count, on the
    card: the plain head's masked logits, the multi head's blended
    probabilities (``exp`` of ``model.apply``'s log-probabilities)."""
    from sessionrec_tpu_torch.train.runner import eval_scores
    scores = eval_scores(model, batch)
    return scores if model.has_plain_head else torch.exp(scores)


def compare_ranks(torch, model, got, want, batches, ties_held=True):
    """{rows, ranked, excluded, mismatched, tied}: ranks ``got`` against
    ``want`` per device batch.  ``excluded``: rows that either ranks
    within the cutoff whose label's score has another real item's within
    REL_TIE (relative) without equalling it, where float32 rounding in
    another order may swap the two; ``tied``: rows whose label ties
    another item exactly in ``want``'s scores, held like the others, or,
    without ``ties_held``, counted apart where they differ
    (``mismatched_at_tie``): scores computed another way need not tie."""
    out = dict(rows=0, ranked=0, excluded=0, mismatched=0, tied=0,
               mismatched_at_tie=0)
    for g, w, b in zip(got, want, batches):
        scores = ranked_scores(torch, model, b)
        lv = torch.gather(scores, 1, b.labels.to(torch.int64)[:, None])
        near = ((scores - lv).abs() <= REL_TIE * lv.abs()) & (scores != lv)
        near[:, model.num_items:] = False
        near = near.any(dim=1) & ((g > 0) | (w > 0))
        out["rows"] += len(g)
        out["ranked"] += int((w > 0).sum())
        tied = (scores == lv).sum(1) > 1
        off = (g != w) & ~near
        out["excluded"] += int(near.sum())
        out["tied"] += int(tied.sum())
        if not ties_held:
            out["mismatched_at_tie"] += int((off & tied).sum())
            off = off & ~tied
        out["mismatched"] += int(off.sum())
    return out


def placed_batch(torch, model, batch, seed):
    """``batch`` on the card with labels at ranks 1, 2, .. PLACED of the
    materialised scores (row r at rank r % PLACED + 1) and exact ties: for
    each of the first 4 rows, its best item outside the session (so that
    both lie in one REnorm part) copied into a random table row, which
    becomes the row's label.  Returns (batch, restore), ``restore()``
    putting the table rows back."""
    from sessionrec_tpu_torch.ops.scoring import stable_topk
    gen = torch.Generator().manual_seed(seed)
    top = stable_topk(ranked_scores(torch, model, batch), PLACED)[1]
    rows = torch.arange(top.shape[0], device=top.device)
    src = top[:, 0]
    if not model.has_plain_head:
        member = model._session_item_mask(batch).bool()
        outside = ~torch.gather(member, 1, top)
        src = top[rows, torch.argmax(outside.to(torch.int32), dim=1)]
    tab = model.embedding.data
    dst = torch.randint(0, model.num_items, (4,), generator=gen)
    dst = dst.to(tab.device)
    saved = tab[dst].clone()
    tab[dst] = tab[src[:4]]
    labels = top[rows, rows % PLACED]
    labels[:4] = dst
    batch = with_labels(batch, labels.to(torch.int32))

    def restore():
        tab[dst] = saved

    return batch, restore


def phase_million_eval(torch, name, runner, cfg, smi):
    """Eval at P = 2^20.  The runner's sweep over the test split at the
    auto policy (its eval graphs; timed, sums); then per method a
    one-batch eval graph (``graph_ranks``: capture seconds and replay ms
    a batch): streamed against materialised, metrics to SUMS_ATOL and
    ranks equal on every row not within REL_TIE of another item, on the
    test labels and on placed labels with exact ties; the ``topk`` rank
    method on one batch; niser_1m also a 1,024-row batch, where the auto
    policy streams."""
    import numpy as np
    from sessionrec_tpu_torch.data.io import max_session_len, read_dataset
    from sessionrec_tpu_torch.data.loader import BatchLoader
    from sessionrec_tpu_torch.train.runner import _streams, sweep_metrics
    model, dev = runner.model, torch.device("cuda")
    model.eval()
    batches = list(runner.test_loader)
    runner.test_loader = batches
    held = reset_peak(torch)
    runner.eval_sweep()                               # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        sums = runner.eval_sweep()
    torch.cuda.synchronize()
    sweep_ms = (time.perf_counter() - t0) / 3 / len(batches) * 1e3
    auto = _streams(model, batches[0], None)
    mrr, hit = sweep_metrics(sums)
    row = {"phase": f"{name}_eval", "batches": len(batches),
           "batch": cfg.data.batch_size, "auto_path":
           "streamed" if auto else "materialised",
           "sweep_ms_per_batch": sweep_ms, "sweep_sums": sums.tolist(),
           "mrr20": mrr, "hr20": hit,
           "eval_graph_replays": {n: g.replays for n, g in
                                  runner.eval_graphs.items()},
           "sweep_peak_gib": peak_gib(torch), "held_before_gib": held,
           "card": smi}
    check(auto == (name == "paper_1m"),
          f"{name}: the auto policy picked the {row['auto_path']} path")
    dbatches = [b.to(dev) for b in batches]
    methods = {}

    def run(key, bs, db, **kw):
        held = reset_peak(torch)
        ranks, cap, ms = graph_ranks(torch, model, bs, **kw)
        methods[key] = {"capture_s": cap, "ms_per_batch_median":
                        float(np.median(ms)), "ms_per_batch": ms,
                        "peak_gib": peak_gib(torch), "held_before_gib": held,
                        "metrics": rank_metrics(torch, ranks, db)}
        return ranks

    train, test, _ = read_dataset(cfg.data.dataset_dir)
    max_len = max(max_session_len(train), max_session_len(test))

    def loader(batch_size):
        return BatchLoader(test, model.graph_kind, batch_size, max_len,
                           order=cfg.model.order, prefetch=0,
                           split_len=cfg.data.split_len)

    if name == "niser_1m":
        ref_b, ref_db = batches, dbatches
    else:
        ref_b = first_batches(loader(M_SMALL_B), M_SMALL_BATCHES)
        ref_db = [b.to(dev) for b in ref_b]
        run("streamed_count_b512", batches, dbatches, streamed=True)
    want = run("materialised_count", ref_b, ref_db, streamed=False)
    got = run("streamed_count", ref_b, ref_db, streamed=True)
    cmp = compare_ranks(torch, model, got, want, ref_db)
    gap = max(abs(a - b) for a, b in zip(methods["streamed_count"]["metrics"],
                                         methods["materialised_count"]
                                         ["metrics"]))
    # the topk rank method, both paths, on one batch
    one, d_one = ref_b[:1], ref_db[:1]
    topk = {s: run(f"{s}_topk", one, d_one,
                   streamed=s == "streamed", rank_method="topk")[0]
            for s in ("materialised", "streamed")}
    topk_cmp = compare_ranks(torch, model, [topk["streamed"],
                                            topk["materialised"]],
                             [want[0], want[0]], d_one * 2)
    # placed labels with exact ties, on the first batch
    placed, restore = placed_batch(torch, model, ref_db[0], 7)
    try:
        p_want = graph_ranks(torch, model, [placed], streamed=False)[0]
        p_got = graph_ranks(torch, model, [placed], streamed=True)[0]
        p_cmp = compare_ranks(torch, model, p_got, p_want, [placed])
    finally:
        restore()
    row.update(methods=methods, ranks=cmp, metrics_max_abs_gap=gap,
               topk_ranks=topk_cmp, placed_ranks=p_cmp)
    ok = (gap <= SUMS_ATOL and cmp["mismatched"] == 0
          and topk_cmp["mismatched"] == 0 and p_cmp["mismatched"] == 0
          and p_cmp["ranked"] >= len(p_want[0]) // 4 and p_cmp["tied"] >= 1)
    if name == "niser_1m":
        big_b = first_batches(loader(2 * cfg.data.batch_size), 1)
        big_d = [big_b[0].to(dev)]
        picks = _streams(model, big_d[0], None)
        g = run("auto_b1024", big_b, big_d)
        w = run("materialised_b1024", big_b, big_d, streamed=False)
        big_cmp = compare_ranks(torch, model, g, w, big_d)
        row["b1024"] = {"rows": int(big_d[0].labels.shape[0]),
                        "auto_path": "streamed" if picks
                        else "materialised", "ranks": big_cmp}
        ok = ok and picks and big_cmp["mismatched"] == 0
    row["ok"] = ok
    emit(row)
    check(ok, f"{name}: streamed and materialised eval disagree: {row}")


def phase_million_serve(torch, name, model, cfg, smi):
    """Serving the paper head at P = 2^20 from the trained model: the
    whole test split at batch 512, auto-streamed (``streamed_multi_topk``
    at the serving tile of 32,768), against the materialised top-k at
    batch 64 (``streamed=False``): ids equal at every position whose
    materialised probability lies more than REL_TIE of the row's largest
    from its neighbours', values to REL_TIE of it; then at the tile of
    2,048, its ids against the 32,768 tile's under the same rule.  Each
    timed as ``phase_serve`` times one step (6 passes, the first warms up
    and captures): sessions/s, median and p99 ms a batch, peak memory."""
    import numpy as np
    from sessionrec_tpu_torch import serving
    from sessionrec_tpu_torch.data.io import max_session_len, read_dataset
    from sessionrec_tpu_torch.train.runner import _streams
    train, test, _ = read_dataset(cfg.data.dataset_dir)
    max_len = max(max_session_len(train), max_session_len(test))
    kw = dict(max_len=max_len, order=cfg.model.order)
    want = list(serving.recommend(model, test, k=TOPK + 1,
                                  batch_size=M_SMALL_B, streamed=False,
                                  **kw))
    w_ids = np.array([ids for _, ids, _ in want])
    w_p = np.exp(np.array([v for _, _, v in want], np.float64))
    scale = w_p.max(axis=1, keepdims=True)
    clear = clear_positions(np, w_p / scale, REL_TIE)
    batches = list(serving.session_batches(
        test, model.graph_kind, cfg.data.batch_size, max_len,
        cfg.model.order))
    out, ids_by_tile = {}, {}
    for tile in (serving.serving_tile(model.padded_items), 2048):
        held = reset_peak(torch)
        step = serving.make_recommend_step(model, TOPK, tile=tile)
        times, got_ids, got_vals = [], [], []
        for rep in range(6):
            for batch, n in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vals, ids = step(batch)
                vals, ids = vals[:n].cpu(), ids[:n].cpu()
                if rep:
                    times.append(time.perf_counter() - t0)
                else:
                    got_ids.append(ids.numpy())
                    got_vals.append(vals.numpy())
        g_ids = np.concatenate(got_ids)
        g_val = np.concatenate(got_vals).astype(np.float64)
        ids_by_tile[tile] = g_ids
        ms = np.array(times) * 1e3
        out[str(tile)] = {
            "id_mismatches": int((g_ids != w_ids[:, :TOPK])[clear].sum()),
            "value_max_rel_err": float((np.abs(g_val - w_p[:, :TOPK])
                                        / scale).max()),
            "graph_replays": step.graph.replays if step.graph else 0,
            "ms_per_batch_median": float(np.median(ms)),
            "ms_per_batch_p99": float(np.percentile(ms, 99)),
            "sessions_per_s": 5 * len(test) / (ms.sum() / 1e3),
            "peak_gib": peak_gib(torch), "held_before_gib": held}
    tiles = list(ids_by_tile)
    auto = _streams(model, batches[0][0], None)
    row = {"phase": f"{name}_serve", "sessions": len(test),
           "batch": cfg.data.batch_size, "k": TOPK,
           "auto_path": "streamed" if auto else "materialised",
           "clear_positions": int(clear.sum()),
           "tied_positions": int((~clear).sum()), "tiles": out,
           "tile_id_mismatches": int((ids_by_tile[tiles[0]]
                                      != ids_by_tile[tiles[1]])[clear].sum()),
           "card": smi}
    row["ok"] = (auto and all(t["id_mismatches"] == 0
                              and t["graph_replays"] > 0
                     and t["value_max_rel_err"] <= REL_TIE
                     for t in out.values())
                 and row["tile_id_mismatches"] == 0)
    emit(row)
    check(row["ok"], f"{name}: streamed serving disagrees: {row}")


def phase_million_kernels(torch, xent, xm, seed, smi):
    """K1 and K2 at niser_1m's shape (B 512, D 64, P 2^20, normalised,
    scale 12), K3 and K4 at paper_1m's (K 3, D 256, P 2^20): each against
    its plain version on the card (``xent_check``, ``multi_check``: K3/K4
    at B 64), then timed with its bound and the library's time (K3/K4 at
    B 64 and at the train step's B 512)."""
    xent_check(torch, xent, (MILLION, MILLION, torch.float32, True, B, 64),
               seed, path="niser_1m")
    xent_times(torch, xent, MILLION, MILLION, torch.float32, seed, smi,
               rows=B, dim=64, path="niser_1m")
    multi_check(torch, xm, (MILLION, MILLION, torch.float32, True,
                            M_SMALL_B, D), seed, path="paper_1m")
    for rows in (M_SMALL_B, B):
        torch.cuda.empty_cache()
        multi_times(torch, xm, MILLION, MILLION, torch.float32, seed, smi,
                    rows=rows, path="paper_1m")
    torch.cuda.empty_cache()


def run_million_paths(torch, np, seed, dataset_dir, smi, tmp):
    """The two million-item paths on a synthetic split written under
    ``tmp``: train, eval, serve; returns ({kernel: wrapper launches},
    {kernel: device launches}) of their training runs."""
    data = million_dataset(np, Path(tmp) / "million", seed, dataset_dir)
    launches, on_device = {}, {}
    for name in MILLION_PATHS:
        wrapped, dev, runner, cfg, saved = phase_million_train(
            torch, name, seed, data, smi, tmp)
        for k in wrapped:
            launches[k] = launches.get(k, 0) + wrapped[k]
            on_device[k] = on_device.get(k, 0) + dev[k]
        phase_million_eval(torch, name, runner, cfg, smi)
        if saved is not None:
            phase_serve(torch, name, saved, cfg, smi)
        else:
            phase_million_serve(torch, name, runner.model, cfg, smi)
        del runner
        torch.cuda.empty_cache()
    return launches, on_device


# ---------------------------------------------------------------------------
# phase 10: the (data, model) mesh, 4 ranks on the one card over gloo
# ---------------------------------------------------------------------------

MESH_DP, MESH_MP = 2, 2
MESH_PATHS = ("path", "paper")
MESH_STEPS = 4
MESH_ROWS = B // MESH_DP                   # each rank's rows of a batch
# tolerances, mesh against one device, justified by the reduction orders:
# a loss is a float32 log-sum-exp over 3,429 logits merged from two shards
# (one max, sums in another order) and a mean over two data blocks, a few
# ulps apart: losses rtol MESH_RTOL.  Every product of the graph side runs
# on 256 rows a rank where the card alone runs 512, so cuBLAS tiles its
# float32 sums otherwise and every activation and gradient differs in its
# last bits, and every gradient is summed over two data positions.  Each
# step starts from the card's state before it, so these differences are
# one step's, not carried over.  State after a step: rtol MESH_RTOL and
# atol MESH_ATOL (as the CPU tests hold the one-device step,
# tests/test_torch_mesh_train.py), on the table and its Adam moments with
# no exception.  Adam divides by sqrt(v) + eps, so where an element's
# gradients are all within a few eps (1e-8) of zero, a last-bit change of
# the gradient moves the update by a share of lr: on the replicated graph
# side, at most MESH_SHARE of all the state's elements may differ by more,
# each by at most lr (counted by tensor, with the card's gradient of each
# such element, and that gradient's largest size in its tensor).  Eval on
# the two sides' own parameters: HR@20 and MRR@20 within MESH_METRIC rows'
# worth of the test split; on the same parameters, the label's full rank
# (cutoff the padded catalog) equal on every row, except where another
# item's score lies within REL_TIE of the label's (float32 products of
# another shape may swap the two) or equals it exactly on the card alone
# (a float32 coincidence that other-shaped products need not repeat):
# those are counted, not held
MESH_RTOL, MESH_ATOL = 1e-4, 1e-5
MESH_SHARE = 2e-4
MESH_METRIC = 2


def shard_inputs(torch, xent, xm, dtype, norm, seed, multi, dim=D):
    """The K1/K2 (or, ``multi``, K3/K4) check inputs at the mesh's shapes:
    MESH_ROWS rows against the padded path catalog, cut to rank (0, 1)'s
    shard of a (2, 2) mesh (rows 1,792.., 1,637 real), with the operands
    the mesh's losses give the wrappers (``_shard_operands``: labels
    shifted or kept global, -1 off the shard; n_valid; col_offset) and the
    whole catalog's log-partitions for the backward.  Returns (shard,
    local labels, local session ids or None, operands, the rest)."""
    from sessionrec_tpu_torch.ops.scoring import pad_catalog
    from sessionrec_tpu_torch.parallel.mesh import Mesh
    P = pad_catalog(PATH_ITEMS)
    mesh = Mesh(MESH_DP, MESH_MP, 1, "cuda", "nccl", None, None)
    rows = P // MESH_MP
    if multi:
        sr3, tab, labels, iids, cot, lse = make_multi_inputs(
            torch, xm, PATH_ITEMS, P, dtype, seed, norm, rows=MESH_ROWS,
            dim=dim)
        ops = xm._shard_operands(labels, rows, PATH_ITEMS, mesh)
        local = iids - ops[2]
        local = torch.where((local >= 0) & (local < rows), local, -1)
        return (tab[ops[2]:ops[2] + rows].contiguous(), ops[0], local, ops,
                (sr3, iids, cot, lse))
    sr, tab, labels, g = make_inputs(torch, PATH_ITEMS, P, dtype, seed,
                                     rows=MESH_ROWS, dim=dim)
    m, s, _ = xent._fwd_plain(sr, tab, labels, PATH_ITEMS, 0, scale=SCALE,
                              normalize_table=norm)
    ops = xent._shard_operands(labels, rows, PATH_ITEMS, mesh)
    local = torch.where(ops[0] >= 0, ops[0] - ops[2], -1)
    return (tab[ops[2]:ops[2] + rows].contiguous(), local, None, ops,
            (sr, g, xent._finish_lse(m, s)))


def phase_shard_checks(torch, xent, xm, seed, dim=D, cases=None):
    """K1-K4 against their plain versions on a catalog shard at the mesh's
    shapes (``shard_inputs``) at width ``dim``, for each (type, table
    normalised) of ``cases`` (default: float32 and bfloat16, normalised
    and not): ``kernel_check`` / ``multi_kernel_check`` lines with
    ``"mesh_shard": true``, the tolerances of the whole-catalog checks;
    the backward kernels twice, their bits repeated."""
    if cases is None:
        cases = [(d, n) for d in (torch.float32, torch.bfloat16)
                 for n in (True, False)]
    for i, (dtype, norm) in enumerate(cases):
        dname = str(dtype).split(".")[-1]
        kw = dict(scale=SCALE, normalize_table=norm)
        tab, local, _, (lbl, n_valid, off), (sr, g, lse) = shard_inputs(
            torch, xent, xm, dtype, norm, seed + i, multi=False, dim=dim)
        got = xent._fwd_cuda(sr, tab, lbl, n_valid, off, **kw)
        m, s, zl = xent._fwd_plain(sr, tab, lbl, n_valid, off, **kw)
        want = (xent._finish_lse(m, s) - zl, xent._finish_lse(m, s))
        bwd = [xent._bwd_cuda(g, sr, tab, lbl, lse, n_valid, off, **kw)
               for _ in range(2)]
        dsr_p, dtab_p = xent._bwd_plain(g, sr, tab, lbl, lse, n_valid, off,
                                        **kw)
        torch.cuda.synchronize()
        e_fwd, fwd_tol = fwd_errors(got, want, TOL[("fwd", dname)])
        tol = TOL[("bwd", dname)]
        e_dsr, dsr_tol = dsr_errors(bwd[0][0], dsr_p, tol)
        dtab = dtable_errors(torch, bwd[0][1], dtab_p, local,
                             n_valid - off, tol)
        same = all(torch.equal(a, b) for a, b in zip(*bwd))
        row = {"phase": "kernel_check", "mesh_shard": True,
               "items": PATH_ITEMS, "P": tab.shape[0], "col_offset": off,
               "n_valid": n_valid, "B": MESH_ROWS, "D": dim, "dtype": dname,
               "normalize_table": norm, "fwd_max_abs_err": e_fwd,
               "fwd_tol": fwd_tol, "dsr_max_abs_err": e_dsr,
               "dsr_tol": dsr_tol, "dtable_err_tol": dtab,
               "k2_repeat_bit_identical": same,
               "ok": (same and e_fwd <= fwd_tol and e_dsr <= dsr_tol
                      and all(e <= t for e, t in dtab.values()))}
        emit(row)
        check(row["ok"], f"K1/K2 disagree on a catalog shard: {row}")

        tab, local, local_ids, (lbl, n_valid, off), (sr3, iids, cot, lse) \
            = shard_inputs(torch, xent, xm, dtype, norm, seed + i,
                           multi=True, dim=dim)
        got = xm._fwd_cuda(sr3, tab, lbl, iids, n_valid, off, **kw)
        want = xm._fwd_plain(sr3, tab, lbl, iids, n_valid, off, **kw)
        bwd = [xm._bwd_cuda(*cot, sr3, tab, lbl, iids, *lse, n_valid, off,
                            **kw) for _ in range(2)]
        dsr_p, dtab_p = xm._bwd_plain(*cot, sr3, tab, lbl, iids, *lse,
                                      n_valid, off, **kw)
        torch.cuda.synchronize()
        stats = stats_errors(torch, got, want, TOL[("fwd", dname)])
        e_dsr, dsr_tol = dsr_errors(bwd[0][0], dsr_p, tol)
        dtab = dtable_errors(torch, bwd[0][1], dtab_p, local, n_valid, tol,
                             local_ids)
        same = all(torch.equal(a, b) for a, b in zip(*bwd))
        row = {"phase": "multi_kernel_check", "mesh_shard": True,
               "items": PATH_ITEMS, "P": tab.shape[0], "col_offset": off,
               "n_valid": n_valid, "K": K, "B": MESH_ROWS, "D": dim,
               "dtype": dname,
               "normalize_table": norm, "stats_err_tol": stats,
               "dsr_max_abs_err": e_dsr, "dsr_tol": dsr_tol,
               "dtable_err_tol": dtab, "k4_repeat_bit_identical": same,
               "ok": (same and all(e <= t for e, t in stats.values())
                      and e_dsr <= dsr_tol
                      and all(e <= t for e, t in dtab.values()))}
        emit(row)
        check(row["ok"], f"K3/K4 disagree on a catalog shard: {row}")


def phase_shard_times(torch, xent, xm, seed, smi):
    """K1-K4 timed at the mesh's shard shapes: MESH_ROWS rows against one
    of the MESH_MP shards of the padded path catalog (1,792 rows, 1,637
    real), float32, normalised (``kernel_time`` lines with ``"path":
    "mesh_shard"``); the column offset changes no work, so the shard is
    timed as a catalog of its own."""
    from sessionrec_tpu_torch.ops.scoring import pad_catalog
    rows = pad_catalog(PATH_ITEMS) // MESH_MP
    items = PATH_ITEMS - rows
    out = xent_times(torch, xent, items, rows, torch.float32, seed, smi,
                     rows=MESH_ROWS, path="mesh_shard")
    out.update(multi_times(torch, xm, items, rows, torch.float32, seed, smi,
                           rows=MESH_ROWS, path="mesh_shard"))
    return out


def mesh_runner(torch, name, seed, dataset_dir, mesh=None):
    """(runner, its first MESH_STEPS training batches, the test batches) of
    mesh path ``name`` at its full width (``path_config``), on ``mesh`` (its
    loaders then yield the rank's rows of every tier) or on the card."""
    from sessionrec_tpu_torch.models import build_model
    from sessionrec_tpu_torch.train.runner import TrainRunner
    from sessionrec_tpu_torch.train.session import make_loaders
    cfg = path_config(name, seed, dataset_dir)
    tl, el, n, _ = make_loaders(cfg.data, "msgifsr", cfg.model.order, mesh)
    t = cfg.train
    runner = TrainRunner(build_model(cfg.model, n), tl, el, lr=t.lr,
                         weight_decay=t.weight_decay, seed=t.seed,
                         cutoff=t.cutoff, lr_step_size=t.lr_step_size,
                         lr_gamma=t.lr_gamma, device="cuda", mesh=mesh)
    return runner, first_batches(tl, MESH_STEPS), list(el)


def step_snapshot(torch, runner):
    """{"state": the runner's global state (the table and its moments
    gathered on a mesh: a collective), "grads": the gradients of the
    parameters that hold one (on a mesh the replicated ones, summed over
    data)}, on the host; None on a mesh's other ranks."""
    from sessionrec_tpu_torch.utils.checkpoint import global_state
    state = global_state(runner)
    if runner.mesh is not None and not runner.mesh.is_primary:
        return None
    return {"state": {k: v.detach().cpu().clone() for k, v in state.items()},
            "grads": {n: p.grad.detach().cpu().clone() for n, p
                      in runner.model.named_parameters()
                      if p.grad is not None}}


def mesh_steps(torch, runner, batches, out, prefix, start=None):
    """(losses, the wrappers' launches, seconds a step): eager steps on
    ``batches``, every launch count set to 0 just before and read just
    after; ``step_snapshot`` is saved as ``out/<prefix><k>.pt`` after
    step k (k = 0: before the first), and with ``start`` each step k > 1 first
    loads the state of ``out/<start><k - 1>.pt``."""
    from sessionrec_tpu_torch.utils import profiling
    from sessionrec_tpu_torch.utils.checkpoint import load_state
    losses, seconds = [], []
    snap = step_snapshot(torch, runner)
    if snap is not None:
        torch.save(snap, out / f"{prefix}0.pt")
    profiling.reset()
    for k, b in enumerate(batches, 1):
        if start is not None and k > 1:
            load_state(runner, torch.load(out / f"{start}{k - 1}.pt",
                                          weights_only=True,
                                          map_location=runner.device)
                       ["state"])
        b = b.to(runner.device)
        t0 = time.perf_counter()
        losses.append(float(runner.train_step(b)))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        snap = step_snapshot(torch, runner)
        if snap is not None:
            torch.save(snap, out / f"{prefix}{k}.pt")
    return losses, wrapper_launches(), seconds


def full_ranks(model):
    """A cutoff that ranks every label (the padded catalog)."""
    return model.padded_items


def mesh_worker(torch, rank, port, out, seed, dataset_dir):
    """Rank ``rank`` of the MESH_DP x MESH_MP mesh on cuda:0 over gloo: each
    mesh path's steps (``mesh_steps``: rank 0 saves the state after each
    as ``OUT/<path>/mesh<k>.pt``), its eval sweep, and the full ranks of
    the test split at the card's final state (``OUT/<path>/card<steps>.pt``);
    rank 0 saves every rank's results to ``OUT/mesh.pt``."""
    import torch.distributed as dist
    from sessionrec_tpu_torch.ops import xent
    from sessionrec_tpu_torch.ops import xent_multi as xm
    from sessionrec_tpu_torch.parallel.mesh import make_mesh
    from sessionrec_tpu_torch.parallel.sharded import sharded_eval_ranks
    from sessionrec_tpu_torch.utils.checkpoint import load_state
    world = MESH_DP * MESH_MP
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh(MESH_DP, MESH_MP,
                         devices=[torch.device("cuda", 0)] * world,
                         backend="gloo")
        results = {}
        for name in MESH_PATHS:
            runner, batches, tests = mesh_runner(torch, name, seed,
                                                 dataset_dir, mesh)
            where = Path(out) / name
            losses, launches, seconds = mesh_steps(
                torch, runner, batches, where, "mesh", "card")
            t0 = time.perf_counter()
            sums = runner.eval_sweep().cpu()
            eval_s = time.perf_counter() - t0
            load_state(runner, torch.load(
                where / f"card{MESH_STEPS}.pt", weights_only=True,
                map_location=runner.device)["state"])
            model = runner.model
            ranks = [sharded_eval_ranks(model, b.to("cuda"),
                                        full_ranks(model))[0].cpu()
                     for b in tests]
            mine = dict(losses=losses, launches=launches, seconds=seconds,
                        ranks=ranks, d=mesh.d, m=mesh.m)
            every = [None] * world
            dist.all_gather_object(every, mine)
            results[name] = dict(ranks=every, sums=sums,
                                 eval_seconds=eval_s,
                                 staged=sorted(mesh.staged))
            del runner, model
        if rank == 0:
            torch.save(results, Path(out) / "mesh.pt")
    finally:
        dist.destroy_process_group()
    return 0


def join_data_blocks(torch, blocks, batch):
    """One device's row order from the data positions' ``blocks`` (each the
    rank's tiers' blocks joined): tier by tier, the blocks in order."""
    from sessionrec_tpu_torch.graph.batch import flatten_blocks
    sizes = [int(b.labels.shape[0]) // MESH_DP
             for b in flatten_blocks(batch)]
    out, start = [], 0
    for n in sizes:
        out += [blk[start:start + n] for blk in blocks]
        start += n
    return torch.cat(out)


def run_mesh_workers(out, seed, dataset_dir):
    """Start the mesh's ranks (``--mesh-worker``) and wait for them; a rank
    that fails stops the others and fails the phase with its output."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-worker",
         str(r), port, str(out), "--seed", str(seed), "--dataset-dir",
         str(dataset_dir)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for r in range(MESH_DP * MESH_MP)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        check(p.returncode == 0,
              f"mesh rank {r} exited {p.returncode}:\n{text[-3000:]}")


def is_table(key):
    """True for the table and its Adam moments in a runner's state."""
    return key == "embedding" or key.startswith("adam/embedding/")


def mesh_state_gaps(torch, out, k, wd):
    """The mesh's state after step ``k`` (``out/mesh<k>.pt``) against the
    card's (``out/card<k>.pt``), each element at rtol MESH_RTOL, atol
    MESH_ATOL: {"step", "elements", "table_over", "table_max_abs_gap",
    "over": {key: [elements over, largest gap, the card's largest
    gradient among them, the card's largest gradient in the tensor, their
    gradients' largest relative mesh-card gap]}, "share" (over, off the
    table, of all elements), "max_abs_gap" (off the table)}.  A
    gradient here is Adam's: the loss's plus weight decay's ``wd * p``
    where the parameter decays."""
    from sessionrec_tpu_torch.train.optim import decays
    card = torch.load(out / f"card{k}.pt", weights_only=True)
    mesh = torch.load(out / f"mesh{k}.pt", weights_only=True)
    before = torch.load(out / f"card{max(k - 1, 0)}.pt",
                        weights_only=True)["state"]
    row = {"step": k, "elements": 0, "table_over": 0,
           "table_max_abs_gap": 0.0, "over": {}, "share": 0.0,
           "max_abs_gap": 0.0}
    for key, want in card["state"].items():
        want = want.float()
        gap = (mesh["state"][key].float() - want).abs()
        row["elements"] += gap.numel()
        bad = gap > MESH_ATOL + MESH_RTOL * want.abs()
        big = float(gap.max()) if gap.numel() else 0.0
        if is_table(key):
            row["table_over"] += int(bad.sum())
            row["table_max_abs_gap"] = max(row["table_max_abs_gap"], big)
            continue
        row["max_abs_gap"] = max(row["max_abs_gap"], big)
        if not bool(bad.any()):
            continue
        param = key.split("/")[1] if key.startswith("adam/") else key
        g = card["grads"].get(param)
        if g is None or k == 0 or g.shape != gap.shape:
            row["over"][key] = [int(bad.sum()), big, None, None, None]
            continue
        g_adam = g + wd * before[param] if decays(param) else g
        g_mesh = mesh["grads"][param]
        rel = ((g_mesh - g).abs() / g.abs().clamp(min=1e-30))[bad]
        row["over"][key] = [int(bad.sum()), big,
                            float(g_adam.abs()[bad].max()),
                            float(g_adam.abs().max()), float(rel.max())]
    row["share"] = sum(v[0] for v in row["over"].values()) / row["elements"]
    return row


def phase_mesh(torch, seed, dataset_dir, smi, tmp):
    """The mesh paths (module docstring, phase 10): each on the card alone
    first (its steps with their states, its eval sweep and the full ranks
    of the test split at its final parameters), then on the mesh's 4
    ranks (``mesh_worker``), held against it step by step; returns
    {kernel: launches summed over the ranks}."""
    from sessionrec_tpu_torch.train.runner import eval_ranks, sweep_metrics
    out = Path(tmp) / "mesh"
    refs = {}
    for name in MESH_PATHS:
        (out / name).mkdir(parents=True, exist_ok=True)
        runner, batches, tests = mesh_runner(torch, name, seed, dataset_dir)
        losses, launches, seconds = mesh_steps(torch, runner, batches,
                                               out / name, "card")
        sums = runner.eval_sweep().cpu()
        model = runner.model
        model.eval()
        tests = [b.to("cuda") for b in tests]
        want = [eval_ranks(model, b, full_ranks(model), streamed=False)
                for b in tests]
        refs[name] = (model, losses, seconds, sums, tests, want,
                      runner.sched.base_lr,
                      runner.opt.param_groups[0]["weight_decay"])
        del runner
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_mesh_workers(out, seed, dataset_dir)
    workers_s = time.perf_counter() - t0
    res = torch.load(out / "mesh.pt", weights_only=False)
    total = {}
    for name in MESH_PATHS:
        model, losses, seconds, sums, tests, want, lr, wd = refs[name]
        got = res[name]
        ranks = got["ranks"]
        # the mesh gathers through its own lookup (parallel/lookup.py)
        kernels = [k for k in PATHS[name]["kernels"] if k != "embed_bwd"]
        bad_launch = {r["d"] * MESH_MP + r["m"]: r["launches"] for r in ranks
                      if any(r["launches"][k] != (MESH_STEPS if k in kernels
                                                  else 0)
                             for k in r["launches"])}
        for r in ranks:
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
        loss_gap = max(abs(a - b) / abs(b) for r in ranks
                       for a, b in zip(r["losses"], losses))
        steps = [mesh_state_gaps(torch, out / name, k, wd)
                 for k in range(MESH_STEPS + 1)]
        table_over = sum(st["table_over"] for st in steps)
        share = max(st["share"] for st in steps)
        gap_max = max(st["max_abs_gap"] for st in steps)
        mrr, hit = sweep_metrics(got["sums"])
        mrr_ref, hit_ref = sweep_metrics(sums)
        n = float(sums[2])
        by_d = {}
        for r in ranks:
            by_d.setdefault(r["m"], {})[r["d"]] = r["ranks"]
        models_agree = all(
            all(torch.equal(a, b) for a, b in zip(by_d[0][d], by_d[m][d]))
            for m in by_d for d in by_d[m])
        joined = [join_data_blocks(torch, [by_d[0][d][i]
                                           for d in range(MESH_DP)], b)
                  .to("cuda") for i, b in enumerate(tests)]
        cmp = compare_ranks(torch, model, joined, want, tests,
                            ties_held=False)
        row = {"phase": f"mesh_{SHORT[name]}", "data": MESH_DP,
               "model": MESH_MP, "backend": "gloo", "devices": "cuda:0 x 4",
               "steps": MESH_STEPS, "rows_per_rank": MESH_ROWS,
               "staged_through_host": got["staged"],
               "losses": losses, "loss_max_rel_gap": loss_gap,
               "launches_by_rank": [r["launches"] for r in ranks],
               "state_by_step": steps, "table_over": table_over,
               "table_max_abs_gap": max(st["table_max_abs_gap"]
                                        for st in steps),
               "graph_share_over": share, "graph_max_abs_gap": gap_max,
               "lr": lr,
               "mrr20": [mrr, mrr_ref], "hr20": [hit, hit_ref],
               "eval_rows": n, "full_ranks": cmp,
               "model_positions_agree": models_agree,
               "step_seconds_mesh": [r["seconds"] for r in ranks][0],
               "step_seconds_one_device": seconds,
               "eval_seconds_mesh": got["eval_seconds"],
               "workers_seconds": workers_s, "card": smi}
        emit(row)
        check(not bad_launch, f"mesh launches {bad_launch}: the path's "
              f"kernels once a step on every rank, the others never")
        check(loss_gap <= MESH_RTOL, f"mesh losses {row['losses']} off "
              f"the card's by {loss_gap}")
        check(table_over == 0, f"mesh table or its moments off the card's: "
              f"{[st['table_over'] for st in steps]} elements by step")
        check(share <= MESH_SHARE and gap_max <= lr,
              f"mesh state off the card's: {steps}")
        check(abs(mrr - mrr_ref) <= MESH_METRIC / n
              and abs(hit - hit_ref) <= MESH_METRIC / n,
              f"mesh metrics {row['mrr20']} {row['hr20']}")
        check(models_agree and cmp["mismatched"] == 0,
              f"mesh ranks differ: {cmp}, model positions agree "
              f"{models_agree}")
    return total


# ---------------------------------------------------------------------------
# phase 11: K1-K4 past 256 features and 256 session items (the slab kernels)
# ---------------------------------------------------------------------------

# widths of the slab kernels' checks: 258 is no multiple of 4 (the tiles go
# by plain loads), 512 is the wide paths' width, 1000 four slabs of 252
WIDE_DIMS = (258, 512, 1000)
WIDE_D = 512
LONG_NS = (300, 1024)            # K3/K4's session item lists past 256


def wide_check_cases(torch):
    """(items, table rows, type, normalised, batch rows, width) of the
    slab kernels' checks: B rows against the padded path catalog at each
    of WIDE_DIMS, float32 and bfloat16, normalised and not."""
    from sessionrec_tpu_torch.ops.scoring import pad_catalog
    return [(PATH_ITEMS, pad_catalog(PATH_ITEMS), dtype, norm, B, dim)
            for dim in WIDE_DIMS
            for dtype in (torch.float32, torch.bfloat16)
            for norm in (True, False)]


# catalog tiles a chunk of K2's dz in the forced-chunk checks: 3 chunks
# of the padded path catalog's 56 tiles (K4's 3 B rows: 10 chunks of 6)
FORCED_CHUNK_TILES = 20


def phase_forced_chunks(torch, xent, xm, seed):
    """K2 and K4 at ``wide_check_cases``'s widths of 512 and 1,000 with the
    dz scratch cap (``xent.DZ_SCRATCH_BYTES``) lowered to
    FORCED_CHUNK_TILES of K2's catalog tiles, so both run their catalog in
    3 or more chunks: against their plain versions, bits repeated
    (``kernel_check`` / ``multi_kernel_check`` lines with
    ``"forced_chunks"``, K2's or K4's chunk count).  The cap is restored
    after."""
    cap = xent.DZ_SCRATCH_BYTES
    try:
        for i, case in enumerate(c for c in wide_check_cases(torch)
                                 if c[-1] >= WIDE_D):
            _, P, dtype, _, rows, dim = case
            esz = torch.empty((), dtype=dtype).element_size()
            xent.DZ_SCRATCH_BYTES = FORCED_CHUNK_TILES * rows * 64 * esz
            chunks = [xent.slab_bwd_plan(r, P, esz, 1, xent.slabs(dim))
                      ["chunks"] for r in (rows, K * rows)]
            check(min(chunks) >= 3, f"forced chunks {chunks} < 3")
            xent_check(torch, xent, case, seed + i, forced_chunks=chunks[0])
            multi_check(torch, xm, case, seed + i, forced_chunks=chunks[1])
    finally:
        xent.DZ_SCRATCH_BYTES = cap


def phase_wide_checks(torch, xent, xm, seed):
    """K1-K4 against their plain versions past 256 features
    (``wide_check_cases``, ``kernel_check`` / ``multi_kernel_check`` lines
    with ``"wide": true``); K2 and K4 with their catalog in 3 or more
    chunks (``phase_forced_chunks``); K3/K4 with LONG_NS session items a
    row at D and WIDE_D (``"long_items": true``); and K1-K4 on a catalog
    shard with its column offset at WIDE_D, float32, normalised.  The
    tolerances of the other checks; the kernels twice, their bits
    repeated (the shard checks repeat the backward's)."""
    from sessionrec_tpu_torch.ops.scoring import pad_catalog
    t0 = time.perf_counter()
    for i, case in enumerate(wide_check_cases(torch)):
        xent_check(torch, xent, case, seed + i, wide=True)
        multi_check(torch, xm, case, seed + i, wide=True)
    phase_forced_chunks(torch, xent, xm, seed)
    for dim in (D, WIDE_D):
        for ns in LONG_NS:
            case = (PATH_ITEMS, pad_catalog(PATH_ITEMS), torch.float32, True,
                    B, dim)
            multi_check(torch, xm, case, seed + ns, ns=ns, long_items=True)
    phase_shard_checks(torch, xent, xm, seed, dim=WIDE_D,
                       cases=[(torch.float32, True)])
    emit({"phase": "wide_checks", "seconds": time.perf_counter() - t0})


def phase_wide_times(torch, xent, xm, seed, smi, dtypes=None):
    """K1-K4 timed at WIDE_D: B rows (K orders of them for K3/K4) against
    the padded path and north-star catalogs, in each of ``dtypes`` (float32
    alone by default), normalised (``kernel_time`` lines with ``"D":
    512``)."""
    from sessionrec_tpu_torch.ops.scoring import pad_catalog
    t0 = time.perf_counter()
    for dtype in dtypes or (torch.float32,):
        for n_items in CATALOGS:
            P = pad_catalog(n_items)
            xent_times(torch, xent, n_items, P, dtype, seed, smi, dim=WIDE_D)
            multi_times(torch, xm, n_items, P, dtype, seed, smi, dim=WIDE_D)
    emit({"phase": "wide_times", "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# phase 12: raw clicks to a trained model (offline preprocessing without
# pandas, gowalla_o1), and the wide paths (o1_wide, paper_wide)
# ---------------------------------------------------------------------------

# the synthetic gowalla-shaped log: check-ins of PRE_USERS users over
# PRE_ITEMS locations in bursts of about 4 (gaps of about half an hour),
# location popularity a Zipf law of exponent PRE_ZIPF (so the top-30,000
# cut falls among tied counts), ISO 8601 times with Z over PRE_DAYS days,
# second resolution (so session end times tie), rows in gowalla's order
# (user, then time descending), a few empty location fields and a few
# quote-led latitude fields holding a tab and an escaped quote.  500,000
# check-ins, not 1,000,000, so the CPU test that recomputes PRE_SHA256
# through the JAX package stays under 20 s.
PRE_EVENTS, PRE_USERS, PRE_ITEMS = 500_000, 100_000, 60_000
PRE_ZIPF, PRE_DAYS = 1.1, 365
# sha256 over train.txt, test.txt and num_items.txt (in that order) that
# the JAX package's pandas pipeline writes from the log of seed 0
# (tests/test_torch_preprocess.py recomputes it)
PRE_SHA256 = "f82a611d5eac39e0841025136b0a284150c17da33f4e7b30a5ca81612374e01c"
# sha256 of that log itself, to tell a changed generator from a changed
# pipeline
PRE_LOG_SHA256 = \
    "9a907ebdc6028f8050c57904321a3273d90865d180ce977780c28265d4bc970f"


def gowalla_log(np, path, seed, n=PRE_EVENTS):
    """Write the synthetic gowalla-shaped log of ``n`` check-ins from
    ``seed`` to ``path``.  Only uniform draws (``integers``, ``random``)
    feed it, whose streams numpy keeps from version to version."""
    rng = np.random.default_rng(seed)
    n_bursts = n // 4
    b_user = rng.integers(0, PRE_USERS, n_bursts)
    b_start = rng.integers(0, PRE_DAYS * 86400, n_bursts)
    ev = np.sort(rng.integers(0, n_bursts, n))
    gaps = (-1800.0 * np.log1p(-rng.random(n))).astype(np.int64)
    cum = np.cumsum(gaps)
    within = cum - cum[np.searchsorted(ev, ev)]
    t = np.minimum(b_start[ev] + within, PRE_DAYS * 86400 - 1)
    user = b_user[ev]
    cdf = np.cumsum(np.arange(1, PRE_ITEMS + 1, dtype=np.float64)
                    ** -PRE_ZIPF)
    rank = np.minimum(np.searchsorted(cdf, rng.random(n) * cdf[-1],
                                      side="right"), PRE_ITEMS - 1)
    loc = np.argsort(rng.random(PRE_ITEMS), kind="stable")[rank]
    stamp = np.datetime_as_string(
        np.datetime64("2010-01-01T00:00:00")
        + t.astype("timedelta64[s]"), unit="s")
    lat = [f"{x:.6f}" for x in rng.random(n) * 180 - 90]
    lon = [f"{x:.6f}" for x in rng.random(n) * 360 - 180]
    loc = [str(x) for x in loc.tolist()]
    for r in rng.integers(0, n, 8).tolist():
        loc[r] = ""
    for r in rng.integers(0, n, 8).tolist():
        lat[r] = '"12.5\t3 ""x"""'
    order = np.lexsort((-t, user)).tolist()
    user, stamp = user.tolist(), stamp.tolist()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write("".join(f"{user[r]}\t{stamp[r]}Z\t{lat[r]}\t{lon[r]}\t"
                        f"{loc[r]}\n" for r in order))


def preprocess_digest(out_dir):
    """sha256 over a preprocessed dataset's three files."""
    h = hashlib.sha256()
    for name in ("train.txt", "test.txt", "num_items.txt"):
        h.update((Path(out_dir) / name).read_bytes())
    return h.hexdigest()


def phase_preprocess(np, seed, tmp):
    """``cli preprocess --dataset gowalla`` on the synthetic log of
    ``seed``, in a subprocess with pandas blocked (``sys.modules``), its
    seconds, events/s, sessions and items, and its files' sha256 against
    the JAX package's (PRE_SHA256, seed 0).  Returns the dataset's
    directory."""
    import importlib.util
    root = Path(tmp) / "gowalla"
    log, out = root / "checkins.txt", root / "data"
    t0 = time.perf_counter()
    gowalla_log(np, log, seed)
    log_s = time.perf_counter() - t0
    code = ("import sys; sys.modules['pandas'] = None; "
            "from sessionrec_tpu_torch.cli import main; main(sys.argv[1:])")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", code, "preprocess", "--dataset", "gowalla",
         "--input", str(log), "--output-dir", str(out)], cwd=str(HERE),
        capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"cli preprocess failed ({proc.returncode}):"
          f" {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    digest = preprocess_digest(out)
    want = PRE_SHA256 if seed == 0 else None
    log_sha = hashlib.sha256(log.read_bytes()).hexdigest()
    lines = {s: len((out / f"{s}.txt").read_text().splitlines())
             for s in ("train", "test")}
    row = {"phase": "preprocess", "dataset": "gowalla", "events": PRE_EVENTS,
           "users": PRE_USERS, "locations": PRE_ITEMS,
           "log_seconds": log_s, "seconds": seconds,
           "events_per_s": PRE_EVENTS / seconds,
           "sessions": lines, "items": int((out / "num_items.txt")
                                           .read_text()),
           "printed": proc.stdout.strip().splitlines(),
           "pandas_installed": importlib.util.find_spec("pandas")
           is not None, "log_sha256": log_sha,
           "log_sha256_seed0": PRE_LOG_SHA256, "sha256": digest,
           "jax_sha256": want,
           "ok": want is None or digest == want}
    emit(row)
    check(row["ok"], f"preprocess output differs from the JAX package's: "
          f"{digest} != {want}")
    return out


# the paths of phase 12: MSGIFSR order 1 at its preset on the preprocessed
# gowalla log (16 steps: 8 eager, one 8-step replay), the o1 and paper
# heads at WIDE_D on datasets/sample (16 and 8 steps) through the slab
# kernels, and the o1 head at WIDE_D in full bfloat16 (16 steps: K1's and
# K2's slab kernels on the tensor cores)
LATE_PATHS = {
    "gowalla_o1": dict(PATHS["path"], steps=16),
    "o1_wide": dict(PATHS["path"], dim=WIDE_D, steps=16),
    "paper_wide": dict(PATHS["paper"], dim=WIDE_D, steps=8),
    "o1_wide_bf16": dict(PATHS["o1_bf16"], dim=WIDE_D, steps=16),
}


def run_late_paths(torch, np, xent, xm, seed, dataset_dir, smi, tmp):
    """Phases 11 and 12: the slab kernels' checks and times, preprocessing,
    K1/K2 against their plain versions at gowalla_o1's catalog
    (``kernel_check`` with ``"path": "gowalla_o1"``), then each of
    LATE_PATHS through ``phase_path`` (its kernels once a
    step, counted with the counts set to 0 just before), ``*_vs_cpu``,
    ``phase_eval`` and ``phase_graph_vs_plain``; gowalla_o1 also serves
    from its checkpoint against the CPU.  Emits each phase's seconds and
    returns (wrapper launches, device launches) summed over the paths."""
    seconds = {}
    t0 = time.perf_counter()
    phase_wide_checks(torch, xent, xm, seed)
    seconds["wide_checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_wide_times(torch, xent, xm, seed, smi)
    seconds["wide_times"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = phase_preprocess(np, seed, tmp)
    seconds["preprocess"] = time.perf_counter() - t0
    # K1/K2 at gowalla_o1's own catalog, before the path runs them
    from sessionrec_tpu_torch.ops.scoring import pad_catalog
    items = int((data / "num_items.txt").read_text())
    xent_check(torch, xent, (items, pad_catalog(items), torch.float32, True,
                             B, D), seed, path="gowalla_o1")
    launches, on_device = {}, {}
    for name, ds in (("gowalla_o1", data), ("o1_wide", dataset_dir),
                     ("paper_wide", dataset_dir),
                     ("o1_wide_bf16", dataset_dir)):
        t0 = time.perf_counter()
        wrapped, dev, runner, cfg, saved = phase_path(
            torch, name, None, seed, str(ds), smi, tmp)
        for k in wrapped:
            launches[k] = launches.get(k, 0) + wrapped[k]
            on_device[k] = on_device.get(k, 0) + dev[k]
        if name == "gowalla_o1":
            phase_serve(torch, name, saved, cfg, smi)
        phase_eval(torch, name, runner, smi)
        del runner
        phase_graph_vs_plain(torch, name, seed, str(ds), smi)
        seconds[name] = time.perf_counter() - t0
    emit({"phase": "late_seconds", **seconds,
          "total": sum(seconds.values())})
    return launches, on_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--dataset-dir", default=str(HERE / "datasets" / "sample"))
    ap.add_argument("--mesh-worker", nargs=3, metavar=("RANK", "PORT", "OUT"),
                    help="run one rank of the mesh phase (started by it)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    csrc = HERE / "sessionrec_tpu_torch" / "csrc"
    if not all((csrc / f).is_file()
               for f in ("xent.cu", "xent_bwd.cu", "xent_multi.cu")):
        print("chip_smoke: sessionrec_tpu_torch not found beside this file",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from sessionrec_tpu_torch.ops import cuda_build, embed, xent
    from sessionrec_tpu_torch.ops import xent_multi as xm
    from sessionrec_tpu_torch.train.runner import set_precision
    from sessionrec_tpu_torch.utils import profiling
    set_precision()
    # the launch counts are the tracing registry's counters
    profiling.enable(True)
    if args.mesh_worker:
        rank, port, out = args.mesh_worker
        return mesh_worker(torch, int(rank), port, out, args.seed,
                           args.dataset_dir)

    try:
        smi = phase_device(torch)
        t0 = time.perf_counter()
        lib = cuda_build.build_library()
        xm._library()
        emit({"phase": "build", "library": lib.name,
              "sources": [p.name for p in cuda_build.sources()],
              "seconds": time.perf_counter() - t0})
        errs = phase_kernel_checks(torch, xent, args.seed)
        errs.update(phase_multi_checks(torch, xm, args.seed))
        times = phase_kernel_times(torch, xent, args.seed, smi)
        phase_family_times(torch, xent, args.seed, smi)
        phase_bf16_path_times(torch, xent, args.seed, smi)
        phase_sround(torch, args.seed, smi)
        multi_times = phase_multi_times(torch, xm, args.seed, smi)
        errs["embed_bwd"], embed_path = phase_embed(
            torch, embed, args.seed, args.dataset_dir, smi)
        phase_million_kernels(torch, xent, xm, args.seed, smi)
        phase_shard_checks(torch, xent, xm, args.seed)
        phase_shard_times(torch, xent, xm, args.seed, smi)
        launches = dict.fromkeys(errs, 0)
        on_device = dict.fromkeys(errs, 0)
        with tempfile.TemporaryDirectory() as tmp:
            for name in PATHS:
                wrapped, dev, runner, cfg, saved = phase_path(
                    torch, name, args.steps, args.seed, args.dataset_dir,
                    smi, tmp)
                for k in wrapped:
                    launches[k] += wrapped[k]
                    on_device[k] += dev[k]
                phase_serve(torch, name, saved, cfg, smi)
                phase_eval(torch, name, runner, smi)
                del runner
                phase_graph_vs_plain(torch, name, args.seed,
                                     args.dataset_dir, smi)
            for name in ("path", "lessr", "o1_bf16"):
                phase_resume(torch, args.seed, args.dataset_dir, smi, tmp,
                             name=name)
            wrapped, dev = run_million_paths(torch, np, args.seed,
                                             args.dataset_dir, smi, tmp)
            for k in wrapped:
                launches[k] += wrapped[k]
                on_device[k] += dev[k]
            mesh_launches = phase_mesh(torch, args.seed, args.dataset_dir,
                                       smi, tmp)
            wrapped, dev = run_late_paths(torch, np, xent, xm, args.seed,
                                          args.dataset_dir, smi, tmp)
            for k in wrapped:
                launches[k] += wrapped[k]
                on_device[k] += dev[k]
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    path = dict(times[(PATH_ITEMS, "float32")],
                **multi_times[(PATH_ITEMS, "float32")], embed_bwd=embed_path)
    kernels = {
        "xent_fwd": ("xent.cu", "sessionrec_tpu/ops/xent.py:71"),
        "xent_bwd": ("xent_bwd.cu", "sessionrec_tpu/ops/xent.py:164"),
        "xent_multi_fwd": ("xent_multi.cu",
                           "sessionrec_tpu/ops/xent_multi.py:57"),
        "xent_multi_bwd": ("xent_multi.cu",
                           "sessionrec_tpu/ops/xent_multi.py:157"),
        # the gather's backward replaces no Pallas kernel (XLA's
        # scatter-add in the JAX package)
        "embed_bwd": ("embed_bwd.cu", None),
    }
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"sessionrec_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches[name],
         "device_launches": on_device[name],
         "mesh_launches": mesh_launches[name],
         "max_abs_err": errs[name], "ms": path[name]["ms"],
         "plain_ms": path[name]["plain_ms"],
         "bound_ms": path[name]["bound_ms"],
         "bound_by": path[name]["bound_by"],
         "library_ms": path[name]["library_ms"]}
        for name, (src, replaces) in kernels.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
