"""The numbers that decide ``correct``, and how a run prints them.

Training readings are taken by leaf: for each parameter the gap between
the program's norm and the reference's, not the norm of their
difference, over the reference's norm of that leaf or of the median
leaf, whichever is larger (some gradients are all but zero).  A number
is the worst leaf's gap (``grad_gap``, ``change_gap``) or the median
leaf's (``grad_gap.median``, ``change_gap.median``); where the reference
returns the model's buffers (running statistics, ``state``) after the
same steps, ``state_gap`` is the worst buffer's gap by the same rule.  A
cell's limits name the numbers it compares, and the others are printed
beside them.

Serving compares each served score with the reference's score of the
same item in the quantity the configuration's head serves (the
reference's ``serve_scores``).
"""

from __future__ import annotations

import statistics
import sys

# a leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by round-off alone: left out of the change
ROUNDING_LEAF = 1e-3


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """``{leaf: |prog - ref| / max(ref, median ref)}`` over ``names``."""
    names = list(names)
    med = statistics.median(ref[n] for n in names)
    out = {}
    for n in names:
        den = max(ref[n], med)
        out[n] = abs(prog[n] - ref[n]) / den if den > 0 else \
            abs(prog[n] - ref[n])
    return out


def moving_leaves(grad_raw: dict) -> list:
    """The leaves whose reference gradient is at least ``ROUNDING_LEAF``
    of the median leaf's."""
    med = statistics.median(grad_raw.values())
    return [n for n, g in grad_raw.items() if g >= ROUNDING_LEAF * med]


def train_numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers of a training cell from the program's and the
    reference's readings (``losses``, ``grad``, ``change``, and ``state``
    where the reference gives it; the reference's ``grad_raw`` picks the
    leaves of the change, and its ``projected`` rows are printed beside
    them)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"]))
    out = {"loss_gap": loss, "_leaves": {},
           "projected_rows": ref["projected"]}
    for name, gaps in (
            ("grad_gap", leaf_gaps(prog["grad"], ref["grad"], ref["grad"])),
            ("change_gap", leaf_gaps(prog["change"], ref["change"],
                                     moving_leaves(ref["grad_raw"])))):
        worst = max(gaps, key=gaps.get)
        out[name] = gaps[worst]
        out[name + ".median"] = statistics.median(gaps.values())
        out["_leaves"][name] = worst
    if ref.get("state"):
        gaps = leaf_gaps(prog["state"], ref["state"], ref["state"])
        worst = max(gaps, key=gaps.get)
        out["state_gap"] = gaps[worst]
        out["_leaves"]["state_gap"] = worst
    return out


def serve_numbers(ids, scores, ref_scores) -> dict:
    """``score_gap``: the largest gap between a served score and the
    reference's score of the same item (``ref_scores [S, n]``, in the
    head's served quantity); ``rank_gap``: the largest by which the
    reference's score of the item served at rank j lies below the
    reference's j-th best score."""
    import torch
    ids = ids.to(ref_scores.device, torch.int64)
    scores = scores.to(ref_scores.device, torch.float32)
    at = torch.gather(ref_scores, 1, ids)
    best = torch.topk(ref_scores, ids.shape[1], dim=1).values
    return {"score_gap": float(torch.max(torch.abs(scores - at))),
            "rank_gap": max(float(torch.max(best - at)), 0.0)}


def verdict(numbers: dict, limits: dict) -> list:
    """``[(name, value, limit)]`` of every limited number; a limit without
    a number raises."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise ValueError(f"limits {missing} have no number")
    return [(n, float(numbers[n]), float(limits[n])) for n in limits]


def print_unlimited(numbers: dict, limits: dict, file=None):
    """The numbers a cell reads and does not compare, on standard
    error."""
    for name, value in numbers.items():
        if not name.startswith("_") and name not in limits:
            print(f"reading {name} {value!r} (not compared)",
                  file=file or sys.stderr, flush=True)


def passed(checks) -> bool:
    return bool(checks) and all(v <= lim for _, v, lim in checks)


def print_checks(checks, file=None):
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAILED'}",
              file=file or sys.stderr, flush=True)
