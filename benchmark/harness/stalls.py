"""Where a run's host time went, on standard error: set-up by phase, and
the window's widest gaps between the ends of consecutive chunks or
requests, so a run that reads far from its set shows where its time
went."""

from __future__ import annotations

import sys


def report(unit: str, ends, wall: float, top: int = 3):
    gaps = sorted(((b - a, b) for a, b in zip([0.0] + ends[:-1], ends)),
                  reverse=True)[:top]
    mean = wall / max(len(ends), 1)
    print(f"window: {len(ends)} {unit}s in {wall:.3f} s, mean {mean:.4f} s; "
          "widest gaps " + ", ".join(f"{g:.4f} s ending at {t:.2f} s"
                                     for g, t in gaps),
          file=sys.stderr, flush=True)


def report_setup(t0: float, marks):
    """``marks``: ``[(phase, host clock at its end)]`` from ``t0``."""
    parts, at = [], t0
    for name, t in marks:
        parts.append(f"{name} {t - at:.3f} s")
        at = t
    print("setup: " + ", ".join(parts), file=sys.stderr, flush=True)
