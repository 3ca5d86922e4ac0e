"""What passes between the harness, a traffic driver and a metric
reader."""

from __future__ import annotations

from dataclasses import dataclass, field

from harness.spans import Spans


@dataclass
class Context:
    """What a traffic driver gets: the cell, the run's seed, length and
    mode, the device, the process's start on the host clock and the
    spans to record into."""

    cell: object
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    spans: Spans = field(default_factory=Spans)


@dataclass
class Outcome:
    """What a traffic driver returns: its end-to-end metrics by name, the
    attempted and failed steps or requests, the numbers compared with
    their limits (``[(name, value, limit)]``), the device's peak memory,
    the profiled sub-window (a ``harness.trace.Profile``, with ``--trace
    1``) and whatever its metric readers need."""

    metrics: dict
    attempted: int
    failed: int
    checks: list
    memory_peak_bytes: int
    profile: object = None
    data: dict = field(default_factory=dict)


@dataclass
class Run:
    """What a per-layer metric reader gets."""

    cell: object
    outcome: Outcome
    spans: Spans
