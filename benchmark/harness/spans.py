"""Host spans around the calls into the program's layers.

A span adds its host seconds and its units (steps or requests) to its
name's totals.  Inside a profiled sub-window (``profiling``) a span is a
``torch.profiler`` range instead, which the trace reader places on the
device's timeline, and its host time is not added: the profiler slows
the host, and the span metrics are read from the untraced window.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Span:
    def __init__(self, units):
        self.units = units


class Spans:
    def __init__(self):
        self.seconds = defaultdict(float)
        self.units = defaultdict(int)
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str, units: int = 1):
        """Time the block; set ``.units`` of the yielded span where the
        count is known only inside it."""
        s = Span(units)
        if self.profiling:
            import torch
            with torch.profiler.record_function(name):
                yield s
            return
        t = time.perf_counter()
        yield s
        self.seconds[name] += time.perf_counter() - t
        self.units[name] += s.units

    def per_unit_ms(self, name: str):
        """Mean milliseconds a unit of ``name``; None where it never ran."""
        if not self.units.get(name):
            return None
        return self.seconds[name] / self.units[name] * 1e3
