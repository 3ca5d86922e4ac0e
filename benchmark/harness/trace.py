"""A profiled sub-window and what its ``torch.profiler`` trace says.

``profile(fn)`` runs ``fn`` under the profiler (host and device) inside a
``window`` range, writes the Chrome trace under the temporary directory
the environment names, reads it and deletes it.  The device's work is
its kernel, memcpy and memset events; device-side annotation ranges
cover kernels listed on their own and are left out.  Busy time is the
union of those events' intervals within the window; an idle gap is a
stretch of the window with no device event, named after the innermost
benchmark span the host was in at its middle.  The window opens at its
first device event: the harness synchronises the device before the
profiler starts, so the wait before that event is the harness's and not
the program's.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "window"
TOP = 10


def device_events(trace):
    """(name, start_us, dur_us) of the device's own work in a Chrome trace
    exported by ``torch.profiler``."""
    return [(e["name"], float(e["ts"]), float(e["dur"]))
            for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def host_ranges(trace, names):
    """(name, start_us, dur_us) of the host's ``record_function`` ranges
    named in ``names``."""
    return [(e["name"], float(e["ts"]), float(e["dur"]))
            for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name") in names]


def busy_us(events):
    """Length of the union of the events' intervals."""
    return sum(b - a for a, b in union(events))


def union(events):
    """The union of the events' intervals, as sorted ``(start, end)``."""
    out = []
    for _, ts, dur in sorted(events, key=lambda e: e[1]):
        if out and ts <= out[-1][1]:
            out[-1][1] = max(out[-1][1], ts + dur)
        else:
            out.append([ts, ts + dur])
    return [(a, b) for a, b in out]


def clip(events, lo, hi):
    out = []
    for name, ts, dur in events:
        a, b = max(ts, lo), min(ts + dur, hi)
        if b > a:
            out.append((name, a, b - a))
    return out


def gaps(intervals, lo, hi):
    """The stretches of ``[lo, hi]`` that ``intervals`` leave uncovered."""
    out, at = [], lo
    for a, b in intervals:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def innermost(ranges, t):
    """The name of the shortest range holding time ``t``, else "other"."""
    best = None
    for name, ts, dur in ranges:
        if ts <= t <= ts + dur and (best is None or dur < best[1]):
            best = (name, dur)
    return best[0] if best else "other"


@dataclass
class Profile:
    """A profiled sub-window: its length and the device's busy time in
    seconds, its device events ``(name, start_us, dur_us)`` and the
    ``breakdown`` of the run's last line."""

    window_s: float
    busy_s: float
    events: list = field(repr=False)
    breakdown: dict

    def device_seconds(self, match) -> float:
        """Device seconds of the events whose name ``match`` accepts."""
        return sum(dur for name, _, dur in self.events if match(name)) / 1e6


def read(trace, spans) -> Profile:
    """The ``Profile`` of a trace whose sub-window ran inside a ``window``
    range, with host ranges ``spans``."""
    (_, w0, wdur), = host_ranges(trace, {WINDOW})
    w1 = w0 + wdur
    events = clip(device_events(trace), w0, w1)
    if events:
        w0 = min(ts for _, ts, _ in events)
        wdur = w1 - w0
    merged = union(events)
    ranges = host_ranges(trace, set(spans))
    idle = sorted(((innermost(ranges, (a + b) / 2), (b - a) / 1e6)
                   for a, b in gaps(merged, w0, w1)), key=lambda g: -g[1])
    by_name = {}
    for name, _, dur in events:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return Profile(window_s=wdur / 1e6,
                   busy_s=busy_us(events) / 1e6,
                   events=events,
                   breakdown={"device_ops": [[n[:120], s] for n, s in
                                             ops[:TOP]],
                              "idle_gaps": [[n, s] for n, s in idle[:TOP]]})


def profile(fn, spans):
    """Run ``fn()`` profiled inside a ``window`` range; returns ``(its
    result, the Profile)``.  The trace file lives under the temporary
    directory and is deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            out = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    return out, read(trace, spans)
