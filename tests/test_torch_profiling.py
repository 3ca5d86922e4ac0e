"""The step profile counts the device's own work once: kernels, copies and
sets, as a union of intervals, and not the annotated ranges that span
them."""

import pytest

from sessionrec_tpu_torch.utils.profiling import busy_us, device_events


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


TRACE = {"traceEvents": [
    _ev("kernel", "a", 0, 10),
    _ev("gpu_user_annotation", "Optimizer.step#Adam.step", 0, 40),
    _ev("kernel", "b", 5, 10),          # overlaps a
    _ev("kernel", "c", 6, 2),           # inside b
    _ev("gpu_memcpy", "Memcpy HtoD", 20, 5),
    _ev("gpu_memset", "Memset", 30, 1),
    _ev("cpu_op", "aten::mm", 0, 100),
    _ev("cuda_runtime", "cudaLaunchKernel", 1, 1),
    {"ph": "i", "cat": "kernel", "name": "marker", "ts": 50},
]}


def test_only_device_work_is_kept():
    names = [e[0] for e in device_events(TRACE)]
    assert names == ["a", "b", "c", "Memcpy HtoD", "Memset"]


@pytest.mark.parametrize("events,want", [
    ([], 0.0),
    ([("a", 0.0, 10.0)], 10.0),
    ([("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 6.0, 2.0)], 15.0),
    ([("b", 20.0, 5.0), ("a", 0.0, 10.0)], 15.0),
])
def test_busy_time_is_the_union_of_intervals(events, want):
    assert busy_us(events) == want


def test_busy_time_of_the_trace():
    assert busy_us(device_events(TRACE)) == 15.0 + 5.0 + 1.0
