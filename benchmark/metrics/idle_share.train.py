"""Share of the profiled sub-window in which the device ran nothing
(1 - busy / window, busy the union of its kernel, memcpy and memset
intervals), in percent."""


def read(run):
    prof = run.outcome.profile
    if prof is None or prof.window_s <= 0:
        return None
    return (1.0 - prof.busy_s / prof.window_s) * 100.0
