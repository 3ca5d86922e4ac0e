"""Device milliseconds a training step spends in the fused losses (K1-K4,
every kernel named ``xent_*``), from the profiled sub-window's trace."""

from counts import xent


def read(run):
    prof, steps = run.outcome.profile, run.outcome.data["profiled_steps"]
    if prof is None or not steps:
        return None
    s = prof.device_seconds(xent.is_kernel)
    return s / len(steps) * 1e3 if s > 0 else None
