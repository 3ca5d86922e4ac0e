"""Share of their roofline that the fused losses reach in the profiled
sub-window: the least time of each step's K1 + K2 (plain head) or K3 + K4
(multi-order head) at its valid rows (``counts/xent.py``: the larger of
bytes over the memory rate and operations over the float32 peak), over
the device time of the trace's ``xent_*`` kernels, in percent."""

from counts import xent


def read(run):
    prof, steps = run.outcome.profile, run.outcome.data["profiled_steps"]
    if prof is None or not steps:
        return None
    spent = prof.device_seconds(xent.is_kernel)
    if spent <= 0:
        return None
    least = sum(xent.step_loss_seconds(run.cell.config, len(s))
                for s in steps)
    return least / spent * 100.0
