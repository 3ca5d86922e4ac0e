"""The whole training step's share of the card's float32 peak: the model
FLOPs of the profiled sub-window's steps (the family's count,
``counts/flops/<model name>.py``, from the examples themselves), over the
sub-window's seconds times the peak of the configuration's type
(``counts/peaks.json``), in percent.  None for a family without a
count."""

from counts.xent import PEAKS


def read(run):
    prof, steps = run.outcome.profile, run.outcome.data["profiled_steps"]
    count = run.cell.flops()
    if prof is None or not steps or prof.window_s <= 0 or count is None:
        return None
    cfg = run.cell.config
    flops = sum(count.step_flops(cfg, [seq for seq, _ in s]) for s in steps)
    return flops / (prof.window_s * PEAKS["flops_per_s"][cfg["dtype"]]) \
        * 100.0
