"""Host milliseconds a training step spends in ``TrainRunner.run_chunk``
(staging the batches into the graph's slots and the replay's launch;
no synchronisation inside), over the untraced window's steps."""


def read(run):
    return run.spans.per_unit_ms("dispatch")
