"""Device milliseconds a training step owned by the graph side: the
program's ``model.graph`` (expander, dropout, MSHGNN layers) and
``model.readout`` spans, forward and backward, by the capture map of the
owners run (``harness/owners.py``)."""

from harness import owners


def read(run):
    return owners.device_ms(run, ("model.graph", "model.readout"))
