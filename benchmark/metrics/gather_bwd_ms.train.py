"""Device milliseconds a training step owned by the backward part of the
program's ``model.embed`` span (the table gather's backward), by the
capture map of the owners run (``harness/owners.py``)."""

from harness import owners


def read(run):
    return owners.device_ms(run, ("model.embed",), ("bwd",))
