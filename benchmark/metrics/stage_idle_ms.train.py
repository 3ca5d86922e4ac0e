"""Device-idle milliseconds a training step in gaps whose middle the
launching thread spent in the program's ``runner.stage`` span, in the
profiled window of the owners run (``harness/owners.py``)."""

from harness import owners


def read(run):
    return owners.idle_ms(run, "runner.stage")
