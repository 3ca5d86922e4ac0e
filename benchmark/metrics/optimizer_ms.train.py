"""Device milliseconds a training step owned by the program's
``step.optimizer`` span (``zero_grad``, Adam, the table's update, the
schedule, the max-norm projection), by the capture map of the owners
run (``harness/owners.py``)."""

from harness import owners


def read(run):
    return owners.device_ms(run, ("step.optimizer",))
