"""Device milliseconds a request owned by the program's ``serve.topk``
span (the stable top-k over the scores), by the capture map of the
owners run (``harness/owners.py``)."""

from harness import owners


def read(run):
    return owners.device_ms(run, ("serve.topk",))
