"""Device milliseconds a request owned by the program's ``serve.score``
span (the catalog products, REnorm softmax passes and blend after the
session vectors), by the capture map of the owners run
(``harness/owners.py``)."""

from harness import owners


def read(run):
    return owners.device_ms(run, ("serve.score",))
