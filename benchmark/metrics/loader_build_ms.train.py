"""Host milliseconds the loader's prefetch thread takes to build a batch
(the program's ``loader.build`` span), over the untraced window of the
owners run (``harness/owners.py``)."""

from harness import owners


def read(run):
    return owners.host_ms(run, "loader.build")
