"""Host milliseconds a training step spends staging its batch into the
graph's slot (the program's ``runner.stage`` span: pinning and the
non-blocking copies), over the untraced window of the owners run
(``harness/owners.py``)."""

from harness import owners


def read(run):
    return owners.host_ms(run, "runner.stage")
