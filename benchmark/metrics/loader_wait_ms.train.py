"""Milliseconds a training step waits for its batch: the ``loader_wait``
span around ``next()`` on the chunk stream, over the untraced window's
steps (input pipeline: ``data/loader.py``, ``data/native_collate.py``)."""


def read(run):
    return run.spans.per_unit_ms("loader_wait")
