"""Milliseconds a request spends building its batch: the ``build`` span
around ``serving.session_batches``' next batch, over the untraced
window's requests."""


def read(run):
    return run.spans.per_unit_ms("build")
