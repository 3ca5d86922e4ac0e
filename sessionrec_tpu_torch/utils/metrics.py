"""Structured metrics sink — JSONL, one event per line.

Counterpart of ``sessionrec_tpu/utils/metrics.py``, with the same event
schema.  The reference's observability is ``print()`` (train.py:105-116)
plus an inactive wandb import (train.py:8,114).  Here every train/eval
event is appended to a JSONL file; the schema (``kind``/``step``/``epoch`` plus
scalar metrics) maps 1:1 onto ``wandb.log`` so a W&B sink is a trivial
adapter (``WandbSink`` below, gated on the package being importable).
"""

from __future__ import annotations

import json
import time


class MetricsLogger:
    """Append-only JSONL metrics sink."""

    def __init__(self, path):
        self.path = str(path)
        self._f = open(self.path, "a", buffering=1)

    def log(self, kind: str, **scalars):
        event = {"ts": round(time.time(), 3), "kind": kind}
        for k, v in scalars.items():
            event[k] = float(v) if hasattr(v, "__float__") else v
        self._f.write(json.dumps(event) + "\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class WandbSink:
    """Optional W&B adapter over the same ``log(kind, **scalars)`` API."""

    def __init__(self, **wandb_init_kwargs):
        import wandb  # gated: not a framework dependency
        self._wandb = wandb
        self._run = wandb.init(**wandb_init_kwargs)

    def log(self, kind: str, step=None, **scalars):
        payload = {f"{kind}/{k}": v for k, v in scalars.items()}
        self._wandb.log(payload, step=step)

    def close(self):
        self._run.finish()


class MultiSink:
    """Fan a metrics event out to several sinks."""

    def __init__(self, *sinks):
        self.sinks = [s for s in sinks if s is not None]

    def log(self, kind: str, **scalars):
        for s in self.sinks:
            s.log(kind, **scalars)

    def close(self):
        for s in self.sinks:
            s.close()
