"""Structured logging (replaces the reference's bare print()s,
train.py:105-116)."""

from __future__ import annotations

import logging
import sys

_ROOT = "sessionrec_tpu_torch"


def get_logger(name=_ROOT):
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s",
            datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
    return logging.getLogger(name)
