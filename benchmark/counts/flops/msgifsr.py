"""MSGIFSR's model FLOPs of a training step (``counts/model.py``), found
by the family's name (``harness/cells.py``: ``Cell.flops``)."""

from counts.model import step_flops  # noqa: F401
