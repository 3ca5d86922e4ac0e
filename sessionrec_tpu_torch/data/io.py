"""Dataset file IO.

File format matches the reference (src/utils/data/dataset.py:16-27):
one session per line, comma-joined int item ids; ``num_items.txt`` holds
the catalog size.
"""

from __future__ import annotations

import os
from pathlib import Path


def read_sessions(filepath):
    """Read one-session-per-line comma-joined item ids -> list[list[int]]."""
    sessions = []
    with open(filepath) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            # reference uses tab-separated csv with a single column
            line = line.split("\t")[0].strip('"')
            sessions.append([int(x) for x in line.split(",")])
    return sessions


def read_dataset(dataset_dir):
    """-> (train_sessions, test_sessions, num_items).

    Mirrors read_dataset (reference: dataset.py:22-27).
    """
    dataset_dir = Path(dataset_dir)
    train_sessions = read_sessions(dataset_dir / "train.txt")
    test_sessions = read_sessions(dataset_dir / "test.txt")
    with open(dataset_dir / "num_items.txt") as f:
        num_items = int(f.readline())
    return train_sessions, test_sessions, num_items


def max_session_len(sessions) -> int:
    return max((len(s) for s in sessions), default=1)
