"""Prefix augmentation.

A session ``[a, b, c, d]`` yields training examples
``([a], b), ([a, b], c), ([a, b, c], d)`` — one per label position
(reference: src/utils/data/dataset.py:6-13, 29-50).  The index is a flat
array of (session_id, label_position) pairs in session order, which is
exactly the *ordered* (unshuffled) training stream the reference relies
on for time-split datasets (reference: README.md:37, SequentialSampler at
main_lessr.py:92 / main_msgifsr.py:156).
"""

from __future__ import annotations

import numpy as np


class AugmentedIndex:
    """Flat (session_id, label_idx) index over prefix-augmented sessions."""

    def __init__(self, sessions, sort_by_length: bool = False):
        self.sessions = sessions
        lens = np.fromiter((len(s) for s in sessions), dtype=np.int64,
                           count=len(sessions))
        session_idx = np.repeat(np.arange(len(sessions)), np.maximum(lens - 1, 0))
        label_idx = np.concatenate(
            [np.arange(1, l) for l in lens]) if len(lens) else np.empty(0, np.int64)
        index = np.column_stack((session_idx, label_idx))
        if sort_by_length:
            # sort by label position descending (reference: dataset.py:35-38)
            index = index[np.argsort(index[:, 1])[::-1]]
        self.index = index.astype(np.int64)

    def __len__(self):
        return len(self.index)

    def example(self, i):
        sid, lidx = self.index[i]
        seq = self.sessions[sid][:lidx]
        label = self.sessions[sid][lidx]
        return seq, label
