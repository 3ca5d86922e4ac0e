"""Synthetic sessions from a seed.

Session lengths follow a frozen length profile and item ids a frozen
rank-frequency profile (``benchmark/profiles``), stretched to the
configuration's catalog: rank ``r`` of ``P`` items takes the frequency of
profile rank ``ceil(r * S / P)`` of its ``S``.  Every seed of a stream
gets the same lengths in the same order (one fixed shuffle), and its own
draw of ids and of the ranks' places in the catalog: seeds change which
items a session holds, and not how much work a step makes (with the
lengths in a seed's own order, the length tiers' row caps, and so each
step's padded shapes, moved with the seed).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

PROFILES = Path(__file__).resolve().parents[1] / "profiles"


def load_profile(name: str) -> dict:
    return json.loads((PROFILES / name).read_text())


def length_multiset(profile: dict, n: int) -> np.ndarray:
    """``n`` session lengths in the profile's proportions (largest
    remainders), longest last; the same for every seed."""
    lens = np.array([int(k) for k in profile["length_counts"]])
    counts = np.array(list(profile["length_counts"].values()), float)
    share = counts / counts.sum() * n
    take = np.floor(share).astype(np.int64)
    rest = n - int(take.sum())
    take[np.argsort(-(share - take), kind="stable")[:rest]] += 1
    return np.repeat(lens, take)


def item_probabilities(profile: dict, n_items: int) -> np.ndarray:
    """Click probability of each catalog rank (most clicked first)."""
    freq = np.asarray(profile["frequencies"], float)
    ranks = np.arange(1, n_items + 1)
    src = np.ceil(ranks * len(freq) / n_items).astype(np.int64) - 1
    p = freq[src]
    return p / p.sum()


def make_sessions(seed: int, stream: str, n_sessions: int, n_items: int,
                  lengths: dict, items: dict) -> list:
    """``n_sessions`` sessions (lists of int item ids) of ``seed`` for
    ``stream`` (each stream of a seed draws apart)."""
    lens = length_multiset(lengths, n_sessions)
    np.random.default_rng(_tag(stream)).shuffle(lens)
    rng = np.random.default_rng([int(seed), _tag(stream)])
    place = rng.permutation(n_items)
    ranks = rng.choice(n_items, size=int(lens.sum()),
                       p=item_probabilities(items, n_items))
    flat = place[ranks].tolist()
    ends = np.cumsum(lens).tolist()
    return [flat[a:b] for a, b in zip([0] + ends[:-1], ends)]


def _tag(stream: str) -> int:
    return int.from_bytes(stream.encode()[:8].ljust(8, b"\0"), "little")


def prefix_count(lengths: dict, n_sessions: int) -> int:
    """Training examples (a prefix and its next item) of ``n_sessions``
    sessions."""
    return int(np.sum(length_multiset(lengths, n_sessions) - 1))


def sessions_for_examples(lengths: dict, n_examples: int) -> int:
    """The fewest sessions whose prefixes give ``n_examples`` examples."""
    counts = np.array(list(lengths["length_counts"].values()), float)
    lens = np.array([int(k) for k in lengths["length_counts"]])
    per = float(np.sum(counts * (lens - 1)) / counts.sum())
    n = int(np.ceil(n_examples / per))
    while prefix_count(lengths, n) < n_examples:
        n += 1
    return n
