"""Synthetic traffic: a seed gives the same sessions every time, every
seed the same amount of work, and the example stream the port's loader
takes."""

import numpy as np

from harness import data

LEN = data.load_profile("sample_lengths.json")
ITEMS = data.load_profile("sample_item_frequencies.json")


def test_same_seed_same_sessions():
    a = data.make_sessions(2 ** 31 + 7, "train", 500, 37484, LEN, ITEMS)
    b = data.make_sessions(2 ** 31 + 7, "train", 500, 37484, LEN, ITEMS)
    c = data.make_sessions(2 ** 31 + 8, "train", 500, 37484, LEN, ITEMS)
    assert a == b
    assert a != c


def test_seeds_share_the_lengths():
    a = data.make_sessions(1, "train", 10000, 37484, LEN, ITEMS)
    b = data.make_sessions(2, "train", 10000, 37484, LEN, ITEMS)
    assert list(map(len, a)) == list(map(len, b))
    assert max(map(len, a)) == 20


def test_streams_of_one_seed_differ():
    a = data.make_sessions(5, "train", 200, 37484, LEN, ITEMS)
    b = data.make_sessions(5, "serve", 200, 37484, LEN, ITEMS)
    assert a != b


def test_profile_is_the_sample_skew():
    p = data.item_probabilities(ITEMS, 37484)
    assert abs(p.sum() - 1.0) < 1e-9
    top = np.sort(p)[::-1][:3748].sum()
    assert 0.28 < top < 0.32
    lens = data.length_multiset(LEN, 9381)
    assert abs(lens.mean() - 4.106) < 0.01 and np.median(lens) == 3


def test_example_count():
    n = data.sessions_for_examples(LEN, 10000)
    assert data.prefix_count(LEN, n) >= 10000 > data.prefix_count(LEN, n - 1)


def test_stream_is_the_loaders_order():
    from sessionrec_tpu_torch.data.augment import AugmentedIndex
    from traffic.train import Stream
    sessions = data.make_sessions(3, "train", 300, 500, LEN, ITEMS)
    idx = AugmentedIndex(sessions)
    s = Stream(sessions, 64)
    flat = [ex for k in range(s.steps_per_epoch) for ex in s.step(k)]
    assert flat == [idx.example(i) for i in range(len(idx))]
    assert s.step(s.steps_per_epoch) == s.step(0)
