"""The port's data path gives exactly the JAX package's arrays: dataset
IO, prefix augmentation, the CCS builder, and the BatchLoader's
(nested, tiers (4, 8)) SplitBatch stream with its tier caps — ordered and
shuffled — and its device copies."""

import pathlib

import numpy as np
import pytest
import torch

from sessionrec_tpu.data import augment as j_aug
from sessionrec_tpu.data import io as j_io
from sessionrec_tpu.data.loader import BatchLoader as JLoader
from sessionrec_tpu.graph import batch as j_batch
from sessionrec_tpu.graph import builders as j_build
from sessionrec_tpu_torch.data import augment as t_aug
from sessionrec_tpu_torch.data import io as t_io
from sessionrec_tpu_torch.data.loader import BatchLoader as TLoader
from sessionrec_tpu_torch.graph import batch as t_batch
from sessionrec_tpu_torch.graph import builders as t_build

SAMPLE = pathlib.Path(__file__).resolve().parent.parent / "datasets" / "sample"


def _sessions(seed, n=60, max_len=12, items=40):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, items, size=int(rng.integers(1, max_len))))
            for _ in range(n)]


def _arrays(b):
    """Flatten a (nested) batch of either package into named arrays."""
    out = []
    for bi, blk in enumerate(j_batch.flatten_blocks(b)
                             if isinstance(b, j_batch.SplitBatch)
                             else t_batch.flatten_blocks(b)):
        for li, lv in enumerate(blk.levels):
            for f in ("iid", "mask", "intra_adj", "last_idx"):
                out.append((f"{bi}.levels{li}.{f}", getattr(lv, f)))
        for k, (a, c) in enumerate(zip(blk.inter_in, blk.inter_out)):
            out += [(f"{bi}.inter_in{k}", a), (f"{bi}.inter_out{k}", c)]
        out += [(f"{bi}.labels", blk.labels), (f"{bi}.valid", blk.valid)]
    return [(n, np.asarray(a.cpu() if torch.is_tensor(a) else a))
            for n, a in out]


def _assert_same(jb, tb):
    ja, ta = _arrays(jb), _arrays(tb)
    assert [n for n, _ in ja] == [n for n, _ in ta]
    for (n, a), (_, b) in zip(ja, ta):
        assert a.dtype == b.dtype, n
        np.testing.assert_array_equal(a, b, err_msg=n)


def test_read_dataset_and_augment_match():
    jt, je, jn = j_io.read_dataset(SAMPLE)
    tt, te, tn = t_io.read_dataset(SAMPLE)
    assert (jt, je, jn) == (tt, te, tn)
    assert j_io.max_session_len(jt) == t_io.max_session_len(tt)
    np.testing.assert_array_equal(j_aug.AugmentedIndex(jt[:500]).index,
                                  t_aug.AugmentedIndex(tt[:500]).index)


@pytest.mark.parametrize("order", [1, 2])
def test_build_ccs_batch_matches(order):
    sess = _sessions(1)
    labels = list(range(len(sess)))
    jd = j_build.build_ccs_batch(sess, labels, order, 12, 64)
    td = t_build.build_ccs_batch(sess, labels, order, 12, 64)
    for k in range(order):
        for f in jd["levels"][k]:
            np.testing.assert_array_equal(jd["levels"][k][f],
                                          td["levels"][k][f])
    for key in ("inter_in", "inter_out"):
        for a, b in zip(jd[key], td[key]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jd["labels"], td["labels"])
    np.testing.assert_array_equal(jd["valid"], td["valid"])


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("split_len", [None, 6, (4, 8)])
def test_loader_stream_matches(shuffle, split_len):
    sess = _sessions(2, n=120, max_len=14)
    kw = dict(shuffle=shuffle, order=1, seed=7, split_len=split_len)
    jl = JLoader(sess, "ccs", 32, 13, use_native=False, prefetch=0, **kw)
    tl = TLoader(sess, "ccs", 32, 13, prefetch=2, **kw)
    assert jl.split == tl.split
    assert len(jl) == len(tl) and jl.num_examples == tl.num_examples
    for epoch in range(2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jbs, tbs = list(jl), list(tl)
        assert len(jbs) == len(tbs) == len(jl)
        for jb, tb in zip(jbs, tbs):
            _assert_same(jb, tb)
            np.testing.assert_array_equal(np.asarray(jb.labels),
                                          np.asarray(tb.labels))


def test_sample_tier_caps_and_device_copy():
    """The main path's loader on datasets/sample: tiers (4, 8) give the
    JAX package's caps, and ``to`` keeps every array exactly."""
    train, _, _ = t_io.read_dataset(SAMPLE)
    train = train[:2000]
    jl = JLoader(train, "ccs", 512, 20, use_native=False, prefetch=0,
                 split_len=(4, 8))
    tl = TLoader(train, "ccs", 512, 20, split_len=(4, 8), device="cpu")
    assert jl.split == tl.split
    jb, tb = next(iter(jl)), next(iter(tl))
    assert isinstance(tb, t_batch.SplitBatch)
    assert isinstance(tb.short, t_batch.SplitBatch)
    assert torch.is_tensor(tb.short.short.levels[0].iid)
    _assert_same(jb, tb)
    assert tb.labels.dtype == torch.int32 and tb.valid.dtype == torch.float32


def test_split_overflow_raises():
    sess = _sessions(3, n=80, max_len=14)
    tl = TLoader(sess, "ccs", 32, 13, split_len=(4, 8), prefetch=0)
    tl.split = (tl.split[0], (8, 8, 8))
    with pytest.raises(RuntimeError, match="split tier overflow"):
        list(tl)


def test_prefetch_error_surfaces():
    tl = TLoader([[1, 2, 3]] * 40, "ccs", 8, 3, prefetch=2)
    tl.kind = "gru4rec"
    with pytest.raises(ValueError, match="unknown batch kind"):
        list(tl)
