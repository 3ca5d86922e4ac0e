"""The port's C++ CCS builder (csrc/collate.cc through
data/native_collate.py) gives, bit for bit, the JAX package's builder's
arrays and the port's Python builder's, at orders 1-4 and on the edge
cases of tests/test_native_collate.py; the loader yields the same batches
with either builder, flat and tiered, ordered and shuffled; the library
builds where it is told, and a compiler that is missing or fails raises."""

import numpy as np
import pytest

from sessionrec_tpu.graph import builders as j_build
from sessionrec_tpu_torch.data import native_collate as nc
from sessionrec_tpu_torch.data.loader import BatchLoader
from sessionrec_tpu_torch.graph import builders as t_build

from test_torch_data import _assert_same


def _assert_tree_equal(a, b, path=""):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def _three_ways(seqs, labels, order, max_len, batch_size):
    want = j_build.build_ccs_batch(seqs, labels, order, max_len, batch_size)
    _assert_tree_equal(t_build.build_ccs_batch(seqs, labels, order, max_len,
                                               batch_size), want)
    _assert_tree_equal(nc.build_ccs_batch(seqs, labels, order, max_len,
                                          batch_size), want)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_ccs_builder_matches(order):
    rng = np.random.default_rng(200 + order)
    # a small alphabet forces repeated k-grams, short sessions pad levels
    lens = rng.integers(1, 21, size=64)
    seqs = [list(map(int, rng.integers(0, 8, size=n))) for n in lens]
    labels = list(map(int, rng.integers(0, 8, size=64)))
    _three_ways(seqs, labels, order, 20, 80)


@pytest.mark.parametrize("order", [1, 3, 4])
@pytest.mark.parametrize("case", ["empty", "edges"])
def test_edge_cases(order, case):
    """An empty batch; length-1 sessions, repeated items, a session of
    exactly max_len items."""
    if case == "empty":
        seqs, labels = [], []
    else:
        seqs = [[5], [3, 3], [1, 2, 1, 2], [7, 7, 7, 7, 7],
                [4, 9, 4, 9, 4, 9]]
        labels = [0, 1, 2, 3, 4]
    _three_ways(seqs, labels, order, 6, 8)


def _sessions(seed, n=150, max_len=14, items=30):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, items,
                                       size=int(rng.integers(1, max_len)))))
            for _ in range(n)]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("split_len", [None, (4, 8)])
@pytest.mark.parametrize("order", [1, 3])
def test_loader_batches_match_the_python_builder(shuffle, split_len, order):
    """Prefixes longer than max_len = 9 are cut to their last items."""
    sess = _sessions(order)
    kw = dict(shuffle=shuffle, order=order, seed=3, split_len=split_len,
              prefetch=2)
    native = BatchLoader(sess, "ccs", 32, 9, use_native=True, **kw)
    plain = BatchLoader(sess, "ccs", 32, 9, use_native=False, **kw)
    assert max(len(s) for s in sess) > 9
    for epoch in range(2):
        native.set_epoch(epoch)
        plain.set_epoch(epoch)
        nbs, pbs = list(native), list(plain)
        assert len(nbs) == len(pbs) == len(native)
        for a, b in zip(nbs, pbs):
            _assert_same(a, b)


def test_library_lands_in_the_build_dir(tmp_path):
    out = nc.build_library(tmp_path / "build")
    assert out.parent == tmp_path / "build"
    assert out.name.startswith("libsrt_collate-") and out.suffix == ".so"
    assert out == nc.library_path(tmp_path / "build")
    assert nc.build_library(tmp_path / "build") == out        # built once


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler-on-path")
    with pytest.raises(RuntimeError, match="not found"):
        nc.build_library(tmp_path)
    assert not list(tmp_path.glob("*.so"))


def test_failing_compiler_raises_with_its_message(tmp_path, monkeypatch):
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'cxx: refused' >&2\nexit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(RuntimeError, match="cxx: refused"):
        nc.build_library(tmp_path / "build")


def test_loader_raises_when_the_library_does_not_build(tmp_path,
                                                       monkeypatch):
    """No quiet fallback to the Python builder."""
    monkeypatch.setattr(nc, "_lib", None)
    monkeypatch.setattr(nc, "BUILD", tmp_path / "build")
    monkeypatch.setenv("CXX", "no-such-compiler-on-path")
    with pytest.raises(RuntimeError, match="not found"):
        BatchLoader([[1, 2, 3]] * 8, "ccs", 4, 3, use_native=True)
    plain = BatchLoader([[1, 2, 3]] * 8, "ccs", 4, 3, use_native=False,
                        prefetch=0)
    assert len(list(plain)) == len(plain) > 0
