"""Parity of the port's small ops with the JAX package's: the dropout
counter hash bit for bit, masked softmax / mean (fully masked rows too),
counted label ranks (ties too), the max-norm projection and l2norm.
Inputs come from numpy seeds; float tolerances are stated per test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionrec_tpu.models import layers as jl
from sessionrec_tpu.models.lessr import renorm_rows as j_renorm
from sessionrec_tpu.ops import dropout as jd
from sessionrec_tpu.ops import masked as jm
from sessionrec_tpu.ops import scoring as js
from sessionrec_tpu_torch.models import layers as tl
from sessionrec_tpu_torch.models.msgifsr import renorm_rows as t_renorm
from sessionrec_tpu_torch.ops import dropout as td
from sessionrec_tpu_torch.ops import masked as tm
from sessionrec_tpu_torch.ops import scoring as ts


@pytest.mark.parametrize("seed", [0, 1, 123, 2 ** 31 - 1, -1, -987654321])
@pytest.mark.parametrize("shape", [(7, 33), (64, 256)])
def test_hash_bits_bit_identical(seed, shape):
    want = np.asarray(jd._hash_bits(jnp.asarray(seed, jnp.int32), shape))
    got = td._hash_bits(seed, shape).numpy()
    assert got.min() >= 0 and got.max() < 2 ** 32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("seed", [0, 1, 123, 2 ** 31 - 1, -1, -987654321])
def test_tensor_seed_gives_the_same_bits(seed):
    """A seed held as an int64 tensor (the device counter's form) hashes
    as the same integer does, and as the JAX package's seed."""
    shape = (7, 33)
    want = np.asarray(jd._hash_bits(jnp.asarray(seed, jnp.int32), shape))
    got = td._hash_bits(torch.tensor(seed, dtype=torch.int64), shape)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert torch.equal(got, td._hash_bits(seed, shape))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_matches_jax_apply(rate):
    """Same seed -> the same kept elements and values (exact)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 40)).astype(np.float32)
    seed = 4242
    want = np.asarray(jd._apply(jnp.asarray(x.reshape(-1, 40)),
                                jnp.asarray([seed], jnp.int32), rate))
    got = td.dropout(torch.from_numpy(x), rate, seed).numpy()
    np.testing.assert_array_equal(got.reshape(-1, 40), want)
    kept = float((got != 0).mean())
    assert abs(kept - (1 - rate)) < 0.1


def test_threshold_matches():
    for rate in (0.1, 0.25, 0.5, 0.9):
        assert td._keep_threshold(rate) == int(jd._keep_threshold(rate))


def _mask_case(seed):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(4, 6, 3)).astype(np.float32)
    mask = (rng.random((4, 6, 1)) < 0.5).astype(np.float32)
    mask[1] = 0.0                        # a fully masked row
    return e, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_softmax_and_mean(seed):
    e, mask = _mask_case(seed)
    want = np.asarray(jm.masked_softmax(jnp.asarray(e), jnp.asarray(mask),
                                        axis=1))
    got = tm.masked_softmax(torch.from_numpy(e), torch.from_numpy(mask),
                            dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.all(got[1] == 0.0)
    want = np.asarray(jm.masked_mean(jnp.asarray(e), jnp.asarray(mask),
                                     axis=1))
    got = tm.masked_mean(torch.from_numpy(e), torch.from_numpy(mask),
                         dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.all(got[1] == 0.0)


def test_label_ranks_by_count_with_ties():
    rng = np.random.default_rng(3)
    scores = rng.integers(0, 5, size=(16, 40)).astype(np.float32)  # ties
    scores[:, 35:] = -np.inf                                       # padding
    labels = rng.integers(0, 35, size=16).astype(np.int32)
    for k in (1, 5, 20):
        want = np.asarray(js.label_ranks_by_count(
            jnp.asarray(scores), jnp.asarray(labels), k))
        got = ts.label_ranks_by_count(torch.from_numpy(scores),
                                      torch.from_numpy(labels), k).numpy()
        np.testing.assert_array_equal(got, want)
        topk = np.asarray(js.topk_ranks(jnp.asarray(scores),
                                        jnp.asarray(labels), k))
        np.testing.assert_array_equal(got, topk)


def test_pad_catalog_and_item_mask():
    for n in (1, 511, 512, 513, 3429, 37484):
        assert ts.pad_catalog(n) == js.pad_catalog(n)
        np.testing.assert_array_equal(
            ts.item_mask(n, ts.pad_catalog(n)).numpy(),
            np.asarray(js.item_mask(n, js.pad_catalog(n))).astype(bool))


def test_renorm_rows_and_l2norm():
    rng = np.random.default_rng(5)
    t = rng.normal(size=(20, 16)).astype(np.float32) * 0.4
    t[3] = 0.0
    want = np.asarray(j_renorm(jnp.asarray(t), 1.0))
    got = t_renorm(torch.from_numpy(t.copy()), 1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.linalg.norm(got, axis=1).max() <= 1.0 + 1e-6
    np.testing.assert_allclose(
        tl.l2norm(torch.from_numpy(t)).numpy(),
        np.asarray(jl.l2norm(jnp.asarray(t))), rtol=1e-6, atol=1e-7)


def test_masked_catalog_softmax_and_nll_loss():
    """REnorm's restricted softmax (an empty mask gives zeros) and the mean
    NLL over valid rows; rtol 1e-6 / atol 1e-7."""
    rng = np.random.default_rng(7)
    logits = (12 * rng.normal(size=(5, 3, 40))).astype(np.float32)
    mask = (rng.random((5, 1, 40)) < 0.3).astype(np.float32)
    mask[2] = 0.0                                       # an empty partition
    want = np.asarray(js.masked_catalog_softmax(jnp.asarray(logits),
                                                jnp.asarray(mask)))
    got = ts.masked_catalog_softmax(torch.from_numpy(logits),
                                    torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.all(got[2] == 0.0)
    lp = np.log(np.maximum(got[:, 0], 1e-30))
    labels = rng.integers(0, 40, size=5).astype(np.int32)
    valid = np.array([1, 1, 0, 1, 1], np.float32)
    want = float(js.nll_loss(jnp.asarray(lp), jnp.asarray(labels),
                             jnp.asarray(valid)))
    got = float(ts.nll_loss(torch.from_numpy(lp), torch.from_numpy(labels),
                            torch.from_numpy(valid)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
