"""Stochastic rounding of the port (``sessionrec_tpu_torch/ops/sround.py``)
against the JAX package's ``ops/sround.py``: the bf16 bit patterns are
equal (tolerance 0: every bit) for random, bf16-exact, negative,
subnormal, +-Inf and NaN inputs, NaNs with their payload only in the low
bits included, for several seeds, given as an int and as an int64
tensor; and the checks of tests/test_sround.py: exact values pass
through, every output is one of the two bf16 neighbours, the mean over
seeds is the input (unbiased), NaN and Inf pass through."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionrec_tpu.ops import sround as js
from sessionrec_tpu_torch.ops import sround as ts

SEEDS = [0, 1, 7, 12345, 2 ** 31 - 1, -3]


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(33, 24)).astype(np.float32)
    x[1] *= 1e-3
    x[2] = -np.abs(x[2]) * 1e4
    x[3] = np.asarray(jnp.asarray(x[3], jnp.bfloat16), np.float32)  # exact
    x[4] = rng.uniform(-1, 1, 24).astype(np.float32) * np.float32(1e-39)
    x[5, :4] = [np.inf, -np.inf, np.nan, -np.nan]
    x[5, 4:8] = np.array([0x7F800001, 0xFF800003, 0x7FC00000, 0x7F80FFFF],
                         np.uint32).view(np.float32)    # low-payload NaNs
    x[5, 8:12] = [np.float32(3.4e38), np.float32(-3.4e38), 0.0, -0.0]
    x[6] = np.float32(1.0) + np.float32(2.0 ** -9) * rng.uniform(0, 2, 24) \
        .astype(np.float32)
    return x


def _jax_bits(x, seed):
    return np.asarray(js.stochastic_round_bf16_bits(jnp.asarray(x),
                                                    jnp.int32(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("tensor_seed", [False, True])
def test_bits_equal_jax(seed, tensor_seed):
    x = _inputs()
    s = torch.tensor(seed, dtype=torch.int64) if tensor_seed else seed
    got = ts.stochastic_round_bf16_bits(torch.from_numpy(x), s)
    assert got.dtype == torch.int16 and got.shape == x.shape
    got = got.numpy().view(np.uint16)
    want = _jax_bits(x, seed)
    diff = np.argwhere(got != want)
    assert diff.size == 0, [(tuple(i), x[tuple(i)], got[tuple(i)],
                             want[tuple(i)]) for i in diff[:10]]


def test_values_are_the_bits_and_rank_3_works():
    x = _inputs().reshape(3, 11, 24)
    y = ts.stochastic_round_bf16(torch.from_numpy(x), 5)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    want = np.asarray(js.stochastic_round_bf16(jnp.asarray(x), 5),
                      np.float32)
    np.testing.assert_array_equal(y.float().numpy(), want)
    bits = ts.stochastic_round_bf16_bits(torch.from_numpy(x), 5)
    assert torch.equal(ts.bf16_from_bits(bits).view(torch.int16),
                       y.view(torch.int16))


def test_exact_values_pass_through():
    x = torch.tensor([[1.0, -2.5, 0.0, 3.140625, 65280.0, -0.15625]])
    for seed in range(5):
        assert torch.equal(ts.stochastic_round_bf16(x, seed).float(), x)


def test_rounds_to_neighbours():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 128)).astype(np.float32)) * 0.1
    rtn = x.to(torch.bfloat16).float()
    for seed in (1, 2, 3):
        y = ts.stochastic_round_bf16(x, seed).float()
        ulp = torch.clamp(x.abs(), min=1e-30) * 2.0 ** -7
        assert bool((y - x).abs().le(ulp).all())
        assert not torch.equal(y, rtn)


def test_unbiased():
    x = torch.full((4, 256), 1.0 + 1.3 * 2.0 ** -9)
    n = 200
    mean = sum(ts.stochastic_round_bf16(x, seed).double()
               for seed in range(n)) / n
    assert abs(float(mean.mean()) - float(x[0, 0])) < 2.0 ** -9 * 0.2


def test_nan_inf_passthrough():
    x = torch.tensor([[float("nan"), float("inf"), -float("inf"), 1.0]])
    y = ts.stochastic_round_bf16(x, 3).float()
    assert torch.isnan(y[0, 0]) and y[0, 1] == float("inf") \
        and y[0, 2] == -float("inf")
