"""The port's training step on its (2, 2) mesh against its own step on one
device, with dropout on.

The mesh runs as 4 gloo processes on the CPU (``_torch_mesh_worker.py``
``train``, started once for the file), rank 0 also the one-device steps,
on the first 200 sessions of datasets/sample (3,429 items, 3,584 rows:
the second model shard holds 1,637 real rows of 1,792) in batches of 64
with the (4, 8) tiers, each rank its data position's rows of every tier.
For o1 (MSGIFSR order 1, feat_drop 0.5), the paper head (order 3,
REnorm, fusion), LESSR (BatchNorm over the global batch, feat_drop 0.2)
and o1 with a bfloat16 table:

* 3 steps give every rank the one-device losses (rtol 1e-4) and
  parameters, buffers and Adam state (rtol 1e-4, atol 1e-5, as
  tests/test_torch_train.py; the table and its moments each rank's rows);
  a bfloat16 table, which the one-device run rounds with the mesh's
  per-shard seeds, may differ by a bf16 ulp a step where the float32
  sums, added in another order, fall on the two sides of a rounding draw
  (at most 1% of its elements).  Its gradient is summed in float32 and
  cast to bf16 once on the mesh, where one device rounds each term (the
  loss's and the lookup's) to bf16: the table's Adam moments differ by
  up to 2^-8 of their largest element (0.19% measured, on 0.9% of
  them);
* every dropout mask is the one-device mask's bits at the rank's global
  indices, and every stochastic rounding is the JAX package's per-shard
  rounding (``sround.stochastic_round_bf16_bits`` with ``seed + sid *
  0x27D4EB2F``) of the rank's float32 rows, bit for bit;
* the eval sweep after the steps gives the one-device (hit, mrr, n) sums
  to 1e-6;
* a checkpoint saved on the mesh resumes on one device: the state equals
  the mesh's gathered state exactly, and a 4th step agrees with the
  mesh's 4th; and a one-device state loads onto the mesh
  (``checkpoint.load_state``): the ranks' parts join to it exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_worker as W
from sessionrec_tpu.ops.sround import stochastic_round_bf16_bits
from sessionrec_tpu_torch.utils.checkpoint import Checkpointer

DP = MP = 2
RTOL, ATOL = 1e-4, 1e-5
BF16_ULP = 2.0 ** -7          # bf16's spacing relative to a value, at most
MOMENTS = ("adam/embedding/exp_avg", "adam/embedding/exp_avg_sq")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_train")
    return W.spawn("train", out, DP, MP)[0], out


def _whole(ranks, key, name):
    """The global tensor ``name`` from every rank's ``key`` state: the
    table's shards in model order, its moments' slices model-major,
    data-minor; a replicated tensor from rank 0."""
    if name == "embedding":
        return np.concatenate([ranks[m][key][name] for m in range(MP)])
    if name in MOMENTS:
        return np.concatenate([ranks[d * MP + m][key][name]
                               for m in range(MP) for d in range(DP)])
    return ranks[0][key][name]


@pytest.mark.parametrize("case", W.TRAIN_CASES)
def test_mesh_steps_match_one_device(run, case):
    res, _ = run
    ranks = [r[case] for r in res]
    ref = ranks[0]["ref"]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=RTOL)
    for name, want in ref["state"].items():
        got = _whole(ranks, "state", name)
        if name == "embedding" and case == "o1_bf16":
            gap = np.abs(got - want)
            assert float((gap > 0).mean()) <= 0.01
            assert np.all(gap <= W.TRAIN_STEPS * BF16_ULP * np.abs(want)
                          + ATOL)
            continue
        if name in MOMENTS and case == "o1_bf16":
            # one bf16 rounding of the summed gradient against one of
            # each of its terms: within bf16's 2^-8 of the tensor's scale
            gap = np.abs(got - want)
            assert float(gap.max()) <= BF16_ULP / 2 * np.abs(want).max()
            continue
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", W.TRAIN_CASES)
def test_mesh_dropout_masks_are_one_devices(run, case):
    res, _ = run
    ref = res[0][case]["ref"]["masks"]
    assert len(ref) >= 3 * 3
    for rank, r in enumerate(res):
        masks = r[case]["masks"]
        assert len(masks) == len(ref)
        for i, ((idx, keep), (_, want)) in enumerate(zip(masks, ref)):
            np.testing.assert_array_equal(keep, want[idx],
                                          err_msg=f"rank {rank} call {i}")


def test_mesh_rounding_bits_are_jax_per_shard(run):
    res, _ = run
    for r in res:
        rounds = r["o1_bf16"]["rounds"]
        assert len(rounds) == W.TRAIN_STEPS
        for new, seed, sid, bits in rounds:
            want = stochastic_round_bf16_bits(
                jnp.asarray(new), np.int32(np.uint32(
                    (seed + sid * 0x27D4EB2F) & 0xFFFFFFFF).view(np.int32)))
            np.testing.assert_array_equal(
                bits.view(np.uint16), np.asarray(want))


@pytest.mark.parametrize("case", W.TRAIN_CASES)
def test_mesh_eval_sweep_matches_one_device(run, case):
    res, _ = run
    want = res[0][case]["ref"]["sums"]
    assert want[2] > 0
    for r in res:
        np.testing.assert_allclose(r[case]["sums"], want, rtol=0, atol=1e-6)


def test_checkpoint_from_the_mesh_resumes_on_one_device(run):
    res, out = run
    ranks = [r["o1"] for r in res]
    runner = W.train_runner("o1")
    assert Checkpointer(out / "ckpt").restore_latest(runner)
    for name, v in runner.named_state().items():
        np.testing.assert_array_equal(v.float().numpy(),
                                      _whole(ranks, "state", name),
                                      err_msg=name)
    batch = W._batches(runner.train_loader, W.TRAIN_STEPS + 1)[-1]
    loss = float(runner.train_step(batch.to("cpu")))
    np.testing.assert_allclose(loss, ranks[0]["step4"][0], rtol=RTOL)
    for name, v in runner.named_state().items():
        np.testing.assert_allclose(v.float().numpy(),
                                   _whole(ranks, "state4", name),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert torch.equal(runner.seeds.count, torch.tensor(W.TRAIN_STEPS + 1))


def test_one_device_state_loads_onto_the_mesh(run):
    res, _ = run
    ranks = [r["o1"] for r in res]
    want = ranks[0]["loaded_from"]
    assert set(ranks[0]["loaded"]) == set(want)
    assert "adam/embedding/exp_avg" in want
    for name, v in want.items():
        np.testing.assert_array_equal(_whole(ranks, "loaded", name), v,
                                      err_msg=name)
