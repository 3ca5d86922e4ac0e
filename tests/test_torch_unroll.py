"""The pieces the CUDA-graph step rests on, on the CPU: the tensor learning
rate follows the JAX package's ``step_lr`` step by step; dropout seeds
from the device counter give the JAX package's hash bits and a new mask
every step and site; the runner's chunked loop gives the same losses and
parameters with unroll 1 and 3, a tail chunk shorter than unroll
included; and the unroll flag reaches the runner."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sessionrec_tpu.train.optim import step_lr
from sessionrec_tpu_torch import cli
from sessionrec_tpu_torch.data.loader import BatchLoader
from sessionrec_tpu_torch.models import MSGIFSR
from sessionrec_tpu_torch.models.layers import SeedSource
from sessionrec_tpu_torch.ops import dropout as td
from sessionrec_tpu_torch.train.optim import StepLR
from sessionrec_tpu_torch.train.runner import TrainRunner
from sessionrec_tpu_torch.train.session import _CappedLoader

from test_torch_model import PAPER, _sessions


@pytest.mark.parametrize("lr,gamma", [(1e-3, 0.1), (5e-3, 0.5)])
def test_step_lr_matches_jax(lr, gamma):
    """spe = 2, step_size = 3: drops after steps 6 and 12."""
    want = step_lr(lr, 2, 3, gamma)
    sched = StepLR(lr, 2, 3, gamma)
    got = []
    for count in range(14):
        got.append(float(sched.lr))
        assert int(sched.count) == count
        sched.step()
    np.testing.assert_allclose(
        got, [float(want(np.int32(k))) for k in range(14)], rtol=1e-6)
    assert got[5] == got[0] != got[6] == got[11] != got[12]


def test_seed_source_draws_new_seeds_per_step_and_site():
    s = SeedSource(7)
    first = [int(s.next()) for _ in range(4)]
    s.begin_step()
    second = [int(s.next()) for _ in range(4)]
    assert len(set(first + second)) == 8
    again = SeedSource(7)
    assert [int(again.next()) for _ in range(4)] == first
    again.begin_step()
    assert [int(again.next()) for _ in range(4)] == second
    assert int(SeedSource(8).next()) != first[0]


def test_site_seed_gives_the_hash_of_its_value():
    s = SeedSource(3)
    s.begin_step()
    seed = s.next()
    assert seed.dtype == torch.int64 and seed.dim() == 0
    assert torch.equal(td._hash_bits(seed, (5, 40)),
                       td._hash_bits(int(seed), (5, 40)))
    x = torch.ones(5, 40)
    assert torch.equal(td.dropout(x, 0.5, seed), td.dropout(x, 0.5,
                                                            int(seed)))


def _runner(unroll, kw, batches):
    model = MSGIFSR(60, 16, 1, feat_drop=0.2, **kw)
    return TrainRunner(model, batches, [], lr=5e-3, seed=9, unroll=unroll,
                       lr_step_size=1, lr_gamma=0.5, device="cpu",
                       eval_before_train=False)


@pytest.mark.parametrize("kw", [dict(order=1), PAPER],
                         ids=["order1", "paper"])
def test_unroll_1_and_3_give_the_same_run(kw):
    """Seven batches: chunks of 3, 3 and a tail of 1 against seven single
    steps; dropout on, the schedule dropping every 3 steps."""
    loader = _CappedLoader(BatchLoader(
        _sessions(4, n=100), "ccs", 16, 11, prefetch=2, split_len=(4, 8),
        order=kw["order"]), 7)
    assert len(loader) == 7
    runs = []
    for unroll in (1, 3):
        r = _runner(unroll, kw, [None] * 3)       # 3 steps an "epoch"
        r.train_loader = loader
        r.train(1, log_interval=1000)
        runs.append(r)
    a, b = runs
    assert a.steps == b.steps == 7
    np.testing.assert_array_equal(a.losses, b.losses)
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    assert int(a.seeds.count) == int(b.seeds.count) == 7
    assert float(a.sched.lr) == float(b.sched.lr) == pytest.approx(
        5e-3 * 0.5 ** 2)
    assert not a.graphs and not b.graphs        # graphs are for CUDA only


def test_cli_passes_unroll(monkeypatch):
    seen = []

    def run_training(cfg, max_epoch_batches=None):
        seen.append(cfg)
        return SimpleNamespace(max_mrr=0.0, max_hit=0.0)

    monkeypatch.setattr("sessionrec_tpu_torch.train.session.run_training",
                        run_training)
    cli.main(["train", "--model", "msgifsr", "--device", "cpu"])
    cli.main(["train", "--model", "msgifsr", "--unroll", "3",
              "--device", "cpu"])
    assert [c.train.unroll for c in seen] == [8, 3]
    assert all(c.data.use_native_collate for c in seen)


def test_batch_slot_copy_is_leaf_by_leaf_and_shape_checked():
    """A runner's static slot takes the next batch in place; a batch of
    another shape is refused."""
    loader = BatchLoader(_sessions(5, n=60), "ccs", 16, 11, prefetch=0,
                         split_len=(4, 8), order=3)
    first, second = list(loader)[:2]
    slot = first.to("cpu")
    leaves = [lv.iid for lv in slot.short.short.levels]
    slot.copy_(second)
    assert all(a is b for a, b in zip(leaves,
                                      [lv.iid for lv in slot.short.short.levels]))
    want = second.to("cpu")
    assert torch.equal(slot.labels, want.labels)
    assert torch.equal(slot.long.levels[2].intra_adj,
                       want.long.levels[2].intra_adj)
    assert torch.equal(slot.short.long.inter_out[1],
                       want.short.long.inter_out[1])
    other = BatchLoader(_sessions(5, n=60), "ccs", 8, 11, prefetch=0,
                        split_len=(4, 8), order=3)
    with pytest.raises(ValueError, match="shape"):
        slot.copy_(next(iter(other)))
