"""The mixed-precision mode on the card: with a bf16 table and bf16
compute, 8 steps through the captured graph and the same 8 batches
through the plain ``train_step`` give the same losses and tables bit for
bit, stochastic rounding included (its seed comes from the device's step
counter), on the order-1 head (K1/K2's bf16 branch) and the paper head
(K3/K4's); the traced replay runs only the kernels' bf16 instantiations;
the table keeps float32 Adam moments; a resume on the card is bit for
bit; and ``stochastic_round_bf16`` gives the CPU's bits at the path's
table shape.  The kernels have no interpret mode, so without a card
every test here skips.  No JAX is imported:

    python -m pytest --noconftest tests/test_torch_bf16_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from sessionrec_tpu_torch.data.loader import BatchLoader
from sessionrec_tpu_torch.models import MSGIFSR
from sessionrec_tpu_torch.ops.sround import stochastic_round_bf16_bits
from sessionrec_tpu_torch.train.runner import TrainRunner
from sessionrec_tpu_torch.utils.checkpoint import Checkpointer

pytestmark = pytest.mark.gpu

BF16 = dict(table_dtype="bfloat16", compute_dtype="bfloat16")
PATHS = {"order1": dict(order=1, **BF16),
         "paper": dict(order=3, extra=True, fusion=True, **BF16)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no "
                    "interpret mode)")
    return torch.device("cuda")


def _sessions(seed, n):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, 300, size=int(rng.integers(2, 16)))))
            for _ in range(n)]


def _fresh_runner(cuda, kw, ckpt=None):
    loader = BatchLoader(_sessions(0, 300), "ccs", 64, 15, split_len=(4, 8),
                         order=kw["order"])
    model = MSGIFSR(300, 64, 1, feat_drop=0.1, **kw)
    return TrainRunner(model, loader, (), seed=3, unroll=8, lr_step_size=1,
                       device=cuda, eval_before_train=False,
                       checkpointer=Checkpointer(ckpt) if ckpt else None)


@pytest.mark.parametrize("path", PATHS)
def test_bf16_graph_matches_plain_bit_for_bit(cuda, path):
    runner = _fresh_runner(cuda, PATHS[path])
    batches = cs.first_batches(runner.train_loader, 24)
    runner.run_chunk(batches[:8])               # eager: Adam's state exists
    got, want, gaps = cs.graph_vs_plain(torch, runner, batches[8:16])
    assert torch.equal(got, want)
    assert max(gaps.values()) == 0.0, gaps
    assert runner.model.embedding.dtype == torch.bfloat16
    st = runner.named_state()
    assert st["adam/embedding/exp_avg_sq"].dtype == torch.float32
    assert float(st["adam/embedding/step"]) == 16.0
    counts, bf16, events = cs.trace_launches(
        torch, lambda: runner.run_chunk(batches[16:]))
    kernels = cs.K12 if PATHS[path]["order"] == 1 else cs.K34
    if events:
        assert cs.launch_errors(counts, 8, kernels) == {}
        assert bf16 == counts


def test_bf16_resume_on_the_card_is_bit_for_bit(cuda, tmp_path):
    kw = PATHS["order1"]
    full = _fresh_runner(cuda, kw, tmp_path / "full")
    full.train(2, log_interval=10 ** 9)
    _fresh_runner(cuda, kw, tmp_path / "ab").train(1, log_interval=10 ** 9)
    b = _fresh_runner(cuda, kw, tmp_path / "ab")
    assert b.checkpointer.restore_latest(b)
    b.train(2, log_interval=10 ** 9)
    half = len(full.losses) // 2
    assert b.losses == full.losses[half:]
    want, got = full.named_state(), b.named_state()
    for name, t in want.items():
        assert torch.equal(got[name], t), name


@pytest.mark.parametrize("P", [3584, 37888])
def test_rounding_bits_on_the_card_match_the_cpu(cuda, P):
    gen = torch.Generator().manual_seed(P)
    x = torch.randn(P, 256, generator=gen) * 0.06
    x[0, :3] = torch.tensor([float("inf"), float("nan"), -float("inf")])
    for seed in (0, 12345, 2 ** 31 - 1):
        dev = stochastic_round_bf16_bits(
            x.to(cuda), torch.tensor(seed, dtype=torch.int64, device=cuda))
        assert torch.equal(dev.cpu(), stochastic_round_bf16_bits(x, seed))
