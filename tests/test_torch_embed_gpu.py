"""The gather's backward kernel (csrc/embed_bwd.cu) on the card: the bits
of its plain version (ops/embed.py:_bwd_plain, run on the card), within
summation error of a float64 sum, at a padding run of 16,384 slots, ids
with no slots, runs of 1-24 and across tile edges, widths 256 and 512
(and 258, 32: one element a lane, many ways), float32 and bfloat16
tables; the same bits from two calls and from a CUDA-graph replay; one
launch a step; and an MSGIFSR order-1 and paper step over three length
tiers whose table gradient is that of one torch gather a tier and level.
The kernel has no interpret mode, so without a card every test here
skips.  No JAX is imported:

    python -m pytest --noconftest tests/test_torch_embed_gpu.py -m gpu
"""

import pytest
import torch

from sessionrec_tpu_torch.data.loader import BatchLoader
from sessionrec_tpu_torch.models import MSGIFSR
from sessionrec_tpu_torch.ops import embed
from sessionrec_tpu_torch.utils import profiling
from test_torch_embed import _ids, _sessions, assert_sums_close

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no "
                    "interpret mode)")
    return torch.device("cuda")


def _case(cuda, P, D, dtype, seed, pad=16384):
    ids = _ids(P, seed=seed, pad=pad)
    g = torch.randn(ids.numel(), D, generator=torch.Generator()
                    .manual_seed(seed)).to(dtype)
    # three pieces, as a step's gathers hand them over
    cuts = [g[:5000], g[5000:5001], g[5001:]]
    return [c.to(cuda) for c in cuts], ids.to(cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 512, 258, 32, 1000])
def test_kernel_gives_the_plain_bits(cuda, D, dtype):
    P = 1200
    grads, ids = _case(cuda, P, D, dtype, seed=D)
    got = embed._bwd_cuda(grads, ids, P)
    want = embed._bwd_plain(grads, ids, P)
    assert got.dtype == dtype and got.shape == (P, D)
    assert torch.equal(got, want)
    assert_sums_close(got.cpu(), [g.cpu() for g in grads], ids.cpu(), P)


def test_a_step_without_slots_writes_zeros(cuda):
    g = torch.zeros(0, 256, device=cuda)
    ids = torch.zeros(0, dtype=torch.int32, device=cuda)
    out = embed._bwd_cuda([g], ids, 70)
    assert torch.equal(out, torch.zeros(70, 256, device=cuda))


def test_two_calls_and_a_graph_replay_give_the_same_bits(cuda):
    P, D = 37888, 256
    grads, ids = _case(cuda, P, D, torch.float32, seed=5)
    first = embed._bwd_cuda(grads, ids, P)
    assert torch.equal(embed._bwd_cuda(grads, ids, P), first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        embed._bwd_cuda(grads, ids, P)          # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = embed._bwd_cuda(grads, ids, P)
    out.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)


def test_kernels_spill_nothing(cuda):
    for dtype in (torch.float32, torch.bfloat16):
        for vec in (True, False):
            attrs = embed.kernel_attrs(dtype, vec)
            assert all(local == 0 for _, local in attrs.values()), attrs


def _step(model, batch, gather=None, monkeypatch=None):
    if gather is not None:
        monkeypatch.setattr(embed, "gather", gather)
    model.zero_grad(set_to_none=True)
    out = (model.head_multi if model.extra else model.head)(
        batch, training=True, seeds=None)
    sr = out[0]
    w = torch.randn(sr.shape, generator=torch.Generator().manual_seed(9))
    (sr * w.to(sr.device)).sum().backward()
    return model.embedding.grad.clone()


@pytest.mark.parametrize("head", [dict(order=1),
                                  dict(order=3, extra=True, fusion=True)])
def test_a_split_step_runs_one_launch_and_torchs_sum(cuda, head,
                                                     monkeypatch):
    """MSGIFSR over three length tiers at batch 512: one ``embed.bwd``
    launch for every tier and level, and the table gradient of one torch
    gather (index backward) a tier and level, to float32 summation error
    of its largest magnitude."""
    model = MSGIFSR(3429, 256, 1, **head)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(cuda)
    batch = next(iter(BatchLoader(_sessions(1, n=600, items=3429), "ccs",
                                  512, 20, order=model.order, prefetch=0,
                                  split_len=(4, 8)))).to(cuda)
    with profiling.tracing():
        got = _step(model, batch)
        counts = profiling.snapshot()["counts"]
    assert counts.get("embed.bwd") == 1
    want = _step(model, batch, lambda t, ids: [t[i.long()] for i in ids],
                 monkeypatch)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
