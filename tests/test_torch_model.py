"""MSGIFSR order 1: the JAX model's parameters, carried across with
``convert.params_from_jax``, give the same session vectors, fused loss and
gradients of every parameter in the port, with dropout off — on a flat
CcsBatch and on the nested SplitBatch of tiers (4, 8).  Tolerance atol
5e-5, as tests/test_model_torch_parity.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionrec_tpu.data.loader import BatchLoader as JLoader
from sessionrec_tpu.models import MSGIFSR as JMSGIFSR
from sessionrec_tpu.ops import xent as jx
from sessionrec_tpu_torch.convert import params_from_jax
from sessionrec_tpu_torch.data.loader import BatchLoader as TLoader
from sessionrec_tpu_torch.models import MSGIFSR
from sessionrec_tpu_torch.ops import xent as tx

ATOL = 5e-5
NUM_ITEMS = 60
DIM = 32


def _sessions(seed, n=40, max_len=12):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, NUM_ITEMS, size=int(rng.integers(2, max_len))))
            for _ in range(n)]


def make_pair(seed=0, num_items=NUM_ITEMS, dim=DIM):
    jm = JMSGIFSR(num_items=num_items, embedding_dim=dim, num_layers=1,
                  order=1)
    jp, _ = jm.init(jax.random.PRNGKey(seed))
    jp = jm.project_params(jp)
    tm = MSGIFSR(num_items, dim, 1)
    tm.load_state_dict(params_from_jax(jax.device_get(jp)))
    return jm, jp, tm


def _batches(split_len):
    sess = _sessions(1)
    jl = JLoader(sess, "ccs", 24, 11, use_native=False, prefetch=0,
                 split_len=split_len)
    tl = TLoader(sess, "ccs", 24, 11, prefetch=0, split_len=split_len,
                 device="cpu")
    return next(iter(jl)), next(iter(tl))


def test_convert_covers_every_parameter():
    _, jp, tm = make_pair()
    sd = params_from_jax(jax.device_get(jp))
    assert set(sd) == set(dict(tm.named_parameters()))
    assert sd["embedding"].shape == (512, DIM)      # padded table


@pytest.mark.parametrize("split_len", [None, (4, 8)])
def test_head_loss_and_grads_match_jax(split_len):
    jm, jp, tm = make_pair(seed=3)
    jb, tb = _batches(split_len)

    def jloss(p):
        sr, table, _ = jm.head(p, {}, jb, training=True, rng=None)
        loss = jx.fused_nll_loss(sr, table, jb.labels, jb.valid, scale=12.0,
                                 num_items=NUM_ITEMS, normalize_table=True,
                                 use_pallas=False)
        return loss, sr

    (lj, srj), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)

    sr, table = tm.head(tb, training=True, gen=None)
    lt = tx.fused_nll_loss(sr, table, tb.labels, tb.valid, scale=12.0,
                           num_items=NUM_ITEMS, normalize_table=True)
    lt.backward()

    np.testing.assert_allclose(sr.detach().numpy(), np.asarray(srj),
                               atol=ATOL)
    np.testing.assert_allclose(float(lt.detach()), float(lj), atol=ATOL)
    want = params_from_jax(jax.device_get(gj))
    for name, p in tm.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   atol=ATOL, err_msg=name)


def test_dropout_is_seeded_and_active():
    _, _, tm = make_pair(seed=4)
    tm.feat_drop = 0.5
    _, tb = _batches((4, 8))
    a, _ = tm.head(tb, training=True, gen=torch.Generator().manual_seed(1))
    b, _ = tm.head(tb, training=True, gen=torch.Generator().manual_seed(1))
    c, _ = tm.head(tb, training=True, gen=torch.Generator().manual_seed(2))
    d, _ = tm.head(tb, training=False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, d)


@pytest.mark.parametrize("kw", [dict(order=2), dict(extra=True),
                                dict(fusion=True)])
def test_paper_head_not_ported_yet(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MSGIFSR(NUM_ITEMS, DIM, 1, **kw)
