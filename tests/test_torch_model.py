"""MSGIFSR at order 1 and as the order-3 paper head (REnorm + fusion, each
reducer): the JAX model's parameters, carried across with
``convert.params_from_jax``, give the same session vectors, fused loss and
gradients of every parameter in the port, with dropout off — on a flat
CcsBatch and on the nested SplitBatch of tiers (4, 8) — and the same eval
log-probabilities.  Tolerance atol 5e-5, as
tests/test_model_torch_parity.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionrec_tpu.data.loader import BatchLoader as JLoader
from sessionrec_tpu.models import MSGIFSR as JMSGIFSR
from sessionrec_tpu.ops import xent as jx
from sessionrec_tpu.ops import xent_multi as jxm
from sessionrec_tpu_torch.convert import params_from_jax
from sessionrec_tpu_torch.data.loader import BatchLoader as TLoader
from sessionrec_tpu_torch.models import MSGIFSR
from sessionrec_tpu_torch.models.layers import SeedSource
from sessionrec_tpu_torch.ops import xent as tx
from sessionrec_tpu_torch.ops import xent_multi as txm

ATOL = 5e-5
NUM_ITEMS = 60
DIM = 32


def _sessions(seed, n=40, max_len=12):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, NUM_ITEMS, size=int(rng.integers(2, max_len))))
            for _ in range(n)]


PAPER = dict(order=3, extra=True, fusion=True)


def make_pair(seed=0, num_items=NUM_ITEMS, dim=DIM, **kw):
    """(JAX model, its projected params, the port's model carrying them);
    ``kw`` sets order, reducer, extra, fusion."""
    kw = dict(dict(order=1), **kw)
    jm = JMSGIFSR(num_items=num_items, embedding_dim=dim, num_layers=1,
                  **kw)
    jp, _ = jm.init(jax.random.PRNGKey(seed))
    jp = jm.project_params(jp)
    tm = MSGIFSR(num_items, dim, 1, **kw)
    tm.load_state_dict(params_from_jax(jax.device_get(jp)))
    return jm, jp, tm


def _batches(split_len, order=1):
    sess = _sessions(1)
    jl = JLoader(sess, "ccs", 24, 11, use_native=False, prefetch=0,
                 split_len=split_len, order=order)
    tl = TLoader(sess, "ccs", 24, 11, prefetch=0, split_len=split_len,
                 device="cpu", order=order)
    return next(iter(jl)), next(iter(tl))


def test_convert_covers_every_parameter():
    _convert_covers_every_parameter(dict())


@pytest.mark.parametrize("reducer", ["mean", "max", "concat"])
def test_convert_covers_every_paper_head_parameter(reducer):
    _convert_covers_every_parameter(dict(PAPER, reducer=reducer))


def _convert_covers_every_parameter(kw):
    _, jp, tm = make_pair(**kw)
    sd = params_from_jax(jax.device_get(jp))
    params = dict(tm.named_parameters())
    assert set(sd) == set(params)
    assert all(sd[k].shape == params[k].shape for k in sd)
    assert sd["embedding"].shape == (512, DIM)      # padded table
    n_ws = 2 if kw.get("reducer") == "concat" else 0
    assert sum(k.startswith("expander.Ws.") for k in sd) == 2 * n_ws


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

    sr, table = tm.head(tb, training=True, seeds=None)
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
    """The same seed source gives the same output, another seed or the
    next step's counter another one."""
    _, _, tm = make_pair(seed=4)
    tm.feat_drop = 0.5
    _, tb = _batches((4, 8))
    a, _ = tm.head(tb, training=True, seeds=SeedSource(1))
    b, _ = tm.head(tb, training=True, seeds=SeedSource(1))
    c, _ = tm.head(tb, training=True, seeds=SeedSource(2))
    d, _ = tm.head(tb, training=False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, d)
    step = SeedSource(1)
    step.begin_step()
    e, _ = tm.head(tb, training=True, seeds=step)
    assert not torch.equal(a, e)


def _grads_match(tm, gj):
    want = params_from_jax(jax.device_get(gj))
    for name, p in tm.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("split_len", [None, (4, 8)])
@pytest.mark.parametrize("reducer", ["mean", "max", "concat"])
def test_paper_head_loss_and_grads_match_jax(reducer, split_len):
    """Order 3, REnorm and fusion: head_multi's outputs, the fused
    multi-order loss and every parameter's gradient."""
    jm, jp, tm = make_pair(seed=6, reducer=reducer, **PAPER)
    jb, tb = _batches(split_len, order=3)
    kw = dict(scale=12.0, num_items=NUM_ITEMS, normalize_table=True,
              extra=True, fusion=True)

    def jloss(p):
        sr, table, phi, alpha, iids, _ = jm.head_multi(p, {}, jb,
                                                       training=True,
                                                       rng=None)
        loss = jxm.multi_nll_loss(sr, table, jb.labels, jb.valid, iids, phi,
                                  alpha, use_pallas=False, **kw)
        return loss, (sr, phi, iids)

    (lj, (srj, phij, iidj)), gj = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jp)
    sr, table, phi, alpha, iids = tm.head_multi(tb, training=True)
    lt = txm.multi_nll_loss(sr, table, tb.labels, tb.valid, iids, phi,
                            alpha, **kw)
    lt.backward()

    np.testing.assert_array_equal(iids.numpy(), np.asarray(iidj))
    np.testing.assert_allclose(sr.detach().numpy(), np.asarray(srj),
                               atol=ATOL)
    np.testing.assert_allclose(phi.detach().numpy(), np.asarray(phij),
                               atol=ATOL)
    np.testing.assert_allclose(float(lt.detach()), float(lj), atol=ATOL)
    _grads_match(tm, gj)


@pytest.mark.parametrize("extra,fusion", [(True, True), (True, False),
                                          (False, True), (False, False)])
def test_apply_matches_jax(extra, fusion):
    """Eval log-probabilities of the materialised head at order 3."""
    jm, jp, tm = make_pair(seed=7, order=3, extra=extra, fusion=fusion)
    jb, tb = _batches((4, 8), order=3)
    want = jax.jit(lambda p: jm.apply(p, {}, jb, training=False,
                                      rng=None)[0])(jp)
    with torch.no_grad():
        got = tm.apply(tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert tm.has_plain_head == jm.has_plain_head
    assert tm.has_multi_head == jm.has_multi_head


def test_session_iids_pad_the_short_tier():
    """A SplitBatch's narrower tier pads its iid rows with -1 to the wider
    tier's width; each row lists its session's distinct items."""
    _, _, tm = make_pair(order=3, extra=True, fusion=True)
    _, tb = _batches((4, 8), order=3)
    iids = tm._session_iids(tb)
    B = tb.labels.shape[0]
    assert iids.dtype == torch.int32 and iids.shape[0] == B
    assert (iids[:, -1] == -1).any()          # some row is padded
    mask = tm._session_item_mask(tb)
    for row in range(B):
        ids = iids[row][iids[row] >= 0].long()
        assert torch.equal(torch.sort(ids).values,
                           torch.nonzero(mask[row]).flatten())


@pytest.mark.parametrize("reducer", ["mean", "concat"])
def test_reset_draws_every_parameter_of_the_paper_head(reducer):
    """reset_msgifsr walks named_parameters(), so the expander's GRUs and
    linears get the U(-1/sqrt(d), 1/sqrt(d)) regime too (JAX init.py:43-52
    with ``bound``); alpha is one-hot and beta 1."""
    tm = MSGIFSR(NUM_ITEMS, DIM, 1, reducer=reducer, **PAPER)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    bound = 1.0 / DIM ** 0.5
    names = {n for n, _ in tm.named_parameters()}
    assert {"expander.grus.0.w_ih", "expander.grus.1.b_hh"} <= names
    assert ("expander.Ws.1.weight" in names) == (reducer == "concat")
    for name, p in tm.named_parameters():
        if name in ("alpha", "beta"):
            continue
        p = p.detach()
        assert float(p.abs().max()) <= bound, name
        assert float(p.std()) > 0.3 * bound, name
    assert tm.alpha.tolist() == [1.0, 0.0, 0.0] and tm.beta.item() == 1.0
