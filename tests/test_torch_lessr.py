"""LESSR's own pieces in the port against the JAX package, on the CPU,
from numpy-seeded inputs at small width, dropout off:

* ``masked_mailbox_gru``: rows advance only on real slots, rows of
  degree zero return 0 (atol 5e-5);
* the masked BatchNorm: ``bn_batch_moments`` over two parts, the
  normalisation in train and eval, and the running buffers updated in
  place with momentum 0.1 and the unbiased variance (atol 1e-6);
* ``eopa_apply``, ``sgat_apply`` and ``attn_readout_apply`` with their
  BatchNorm, in train and eval (atol 5e-5);
* the model's BatchNorm buffers after a training forward, flat and on
  the nested SplitBatch, against the JAX ``new_state`` (atol 1e-6); eval
  reads them and changes nothing;
* torch's per-module init regime from the generator alone;
* a checkpoint resume equal to the uninterrupted run with atol 0, the
  buffers included.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionrec_tpu.models import layers as jl
from sessionrec_tpu.ops import gru as jg
from sessionrec_tpu_torch.convert import params_from_jax, state_from_jax
from sessionrec_tpu_torch.data.io import read_dataset
from sessionrec_tpu_torch.data.loader import BatchLoader
from sessionrec_tpu_torch.models import LESSR
from sessionrec_tpu_torch.models import layers as L
from sessionrec_tpu_torch.ops import gru as tg
from sessionrec_tpu_torch.train.runner import TrainRunner
from sessionrec_tpu_torch.train.session import _CappedLoader
from sessionrec_tpu_torch.utils import checkpoint as ck
from test_torch_families import (NUM_ITEMS, _loaders, _perturb_bn,
                                 _sessions, head_vs_jax, make_family)

ATOL = 5e-5
BN_ATOL = 1e-6
DIM = 16
SAMPLE_DIR = pathlib.Path(__file__).resolve().parent.parent / "datasets" \
    / "sample"


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op CPU thread per test: the threaded ``index_put_`` of the
    embedding gather's backward adds in a varying order (the resume test
    needs the same bits twice), and the suite's parallel workers would
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lessr_batch(split_len=None, n=24):
    jl_, tl_ = _loaders("lessr", _sessions(1, n=n), n, split_len)
    return next(iter(jl_)), next(iter(tl_))


def _load(module, jp, js=None):
    module.load_state_dict({**params_from_jax(jax.device_get(jp)),
                            **state_from_jax(jax.device_get(js or {}))})
    return module


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, err_msg=what)


def test_masked_mailbox_gru_matches_jax():
    """Mailboxes of 0 to 6 real messages, left-aligned, in a depth of 7:
    rows of degree zero stay 0."""
    rng = np.random.default_rng(0)
    H, M, R = DIM, 7, 40
    jp = jax.device_get(jl.I.gru_params(jax.random.PRNGKey(0), DIM, H))
    tp = _load(L.GRU(DIM, H), jp)
    mail = rng.normal(size=(R, M, DIM)).astype(np.float32)
    deg = rng.integers(0, M, size=R)
    deg[:3] = 0
    mask = (np.arange(M)[None, :] < deg[:, None]).astype(np.float32)
    want = jg.masked_mailbox_gru(jp, jnp.asarray(mail), jnp.asarray(mask))
    got = tg.masked_mailbox_gru(tp, torch.from_numpy(mail),
                                torch.from_numpy(mask))
    _close(got, want)
    assert float(got[:3].detach().abs().max()) == 0.0
    # the same as torch's GRU over each row's real messages alone
    gru = torch.nn.GRU(DIM, H, batch_first=True)
    with torch.no_grad():
        for mine, theirs in (("w_ih", "weight_ih_l0"),
                             ("w_hh", "weight_hh_l0"),
                             ("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
            getattr(gru, theirs).copy_(getattr(tp, mine))
        for r in np.flatnonzero(deg):
            _, h = gru(torch.from_numpy(mail[r:r + 1, :deg[r]]))
            torch.testing.assert_close(got[r], h[0, 0], rtol=0, atol=1e-5)


def _bn_pair(seed, C):
    jp, js = jl.I.batchnorm_params(C)
    rng = np.random.default_rng(seed)
    jp, js = (_perturb_bn({"bn": t}, rng)["bn"] for t in (jp, js))
    return jp, js, _load(L.BatchNorm(C), jp, js)


def test_bn_batch_moments_over_two_parts_match_jax():
    rng = np.random.default_rng(1)
    parts = [(rng.normal(size=(5, 4, 6)).astype(np.float32),
              (rng.random((5, 4)) < 0.6).astype(np.float32)),
             (rng.normal(2, 3, size=(3, 7, 6)).astype(np.float32),
              (rng.random((3, 7)) < 0.6).astype(np.float32))]
    want = jl.bn_batch_moments([(jnp.asarray(x), jnp.asarray(m))
                                for x, m in parts])
    got = L.bn_batch_moments([(torch.from_numpy(x), torch.from_numpy(m))
                              for x, m in parts])
    for g, w in zip(got, want):
        _close(g, w, BN_ATOL)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("parts", [1, 2])
def test_masked_batchnorm_matches_jax(training, parts):
    """Train: the joint statistics of the parts' real rows normalise, and
    the buffers move once to ``0.9 * old + 0.1 * batch`` (the unbiased
    variance); eval: the running statistics normalise and nothing
    moves."""
    rng = np.random.default_rng(2)
    jp, js, tp = _bn_pair(3, 6)
    xs = [rng.normal(1, 2, size=(4, 5, 6)).astype(np.float32)
          for _ in range(parts)]
    masks = [(rng.random((4, 5)) < 0.7).astype(np.float32)
             for _ in range(parts)]
    jx_ = [jnp.asarray(x) for x in xs]
    jm_ = [jnp.asarray(m) for m in masks]
    moments = jl.bn_batch_moments(list(zip(jx_, jm_))) \
        if training and parts > 1 else None
    want = [jl.batchnorm_apply(jp, js, x, m, training=training,
                               moments=moments) for x, m in zip(jx_, jm_)]
    before = {n: t.clone() for n, t in tp.named_buffers()}
    got = L.batchnorm_parts(tp, [torch.from_numpy(x) for x in xs],
                            [torch.from_numpy(m) for m in masks],
                            training=training)
    for g, (w, _) in zip(got, want):
        _close(g, w)
    new_state = want[-1][1]
    for name in ("mean", "var"):
        _close(getattr(tp, name), new_state[name], BN_ATOL, name)
        assert torch.equal(getattr(tp, name), before[name]) != training


@pytest.mark.parametrize("layer", ["eopa", "sgat"])
@pytest.mark.parametrize("training", [True, False])
def test_eopa_and_sgat_match_jax(layer, training):
    """A layer of input width 2d (the second layer's, dense
    concatenation) with its BatchNorm: output and new state."""
    jb, tb = _lessr_batch()
    rng = np.random.default_rng(4)
    C = 2 * DIM
    if layer == "eopa":
        jp, js = jl.init_eopa(jax.random.PRNGKey(3), C, DIM)
        tp = L.EOPA(C, DIM)
    else:
        jp, js = jl.init_sgat(jax.random.PRNGKey(3), C, DIM, DIM)
        tp = L.SGAT(C, DIM, DIM)
    jp, js = _perturb_bn(jp, rng), _perturb_bn(js, rng)
    _load(tp, jp, js)
    feat = rng.normal(size=tb.node_iid.shape + (C,)).astype(np.float32)
    kw = dict(feat_drop=0.0, training=training)
    if layer == "eopa":
        want, ns = jl.eopa_apply(jp, js, jnp.asarray(feat), jb.node_mask,
                                 jb.mail_idx, jb.mail_mask, None, **kw)
    else:
        want, ns = jl.sgat_apply(jp, js, jnp.asarray(feat), jb.node_mask,
                                 jb.sc_adj, None, **kw)
    x = L.batchnorm_parts(tp.bn, [torch.from_numpy(feat)], [tb.node_mask],
                          training=training)[0]
    if layer == "eopa":
        got = L.eopa_apply(tp, x, tb.mail_idx, tb.mail_mask, None, **kw)
    else:
        got = L.sgat_apply(tp, x, tb.sc_adj, None, **kw)
    _close(got, want)
    _close(tp.bn.mean, ns["bn"]["mean"], BN_ATOL)
    _close(tp.bn.var, ns["bn"]["var"], BN_ATOL)


@pytest.mark.parametrize("training", [True, False])
def test_attn_readout_with_batchnorm_matches_jax(training):
    jb, tb = _lessr_batch()
    rng = np.random.default_rng(5)
    C = 4 * DIM
    jp, js = jl.init_attn_readout(jax.random.PRNGKey(4), C, DIM, DIM,
                                  bound=None, batch_norm=True,
                                  activation=True)
    jp, js = _perturb_bn(jp, rng), _perturb_bn(js, rng)
    tp = _load(L.AttnReadout(C, DIM, DIM, batch_norm=True, activation=True),
               jp, js)
    feat = rng.normal(size=tb.node_iid.shape + (C,)).astype(np.float32)
    kw = dict(feat_drop=0.0, training=training)
    want, ns = jl.attn_readout_apply(jp, js, jnp.asarray(feat), jb.node_mask,
                                     jb.last_idx, None, **kw)
    x = L.batchnorm_parts(tp.bn, [torch.from_numpy(feat)], [tb.node_mask],
                          training=training)[0]
    got = L.attn_readout_apply(tp, x, tb.node_mask, tb.last_idx, None, **kw)
    _close(got, want)
    _close(tp.bn.mean, ns["bn"]["mean"], BN_ATOL)


@pytest.mark.parametrize("split_len", [None, (4, 8)])
def test_batchnorm_state_after_a_training_forward_matches_jax(split_len):
    """Every running buffer after one training forward equals the JAX
    ``new_state`` to 1e-6: on the tiers (4, 8) each BatchNorm takes its
    statistics jointly over the three tiers and moves once."""
    (_, _, _, nsj), tm, _ = head_vs_jax("lessr", split_len)
    want = state_from_jax(jax.device_get(nsj))
    got = dict(tm.named_buffers())
    assert set(got) == set(want) and len(got) == 10
    for name, t in got.items():
        _close(t, want[name].numpy(), BN_ATOL, name)


def test_eval_reads_the_running_statistics():
    """An eval forward changes no buffer, and a row's session vector does
    not depend on the other rows of its batch."""
    _, _, _, tm = make_family("lessr", seed=6)
    _, tb = _lessr_batch()
    before = {n: t.clone() for n, t in tm.named_buffers()}
    with torch.no_grad():
        full, _ = tm.head(tb, training=False)
    for n, t in tm.named_buffers():
        assert torch.equal(t, before[n]), n
    half = type(tb)(**{f.name: getattr(tb, f.name)[:12]
                       for f in dataclasses.fields(tb)})
    with torch.no_grad():
        part, _ = tm.head(half, training=False)
    torch.testing.assert_close(part, full[:12], rtol=0, atol=1e-6)


def test_torch_default_regime():
    """Linear weight and bias U(+-1/sqrt(fan_in)), GRU U(+-1/sqrt(H)), the
    table N(0, 1) over its padded rows, PReLU 0.25, BatchNorm 1 / 0 and
    running 0 / 1; the generator alone draws (the global RNG is
    untouched), so one seed gives one model."""
    before = torch.random.get_rng_state()
    a, b = LESSR(NUM_ITEMS, DIM, 3), LESSR(NUM_ITEMS, DIM, 3)
    for m in (a, b):
        m.reset_parameters(torch.Generator().manual_seed(1))
    assert torch.equal(torch.random.get_rng_state(), before)
    for (n, p), (_, q) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(p, q), n
    sd = a.state_dict()
    emb = sd["embedding"]
    assert emb.shape == (512, DIM) and abs(float(emb.std()) - 1.0) < 0.05
    for name, fan in (("layers.0.fc_self.weight", DIM),
                      ("layers.1.fc_q.weight", 2 * DIM),
                      ("layers.1.fc_q.bias", 2 * DIM),
                      ("readout.fc_out.weight", 4 * DIM),
                      ("fc_sr.weight", 5 * DIM),
                      ("layers.2.gru.w_ih", 3 * DIM)):
        bound = fan ** -0.5
        assert float(sd[name].abs().max()) <= bound, name
        assert float(sd[name].abs().max()) > 0.8 * bound, name
    assert torch.equal(sd["layers.0.act.a"], torch.full((DIM,), 0.25))
    for bn in ("layers.0.bn", "layers.2.bn", "readout.bn", "bn"):
        assert float(sd[f"{bn}.scale"].min()) == 1.0
        assert float(sd[f"{bn}.bias"].abs().max()) == 0.0
        assert float(sd[f"{bn}.mean"].abs().max()) == 0.0
        assert float(sd[f"{bn}.var"].min()) == 1.0


def _runner(ckpt_dir, **kw):
    """LESSR at d=16 on 400 train and 200 test sessions of datasets/sample,
    batch 128, unroll 2, shuffled (6 batches of each epoch's order),
    dropout on."""
    train, test, num_items = read_dataset(SAMPLE_DIR)
    tl_ = _CappedLoader(BatchLoader(train[:400], "lessr", 128, 20,
                                    shuffle=True, seed=7, split_len=(4, 8)),
                        6)
    el = BatchLoader(test[:200], "lessr", 128, 20, split_len=(4, 8))
    return TrainRunner(LESSR(num_items, DIM, 3, feat_drop=0.2), tl_, el,
                       lr=1e-3, weight_decay=1e-4, patience=10,
                       eval_before_train=False, seed=3,
                       checkpointer=ck.Checkpointer(ckpt_dir), unroll=2,
                       device="cpu", lr_step_size=1, lr_gamma=0.5, **kw)


def test_resume_reproduces_uninterrupted_run(tmp_path):
    """Two epochs against one, then a fresh runner that resumes for the
    second: losses, parameters, buffers, Adam's state, the schedule and
    the dropout counter equal with atol 0."""
    full = _runner(tmp_path / "full")
    full.train(2, log_interval=10 ** 9)
    a = _runner(tmp_path / "ab")
    a.train(1, log_interval=10 ** 9)
    b = _runner(tmp_path / "ab")
    assert b.checkpointer.restore_latest(b)
    saved = torch.load(tmp_path / "ab" / "epoch_0000" / ck.PARAMS,
                       weights_only=True)
    assert "layers.0.bn.mean" in saved and "bn.var" in saved
    b.train(2, log_interval=10 ** 9)
    assert b.steps == full.steps
    np.testing.assert_array_equal(b.losses, full.losses[a.steps:])
    want, got = full.named_state(), b.named_state()
    assert set(got) == set(want)
    assert {n for n, _ in full.model.named_buffers()} <= set(got)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
    assert (b.max_mrr, b.max_hit, b.bad_counter) == \
        (full.max_mrr, full.max_hit, full.bad_counter)
    # serving restores the buffers with the parameters, from params.pt
    model = LESSR(full.model.num_items, DIM, 3)
    assert ck.Checkpointer(tmp_path / "full").restore_params(model)
    for name, t in full.model.state_dict().items():
        assert torch.equal(model.state_dict()[name], t), name
