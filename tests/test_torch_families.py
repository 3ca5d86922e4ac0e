"""SRGNN, NISER+ and LESSR in the port against the JAX package, on the
CPU, at small width (d 16, 2 or 3 layers) from numpy-seeded sessions:

* batches of both kinds ('session', 'lessr') from the Python and the C++
  builder, flat and in tiers (4, 8), ordered and shuffled: equal to the
  JAX package's leaf by leaf, exactly;
* ``srgnn_layer_apply`` and ``attn_readout_apply`` (no BatchNorm) against
  their JAX functions, dropout off, atol 5e-5;
* each family's session vectors, fused loss and the gradient of every
  parameter, on a flat batch and on the nested SplitBatch, from JAX
  parameters carried across with ``convert`` (atol 5e-5, as
  tests/test_torch_model.py), also with ``readout_on_embedding`` off and
  LESSR without BatchNorm;
* three optimizer steps (losses rtol 1e-4, parameters and LESSR's
  buffers atol 1e-5, as tests/test_torch_train.py);
* eval ranks on every row whose label score is clear of the others' by
  1e-5, and MRR@20 / HR@20 to 1e-6 (as tests/test_torch_eval.py);
* ``recommend``'s ids at every position clear of its neighbours by 1e-5
  and its scores to 1e-5 (as tests/test_torch_serving.py);
* the no-decay parameters against the JAX ``decay_mask``, the init
  regimes, the presets, and ``cli train`` then ``cli predict`` on the
  CPU.
LESSR's own pieces (EOPA, SGAT, the masked BatchNorm, the mailbox GRU,
its BatchNorm state and resume) are in tests/test_torch_lessr.py.
"""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionrec_tpu import serving as jserving
from sessionrec_tpu.data.loader import BatchLoader as JLoader
from sessionrec_tpu.models import LESSR as JLESSR
from sessionrec_tpu.models import NISER as JNISER
from sessionrec_tpu.models import SRGNN as JSRGNN
from sessionrec_tpu.models import layers as jl
from sessionrec_tpu.ops import xent as jx
from sessionrec_tpu.train.optim import decay_mask
from sessionrec_tpu.train.optim import make_optimizer as j_make_optimizer
from sessionrec_tpu.train.runner import (_eval_ranks, make_eval_step,
                                         make_train_step)
from sessionrec_tpu_torch import cli, serving
from sessionrec_tpu_torch.convert import params_from_jax, state_from_jax
from sessionrec_tpu_torch.data.loader import BatchLoader as TLoader
from sessionrec_tpu_torch.graph import batch as tbatch
from sessionrec_tpu_torch.models import LESSR, NISER, SRGNN, build_model
from sessionrec_tpu_torch.models import layers as L
from sessionrec_tpu_torch.ops import xent as tx
from sessionrec_tpu_torch.train import optim as t_optim
from sessionrec_tpu_torch.train.runner import (TrainRunner, eval_ranks,
                                               evaluate)
from sessionrec_tpu_torch.utils.config import preset
from test_torch_eval import _clear_rows
from test_torch_serving import _assert_same_leaves, _clear

REPO = pathlib.Path(__file__).resolve().parent.parent
ATOL = 5e-5
NUM_ITEMS = 60
DIM = 16
CUTOFF = 20
TIE = 1e-5
KIND = {"srgnn": "session", "niser": "session", "lessr": "lessr"}
# (JAX class, port class, layers, options) of each case
CASES = {
    "srgnn": (JSRGNN, SRGNN, 2, {}),
    "srgnn-gnn": (JSRGNN, SRGNN, 2, dict(readout_on_embedding=False)),
    "niser": (JNISER, NISER, 2, {}),
    "niser-gnn": (JNISER, NISER, 2, dict(readout_on_embedding=False)),
    "lessr": (JLESSR, LESSR, 3, {}),
    "lessr-nobn": (JLESSR, LESSR, 3, dict(batch_norm=False)),
}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op CPU thread per test: the suite's parallel workers
    would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sessions(seed, n=40, max_len=12, lo=1):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, NUM_ITEMS,
                                       size=int(rng.integers(lo, max_len)))))
            for _ in range(n)]


def _perturb_bn(tree, rng):
    """Random BatchNorm parameters or running statistics in a JAX tree, so
    that eval and the normalisation are not the identity."""
    if isinstance(tree, list):
        return [_perturb_bn(t, rng) for t in tree]
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "bn":
            out[k] = {n: jnp.asarray(
                rng.uniform(0.5, 1.5, np.shape(a)) if n in ("scale", "var")
                else rng.normal(0, 0.2, np.shape(a)), jnp.float32)
                for n, a in v.items()}
        else:
            out[k] = _perturb_bn(v, rng)
    return out


def make_family(case, seed=0, dim=DIM, feat_drop=0.0):
    """(JAX model, projected params, state, the port's model carrying
    both)."""
    jcls, tcls, layers, kw = CASES[case]
    jm = jcls(num_items=NUM_ITEMS, embedding_dim=dim, num_layers=layers,
              feat_drop=feat_drop, **kw)
    jp, js = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jp, js = _perturb_bn(jp, rng), _perturb_bn(js, rng)
    jp = jm.project_params(jp)
    tm = tcls(NUM_ITEMS, dim, layers, feat_drop=feat_drop, **kw)
    tm.load_state_dict(_state_dict(jp, js))
    return jm, jp, js, tm


def _state_dict(jp, js):
    return {**params_from_jax(jax.device_get(jp)),
            **state_from_jax(jax.device_get(js))}


def _loaders(case, sess, batch, split_len, **kw):
    kind = KIND[case.split("-")[0]]
    jl_ = JLoader(sess, kind, batch, 11, use_native=False, prefetch=0,
                  split_len=split_len, **kw)
    tl_ = TLoader(sess, kind, batch, 11, prefetch=0, split_len=split_len,
                  device="cpu", **kw)
    return jl_, tl_


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["session", "lessr"])
@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("split_len", [None, (4, 8)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_match_jax(kind, native, split_len, shuffle):
    """Two epochs of 128-row batches (the SRGNN/NISER presets' size) of
    sessions of 1 to 13 items at a node cap of 11 (longer prefixes keep
    their last items): every leaf equal, in the same example order."""
    sess = _sessions(4, n=120, max_len=14)
    kw = dict(shuffle=shuffle, seed=5, split_len=split_len)
    jl_ = JLoader(sess, kind, 128, 11, use_native=False, prefetch=0, **kw)
    tl_ = TLoader(sess, kind, 128, 11, use_native=native, prefetch=2, **kw)
    for epoch in range(2):
        jl_.set_epoch(epoch)
        tl_.set_epoch(epoch)
        jbs, tbs = list(jl_), list(tl_)
        assert len(jbs) == len(tbs) == len(tl_) > 1
        for jb, tb in zip(jbs, tbs):
            assert type(tb).__name__ == type(jb).__name__
            _assert_same_leaves(tb, jb)
    if split_len:
        blocks = tbatch.flatten_blocks(tbs[0])
        assert [b.node_iid.shape[1] for b in blocks] == [4, 8, 11]
        if kind == "lessr":
            assert [b.mail_idx.shape[2] for b in blocks] == [3, 7, 10]


def test_session_graph_edge_cases_match_jax():
    """A one-item session (the self-loop 0 -> 0), repeated items and
    pairs (count weights; duplicate mailbox messages in order), an empty
    tail of padding rows."""
    seqs = [[5], [3, 3], [1, 2, 1, 2], [7, 7, 7, 7, 7], [4, 9, 4, 9, 4, 9]]
    labels = list(range(5))
    from sessionrec_tpu.graph import builders as jb
    from sessionrec_tpu_torch.data import native_collate as nc
    from sessionrec_tpu_torch.graph import builders as tb
    for name in ("build_session_batch", "build_lessr_batch"):
        want = getattr(jb, name)(seqs, labels, 6, 8)
        for builder in (tb, nc):
            got = getattr(builder, name)(seqs, labels, 6, 8)
            assert list(got) == list(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, (name, k)
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    d = tb.build_session_batch(seqs, labels, 6, 8)
    assert d["adj"][0, 0, 0] == 1.0 and d["adj"][2].sum() == 3.0
    m = tb.build_lessr_batch(seqs, labels, 6, 8)
    assert m["mail_mask"][3, 0].sum() == 4.0        # 7 -> 7, four times


@pytest.mark.parametrize("name", ["build_session_batch", "build_lessr_batch"])
def test_native_builders_refuse_what_overflows(name):
    """The C builders index without bounds: more sequences than the batch,
    or a sequence longer than the node cap, raise before the call."""
    from sessionrec_tpu_torch.data import native_collate as nc
    build = getattr(nc, name)
    with pytest.raises(ValueError, match="batch of 2"):
        build([[1], [2], [3]], [0, 0, 0], 4, 2)
    with pytest.raises(ValueError, match="node cap 4"):
        build([[1, 2, 3, 4, 5]], [0], 4, 2)


# ---------------------------------------------------------------------------
# layers without BatchNorm
# ---------------------------------------------------------------------------

def _session_batch(split_len=None, n=24):
    sess = _sessions(1, n=n)
    jl_, tl_ = _loaders("srgnn", sess, n, split_len)
    return next(iter(jl_)), next(iter(tl_))


def test_srgnn_layer_matches_jax():
    jb, tb = _session_batch()
    rng = np.random.default_rng(2)
    jp = jl.init_srgnn_layer(jax.random.PRNGKey(1), DIM, bound=0.25)
    tp = L.SRGNNLayer(DIM)
    tp.load_state_dict(params_from_jax(jax.device_get(jp)))
    feat = rng.normal(size=tb.node_iid.shape + (DIM,)).astype(np.float32)
    want = jl.srgnn_layer_apply(jp, jnp.asarray(feat), jb.adj, None,
                                feat_drop=0.0, training=False)
    got = L.srgnn_layer_apply(tp, torch.from_numpy(feat), tb.adj, None,
                              feat_drop=0.0, training=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


@pytest.mark.parametrize("in_dim,act", [(DIM, False), (3 * DIM, True)])
def test_attn_readout_matches_jax(in_dim, act):
    """SRGNN's readout (in = out, no PReLU) and LESSR's shape of it
    (fc_out from a wider input, PReLU), without BatchNorm."""
    jb, tb = _session_batch()
    rng = np.random.default_rng(3)
    jp, _ = jl.init_attn_readout(jax.random.PRNGKey(2), in_dim, DIM, DIM,
                                 bound=None, activation=act)
    tp = L.AttnReadout(in_dim, DIM, DIM, activation=act)
    tp.load_state_dict(params_from_jax(jax.device_get(jp)))
    assert hasattr(tp, "fc_out") == (in_dim != DIM) == ("fc_out" in jp)
    feat = rng.normal(size=tb.node_iid.shape + (in_dim,)).astype(np.float32)
    want, _ = jl.attn_readout_apply(jp, {}, jnp.asarray(feat), jb.node_mask,
                                    jb.last_idx, None, feat_drop=0.0,
                                    training=False)
    got = L.attn_readout_apply(tp, torch.from_numpy(feat), tb.node_mask,
                               tb.last_idx, None, feat_drop=0.0,
                               training=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the heads: session vectors, fused loss, gradients
# ---------------------------------------------------------------------------

def _loss_kw(jm):
    return dict(scale=float(jm.scale) if jm.scale else 1.0,
                num_items=NUM_ITEMS, normalize_table=jm.table_norm)


def head_vs_jax(case, split_len, seed=3):
    """(JAX (loss, sr, grads, new state), port model after its forward and
    backward, its (loss, sr)) on the first 24-row batch."""
    jm, jp, js, tm = make_family(case, seed=seed)
    jb, tb = (next(iter(x)) for x in _loaders(case, _sessions(1), 24,
                                               split_len))

    def jloss(p):
        sr, table, ns = jm.head(p, js, jb, training=True, rng=None)
        loss = jx.fused_nll_loss(sr, table, jb.labels, jb.valid,
                                 use_pallas=False, **_loss_kw(jm))
        return loss, (sr, ns)

    (lj, (srj, nsj)), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jp)
    sr, table = tm.head(tb, training=True)
    lt = tx.fused_nll_loss(sr, table, tb.labels, tb.valid, **_loss_kw(jm))
    lt.backward()
    return (lj, srj, gj, nsj), tm, (lt, sr)


@pytest.mark.parametrize("split_len", [None, (4, 8)])
@pytest.mark.parametrize("case", list(CASES))
def test_head_loss_and_grads_match_jax(case, split_len):
    (lj, srj, gj, _), tm, (lt, sr) = head_vs_jax(case, split_len)
    np.testing.assert_allclose(sr.detach().numpy(), np.asarray(srj),
                               atol=ATOL)
    np.testing.assert_allclose(float(lt.detach()), float(lj), atol=ATOL)
    want = params_from_jax(jax.device_get(gj))
    assert set(want) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   atol=ATOL, err_msg=name)
    quirk = CASES[case][3].get("readout_on_embedding", True)
    if case.startswith(("srgnn", "niser")):
        # the readout reads the embedding: the GNN layers reach nothing
        gru = dict(tm.named_parameters())["layers.0.gru.w_ih"]
        assert (gru.grad is None) == quirk


@pytest.mark.parametrize("case", list(CASES))
def test_convert_covers_every_parameter_and_buffer(case):
    _, jp, js, tm = make_family(case)
    sd = _state_dict(jp, js)
    assert set(sd) == set(tm.state_dict())
    assert all(sd[k].shape == tm.state_dict()[k].shape for k in sd)
    assert sd["embedding"].shape == (512, DIM)       # padded table
    assert bool(dict(tm.named_buffers())) == (case == "lessr")


@pytest.mark.parametrize("case", ["srgnn", "niser", "lessr"])
def test_no_decay_parameters_follow_the_jax_mask(case):
    _, jp, _, tm = make_family(case)
    mask = params_from_jax(jax.tree_util.tree_map(
        lambda x: np.float32(x), decay_mask(jp)))
    want = {n for n, m in mask.items() if not bool(m)}
    got = {n for n, _ in tm.named_parameters() if not t_optim.decays(n)}
    assert got == want
    assert any(".bias" in n for n in got)
    if case == "lessr":
        assert {"bn.scale", "layers.0.act.a", "readout.bn.bias"} <= got


# ---------------------------------------------------------------------------
# training, eval, serving
# ---------------------------------------------------------------------------

STEPS = 3
LR, WD = 5e-3, 1e-4


@pytest.mark.parametrize("case", ["srgnn", "niser-gnn", "lessr"])
def test_three_steps_match_jax(case):
    """From the same converted parameters (and LESSR's state), with
    feat_drop 0 and the same tiered batches, three steps of the JAX step
    and the port's ``train_step``, with the StepLR drop on every step."""
    jm, jp, js, tm = make_family(case, seed=5)
    sess = _sessions(2, n=120, lo=2)
    jl_, tl_ = _loaders(case, sess, 32, (4, 8))
    jbs, tbs = list(jl_)[:STEPS], list(tl_)[:STEPS]
    start = _state_dict(jp, js)

    sched = dict(steps_per_epoch=1, lr_step_size=1, lr_gamma=0.5)
    tx_ = j_make_optimizer(jp, LR, WD, **sched)
    opt_state = tx_.init(jp)
    step = make_train_step(jm, tx_)
    jlosses = []
    for b in jbs:
        jp, js, opt_state, loss = step(jp, js, opt_state, b,
                                       jax.random.PRNGKey(0))
        jlosses.append(float(loss))

    runner = TrainRunner(tm, tbs[:1], [], lr=LR, weight_decay=WD,
                         device="cpu", lr_step_size=1, lr_gamma=0.5)
    tm.load_state_dict(start)        # the runner drew its own init
    tlosses = [float(runner.train_step(b)) for b in tbs]

    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    want = _state_dict(jp, js)
    for name, t in tm.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)


@functools.lru_cache(maxsize=None)
def _eval_case(case, split_len):
    jm, jp, js, tm = make_family(case, seed=11)
    jl_, tl_ = _loaders(case, _sessions(5, n=70, lo=2), 32, split_len)
    tm.eval()
    tm.project_params()              # the JAX eval step projects its params
    return jm, jp, js, tm, list(jl_), list(tl_)


EVAL_CASES = [(c, s) for c in ("srgnn", "niser", "lessr")
              for s in (None, (4, 8))]


def _jax_scores(jm, jp, js, batch):
    sr, table, _ = jm.head(jp, js, batch, training=False, rng=None)
    if jm.table_norm:
        table = jl.l2norm(table)
    logits = sr @ table.T
    imask = jnp.arange(table.shape[0]) < NUM_ITEMS
    return jnp.where(imask, logits, -jnp.inf)


@pytest.mark.parametrize("case,split_len", EVAL_CASES)
def test_eval_ranks_and_metrics_match_jax(case, split_len):
    jm, jp, js, tm, jbs, tbs = _eval_case(case, split_len)
    ranks = jax.jit(lambda p, s, b: _eval_ranks(jm, p, s, b, CUTOFF))
    scores = jax.jit(lambda p, s, b: _jax_scores(jm, p, s, b))
    rows = excluded = 0
    for jb, tb in zip(jbs, tbs):
        want = np.asarray(ranks(jp, js, jb))
        got = eval_ranks(tm, tb, CUTOFF).numpy()
        labels = np.asarray(jb.labels)
        clear = _clear_rows(np.asarray(scores(jp, js, jb)), labels)
        np.testing.assert_array_equal(got[clear], want[clear])
        rows += len(labels)
        excluded += int((~clear).sum())
    assert excluded <= rows // 100
    step = make_eval_step(jm, CUTOFF)
    hit = mrr = n = 0.0
    for jb in jbs:
        h, m, v = step(jp, js, jb)
        hit, mrr, n = hit + float(h), mrr + float(m), n + float(v)
    mrr_t, hit_t = evaluate(tm, tbs, CUTOFF)
    assert n > 100
    np.testing.assert_allclose(mrr_t, mrr / n, rtol=0, atol=1e-6)
    np.testing.assert_allclose(hit_t, hit / n, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["srgnn", "niser", "lessr"])
def test_recommend_matches_jax(case):
    jm, jp, js, tm = make_family(case, seed=3)
    sess = _sessions(2, n=23)
    K = 10
    want = list(jserving.recommend(jm, jp, js, sess, max_len=8, k=K + 1,
                                   batch_size=8))
    got = list(serving.recommend(tm, sess, max_len=8, k=K, batch_size=8))
    assert [s for s, _, _ in got] == sess
    w_ids = np.array([ids for _, ids, _ in want])
    w_scores = np.array([v for _, _, v in want], np.float64)
    g_ids = np.array([ids for _, ids, _ in got])
    g_scores = np.array([v for _, _, v in got], np.float64)
    clear = _clear(w_scores)
    np.testing.assert_array_equal(g_ids[clear], w_ids[:, :K][clear])
    np.testing.assert_allclose(g_scores, w_scores[:, :K], rtol=0, atol=TIE)
    assert clear.mean() > 0.9


# ---------------------------------------------------------------------------
# init, config, CLI
# ---------------------------------------------------------------------------

def test_uniform_regime_and_the_global_rng():
    """SRGNN and NISER: every parameter U(-1/sqrt(d), 1/sqrt(d)) from the
    generator; building and resetting a model draws nothing from the
    global RNG; the same generator seed gives the same parameters."""
    before = torch.random.get_rng_state()
    for cls in (SRGNN, NISER):
        a, b = cls(NUM_ITEMS, DIM, 2), cls(NUM_ITEMS, DIM, 2)
        a.reset_parameters(torch.Generator().manual_seed(0))
        b.reset_parameters(torch.Generator().manual_seed(0))
        bound = 1.0 / DIM ** 0.5
        for (name, p), (_, q) in zip(a.named_parameters(),
                                     b.named_parameters()):
            p = p.detach()
            assert torch.equal(p, q), name
            assert float(p.abs().max()) <= bound, name
            assert float(p.std()) > 0.3 * bound, name
    assert torch.equal(torch.random.get_rng_state(), before)


def test_presets_follow_the_reference_scripts():
    s, n, le = preset("srgnn"), preset("niser"), preset("lessr")
    for cfg in (s, n):
        assert (cfg.model.embedding_dim, cfg.model.num_layers,
                cfg.model.feat_drop) == (64, 2, 0.5)
        assert (cfg.data.batch_size, cfg.data.shuffle_train) == (128, True)
        assert cfg.train.patience == 2
    assert (le.model.embedding_dim, le.model.num_layers,
            le.model.feat_drop, le.model.batch_norm) == (32, 3, 0.2, True)
    assert (le.data.batch_size, le.data.shuffle_train) == (512, False)
    assert le.data.split_len == (4, 8) and le.train.unroll == 8
    m = build_model(preset("niser", norm=False, scale=6.0).model, 100)
    assert (m.norm, m.table_norm, m.scale) == (False, False, 6.0)
    assert not build_model(preset("srgnn", readout_on_embedding=False)
                           .model, 100).readout_on_embedding
    assert not build_model(preset("lessr", batch_norm=False).model,
                           100).batch_norm


@pytest.mark.parametrize("model", ["srgnn", "niser", "lessr"])
def test_cli_train_then_predict_on_cpu(tmp_path, capsys, model):
    ckpt = tmp_path / "ckpt"
    common = ["--model", model, "--device", "cpu", "--dataset-dir",
              str(REPO / "datasets" / "sample"), "--embedding-dim", "16",
              "--checkpoint-dir", str(ckpt)]
    cli.main(["train", *common, "--max-epoch-batches", "3", "--epochs", "1",
              "--unroll", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-2] == "MRR@20\tHR@20"
    mrr, hit = (float(x.rstrip("%")) for x in out[-1].split("\t"))
    assert 0.0 <= mrr <= hit <= 100.0
    sess_file = tmp_path / "sessions.txt"
    sess_file.write_text("5,9,5\n31,7\n")
    cli.main(["predict", *common, "--sessions-file", str(sess_file),
              "--k", "5", "--output", str(tmp_path / "recs.jsonl")])
    recs = [json.loads(line) for line in
            (tmp_path / "recs.jsonl").read_text().splitlines()]
    assert [r["session"] for r in recs] == [[5, 9, 5], [31, 7]]
    for r in recs:
        assert len(set(r["items"])) == 5
        assert r["scores"] == sorted(r["scores"], reverse=True)


def test_cli_no_norm():
    args = ["train", "--model", "niser", "--no-norm"]
    p = cli.argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd")
    cli._add_train_flags(sub.add_parser("train"))
    assert not cli.build_config(p.parse_args(args)).model.norm
    assert cli.build_config(p.parse_args(args[:3])).model.norm
