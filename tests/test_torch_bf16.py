"""The port's mixed-precision mode (``table_dtype``, ``compute_dtype``)
against the JAX package's, on the CPU.

* ``optim.TableAdam``: float32 moments for a bf16 table, the second
  moment decays after warm-up, a float32 update (tests/test_optim.py),
  and three updates equal to the JAX chain's for a bf16 leaf (rtol
  1e-5, atol 1e-9 = 1e-6 lr: the two sum in another order).
* ``runner.apply_table_update`` against JAX ``_apply_updates_project``
  with the same rounding seed: the bf16 table bit for bit (MSGIFSR and
  LESSR, whose max-norm projection runs on the float32 sum); the
  in-place projection of a bf16 table bit for bit.
* The fused losses (``catalog_xent``, ``multi_nll_loss``) in all four
  combinations of table and compute type against the JAX Pallas kernels
  in interpret mode (as tests/test_xent.py runs them).  Tolerances, each
  a share of the reference's largest magnitude: float32 as
  tests/test_torch_xent.py; where a result is bf16 (d_table of a bf16
  table, d_sr of bf16 compute) one rounding may go the other way,
  ``BF16_ULP`` = 2^-7; a float32 table with bf16 compute runs float32
  products where JAX rounds dz and the table operand to bf16
  (ops/xent.py), ``MIXED`` = 2e-2.
* Each family's head, loss and gradients with a bf16 table and bf16
  compute: session vectors and loss to ``HEAD`` = 3e-2 of their largest
  magnitude (both packages round every bf16 op's output, XLA's CPU
  fusions sometimes once for a chain of ops); each gradient's error
  against the float32-compute gradients at most three times JAX's bf16
  error (or ``HEAD``, the larger).
* Three optimizer steps of the order-1 head and the paper head with a
  bf16 table: the first loss rtol 1e-5, the later ones rtol 2e-3; 99% of
  each parameter's elements within atol 1e-4 of JAX's (the table's plus
  two bf16 ulps), all within twice the rates' sum.  The rounding seeds
  differ, so a table element may take the other neighbour, and the next
  steps see tables that differ by it; Adam's early steps then move an
  element whose near-zero gradient changed sign the other way.
* Eval ranks and ``recommend`` ids in full bf16 at rows and positions
  whose JAX scores lie more than ``BF16_TIE`` apart; the masked
  BatchNorm in bf16 (one bf16 ulp); the CLI trains and serves in full
  bf16; JAX bf16 parameters carry across bit for bit.
"""

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
from sessionrec_tpu.models import MSGIFSR as JMSGIFSR
from sessionrec_tpu.models import NISER as JNISER
from sessionrec_tpu.models import SRGNN as JSRGNN
from sessionrec_tpu.ops import xent as jx
from sessionrec_tpu.ops import xent_multi as jxm
from sessionrec_tpu.train.optim import make_optimizer as j_make_optimizer
from sessionrec_tpu.train.runner import _apply_updates_project
from sessionrec_tpu_torch import cli, serving
from sessionrec_tpu_torch.convert import params_from_jax
from sessionrec_tpu_torch.data.loader import BatchLoader as TLoader
from sessionrec_tpu_torch.models import LESSR, MSGIFSR, NISER, SRGNN
from sessionrec_tpu_torch.ops import xent as tx
from sessionrec_tpu_torch.ops import xent_multi as txm
from sessionrec_tpu_torch.train import optim as t_optim
from sessionrec_tpu_torch.train.runner import apply_table_update

REPO = pathlib.Path(__file__).resolve().parent.parent
NUM_ITEMS = 60
DIM = 16
BF16_ULP = 2.0 ** -7
MIXED = 2e-2
HEAD = 3e-2
# eval and serving scores: the two packages' bf16 scores differ by up to
# 0.9% of a row's largest magnitude here; positions closer than this may
# swap
BF16_TIE = 1.5e-2
BF = dict(table_dtype="bfloat16", compute_dtype="bfloat16")
PAPER = dict(order=3, extra=True, fusion=True)
# (JAX class, port class, layers, options, batch kind)
MODELS = {
    "o1": (JMSGIFSR, MSGIFSR, 1, dict(order=1), "ccs"),
    "paper": (JMSGIFSR, MSGIFSR, 1, PAPER, "ccs"),
    "srgnn": (JSRGNN, SRGNN, 1, {}, "session"),
    "niser": (JNISER, NISER, 1, {}, "session"),
    "lessr": (JLESSR, LESSR, 3, {}, "lessr"),
}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op CPU thread per test: the suite's parallel workers
    would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sessions(seed, n=40, max_len=12):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, NUM_ITEMS,
                                       size=int(rng.integers(2, max_len)))))
            for _ in range(n)]


def make_model(case, seed=0, **dtypes):
    """(JAX model, its projected params and state, the port's model
    carrying them)."""
    jcls, tcls, layers, kw, _ = MODELS[case]
    jm = jcls(num_items=NUM_ITEMS, embedding_dim=DIM, num_layers=layers,
              **kw, **dtypes)
    jp, js = jm.init(jax.random.PRNGKey(seed))
    jp = jm.project_params(jp)
    tm = tcls(NUM_ITEMS, DIM, layers, **kw, **dtypes)
    tm.load_state_dict({**params_from_jax(jax.device_get(jp)),
                        **params_from_jax(jax.device_get(js))})
    return jm, jp, js, tm


def _batch(case, split_len=(4, 8), n=40, batch=24):
    kind, order = MODELS[case][4], MODELS[case][3].get("order", 1)
    sess = _sessions(1, n=n)
    jl = JLoader(sess, kind, batch, 11, use_native=False, prefetch=0,
                 split_len=split_len, order=order)
    tl = TLoader(sess, kind, batch, 11, prefetch=0, split_len=split_len,
                 device="cpu", order=order)
    return list(jl), list(tl)


def _rel_err(got, want):
    """max |got - want| over max |want|."""
    got = np.asarray(torch.as_tensor(got).float().detach().numpy()
                     if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# the table's optimizer
# ---------------------------------------------------------------------------

def test_table_adam_keeps_float32_moments():
    _, _, _, tm = make_model("o1", **BF)
    opt, sched, table_opt = t_optim.make_optimizer(tm, 1e-3, 1e-4, 10)
    assert table_opt is not None and table_opt.param is tm.embedding
    assert all(p is not tm.embedding for g in opt.param_groups
               for p in g["params"])
    assert {k: v.dtype for k, v in table_opt.state.items()} == dict.fromkeys(
        ("step", "exp_avg", "exp_avg_sq"), torch.float32)
    _, _, _, t32 = make_model("o1")
    assert t_optim.make_optimizer(t32, 1e-3, 1e-4, 10)[2] is None


def _table_opt(value, wd):
    p = torch.nn.Parameter(torch.full((4, 4), value, dtype=torch.bfloat16))
    return t_optim.TableAdam(p, torch.tensor(1e-3), wd)


def test_nu_decays_after_warm():
    """After one large gradient, zero gradients decay the second moment by
    b2 a step (a bf16 moment would freeze: the increment is below its half
    ulp)."""
    opt = _table_opt(0.5, 0.0)
    opt.param.grad = torch.full((4, 4), 1.0, dtype=torch.bfloat16)
    opt.update()
    nu0 = float(opt.state["exp_avg_sq"][0, 0])
    opt.param.grad = torch.zeros((4, 4), dtype=torch.bfloat16)
    for _ in range(3):
        opt.update()
    nu3 = float(opt.state["exp_avg_sq"][0, 0])
    assert np.isclose(nu3, nu0 * 0.999 ** 3, rtol=1e-5)
    assert nu3 < nu0


def test_updates_are_float32_and_match_jax():
    params = {"embedding": jnp.full((4, 4), 0.5, jnp.bfloat16)}
    tx_ = j_make_optimizer(params, lr=1e-3, weight_decay=1e-4,
                           steps_per_epoch=10)
    state = tx_.init(params)
    opt = _table_opt(0.5, 1e-4)
    rng = np.random.default_rng(0)
    for _ in range(3):
        g = rng.normal(size=(4, 4)).astype(np.float32)
        gj = {"embedding": jnp.asarray(g, jnp.bfloat16)}
        want, state = tx_.update(gj, state, params)
        opt.param.grad = torch.from_numpy(g).to(torch.bfloat16)
        got = opt.update()
        assert got.dtype == torch.float32
        assert want["embedding"].dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), _np(want["embedding"]),
                                   rtol=1e-5, atol=1e-9)
    assert float(opt.state["step"]) == 3.0


# ---------------------------------------------------------------------------
# the bf16 branch of _apply_updates_project
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["o1", "lessr"])
def test_table_update_is_bit_identical_to_jax(case):
    """Table + update in float32, the max-norm projection (rows pushed
    past norm 1 by the update; LESSR's N(0, 1) table starts past it),
    stochastic rounding with the JAX seed: every bit equal."""
    jm, jp, _, tm = make_model(case, table_dtype="bfloat16")
    rng = np.random.default_rng(1)
    upd = (rng.normal(size=jp["embedding"].shape) * 0.05).astype(np.float32)
    updates = jax.tree_util.tree_map(jnp.zeros_like, jp)
    updates["embedding"] = jnp.asarray(upd)
    key = jax.random.PRNGKey(7)
    want = _apply_updates_project(jm, jp, updates, key)["embedding"]
    seed = int(jax.random.key_data(jax.random.fold_in(key, 0x5EED))
               .ravel()[-1].astype(jnp.int32))
    apply_table_update(tm, torch.from_numpy(upd), seed)
    got = tm.embedding.detach().view(torch.int16).numpy().view(np.uint16)
    want = np.asarray(jax.lax.bitcast_convert_type(want, jnp.uint16))
    bad = np.argwhere(got != want)
    assert bad.size == 0, [(tuple(i), got[tuple(i)], want[tuple(i)])
                           for i in bad[:20]]
    norms = tm.embedding.detach().float().norm(dim=1)
    assert float(norms.max()) <= 1.0 + 2e-2


def test_renorm_of_a_bf16_table_matches_jax():
    """The in-place max-norm projection of a bf16 table (LESSR's N(0, 1)
    rows start past norm 1) takes its norms in float32 and scales in
    bf16, as the JAX ``renorm_rows``: every bit equal."""
    from sessionrec_tpu.models.lessr import renorm_rows as j_renorm
    from sessionrec_tpu_torch.models.lessr import renorm_rows
    x = np.random.default_rng(2).normal(size=(512, DIM)).astype(np.float32)
    want = j_renorm(jnp.asarray(x, jnp.bfloat16), 1.0)
    got = renorm_rows(torch.from_numpy(x).to(torch.bfloat16), 1.0)
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16),
        np.asarray(jax.lax.bitcast_convert_type(want, jnp.uint16)))


# ---------------------------------------------------------------------------
# the fused losses in the four dtype combinations
# ---------------------------------------------------------------------------

COMBOS = [("float32", "float32"), ("bfloat16", "bfloat16"),
          ("float32", "bfloat16"), ("bfloat16", "float32")]


def _grad_tol(table_dtype, compute_dtype, what):
    """The share of the reference's largest magnitude that ``what``
    ('d_sr' or 'd_table') is held to (see the module docstring)."""
    if table_dtype == "float32" and compute_dtype == "bfloat16":
        return MIXED
    bf16_out = (table_dtype if what == "d_table" else compute_dtype) \
        == "bfloat16"
    return BF16_ULP if bf16_out else 1e-5 if table_dtype == "float32" \
        else 2e-5


def _xent_inputs(seed=0, B=8, D=64, P=512, n=500):
    rng = np.random.default_rng(seed)
    sr = rng.normal(size=(B, D)).astype(np.float32)
    sr /= np.linalg.norm(sr, axis=-1, keepdims=True)
    table = (rng.uniform(-1, 1, size=(P, D)) / 8).astype(np.float32)
    labels = rng.integers(0, n, size=B).astype(np.int32)
    valid = np.ones(B, np.float32)
    valid[-1] = 0.0
    return sr, table, labels, valid


@pytest.mark.parametrize("table_dtype,compute_dtype", COMBOS)
def test_fused_loss_in_every_dtype_combination(table_dtype, compute_dtype):
    sr, table, labels, valid = _xent_inputs()
    kw = dict(scale=12.0, num_items=500, normalize_table=True)
    js_, jt = jnp.asarray(sr, compute_dtype), jnp.asarray(table, table_dtype)

    def jloss(s, t):
        return jx.fused_nll_loss(s, t, jnp.asarray(labels),
                                 jnp.asarray(valid), use_pallas=True, **kw)

    lj, (gsj, gtj) = jax.value_and_grad(jloss, argnums=(0, 1))(js_, jt)
    s = torch.from_numpy(_np(js_)).to(getattr(torch, compute_dtype)) \
        .requires_grad_(True)
    t = torch.from_numpy(_np(jt)).to(getattr(torch, table_dtype)) \
        .requires_grad_(True)
    lt = tx.fused_nll_loss(s, t, torch.from_numpy(labels),
                           torch.from_numpy(valid), **kw)
    lt.backward()
    assert s.grad.dtype == s.dtype and t.grad.dtype == t.dtype
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    for what, got, want in (("d_sr", s.grad, gsj), ("d_table", t.grad, gtj)):
        err = _rel_err(got, _np(want))
        assert err <= _grad_tol(table_dtype, compute_dtype, what), \
            (what, err)


@pytest.mark.parametrize("table_dtype,compute_dtype", COMBOS)
def test_multi_loss_in_every_dtype_combination(table_dtype, compute_dtype):
    rng = np.random.default_rng(3)
    K, B, D, P, n, N = 3, 8, 64, 512, 500, 6
    sr = rng.normal(size=(B, K, D)).astype(np.float32)
    sr /= np.linalg.norm(sr, axis=-1, keepdims=True)
    table = (rng.uniform(-1, 1, size=(P, D)) / 8).astype(np.float32)
    iids = rng.integers(0, n, size=(B, N)).astype(np.int32)
    iids[0] = -1
    labels = rng.integers(0, n, size=B).astype(np.int32)
    labels[::2] = np.maximum(iids[::2, 0], 0)
    valid = np.ones(B, np.float32)
    phi = rng.dirichlet([1.0, 1.0], size=(B, K)).astype(np.float32)
    alpha = rng.normal(size=K).astype(np.float32)
    kw = dict(scale=12.0, num_items=n, normalize_table=True, extra=True,
              fusion=True)
    js_, jt = jnp.asarray(sr, compute_dtype), jnp.asarray(table, table_dtype)

    def jloss(s, t):
        return jxm.multi_nll_loss(s, t, jnp.asarray(labels),
                                  jnp.asarray(valid), jnp.asarray(iids),
                                  jnp.asarray(phi), jnp.asarray(alpha),
                                  use_pallas=True, **kw)

    lj, (gsj, gtj) = jax.value_and_grad(jloss, argnums=(0, 1))(js_, jt)
    s = torch.from_numpy(_np(js_)).to(getattr(torch, compute_dtype)) \
        .requires_grad_(True)
    t = torch.from_numpy(_np(jt)).to(getattr(torch, table_dtype)) \
        .requires_grad_(True)
    lt = txm.multi_nll_loss(s, t, torch.from_numpy(labels),
                            torch.from_numpy(valid), torch.from_numpy(iids),
                            torch.from_numpy(phi), torch.from_numpy(alpha),
                            **kw)
    lt.backward()
    assert s.grad.dtype == s.dtype and t.grad.dtype == t.dtype
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    for what, got, want in (("d_sr", s.grad, gsj), ("d_table", t.grad, gtj)):
        err = _rel_err(got, _np(want))
        assert err <= _grad_tol(table_dtype, compute_dtype, what), \
            (what, err)


def test_kernels_take_one_type():
    """The plain versions refuse mixed operands, as the kernels do;
    ``catalog_xent`` maps them onto float32 first."""
    sr, table, labels, _ = _xent_inputs()
    s = torch.from_numpy(sr)
    t = torch.from_numpy(table).to(torch.bfloat16)
    lbl = torch.from_numpy(labels)
    with pytest.raises(TypeError, match="dtype"):
        tx.xent_fwd(s, t, lbl, 500, scale=1.0, normalize_table=False)
    assert tx.catalog_xent(s, t, lbl, scale=1.0,
                           num_items=500).dtype == torch.float32


# ---------------------------------------------------------------------------
# the models in bf16
# ---------------------------------------------------------------------------

def _jax_loss(jm, p, js, jb, training=True, use_pallas=False):
    kw = dict(scale=float(jm.scale) if jm.scale else 1.0,
              num_items=NUM_ITEMS, normalize_table=jm.table_norm,
              use_pallas=use_pallas)
    if jm.has_plain_head:
        sr, table, _ = jm.head(p, js, jb, training=training, rng=None)
        return jx.fused_nll_loss(sr, table, jb.labels, jb.valid, **kw), sr
    sr, table, phi, alpha, iids, _ = jm.head_multi(p, js, jb,
                                                   training=training,
                                                   rng=None)
    return jxm.multi_nll_loss(sr, table, jb.labels, jb.valid, iids, phi,
                              alpha, extra=jm.extra, fusion=jm.fusion,
                              **kw), sr


@pytest.mark.parametrize("case", ["o1", "niser"])
def test_recommend_in_bf16_matches_jax(case):
    jm, jp, js, tm = make_model(case, seed=3, **BF)
    order = MODELS[case][3].get("order", 1)
    sess = _sessions(2, n=23)
    K = 10
    want = list(jserving.recommend(jm, jp, js, sess, max_len=8, k=K + 1,
                                   batch_size=8, order=order))
    got = list(serving.recommend(tm, sess, max_len=8, k=K, batch_size=8,
                                 order=order))
    w_ids = np.array([ids for _, ids, _ in want])
    w_sc = np.array([v for _, _, v in want], np.float64)
    g_ids = np.array([ids for _, ids, _ in got])
    g_sc = np.array([v for _, _, v in got], np.float64)
    gap = np.abs(np.diff(w_sc, axis=1))
    left = np.concatenate([np.full((len(w_sc), 1), np.inf), gap[:, :-1]], 1)
    clear = (gap > BF16_TIE) & (left > BF16_TIE)
    np.testing.assert_array_equal(g_ids[clear], w_ids[:, :K][clear])
    assert _rel_err(g_sc, w_sc[:, :K]) <= HEAD
    assert clear.sum() >= 40


def test_convert_carries_bf16_leaves_bit_for_bit():
    _, jp, _, tm = make_model("o1", **BF)
    assert jp["embedding"].dtype == jnp.bfloat16
    got = tm.embedding.detach().view(torch.int16).numpy().view(np.uint16)
    want = np.asarray(jax.lax.bitcast_convert_type(jp["embedding"],
                                                   jnp.uint16))
    np.testing.assert_array_equal(got, want)


def test_table_draws_match_before_the_cast():
    """The init regimes draw the table in float32 and then cast: the bf16
    table is the float32 draw rounded to nearest."""
    for cls in (MSGIFSR, LESSR):
        a, b = cls(NUM_ITEMS, DIM, 1), cls(NUM_ITEMS, DIM, 1,
                                           table_dtype="bfloat16")
        a.reset_parameters(torch.Generator().manual_seed(0))
        b.reset_parameters(torch.Generator().manual_seed(0))
        assert b.embedding.dtype == torch.bfloat16
        assert torch.equal(a.embedding.detach().to(torch.bfloat16),
                           b.embedding.detach())


def test_cli_trains_and_serves_in_bf16_on_cpu(capsys, tmp_path):
    """``train`` in full bf16 writes a checkpoint whose table is bf16;
    ``predict`` with the same flags restores it and serves top-k lists."""
    flags = ["--model", "msgifsr", "--order", "1", "--device", "cpu",
             "--embedding-dim", "32", "--table-dtype", "bfloat16",
             "--compute-dtype", "bfloat16", "--checkpoint-dir",
             str(tmp_path / "ck"), "--dataset-dir",
             str(REPO / "datasets" / "sample")]
    cli.main(["train", *flags, "--max-epoch-batches", "2", "--epochs", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-2] == "MRR@20\tHR@20"
    mrr, hit = (float(x.rstrip("%")) for x in out[-1].split("\t"))
    assert 0.0 <= mrr <= hit <= 100.0
    saved = torch.load(tmp_path / "ck" / "epoch_0000" / "params.pt",
                       weights_only=True)
    assert saved["embedding"].dtype == torch.bfloat16
    (tmp_path / "s.txt").write_text("5,9,5\n31,7\n")
    cli.main(["predict", *flags, "--sessions-file", str(tmp_path / "s.txt"),
              "--k", "5", "--output", str(tmp_path / "recs.jsonl")])
    recs = [json.loads(line) for line in
            (tmp_path / "recs.jsonl").read_text().splitlines()]
    assert [r["session"] for r in recs] == [[5, 9, 5], [31, 7]]
    assert all(len(r["items"]) == 5 and r["scores"] == sorted(
        r["scores"], reverse=True) for r in recs)


def test_batchnorm_in_bf16_matches_jax():
    """The masked BatchNorm on bf16 input with bf16-cast parameters:
    float32 statistics, running buffers and normalisation, the output in
    bf16 (JAX ``batchnorm_apply``): outputs to one bf16 ulp, buffers to
    1e-6."""
    from sessionrec_tpu.models.layers import batchnorm_apply
    from sessionrec_tpu_torch.models import layers as L
    rng = np.random.default_rng(4)
    x = rng.normal(1.0, 2.0, size=(6, 9, DIM)).astype(np.float32)
    mask = (rng.uniform(size=(6, 9)) < 0.7).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, DIM).astype(np.float32)
    bias = rng.normal(0, 0.2, DIM).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    pj = {"scale": jnp.asarray(scale, jnp.bfloat16),
          "bias": jnp.asarray(bias, jnp.bfloat16)}
    sj = {"mean": jnp.zeros(DIM), "var": jnp.ones(DIM)}
    want, ns = batchnorm_apply(pj, sj, xb, jnp.asarray(mask), training=True)
    bn = L.BatchNorm(DIM)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    got = L.batchnorm_parts(L.cast_floats(bn, torch.bfloat16),
                            [torch.from_numpy(_np(xb)).to(torch.bfloat16)],
                            [torch.from_numpy(mask)], training=True)[0]
    assert got.dtype == torch.bfloat16
    w = _np(want)
    assert float(np.abs(got.detach().float().numpy() - w).max()) <= \
        BF16_ULP * float(np.abs(w).max())
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(ns["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(ns["var"]),
                               atol=1e-6)


def test_preset_takes_the_dtypes():
    from sessionrec_tpu_torch.models import build_model
    from sessionrec_tpu_torch.utils.config import preset
    cfg = preset("lessr", **BF)
    assert (cfg.model.table_dtype, cfg.model.compute_dtype) == \
        ("bfloat16", "bfloat16")
    m = build_model(cfg.model, NUM_ITEMS)
    assert m.embedding.dtype == torch.bfloat16 and m.cdt == torch.bfloat16
