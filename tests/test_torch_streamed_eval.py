"""Streamed eval in the port (``ops/streamed_eval.py``, the streamed paths
of ``train/runner.py:eval_ranks`` / ``eval_sums``) against the JAX
package's ``sessionrec_tpu/ops/streamed_eval.py`` and against the port's
own materialised path, on the CPU.

The JAX functions are plain XLA (``lax.scan``, a dot, ``lax.top_k``), so
they run as they are here.  Inputs come from numpy seeds; the catalog
pads (P = 300 rows, 295 real items, tile 128: the last of three slabs
half padding), and duplicated table rows make exact ties inside a slab
and across slab edges.  Ranks and ids must be equal to JAX's, ties
included; the multi head's top-k values agree to 1e-6 of each row's
largest value (the products and exponentials round in another order).
Unit-norm session vectors, as the models emit them.

Port-internal: streamed ranks equal the materialised ones for every
family, with both rank methods, on labels placed at ranks 1..20 and on
exact ties (a table row copied); the auto policy decides as JAX's; a
catalog cut into two shards by ``col_offset`` / ``n_valid`` gives the
whole catalog's ranks once the shards' label scores and counts are
combined (what a catalog-sharded caller will reduce across processes);
``axis_name`` takes a mesh, not a JAX axis name; ``eval_sums(streamed=True)`` equals the JAX
``make_eval_step(streamed=True)`` sums to 1e-6; ``topk_ranks`` takes
``lax.top_k``'s tie order; ``log_softmax_scores`` equals JAX's to 1e-5.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionrec_tpu.data.loader import BatchLoader as JLoader
from sessionrec_tpu.ops import scoring as jscoring
from sessionrec_tpu.ops import streamed_eval as jse
from sessionrec_tpu.train.runner import _auto_stream as j_auto_stream
from sessionrec_tpu.train.runner import make_eval_step
from sessionrec_tpu_torch.data.loader import BatchLoader as TLoader
from sessionrec_tpu_torch.models import LESSR, MSGIFSR, NISER, SRGNN
from sessionrec_tpu_torch.ops import scoring
from sessionrec_tpu_torch.ops import streamed_eval as se
from sessionrec_tpu_torch.train.runner import (_auto_stream, _streams,
                                               eval_ranks, eval_scores,
                                               eval_sums)
from test_torch_model import PAPER, make_pair

P, ITEMS, TILE, D, B, K = 300, 295, 128, 16, 8, 20
# rows whose copies make exact ties: (source, copy); 3 -> 150 and 290
# cross slab edges, 200 -> 120 ties a later slab with an earlier one
DUPS = ((3, 150), (3, 290), (200, 120), (7, 64))
LABELS = [3, 150, 290, 200, 120, 7, 64, 11]
CUTOFF = 20
VALUE_RTOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(seed, orders=None):
    """(table [P, D] with DUPS, labels [B], sr [B, D] or [B, K, D] near
    the labels' rows, iids [B, 5] -1 padded, phi [B, K, 2], alpha [K])."""
    rng = np.random.default_rng(seed)
    tab = (rng.standard_normal((P, D)) * 0.3).astype(np.float32)
    for src, dst in DUPS:
        tab[dst] = tab[src]
    labels = np.array(LABELS, np.int32)
    near = 2 * tab[labels] + 0.3 * rng.standard_normal((B, D))
    if orders is None:
        sr = _unit(near)
    else:
        sr = _unit(near[:, None, :]
                   + 0.1 * rng.standard_normal((B, orders, D)))
    iids = rng.integers(0, ITEMS, size=(B, 5)).astype(np.int32)
    iids[:, 3:] = -1
    iids[0, 0], iids[3, 1], iids[5, 0] = 3, 200, 64    # labels in session
    n = orders or 1
    phi = rng.random((B, n, 2)).astype(np.float32)
    phi /= phi.sum(-1, keepdims=True)
    alpha = rng.standard_normal(n).astype(np.float32)
    return tab, labels, sr, iids, phi, alpha


CDT = {None: (None, None), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("cdt", list(CDT))
def test_plain_rankers_match_jax(norm, cdt):
    tab, labels, sr, _, _, _ = _inputs(0)
    jc, tc = CDT[cdt]
    kw = dict(num_items=ITEMS, k=CUTOFF, normalize_table=norm, tile=TILE)
    jargs = (jnp.asarray(sr), jnp.asarray(tab), jnp.asarray(labels))
    targs = (torch.tensor(sr), torch.tensor(tab), torch.tensor(labels))
    want = np.asarray(jse.streamed_count_ranks(*jargs, compute_dtype=jc,
                                               **kw))
    assert (want > 0).sum() >= B - 1 and len(set(want.tolist())) > 2
    got = se.streamed_count_ranks(*targs, compute_dtype=tc, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    want = jse.streamed_topk_ranks(*jargs, compute_dtype=jc, scale=12.0,
                                   **kw)
    got = se.streamed_topk_ranks(*targs, compute_dtype=tc, scale=12.0, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# the (order, extra, fusion) grid of tests/test_streamed_eval.py:97/189,
# each with the table normalised in float32 and raw in bfloat16 compute
MULTI = [(o, e, f, norm, cdt) for o, e, f in ((2, True, False),
                                             (2, False, True),
                                             (3, True, True))
         for norm, cdt in ((True, None), (False, "bfloat16"))]


@pytest.mark.parametrize("order,extra,fusion,norm,cdt", MULTI)
def test_multi_rankers_match_jax(order, extra, fusion, norm, cdt):
    tab, labels, sr, iids, phi, alpha = _inputs(1, orders=order)
    jc, tc = CDT[cdt]
    kw = dict(num_items=ITEMS, extra=extra, fusion=fusion, k=CUTOFF,
              scale=12.0, normalize_table=norm, tile=TILE)
    jphi = jnp.asarray(phi) if extra else None
    tphi = torch.tensor(phi) if extra else None
    jv, ji = jse.streamed_multi_topk(
        jnp.asarray(sr), jnp.asarray(tab), jnp.asarray(iids), jphi,
        jnp.asarray(alpha), compute_dtype=jc, **kw)
    tv, ti = se.streamed_multi_topk(
        torch.tensor(sr), torch.tensor(tab), torch.tensor(iids), tphi,
        torch.tensor(alpha), compute_dtype=tc, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jv = np.asarray(jv)
    err = np.abs(tv.numpy() - jv).max(axis=1) / np.abs(jv).max(axis=1)
    assert err.max() <= VALUE_RTOL, err
    for jfn, tfn in ((jse.streamed_multi_count_ranks,
                      se.streamed_multi_count_ranks),
                     (jse.streamed_multi_topk_ranks,
                      se.streamed_multi_topk_ranks)):
        want = np.asarray(jfn(
            jnp.asarray(sr), jnp.asarray(tab), jnp.asarray(labels),
            jnp.asarray(iids), jphi, jnp.asarray(alpha), compute_dtype=jc,
            **kw))
        got = tfn(torch.tensor(sr), torch.tensor(tab), torch.tensor(labels),
                  torch.tensor(iids), tphi, torch.tensor(alpha),
                  compute_dtype=tc, **kw)
        assert (want > 0).sum() >= B - 1
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# port-internal: streamed against materialised, every family
# ---------------------------------------------------------------------------

FAMILY_ITEMS = 5000        # 5,120 rows padded: three 2,048-row slabs
FAMILIES = {
    "srgnn": lambda: SRGNN(FAMILY_ITEMS, 16, 1),
    "niser": lambda: NISER(FAMILY_ITEMS, 16, 1),
    "lessr": lambda: LESSR(FAMILY_ITEMS, 16, 2),
    "msgifsr_o1": lambda: MSGIFSR(FAMILY_ITEMS, 16, 1, order=1),
    "msgifsr_o3": lambda: MSGIFSR(FAMILY_ITEMS, 16, 1, order=3),
    "msgifsr_o3_paper": lambda: MSGIFSR(FAMILY_ITEMS, 16, 1, **PAPER),
}


def _family_case(name, seed=0):
    """(model, a flat batch of 16 rows) with exact ties: each of the first
    rows' top item copied into another table row, and labels at ranks 1,
    2, ... of the materialised scores, at the copies, and beyond."""
    model = FAMILIES[name]()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.eval()
    model.project_params()
    rng = np.random.default_rng(seed)
    sess = [list(map(int, rng.integers(0, FAMILY_ITEMS,
                                       size=int(rng.integers(2, 9)))))
            for _ in range(16)]
    batch = next(iter(TLoader(sess, model.graph_kind, 16, 9, prefetch=0,
                              device="cpu", order=getattr(model, "order",
                                                          1))))
    top = scoring.stable_topk(eval_scores(model, batch), 24)[1]
    copies = {}
    with torch.no_grad():
        for r in range(4):
            dst = FAMILY_ITEMS - 1 - r if r % 2 else 4000 + r
            model.embedding[dst] = model.embedding[top[r, r]]
            copies[r] = dst
    top = scoring.stable_topk(eval_scores(model, batch), 24)[1]
    labels = [copies.get(r, int(top[r, min(r, 23)])) for r in range(16)]
    labels[-1] = int(rng.integers(0, FAMILY_ITEMS))
    return model, dataclasses.replace(
        batch, labels=torch.tensor(labels, dtype=torch.int32))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_streamed_equals_materialised_for_each_family(name):
    model, batch = _family_case(name)
    ranks = {(s, m): eval_ranks(model, batch, CUTOFF, streamed=s,
                                rank_method=m)
             for s in (False, True) for m in ("count", "topk")}
    want = ranks[(False, "count")]
    assert int((want > 0).sum()) >= 12 and int(want.max()) >= 10
    for key, got in ranks.items():
        assert torch.equal(got, want), (key, got, want)


def test_auto_stream_policy_matches_jax():
    """The four cases of tests/test_streamed_eval.py:133-142, then JAX's
    decision on a grid of shapes."""
    assert not _auto_stream(512, 1 << 20)     # 2^29: materialise
    assert not _auto_stream(512, 37888)
    assert _auto_stream(512, 1 << 22)
    assert _auto_stream(2048, 1 << 20)
    for b in (1, 64, 511, 512, 1024, 2048):
        for p in (3584, 37888, (1 << 20) - 512, 1 << 20, 1 << 21):
            for rows in (1, 2, 3):
                assert _auto_stream(b, p, rows) == j_auto_stream(b, p, rows)
    # per model, the rows JAX's _eval_ranks counts: K for every MSGIFSR,
    # its plain head too (2^30 lies between 1 and 3 rows here)
    batch = types.SimpleNamespace(labels=torch.empty(100_000))
    for name, model in (("srgnn", FAMILIES["srgnn"]()),
                        ("o3", FAMILIES["msgifsr_o3"]()),
                        ("paper", FAMILIES["msgifsr_o3_paper"]())):
        assert _streams(model, batch, None) == (name != "srgnn"), name
        assert _streams(model, batch, False) is False


def test_two_catalog_shards_add_up_to_the_whole():
    """Each shard's label scores (NEG_INF where the shard lacks the label)
    combined, then each shard's counts summed: the whole catalog's ranks,
    exact ties included."""
    tab, labels, sr, _, _, _ = _inputs(2)
    t_sr, t_lab = torch.tensor(sr), torch.tensor(labels).to(torch.int64)
    whole = se.streamed_count_ranks(t_sr, torch.tensor(tab), t_lab,
                                    num_items=ITEMS, k=P, tile=TILE)
    cut = 150                                  # a shard edge between ties
    shards = []
    for start, rows in ((0, cut), (cut, P - cut)):
        shards.append((start, se._plain_ctx(
            t_sr, torch.tensor(tab[start:start + rows]),
            normalize_table=False, compute_dtype=None, tile=TILE,
            col_offset=start, n_valid=min(ITEMS - start, rows))))
    lvs = [se._label_scores(n, fn, t_lab, start, TILE)
           for start, (n, fn) in shards]
    owned = t_lab < cut
    lv = torch.where(owned, lvs[0], lvs[1])
    assert torch.all(torch.where(owned, lvs[1], lvs[0]) == se.NEG_INF)
    gt = eq = 0
    for _, (n, fn) in shards:
        g, e = se._counts(n, fn, t_lab, lv)
        gt, eq = gt + g, eq + e
    np.testing.assert_array_equal(se._clip_ranks(gt, eq, P).numpy(),
                                  whole.numpy())
    assert whole.tolist()[:3] == [1, 2, 3]     # rows 3 / 150 / 290 tie


def test_axis_name_raises():
    """``axis_name`` takes a ``parallel.mesh.Mesh`` (the model group that
    merges catalog shards); a JAX axis name means nothing here."""
    tab, labels, sr, iids, phi, alpha = _inputs(3, orders=2)
    with pytest.raises(TypeError, match="Mesh"):
        se.streamed_count_ranks(torch.tensor(sr[:, 0]), torch.tensor(tab),
                                torch.tensor(labels), num_items=ITEMS,
                                axis_name="model")
    with pytest.raises(TypeError, match="Mesh"):
        se.streamed_multi_count_ranks(
            torch.tensor(sr), torch.tensor(tab), torch.tensor(labels),
            torch.tensor(iids), torch.tensor(phi), torch.tensor(alpha),
            num_items=ITEMS, extra=True, fusion=True, axis_name="model")
    with pytest.raises(ValueError, match="rank_method"):
        scoring.use_count_ranks("sort")


@pytest.mark.parametrize("head", ["o1", "paper"])
def test_streamed_eval_sums_match_jax(head):
    """``eval_sums(streamed=True)`` against ``make_eval_step(streamed=True)``
    on a 5,000-item catalog (three slabs), the same converted parameters
    and batches: (hits, reciprocal-rank sum, rows) to 1e-6."""
    kw = PAPER if head == "paper" else {}
    order = kw.get("order", 1)
    jm, jp, tm = make_pair(seed=5, num_items=FAMILY_ITEMS, **kw)
    tm.eval()
    rng = np.random.default_rng(6)
    sess = [list(map(int, rng.integers(0, FAMILY_ITEMS,
                                       size=int(rng.integers(2, 9)))))
            for _ in range(40)]
    jb = next(iter(JLoader(sess, "ccs", 64, 9, use_native=False, prefetch=0,
                           order=order)))
    tb = next(iter(TLoader(sess, "ccs", 64, 9, prefetch=0, device="cpu",
                           order=order)))
    # labels at ranks 1, 2, ... (a random model ranks few real labels)
    top = scoring.stable_topk(eval_scores(tm, tb), 30)[1]
    labels = top[torch.arange(64), torch.arange(64) % 30].to(torch.int32)
    tb = dataclasses.replace(tb, labels=labels)
    jb = jb.replace(labels=jnp.asarray(labels.numpy()))
    want = np.array([float(x) for x in
                     make_eval_step(jm, CUTOFF, streamed=True)(jp, {}, jb)])
    got = eval_sums(tm, tb, CUTOFF, streamed=True).numpy()
    assert want[0] > 0 and want[2] > 50
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        eval_sums(tm, tb, CUTOFF, streamed=False).numpy(), want, rtol=0,
        atol=1e-6)


def test_topk_ranks_take_lax_top_k_ties():
    rng = np.random.default_rng(7)
    scores = rng.integers(-3, 4, size=(32, 60)).astype(np.float32)
    labels = rng.integers(0, 60, size=32).astype(np.int32)
    hits = 0
    for k in (1, 5, 20):
        want = np.asarray(jscoring.topk_ranks(jnp.asarray(scores),
                                              jnp.asarray(labels), k))
        got = scoring.topk_ranks(torch.tensor(scores), torch.tensor(labels),
                                 k)
        hits += int((want > 0).sum())
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            scoring.label_ranks_by_count(torch.tensor(scores),
                                         torch.tensor(labels), k).numpy(),
            want)
    assert hits > 10


def test_log_softmax_scores_match_jax():
    tab, _, sr, _, _, _ = _inputs(8)
    imask = np.arange(P) < ITEMS
    for cdt in CDT:
        jc, tc = CDT[cdt]
        want = np.asarray(jscoring.log_softmax_scores(
            jnp.asarray(sr), jnp.asarray(tab), jnp.asarray(imask), 12.0,
            compute_dtype=jc))
        got = scoring.log_softmax_scores(
            torch.tensor(sr), torch.tensor(tab), torch.tensor(imask), 12.0,
            compute_dtype=tc).numpy()
        np.testing.assert_allclose(got[:, :ITEMS], want[:, :ITEMS], rtol=0,
                                   atol=1e-5)
        assert (got[:, ITEMS:] < -1e29).all()
        assert (want[:, ITEMS:] < -1e29).all()
