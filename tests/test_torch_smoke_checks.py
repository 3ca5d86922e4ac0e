"""chip_smoke.py's d_table check, on the CPU: each group of table rows is
held to its own scale, so a K2 that gets the softmax term wrong on rows
no label hits fails it, though those rows' gradients are orders of
magnitude below the labelled rows'.  The plain K2 stands in for the
kernel; a copy of its result with that term dropped is the mutant."""

import pytest
import torch

import chip_smoke as cs
from sessionrec_tpu_torch.ops import xent
from sessionrec_tpu_torch.ops.scoring import pad_catalog

N_ITEMS = 600
TOL = 1e-3                         # chip_smoke's float32 K2 tolerance


def _dtable(P, norm):
    sr, tab, labels, g = cs.make_inputs(torch, N_ITEMS, P, torch.float32,
                                        seed=1, dev="cpu")
    kw = dict(scale=cs.SCALE, normalize_table=norm)
    m, s, zl = xent._fwd_plain(sr, tab, labels, N_ITEMS, 0, **kw)
    lse = xent._finish_lse(m, s)
    _, dtab = xent._bwd_plain(g, sr, tab, labels, lse, N_ITEMS, 0, **kw)
    return dtab, labels


@pytest.mark.parametrize("P", [N_ITEMS, pad_catalog(N_ITEMS)])
@pytest.mark.parametrize("norm", [True, False])
def test_grouped_check_passes_the_plain_result(P, norm):
    dtab, labels = _dtable(P, norm)
    errs = cs.dtable_errors(torch, dtab.clone(), dtab, labels, N_ITEMS, TOL)
    assert {"labelled", "unlabelled", "zero_row", "large_row"} <= set(errs)
    assert ("padding" in errs) == (P > N_ITEMS)
    assert all(e == 0.0 for e, _ in errs.values())


@pytest.mark.parametrize("P", [N_ITEMS, pad_catalog(N_ITEMS)])
@pytest.mark.parametrize("norm", [True, False])
def test_grouped_check_fails_a_k2_without_the_softmax_term(P, norm):
    dtab, labels = _dtable(P, norm)
    groups = cs.dtable_groups(torch, labels, N_ITEMS, P)
    bad = dtab.clone()
    bad[groups["unlabelled"]] = 0.0
    errs = cs.dtable_errors(torch, bad, dtab, labels, N_ITEMS, TOL)
    assert errs["unlabelled"][0] > errs["unlabelled"][1]


def test_padding_rows_must_be_exactly_zero():
    P = pad_catalog(N_ITEMS)
    dtab, labels = _dtable(P, True)
    bad = dtab.clone()
    bad[-1, 0] = 1e-30
    errs = cs.dtable_errors(torch, bad, dtab, labels, N_ITEMS, TOL)
    assert errs["padding"][0] > errs["padding"][1] == 0.0


# K4 (xent_multi_bwd): rows hit only by session items carry p_in terms and
# the rows no label or session item hits carry only p_ex terms; each group
# is held to its own scale, so a K4 that drops either term fails.  The
# catalog is the path's: with 512 rows of up to 19 session items, a
# smaller one has no row that nothing hits.
M_ITEMS = cs.PATH_ITEMS

def _multi_dtable(P, norm, **drop):
    from sessionrec_tpu_torch.ops import xent_multi as xm
    sr3, tab, labels, iids, cot, lse = cs.make_multi_inputs(
        torch, xm, M_ITEMS, P, torch.float32, seed=2, norm=norm, dev="cpu")
    kw = dict(scale=cs.SCALE, normalize_table=norm)
    gz, gin, gex = cot
    gin = torch.zeros_like(gin) if drop.get("p_in") else gin
    gex = torch.zeros_like(gex) if drop.get("p_ex") else gex
    _, dtab = xm._bwd_plain(gz, gin, gex, sr3, tab, labels, iids, *lse,
                            M_ITEMS, 0, **kw)
    return dtab, labels, iids


@pytest.mark.parametrize("norm", [True, False])
def test_multi_grouped_check_passes_the_plain_result(norm):
    P = pad_catalog(M_ITEMS)
    dtab, labels, iids = _multi_dtable(P, norm)
    errs = cs.dtable_errors(torch, dtab.clone(), dtab, labels, M_ITEMS, TOL,
                            iids)
    assert set(errs) == {"labelled", "session", "unlabelled", "padding",
                         "zero_row", "large_row"}
    assert all(e == 0.0 for e, _ in errs.values())
    assert all(t > 0.0 for name, (_, t) in errs.items() if name != "padding")


@pytest.mark.parametrize("P", [M_ITEMS, pad_catalog(M_ITEMS)])
@pytest.mark.parametrize("norm", [True, False])
def test_multi_grouped_check_fails_a_k4_without_p_ex_on_other_rows(P, norm):
    dtab, labels, iids = _multi_dtable(P, norm)
    bad, _, _ = _multi_dtable(P, norm, p_ex=True)
    groups = cs.dtable_groups(torch, labels, M_ITEMS, P, iids)
    mutant = dtab.clone()
    mutant[groups["unlabelled"]] = bad[groups["unlabelled"]]
    assert float(bad[groups["unlabelled"]].abs().max()) == 0.0
    errs = cs.dtable_errors(torch, mutant, dtab, labels, M_ITEMS, TOL, iids)
    assert errs["unlabelled"][0] > errs["unlabelled"][1]


@pytest.mark.parametrize("norm", [True, False])
def test_multi_grouped_check_fails_a_k4_without_p_in_on_session_rows(norm):
    P = pad_catalog(M_ITEMS)
    dtab, labels, iids = _multi_dtable(P, norm)
    bad, _, _ = _multi_dtable(P, norm, p_in=True)
    groups = cs.dtable_groups(torch, labels, M_ITEMS, P, iids)
    mutant = dtab.clone()
    mutant[groups["session"]] = bad[groups["session"]]
    errs = cs.dtable_errors(torch, mutant, dtab, labels, M_ITEMS, TOL, iids)
    assert errs["session"][0] > errs["session"][1]


# K3's stats check: logits and their maxima held to their own scale, the
# sum-exps relatively, an empty partition's 0 exactly

def _stats():
    from sessionrec_tpu_torch.ops import xent_multi as xm
    sr3, tab, labels, iids, _, _ = cs.make_multi_inputs(
        torch, xm, M_ITEMS, pad_catalog(M_ITEMS), torch.float32, seed=3,
        dev="cpu")
    return xm._fwd_plain(sr3, tab, labels, iids, M_ITEMS, 0,
                         scale=cs.SCALE, normalize_table=True)


def test_stats_check_passes_the_plain_result():
    want = _stats()
    errs = cs.stats_errors(torch, [t.clone() for t in want], want, 1e-5)
    assert set(errs) == set(cs.STATS)
    assert all(e == 0.0 and t > 0.0 for e, t in errs.values())
    assert bool((want[1][:, 1] == 0.0).all())   # row 1: no session item


@pytest.mark.parametrize("stat,change", [
    ("s_in", lambda s: s * (1 + 1e-3)),      # a sum-exp 0.1% off
    ("s_in", lambda s: s + 1e-20),           # an empty partition not 0
    ("zl", lambda z: z - 1e-2),              # a label logit off
    ("m_ex", lambda m: m + 1e-2)])
def test_stats_check_fails_a_wrong_stat(stat, change):
    want = _stats()
    got = [t.clone() for t in want]
    i = cs.STATS.index(stat)
    got[i] = change(got[i])
    errs = cs.stats_errors(torch, got, want, 1e-5)
    assert errs[stat][0] > errs[stat][1]


# K2's split partials: d_table sums the row splits' partials of dz^T sr,
# d_sr the catalog splits' partials of dz t (ops/xent.py:_bwd_grid on one
# wave of 132 blocks).  A K2 that loses one split's partial must fail the
# d_table check or the d_sr check.

def _k2(P, norm):
    sr, tab, labels, g = cs.make_inputs(torch, N_ITEMS, P, torch.float32,
                                        seed=4, dev="cpu")
    kw = dict(scale=cs.SCALE, normalize_table=norm)
    m, s, zl = xent._fwd_plain(sr, tab, labels, N_ITEMS, 0, **kw)
    lse = xent._finish_lse(m, s)
    grid = xent._bwd_grid(cs.B, P, 132, 64)
    return (sr, tab, labels, g, lse, kw, grid,
            xent._bwd_plain(g, sr, tab, labels, lse, N_ITEMS, 0, **kw))


@pytest.mark.parametrize("P", [N_ITEMS, pad_catalog(N_ITEMS)])
@pytest.mark.parametrize("norm", [True, False])
def test_dtable_check_fails_a_k2_without_one_row_split(P, norm):
    sr, tab, labels, g, lse, kw, grid, (_, dtab) = _k2(P, norm)
    assert grid["t_split"] > 1
    rows = slice(64 * grid["t_per"], 64 * 2 * grid["t_per"])   # split 1
    g_rest = g.clone()
    g_rest[rows] = 0.0
    _, bad = xent._bwd_plain(g_rest, sr, tab, labels, lse, N_ITEMS, 0, **kw)
    errs = cs.dtable_errors(torch, bad, dtab, labels, N_ITEMS, TOL)
    assert any(e > t for e, t in errs.values())
    ok = cs.dtable_errors(torch, dtab.clone(), dtab, labels, N_ITEMS, TOL)
    assert all(e <= t for e, t in ok.values())


@pytest.mark.parametrize("P", [N_ITEMS, pad_catalog(N_ITEMS)])
@pytest.mark.parametrize("norm", [True, False])
def test_dsr_check_fails_a_k2_without_one_catalog_split(P, norm):
    sr, tab, labels, g, lse, kw, grid, (dsr, _) = _k2(P, norm)
    assert grid["s_split"] > 1
    a = 64 * grid["s_per"]                                        # split 1
    b = min(P, a + 64 * grid["s_per"])
    # the split's partial: the same function over its columns alone, as the
    # catalog-sharded path computes a shard's share
    part, _ = xent._bwd_plain(g, sr, tab[a:b], labels, lse, N_ITEMS, a,
                              **kw)
    assert float(part.abs().max()) > 0.0
    err, tol = cs.dsr_errors(dsr - part, dsr, TOL)
    assert err > tol
    assert cs.dsr_errors(dsr.clone(), dsr, TOL) == [0.0, tol]


# K1's split partials: each catalog split of its grid (ops/xent.py:
# _fwd_grid on one wave of 132 blocks) writes (m, s, zl) per row over its
# columns, and xent_fwd_merge combines them.  A K1 that loses one split's
# partial, or scores the table without dividing by its norms, must fail
# the forward check.

def _k1_merge(parts):
    """(loss, lse) from the splits' (m, s, zl), as xent_fwd_merge does."""
    m, s, zl = (torch.stack([p[q] for p in parts]) for q in range(3))
    ms = torch.clamp(m.amax(0), min=-1e30 * 0.5)
    sg = torch.sum(s * torch.exp(torch.clamp(m, min=-1e30) - ms), 0)
    lse = ms + torch.log(torch.clamp(sg, min=torch.finfo(torch.float32).tiny))
    return lse - zl.sum(0), lse


def _k1(P, seed=7):
    sr, tab, labels, _ = cs.make_inputs(torch, N_ITEMS, P, torch.float32,
                                        seed=seed, dev="cpu")
    kw = dict(scale=cs.SCALE, normalize_table=True)
    return sr, tab, labels, kw, xent.xent_fwd(sr, tab, labels, N_ITEMS, **kw)


@pytest.mark.parametrize("P", [N_ITEMS, pad_catalog(N_ITEMS)])
def test_fwd_check_fails_a_k1_without_one_catalog_split(P):
    sr, tab, labels, kw, want = _k1(P)
    grid = xent._fwd_grid(cs.B, P, 132, 64)
    assert grid["s_split"] > 1
    parts = []
    for sp in range(grid["s_split"]):
        a = 64 * grid["s_per"] * sp
        b = min(P, a + 64 * grid["s_per"])
        # K1 compares global columns: the split's table rows at offset a
        parts.append(xent._fwd_plain(sr, tab[a:b], labels, N_ITEMS, a, **kw))
    tol = cs.TOL[("fwd", "float32")]
    err, bound = cs.fwd_errors(_k1_merge(parts), want, tol)
    assert err <= bound
    # a split of padding rows alone carries no mass: drop live ones
    live = [sp for sp in range(grid["s_split"])
            if 64 * grid["s_per"] * sp < N_ITEMS]
    for lost in (live[0], live[1], live[-1]):
        err, bound = cs.fwd_errors(
            _k1_merge(parts[:lost] + parts[lost + 1:]), want, tol)
        assert err > bound


@pytest.mark.parametrize("P", [N_ITEMS, pad_catalog(N_ITEMS)])
def test_fwd_check_fails_a_k1_that_skips_the_norms(P):
    sr, tab, labels, kw, want = _k1(P, seed=8)
    raw = xent.xent_fwd(sr, tab, labels, N_ITEMS, scale=cs.SCALE,
                        normalize_table=False)
    err, bound = cs.fwd_errors(raw, want, cs.TOL[("fwd", "float32")])
    assert err > bound
    assert cs.fwd_errors(want, want, 1e-5) == [0.0, bound]


# K3's and K4's split partials: the same grids over the K * B rows (one
# wave of 132 blocks).  K4's d_table sums the row splits' partials, its
# d_sr and K3's stats the catalog splits'.  A K4 that loses one split's
# partial must fail the d_table or the d_sr check, a K3 that loses one
# catalog split's stats the stats check.

def _local_labels(labels, a, b):
    """Labels localised to the table rows [a, b), -1 outside, as the
    catalog-sharded path hands a shard its labels."""
    lab = labels.long() - a
    return torch.where((lab >= 0) & (lab < b - a), lab, -1).to(torch.int32)


def _k4(P, norm):
    from sessionrec_tpu_torch.ops import xent_multi as xm
    sr3, tab, labels, iids, cot, lse = cs.make_multi_inputs(
        torch, xm, M_ITEMS, P, torch.float32, seed=5, norm=norm, dev="cpu")
    kw = dict(scale=cs.SCALE, normalize_table=norm)
    grid = xent._bwd_grid(cs.K * cs.B, P, 132, 64)
    args = (sr3, tab, labels, iids, cot, lse, kw)
    return xm, args, grid, xm._bwd_plain(*cot, sr3, tab, labels, iids, *lse,
                                         M_ITEMS, 0, **kw)


@pytest.mark.parametrize("P", [M_ITEMS, pad_catalog(M_ITEMS)])
@pytest.mark.parametrize("norm", [True, False])
def test_dtable_check_fails_a_k4_without_one_row_split(P, norm):
    xm, (sr3, tab, labels, iids, cot, lse, kw), grid, (_, dtab) = _k4(P, norm)
    assert grid["t_split"] > 1
    rows = slice(64 * grid["t_per"], 64 * 2 * grid["t_per"])   # split 1
    cot_rest = []
    for c in cot:
        c = c.clone().reshape(-1)             # row k * B + b of the K * B
        c[rows] = 0.0
        cot_rest.append(c.reshape(cs.K, cs.B))
    _, bad = xm._bwd_plain(*cot_rest, sr3, tab, labels, iids, *lse, M_ITEMS,
                           0, **kw)
    errs = cs.dtable_errors(torch, bad, dtab, labels, M_ITEMS, TOL, iids)
    assert any(e > t for e, t in errs.values())
    ok = cs.dtable_errors(torch, dtab.clone(), dtab, labels, M_ITEMS, TOL,
                          iids)
    assert all(e <= t for e, t in ok.values())


@pytest.mark.parametrize("P", [M_ITEMS, pad_catalog(M_ITEMS)])
@pytest.mark.parametrize("norm", [True, False])
def test_dsr_check_fails_a_k4_without_one_catalog_split(P, norm):
    xm, (sr3, tab, labels, iids, cot, lse, kw), grid, (dsr, _) = _k4(P, norm)
    assert grid["s_split"] > 1
    a = 64 * grid["s_per"]                                        # split 1
    b = min(P, a + 64 * grid["s_per"])
    # the split's partial: the same function over its columns alone, as the
    # catalog-sharded path computes a shard's share
    part, _ = xm._bwd_plain(*cot, sr3, tab[a:b], _local_labels(labels, a, b),
                            iids, *lse, M_ITEMS - a, a, **kw)
    assert float(part.abs().max()) > 0.0
    err, tol = cs.dsr_errors(dsr - part, dsr, TOL)
    assert err > tol
    assert cs.dsr_errors(dsr.clone(), dsr, TOL) == [0.0, tol]


def _merge_stats(parts):
    """(m_in, s_in, m_ex, s_ex, zl) over the union of the parts' columns,
    as xent_multi_fwd_merge combines the catalog splits."""
    out = []
    for q in (0, 2):
        m = torch.stack([p[q] for p in parts])
        s = torch.stack([p[q + 1] for p in parts])
        mg = m.amax(0)
        ms = torch.clamp(mg, min=-1e30 * 0.5)
        out += [mg, torch.sum(s * torch.exp(m - ms), 0)]
    return out + [torch.stack([p[4] for p in parts]).sum(0)]


@pytest.mark.parametrize("P", [M_ITEMS, pad_catalog(M_ITEMS)])
def test_stats_check_fails_a_k3_without_one_catalog_split(P):
    from sessionrec_tpu_torch.ops import xent_multi as xm
    sr3, tab, labels, iids, _, _ = cs.make_multi_inputs(
        torch, xm, M_ITEMS, P, torch.float32, seed=6, dev="cpu")
    kw = dict(scale=cs.SCALE, normalize_table=True)
    want = xm._fwd_plain(sr3, tab, labels, iids, M_ITEMS, 0, **kw)
    grid = xent._bwd_grid(cs.K * cs.B, P, 132, 64)
    assert grid["s_split"] > 1
    parts = []
    for sp in range(grid["s_split"]):
        a = 64 * grid["s_per"] * sp
        b = min(P, a + 64 * grid["s_per"])
        parts.append(xm._fwd_plain(sr3, tab[a:b], _local_labels(labels, a, b),
                                   iids, M_ITEMS - a, a, **kw))
    merged = cs.stats_errors(torch, _merge_stats(parts), want, 1e-5)
    assert all(e <= t for e, t in merged.values())
    lost = cs.stats_errors(torch, _merge_stats(parts[:1] + parts[2:]), want,
                           1e-5)
    assert any(e > t for e, t in lost.values())


# The paths' launch check: each of the path's kernels once per real step
# and the other pair never, counted on the device (the eager launches plus
# each graph's captured launches times its replays, ``runner.launches``, or
# by kernel name in a trace).  A path that runs a kernel twice in a step,
# skips it, or runs the other pair must fail.

O1 = cs.PATHS["path"]["kernels"]


def _counts(**kw):
    return dict(dict(xent_fwd=40, xent_bwd=40, xent_multi_fwd=0,
                     xent_multi_bwd=0, embed_bwd=40), **kw)


def test_launch_check_passes_once_per_step():
    assert cs.launch_errors(_counts(), 40, O1) == {}
    paper = cs.PATHS["paper"]["kernels"]
    assert cs.launch_errors(_counts(xent_fwd=0, xent_bwd=0,
                                    xent_multi_fwd=40, xent_multi_bwd=40),
                            40, paper) == {}


@pytest.mark.parametrize("wrong,want", [
    (dict(xent_fwd=80), {"xent_fwd": [80, 40]}),            # twice a step
    (dict(xent_bwd=39), {"xent_bwd": [39, 40]}),            # one skipped
    (dict(xent_fwd=0), {"xent_fwd": [0, 40]}),              # never
    (dict(xent_multi_fwd=40), {"xent_multi_fwd": [40, 0]}),   # other pair
    (dict(embed_bwd=120), {"embed_bwd": [120, 40]})])  # a gather a tier
def test_launch_check_fails_a_wrong_count(wrong, want):
    assert cs.launch_errors(_counts(**wrong), 40, O1) == want


@pytest.mark.parametrize("name,levels", [("path", 1), ("paper", 3),
                                         ("lessr", 0)])
def test_step_ids_are_the_gathers_of_a_step(name, levels):
    """The embed phase's ids: every tier's levels (MSGIFSR) or node ids,
    shortest tier first, as the models gather them; their run profile."""
    from sessionrec_tpu_torch.graph.batch import flatten_blocks
    from sessionrec_tpu_torch.train.session import make_loaders
    cfg = cs.path_config(name, 0, "datasets/sample", dev="cpu",
                         batch_size=64)
    train, _, _, _ = make_loaders(cfg.data, cfg.model.name, cfg.model.order)
    batch = cs.first_batches(train, 1)[0].to("cpu")
    blocks = flatten_blocks(batch)
    ids = cs.step_ids(batch)
    want = ([lv.iid for b in blocks for lv in b.levels] if levels
            else [b.node_iid for b in blocks])
    assert len(ids) == 3 * max(levels, 1) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(ids, want))
    n, row0, rest = cs.run_profile(torch, ids)
    flat = torch.cat([i.reshape(-1) for i in ids])
    assert n == flat.numel() and row0 == int((flat == 0).sum()) > 0
    assert 0 < rest < row0


def test_device_launches_count_each_replay():
    """40 steps: 8 eager and 8 captured wrapper launches, then 4 replays
    of the 8-step graph; a graph whose step launched K1 twice shows."""
    from sessionrec_tpu_torch.train.runner import StepGraph

    def graph(fwd, bwd):
        return StepGraph(None, None, "train.8", replays=4,
                         counts={"xent.fwd": fwd, "xent.bwd": bwd})
    wrapped = _counts(xent_fwd=16, xent_bwd=16)
    assert cs.device_launches(wrapped, {8: graph(8, 8)}) == _counts()
    got = cs.device_launches(_counts(xent_fwd=24, xent_bwd=16),
                             {8: graph(16, 8)})
    assert cs.launch_errors(got, 40, O1) == {"xent_fwd": [72, 40]}


@pytest.mark.parametrize("name,want", [
    ("void xent_fwd_partial<float>(float const*, int)", "xent_fwd_partial"),
    ("void (anonymous namespace)::xent_bwd_dtable<__nv_bfloat16, true>(int)",
     "xent_bwd_dtable"),
    ("xent_bwd_dtable_reduce<float>", "xent_bwd_dtable_reduce"),
    ("void (anonymous namespace)::xent_bwd_dtable_tc<__nv_bfloat16, true>"
     "(float const*, int)", "xent_bwd_dtable_tc"),
    ("void at::native::vectorized_elementwise_kernel<4, F>(int, F)",
     "vectorized_elementwise_kernel")])
def test_trace_names_reduce_to_the_kernel(name, want):
    assert cs.kernel_base_name(name) == want


def test_trace_counts_the_slab_kernels_as_their_wrappers_launches():
    """Past 256 features a forward wrapper's main product is its slab
    kernel and a backward wrapper's once-a-call kernel its finish kernel;
    the trace counts each as the one-pass kernel is counted, bf16 apart,
    and neither the dz kernels (one a catalog chunk) nor the products K2
    and K4 share."""
    events = [("void (anonymous namespace)::xent_fwd_slab<float>(int)", 0, 1),
              ("void (anonymous namespace)::xent_bwd_finish_slab"
               "<__nv_bfloat16>(int)", 0, 1),
              ("void (anonymous namespace)::xent_bwd_dz_slab"
               "<__nv_bfloat16>(int)", 0, 1),
              ("void (anonymous namespace)::xent_slab_dtable"
               "<float>(int)", 0, 1),
              ("void (anonymous namespace)::xent_multi_fwd_slab<float>(int)",
               0, 1),
              ("void (anonymous namespace)::xent_multi_bwd_dtable"
               "<float, true>(int)", 0, 1),
              # bfloat16 on the tensor cores: K1's slab kernel keeps its
              # name, the products K2 and K4 share count nothing
              ("void (anonymous namespace)::xent_fwd_slab<__nv_bfloat16>"
               "(int)", 0, 1),
              ("void (anonymous namespace)::xent_slab_dtable_tc"
               "<__nv_bfloat16>(int)", 0, 1),
              ("void (anonymous namespace)::xent_slab_dsr_tc"
               "<__nv_bfloat16>(int)", 0, 1)]
    counts, bf16, n = cs.count_launches(events)
    assert counts == dict(xent_fwd=2, xent_bwd=1, xent_multi_fwd=1,
                          xent_multi_bwd=1, embed_bwd=0)
    assert bf16 == dict(xent_fwd=1, xent_bwd=1, xent_multi_fwd=0,
                        xent_multi_bwd=0, embed_bwd=0)
    assert n == 9


def test_trace_counts_the_tensor_core_kernels_as_their_wrappers_launches():
    """In bfloat16 up to 256 features K2's and K4's d_table products are
    xent_bwd_dtable_tc and xent_multi_bwd_dtable_tc, each counted as one
    launch of its wrapper's bfloat16 instantiation; K1's and K3's keep
    their partial kernels' names.  The d_sr products (xent_bwd_dsr_tc,
    xent_multi_bwd_dsr_tc) count nothing."""
    events = [("void (anonymous namespace)::xent_fwd_partial"
               "<__nv_bfloat16>(int)", 0, 1),
              ("void (anonymous namespace)::xent_bwd_dtable_tc"
               "<__nv_bfloat16, true>(int)", 0, 1),
              ("void (anonymous namespace)::xent_bwd_dsr_tc"
               "<__nv_bfloat16, true>(int)", 0, 1),
              ("void (anonymous namespace)::xent_multi_fwd_partial"
               "<__nv_bfloat16>(int)", 0, 1),
              ("void (anonymous namespace)::xent_multi_bwd_dtable_tc"
               "<__nv_bfloat16, true>(int)", 0, 1),
              ("void (anonymous namespace)::xent_multi_bwd_dsr_tc"
               "<__nv_bfloat16, true>(int)", 0, 1)]
    counts, bf16, n = cs.count_launches(events)
    want = dict(xent_fwd=1, xent_bwd=1, xent_multi_fwd=1, xent_multi_bwd=1,
                embed_bwd=0)
    assert counts == bf16 == want
    assert n == 6


def test_trace_counts_the_gathers_backward_by_its_rows_kernel():
    """The gather's backward launches its sort, embed_bwd_tiles and
    embed_bwd_rows once a call; the rows kernel counts the call."""
    events = [("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel"
               "<int>(int)", 0, 1),
              ("void (anonymous namespace)::embed_bwd_tiles<float, 4>"
               "(int)", 0, 1),
              ("void (anonymous namespace)::embed_bwd_rows<float, 4>(int)",
               0, 1),
              ("void (anonymous namespace)::embed_bwd_tiles"
               "<__nv_bfloat16, 4>(int)", 0, 1),
              ("void (anonymous namespace)::embed_bwd_rows"
               "<__nv_bfloat16, 4>(int)", 0, 1)]
    counts, bf16, n = cs.count_launches(events)
    assert (counts["embed_bwd"], bf16["embed_bwd"], n) == (2, 1, 5)
    assert sum(counts.values()) == 2


@pytest.mark.parametrize("kernel_sum,events,coverage,complete", [
    (0.99, 1.0, 0.99, True),           # the gaps between launches
    (0.9, 1.0, 0.9, True),             # at the share
    (0.2846, 0.9852, 0.2888754, False),  # a trace that lost records
    (1.2, 1.0, 1.2, False),            # more kernel time than the calls'
    (0.5, 0.0, 0.0, False)])           # no events time
def test_trace_coverage_flags_a_trace_that_lost_records(kernel_sum, events,
                                                        coverage, complete):
    got = cs.trace_coverage(kernel_sum, events)
    assert got["coverage"] == pytest.approx(coverage, abs=1e-6)
    assert got["complete"] is complete
    assert (got["kernel_sum_ms"], got["events_ms"]) == (kernel_sum, events)


@pytest.mark.parametrize("counts,complete", [
    ({"k2_dz": 30, "xent_slab_dtable": 10, "Memset (Device)": 10}, True),
    ({"xent_fwd_slab": 3, "xent_fwd_merge": 10}, False),    # records lost
    ({}, False),                                           # none at all
    ({"xent_fwd_slab": 20, "xent_fwd_merge": 20}, True)])  # 2 a call
def test_a_trace_missing_records_is_retraced(counts, complete):
    """kernel_ms traces again, held open longer, unless every kernel's
    records of 10 calls are a multiple of 10 (a chunked dz kernel launches
    once a chunk)."""
    events = [(name, 0.0, 1.0) for name, n in counts.items()
              for _ in range(n)]
    assert cs.records_complete(events, 10) is complete


# The launch lines' fields of K1's and K3's forward past 256 features:
# the slots queries' shared bytes and ring stages reach ``k1_launch`` and
# ``multi_launch``, beside the grid that two blocks an SM give.  The
# queries' numbers at D 512, float32, on 132 SMs stand in for the card
# (the last of each: the forward product is not on the tensor cores).

K1_SLOTS = (2, 132, 96, 0, 104448, 3, 0)
MULTI_SLOTS = (2, 1, 2, 132, 120, 128, 122, 0, 0, 0, 104448, 3, 0, 0)


class _Library:
    @staticmethod
    def srt_xent_bwd_tile():
        return 64

    @staticmethod
    def srt_xent_slabs(D):
        return -(-D // 256)

    srt_xent_multi_dz_slots = srt_xent_bwd_dz_slots = None


@pytest.fixture
def slots(monkeypatch):
    from sessionrec_tpu_torch.ops import xent_multi as xm
    monkeypatch.setattr(xent, "_library", lambda: _Library)
    monkeypatch.setattr(xm, "_library", lambda: _Library)
    monkeypatch.setattr(xent, "_fwd_attrs", lambda dev, D, dt: K1_SLOTS)
    monkeypatch.setattr(xm, "_attrs", lambda dev, D, dt: MULTI_SLOTS)
    monkeypatch.setattr(xent, "slots_query", lambda *a: (2, 92, 0))
    return xm


def test_k1_launch_line_carries_the_ring(slots):
    shape = xent.fwd_launch_shape(torch.zeros(512, 512), 3584)
    assert shape == dict(blocks=224, row_tiles=8, catalog_splits=28,
                         tiles_per_split=2, resident_per_sm=2, sms=132,
                         registers=96, local_bytes=0, smem_bytes=104448,
                         ring_stages=3, product="fma")


def test_k3_launch_line_carries_the_ring(slots):
    shape = slots.multi_launch_shape(torch.zeros(3, 512, 512), 3584)
    assert shape["k3"] == dict(blocks=240, catalog_splits=10,
                               resident_per_sm=2, smem_bytes=104448,
                               ring_stages=3, product="fma")
    assert shape["registers"]["fwd"] == 120 and shape["sms"] == 132
    assert shape["local_bytes"]["fwd"] == 0


# The launch lines name each product kernel's arithmetic, as the slots
# queries report it: up to 256 features bfloat16 runs on the tensor cores,
# float32 on the FMA pipes, K1 to K4 alike.  The queries' numbers at D 256
# on 132 SMs (two blocks an SM in bfloat16) stand in for the card.

def _d256_slots(monkeypatch, dtype):
    from sessionrec_tpu_torch.ops import xent_multi as xm
    tc = int(dtype == torch.bfloat16)
    per_sm = 1 + tc
    monkeypatch.setattr(xent, "_library", lambda: _Library)
    monkeypatch.setattr(xm, "_library", lambda: _Library)
    monkeypatch.setattr(xent, "_fwd_attrs", lambda dev, D, dt: (
        per_sm, 132, 80, 0, 101376, 2, tc))
    monkeypatch.setattr(xent, "_bwd_attrs", lambda dev, D, dt: (
        per_sm, per_sm, 132, 120, 120, 0, 0, tc))
    monkeypatch.setattr(xm, "_attrs", lambda dev, D, dt: (
        per_sm, per_sm, per_sm, 132, 80, 128, 122, 0, 0, 0, 101888, 2, tc,
        tc))
    return xm


@pytest.mark.parametrize("dtype,product", [(torch.bfloat16, "tensor_core"),
                                           (torch.float32, "fma")])
def test_k1_k2_launch_lines_name_the_product(monkeypatch, dtype, product):
    xm = _d256_slots(monkeypatch, dtype)
    sr = torch.zeros(512, 256, dtype=dtype)
    k1, k2 = xent.fwd_launch_shape(sr, 3584), xent.bwd_launch_shape(sr, 3584)
    assert k1["product"] == k2["product"] == product
    assert k1["resident_per_sm"] == k2["resident_per_sm"] == \
        (2 if product == "tensor_core" else 1)
    multi = xm.multi_launch_shape(sr.expand(3, 512, 256), 3584)
    assert multi["k3"]["product"] == product
    assert multi["k4"]["product"] == product


# K4's grid up to 256 features comes from its own product kernels' slots:
# in bfloat16 the tensor-core kernels' two blocks an SM (264 slots on 132
# SMs), in float32 the FMA kernels' one.  Over the paper path's 1,536 rows
# (24 row tiles) and 3,584 catalog rows (56 tiles): d_table 56 tiles x 4
# row splits of 6 row tiles, d_sr 24 row tiles x 10 catalog splits of 6
# tiles in bfloat16; 2 splits of 12 and 5 of 12 in float32.
@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, dict(t_split=4, t_per=6, s_split=10, s_per=6,
                          dtable_blocks=224, dsr_blocks=240, per_sm=2)),
    (torch.float32, dict(t_split=2, t_per=12, s_split=5, s_per=12,
                         dtable_blocks=112, dsr_blocks=120, per_sm=1))])
def test_k4_grid_follows_its_own_kernels_slots(monkeypatch, dtype, want):
    xm = _d256_slots(monkeypatch, dtype)
    grid = xm._grid(None, 3 * 512, 3584, 256, dtype, k4=True)
    assert {k: grid[k] for k in ("t_split", "t_per", "s_split", "s_per")} \
        == {k: want[k] for k in ("t_split", "t_per", "s_split", "s_per")}
    k4 = xm.multi_launch_shape(torch.zeros(3, 512, 256, dtype=dtype),
                               3584)["k4"]
    assert (k4["dtable_blocks"], k4["dsr_blocks"], k4["resident_per_sm"]) \
        == (want["dtable_blocks"], want["dsr_blocks"], want["per_sm"])
    assert k4["dtable_blocks"] <= 132 * want["per_sm"] >= k4["dsr_blocks"]


# The launch lines past 256 features: at D 512 the slots queries report
# K1's to K4's slab kernels on the tensor cores in bfloat16 (K1's ring of
# four 18,432-byte stages) and on the FMA pipes in float32 (three of
# 34,816), two blocks an SM in both; the numbers stand in for the card.

def _d512_slots(monkeypatch, dtype):
    from sessionrec_tpu_torch.ops import xent_multi as xm
    tc = int(dtype == torch.bfloat16)
    ring = (73728, 4) if tc else (104448, 3)
    monkeypatch.setattr(xent, "_library", lambda: _Library)
    monkeypatch.setattr(xm, "_library", lambda: _Library)
    monkeypatch.setattr(xent, "_fwd_attrs", lambda dev, D, dt: (
        2, 132, 96, 0, *ring, tc))
    monkeypatch.setattr(xent, "_bwd_attrs", lambda dev, D, dt: (
        2, 2, 132, 128, 128, 0, 0, tc))
    monkeypatch.setattr(xm, "_attrs", lambda dev, D, dt: (
        2, 2, 2, 132, 120, 128, 128, 0, 0, 0, ring[0] + 512, ring[1], tc,
        tc))
    monkeypatch.setattr(xent, "slots_query", lambda *a: (3, 96, 0))
    return xm


@pytest.mark.parametrize("dtype,product,stages", [
    (torch.bfloat16, "tensor_core", 4), (torch.float32, "fma", 3)])
def test_slab_launch_lines_name_the_product(monkeypatch, dtype, product,
                                            stages):
    xm = _d512_slots(monkeypatch, dtype)
    sr = torch.zeros(512, 512, dtype=dtype)
    k1, k2 = xent.fwd_launch_shape(sr, 3584), xent.bwd_launch_shape(sr, 3584)
    multi = xm.multi_launch_shape(sr.expand(3, 512, 512), 3584)
    assert k1["product"] == k2["product"] == multi["k3"]["product"] == \
        multi["k4"]["product"] == product
    assert k1["ring_stages"] == multi["k3"]["ring_stages"] == stages
    assert k2["slabs"] == multi["k4"]["slabs"] == 2
    assert k2["dz_resident_per_sm"] == multi["k4"]["dz_resident_per_sm"] == 3
    assert k2["registers"]["dz"] == 96 and k2["local_bytes"]["dz"] == 0


# The slab backward's plan at the north star (37,888 rows) with two
# resident product blocks an SM on 132 SMs (264 slots), D 512 (two slabs):
# one dz chunk; d_table's product 592 catalog tiles x 2 slabs, one row
# split (its tiles alone pass the slots: 4.48 waves); d_sr's rows x 2 slabs
# x catalog splits within one wave.  K2 over 512 rows, K4 over 3 x 512.
@pytest.mark.parametrize("rows,esz,want", [
    (512, 2, dict(dz_blocks=4736, dtable_blocks=1184, dsr_blocks=256,
                  chunks=1, row_splits=1, catalog_splits=16, dz_mib=37.0)),
    (1536, 2, dict(dz_blocks=14208, dtable_blocks=1184, dsr_blocks=240,
                   chunks=1, row_splits=1, catalog_splits=5, dz_mib=111.0)),
    (512, 4, dict(dz_blocks=4736, dtable_blocks=1184, dsr_blocks=256,
                  chunks=1, row_splits=1, catalog_splits=16, dz_mib=74.0))])
def test_slab_plan_at_the_north_star_with_two_blocks_an_sm(monkeypatch, rows,
                                                           esz, want):
    monkeypatch.setattr(xent, "_library", lambda: _Library)
    plan = xent.slab_bwd_plan(rows, 37888, esz, 264, 2)
    assert (plan["chunk"], plan["t_split"], plan["dsr_parts"]) == \
        (592, 1, want["catalog_splits"])
    shape = xent.slab_grid_shape(rows, 37888, esz, 2, 132, 2)
    assert shape == dict(want, slabs=2, resident_per_sm=2)
    assert shape["dsr_blocks"] <= 264 < shape["dtable_blocks"]


def test_o1_wide_bf16_is_o1_bf16_at_the_wide_width():
    """The bfloat16 wide path: o1_bf16's model (bfloat16 table and compute,
    K1/K2 once a step) at WIDE_D features, 16 steps."""
    spec = cs.LATE_PATHS["o1_wide_bf16"]
    assert spec["kernels"] == cs.PATHS["o1_bf16"]["kernels"] == cs.K12
    assert spec["dim"] == cs.WIDE_D == 512 and spec["steps"] == 16
    assert cs.is_bf16("o1_wide_bf16")
    assert cs.SHORT["o1_wide_bf16"] == "o1_wide_bf16"
    cfg = cs.path_config("o1_wide_bf16", 0, "datasets/sample", dev="cpu")
    base = cs.path_config("o1_bf16", 0, "datasets/sample", dev="cpu")
    assert cfg.model.embedding_dim == 512
    assert cfg.model.table_dtype == cfg.model.compute_dtype == "bfloat16"
    assert (cfg.model.order, cfg.data.batch_size) == \
        (base.model.order, base.data.batch_size) == (1, 512)


# Mutants of the tensor-core kernels' likeliest faults, in bfloat16 at
# widths whose k loop ends in a partial step of 16 (D 30, 100, 132): a K1
# or K2 whose k loop stops at round_down(D, 16), so the tail's features are
# never multiplied, and a K1 whose quad merge loses one lane's partial
# (lane 4 g + 3 holds columns 6 and 7 of every 8 of the tile, so those
# columns drop out of lse and the label's logit).  chip_smoke's bfloat16
# checks must fail each; the same arithmetic on all the logits passes them.

TAIL_DIMS = (30, 100, 132)
BF16_ITEMS, BF16_P = 600, 640


def _bf16_case(dim, seed=11):
    sr, tab, labels, g = cs.make_inputs(torch, BF16_ITEMS, BF16_P,
                                        torch.bfloat16, seed=seed, dev="cpu",
                                        rows=96, dim=dim)
    return sr, tab, labels, g, dict(scale=cs.SCALE, normalize_table=True)


def _k1_logits(sr, tab, keep):
    """K1's logits over the first ``keep`` features, each divided by its
    column's norm over all of them (xent_table_norms)."""
    t = tab.float()
    n = torch.clamp(torch.linalg.vector_norm(t, dim=1), min=1e-12)
    return cs.SCALE * (sr.float()[:, :keep] @ t[:, :keep].T) / n


def _k1_from_logits(z, labels, kept=None):
    """K1's (loss, lse) from its logits, the columns where ``kept`` is
    False left out of both."""
    col = torch.arange(z.shape[1])[None, :]
    live = col < BF16_ITEMS if kept is None else (col < BF16_ITEMS) & kept
    z = torch.where(live, z, -1e30)
    zl = torch.where(live & (col == labels.long()[:, None]), z, 0.0).sum(1)
    lse = torch.logsumexp(z, 1)
    return lse - zl, lse


def _k2_from_logits(z, g, sr, tab, labels, lse):
    """K2's (d_sr, d_table) from its logits z, normalised table (the
    arithmetic of ``xent._bwd_plain`` past the logits)."""
    that, tmm, n = xent._operand(tab, True)
    col = torch.arange(tab.shape[0])[None, :]
    p = torch.where(col < BF16_ITEMS, torch.exp(z - lse[:, None]), 0.0)
    onehot = (col == labels.long()[:, None]).float()
    dz = ((p - onehot) * (cs.SCALE * g)[:, None]).to(tab.dtype).float()
    gtab = dz.T @ sr.float()
    gdot = torch.sum(gtab * that, dim=1, keepdim=True)
    gtab = (gtab - gdot * that * (n > 1e-12).float()) / n
    return dz @ tmm, gtab.to(tab.dtype)


def _k2_fails(got, want, labels):
    tol = cs.TOL[("bwd", "bfloat16")]
    e_dsr, dsr_tol = cs.dsr_errors(got[0], want[0], tol)
    groups = cs.dtable_errors(torch, got[1], want[1], labels, BF16_ITEMS, tol)
    return e_dsr > dsr_tol or any(e > t for e, t in groups.values())


@pytest.mark.parametrize("dim", TAIL_DIMS)
def test_fwd_check_fails_a_k1_that_drops_the_k_tail(dim):
    sr, tab, labels, _, kw = _bf16_case(dim)
    want = xent.xent_fwd(sr, tab, labels, BF16_ITEMS, **kw)
    tol = cs.TOL[("fwd", "bfloat16")]
    full = _k1_from_logits(_k1_logits(sr, tab, dim), labels)
    err, bound = cs.fwd_errors(full, want, tol)
    assert err <= bound
    tail = _k1_from_logits(_k1_logits(sr, tab, dim // 16 * 16), labels)
    err, bound = cs.fwd_errors(tail, want, tol)
    assert err > bound


@pytest.mark.parametrize("dim", TAIL_DIMS)
def test_fwd_check_fails_a_k1_whose_quad_merge_loses_a_lane(dim):
    sr, tab, labels, _, kw = _bf16_case(dim, seed=12)
    want = xent.xent_fwd(sr, tab, labels, BF16_ITEMS, **kw)
    z = _k1_logits(sr, tab, dim)
    lost = torch.arange(BF16_P)[None, :] % 8 >= 6
    err, bound = cs.fwd_errors(_k1_from_logits(z, labels, ~lost), want,
                               cs.TOL[("fwd", "bfloat16")])
    assert err > bound


@pytest.mark.parametrize("dim", TAIL_DIMS)
def test_bwd_check_fails_a_k2_that_drops_the_k_tail(dim):
    sr, tab, labels, g, kw = _bf16_case(dim, seed=13)
    _, lse = xent.xent_fwd(sr, tab, labels, BF16_ITEMS, **kw)
    want = xent.xent_bwd(g, sr, tab, labels, lse, BF16_ITEMS, **kw)
    tmm = xent._operand(tab, True)[1]

    def logits(keep):
        return cs.SCALE * (sr.float()[:, :keep] @ tmm[:, :keep].T)

    assert not _k2_fails(_k2_from_logits(logits(dim), g, sr, tab, labels,
                                         lse), want, labels)
    assert _k2_fails(_k2_from_logits(logits(dim // 16 * 16), g, sr, tab,
                                     labels, lse), want, labels)


# K4's mutants on the tensor cores, in bfloat16 at the same widths, against
# chip_smoke's K4 checks (d_sr, and d_table by group with the session rows
# their own): a K4 whose k loop stops at round_down(D, 16); one whose dz
# epilogue gives both columns of a lane's pair (2 j, 2 j + 1) the first
# one's membership bit; one whose row fold takes every order's row inputs
# (gz, gin, gex, lse_in, lse_ex) from order 0.  The same arithmetic on all
# the logits, the right bits and rows passes them.

def _k4_case(dim, seed):
    from sessionrec_tpu_torch.ops import xent_multi as xm
    sr3, tab, labels, iids, cot, lse = cs.make_multi_inputs(
        torch, xm, BF16_ITEMS, BF16_P, torch.bfloat16, seed, dev="cpu",
        rows=96, dim=dim)
    want = xm.xent_multi_bwd(*cot, sr3, tab, labels, iids, *lse, BF16_ITEMS,
                             scale=cs.SCALE, normalize_table=True)
    return xm, sr3, tab, labels, iids, cot, lse, want


def _k4_from_logits(z, member, cot, lse, sr3, tab, labels):
    """K4's (d_sr, d_table) from its logits z [K, B, P] and membership
    [B, P], normalised table (the arithmetic of ``xent_multi._bwd_plain``
    past the logits)."""
    that, tmm, n = xent._operand(tab, True)
    col = torch.arange(tab.shape[0])
    live = (col < BF16_ITEMS)[None, None, :]
    onehot = (col[None, :] == labels.long()[:, None])[None].float()
    gz, gin, gex = (c[..., None] for c in cot)
    lin, lex = (torch.clamp(x, min=-1e30 * 0.5)[..., None] for x in lse)
    p_in = torch.where(member[None] & live, torch.exp(z - lin), 0.0)
    p_ex = torch.where(~member[None] & live, torch.exp(z - lex), 0.0)
    dz = ((gin * p_in + gex * p_ex + gz * onehot) * cs.SCALE) \
        .to(tab.dtype).float()
    K, B, D = sr3.shape
    gtab = dz.reshape(K * B, -1).T @ sr3.float().reshape(K * B, D)
    gdot = torch.sum(gtab * that, dim=1, keepdim=True)
    gtab = (gtab - gdot * that * (n > 1e-12).float()) / n
    return dz @ tmm, gtab.to(tab.dtype)


def _k4_fails(got, want, labels, iids):
    tol = cs.TOL[("bwd", "bfloat16")]
    e_dsr, dsr_tol = cs.dsr_errors(got[0], want[0], tol)
    groups = cs.dtable_errors(torch, got[1], want[1], labels, BF16_ITEMS,
                              tol, iids)
    return e_dsr > dsr_tol or any(e > t for e, t in groups.values())


def _k4_logits(sr3, tab, keep):
    tmm = xent._operand(tab, True)[1]
    return cs.SCALE * (sr3.float()[..., :keep] @ tmm[:, :keep].T)


@pytest.mark.parametrize("dim", TAIL_DIMS)
def test_bwd_check_fails_a_k4_that_drops_the_k_tail(dim):
    xm, sr3, tab, labels, iids, cot, lse, want = _k4_case(dim, 14)
    member = xm._member(iids, BF16_P, 0)
    full = _k4_from_logits(_k4_logits(sr3, tab, dim), member, cot, lse, sr3,
                           tab, labels)
    assert not _k4_fails(full, want, labels, iids)
    tail = _k4_from_logits(_k4_logits(sr3, tab, dim // 16 * 16), member, cot,
                           lse, sr3, tab, labels)
    assert _k4_fails(tail, want, labels, iids)


@pytest.mark.parametrize("dim", TAIL_DIMS)
def test_bwd_check_fails_a_k4_that_shares_a_pairs_membership_bit(dim):
    xm, sr3, tab, labels, iids, cot, lse, want = _k4_case(dim, 15)
    member = xm._member(iids, BF16_P, 0)
    shared = member.clone()
    shared[:, 1::2] = member[:, 0::2]
    # a session item at an odd column whose even neighbour is not one: the
    # mutant scores it in the "ex" partition
    assert bool((member[:, 1::2] & ~member[:, 0::2]).any())
    z = _k4_logits(sr3, tab, dim)
    assert not _k4_fails(_k4_from_logits(z, member, cot, lse, sr3, tab,
                                         labels), want, labels, iids)
    assert _k4_fails(_k4_from_logits(z, shared, cot, lse, sr3, tab, labels),
                     want, labels, iids)


@pytest.mark.parametrize("dim", TAIL_DIMS)
def test_bwd_check_fails_a_k4_that_folds_every_order_onto_order_0(dim):
    xm, sr3, tab, labels, iids, cot, lse, want = _k4_case(dim, 16)
    member = xm._member(iids, BF16_P, 0)
    z = _k4_logits(sr3, tab, dim)
    assert not _k4_fails(_k4_from_logits(z, member, cot, lse, sr3, tab,
                                         labels), want, labels, iids)
    first = [c[:1].expand_as(c) for c in cot]
    first_lse = [x[:1].expand_as(x) for x in lse]
    assert _k4_fails(_k4_from_logits(z, member, first, first_lse, sr3, tab,
                                     labels), want, labels, iids)


# Mutants of the tensor-core slab kernels past 256 features, in bfloat16
# at widths 258 and 1,000 (96 rows, 640 table rows): k-chunks of 64, so
# the last chunk is 2 and 40 wide; the backward's slabs start on a k step
# of 16 (csrc/tiles.cuh:slab_width: 144 + 114, and 3 x 256 + 232).  A K1
# whose last chunk runs round_down(w, 16) features, or that sums every
# chunk but the last; a K2 whose d_table product drops each slab's
# features past round_down(w, 16), or whose 64-row stages skip the last
# partial one (rows 64-95 of 96); a K4 whose d_sr takes only the first
# slab.  chip_smoke's checks must fail each; the same arithmetic on the
# full logits passes them.

SLAB_DIMS = (258, 1000)


def _slabs_bf16(D):
    """[(k0, w)] of the bfloat16 feature slabs past 256 features."""
    n = -(-D // 256)
    sw = (-(-D // n) + 15) & ~15
    return [(k0, min(sw, D - k0)) for k0 in range(0, D, sw)]


def _chunk_keep(D, last):
    """Features a K1 multiplies when its last k-chunk of 64 runs ``last``
    of its w features."""
    k0 = (D - 1) // 64 * 64
    return torch.arange(D) < k0 + last(D - k0)


def _k1_logits_of(sr, tab, keep):
    t = tab.float()
    n = torch.clamp(torch.linalg.vector_norm(t, dim=1), min=1e-12)
    return cs.SCALE * ((sr.float() * keep) @ t.T) / n


@pytest.mark.parametrize("dim", SLAB_DIMS)
@pytest.mark.parametrize("fault", ["last_chunk_rounded_down",
                                   "last_chunk_dropped"])
def test_fwd_check_fails_a_slab_k1_that_loses_the_last_chunk(dim, fault):
    sr, tab, labels, _, kw = _bf16_case(dim, seed=17)
    want = xent.xent_fwd(sr, tab, labels, BF16_ITEMS, **kw)
    tol = cs.TOL[("fwd", "bfloat16")]
    full = _k1_from_logits(_k1_logits_of(sr, tab, torch.ones(dim)), labels)
    err, bound = cs.fwd_errors(full, want, tol)
    assert err <= bound
    last = {"last_chunk_rounded_down": lambda w: w // 16 * 16,
            "last_chunk_dropped": lambda w: 0}[fault]
    keep = _chunk_keep(dim, last)
    assert 0 < int((~keep).sum()) <= 64
    bad = _k1_from_logits(_k1_logits_of(sr, tab, keep.float()), labels)
    err, bound = cs.fwd_errors(bad, want, tol)
    assert err > bound


def _k2_slab(z, g, sr, tab, labels, lse, rows=None, feats=None):
    """``_k2_from_logits`` with d_table's product dz^T sr over the batch
    rows ``rows`` only and its features ``feats`` only (all by default),
    before the l2norm VJP, as a faulty slab product would give it."""
    that, tmm, n = xent._operand(tab, True)
    col = torch.arange(tab.shape[0])[None, :]
    p = torch.where(col < BF16_ITEMS, torch.exp(z - lse[:, None]), 0.0)
    onehot = (col == labels.long()[:, None]).float()
    dz = ((p - onehot) * (cs.SCALE * g)[:, None]).to(tab.dtype).float()
    rows = slice(None) if rows is None else rows
    gtab = dz[rows].T @ sr.float()[rows]
    if feats is not None:
        gtab = gtab * feats
    gdot = torch.sum(gtab * that, dim=1, keepdim=True)
    gtab = (gtab - gdot * that * (n > 1e-12).float()) / n
    return dz @ tmm, gtab.to(tab.dtype)


@pytest.mark.parametrize("dim", SLAB_DIMS)
@pytest.mark.parametrize("fault", ["slab_tail_dropped",
                                   "last_partial_stage_skipped"])
def test_bwd_check_fails_a_slab_k2_with_a_short_product(dim, fault):
    sr, tab, labels, g, kw = _bf16_case(dim, seed=18)
    _, lse = xent.xent_fwd(sr, tab, labels, BF16_ITEMS, **kw)
    want = xent.xent_bwd(g, sr, tab, labels, lse, BF16_ITEMS, **kw)
    tmm = xent._operand(tab, True)[1]
    z = cs.SCALE * (sr.float() @ tmm.T)
    assert not _k2_fails(_k2_slab(z, g, sr, tab, labels, lse), want,
                         labels)
    if fault == "slab_tail_dropped":
        feats = torch.ones(dim)
        for k0, w in _slabs_bf16(dim):
            feats[k0 + w // 16 * 16:k0 + w] = 0.0
        assert int((feats == 0).sum()) in (2, 8)
        bad = _k2_slab(z, g, sr, tab, labels, lse, feats=feats)
    else:
        assert sr.shape[0] == 96
        bad = _k2_slab(z, g, sr, tab, labels, lse, rows=slice(0, 64))
    assert _k2_fails(bad, want, labels)


@pytest.mark.parametrize("dim", SLAB_DIMS)
def test_bwd_check_fails_a_slab_k4_whose_dsr_takes_one_slab(dim):
    xm, sr3, tab, labels, iids, cot, lse, want = _k4_case(dim, 19)
    member = xm._member(iids, BF16_P, 0)
    z = _k4_logits(sr3, tab, dim)
    dsr, dtab = _k4_from_logits(z, member, cot, lse, sr3, tab, labels)
    assert not _k4_fails((dsr, dtab), want, labels, iids)
    first = _slabs_bf16(dim)[0][1]
    bad = dsr.clone()
    bad[..., first:] = 0.0
    assert _k4_fails((bad, dtab), want, labels, iids)


# vs_cpu's readings: the ``torch.relu`` inputs whose sign parts the card
# and the CPU (not checked), and, where the check fails, the same
# gradients through K1-K4's plain versions on the card.

def test_relu_inputs_record_without_changing_the_result():
    x = torch.tensor([[0.5, -1.862645e-09, -0.25, 1.0]], requires_grad=True)
    relu = torch.relu
    with cs.relu_inputs(torch) as rec:
        y = torch.relu(x)
    assert torch.relu is relu                      # restored on exit
    y.sum().backward()
    assert y.tolist() == [[0.5, 0.0, 0.0, 1.0]]
    assert x.grad.tolist() == [[1.0, 0.0, 0.0, 1.0]]
    assert len(rec.inputs) == 1 and torch.equal(rec.inputs[0], x.detach())


def test_relu_flips_count_the_inputs_that_change_sign():
    card = [torch.tensor([0.5, -1.862645e-09, -0.25, 1.0])]
    cpu = [torch.tensor([0.5, 1.490116e-08, -0.25, 1.0])]
    n, worst = cs.relu_flips(card, cpu)
    assert n == 1 and worst == pytest.approx(1.490116e-08)
    assert cs.relu_flips(card, card) == [0, 0.0]


def test_plain_kernels_stand_in_for_the_wrappers_and_restore_them():
    from sessionrec_tpu_torch.ops import xent_multi as xm
    kernels = (xent._fwd_cuda, xent._bwd_cuda, xm._fwd_cuda, xm._bwd_cuda)
    sr, tab, labels, _ = cs.make_inputs(torch, N_ITEMS, pad_catalog(N_ITEMS),
                                        torch.float32, seed=1, dev="cpu")
    kw = dict(scale=cs.SCALE, normalize_table=True)
    with cs.plain_kernels():
        got = xent._fwd_cuda(sr, tab, labels, N_ITEMS, 0, **kw)
        assert xm._fwd_cuda is xm._fwd_plain
        assert xent._bwd_cuda is xent._bwd_plain
    want = xent.xent_fwd(sr, tab, labels, N_ITEMS, 0, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (xent._fwd_cuda, xent._bwd_cuda, xm._fwd_cuda,
            xm._bwd_cuda) == kernels


def _paper_head():
    from sessionrec_tpu_torch.data.loader import BatchLoader
    from sessionrec_tpu_torch.models import MSGIFSR
    model = MSGIFSR(500, 8, 1, order=3, extra=True, fusion=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    sessions = [[1, 2, 3], [4, 5], [6, 7, 8, 9]] * 10
    batch = next(iter(BatchLoader(sessions, "ccs", 16, 9, order=3,
                                  prefetch=0))).to("cpu")
    return model, batch


def test_vs_cpu_runs_the_paper_head_on_one_device():
    """The whole check with both sides on the CPU: no error, no flip."""
    model, batch = _paper_head()
    errs, ok = cs.vs_cpu(torch, model, batch,
                         ("embedding", "sc_sr.0.l1.weight"))
    assert ok and errs["relu_flips"] == [0, 0.0]
    assert "plain_on_card" not in errs
    assert errs["sc_sr.0.l1.weight"] == 0.0 and errs["loss"] == 0.0


def test_vs_cpu_adds_the_plain_witness_where_it_fails(monkeypatch):
    """A failing check (every error read as 1) reruns the gradients
    through the plain versions and reports each beside the CPU's."""
    model, batch = _paper_head()
    monkeypatch.setattr(cs, "max_err", lambda a, b: 1.0)
    grads = ("embedding", "sc_sr.0.l1.weight")
    errs, ok = cs.vs_cpu(torch, model, batch, grads)
    assert not ok and errs["plain_on_card"] == {g: [1.0, 1.0] for g in grads}


# The gate's ties: every ``torch.relu`` input agrees to RELU_GAP of its
# call's largest (``relu_gap``); at an input within it that changes sign,
# the card may agree with the CPU's other branch (``relu_branches``).  A
# hook on the "card" model's gate layer (the CPU's copy runs without it)
# stands in for the card's rounding, or for a wrong layer.

@pytest.mark.parametrize("second, gap", [
    ([0.5, -1e-9, -0.25, 1.0], 0.0),
    ([0.5, 1e-6, -0.25, 1.0], pytest.approx(1e-6 + 1e-9)),
    ([0.5, -1e-9, -0.25, 2.0], pytest.approx(0.5)),
    ([0.5, -1e-9, -0.25], float("inf")),
])
def test_relu_gap_reads_each_call_against_its_largest(second, gap):
    first = [torch.tensor([0.5, -1e-9, -0.25, 1.0])]
    assert cs.relu_gap(first, [torch.tensor(second)]) == gap
    assert cs.relu_gap(first, first + first) == float("inf")


def test_relu_gap_fails_where_an_input_is_nan():
    a = torch.tensor([float("nan"), 0.5, -1.0])
    ok = torch.tensor([0.1, 0.5, -1.0])
    for first, second in (([a], [a.clone()]), ([ok, a], [ok, ok])):
        assert not cs.relu_gap(first, second) <= cs.RELU_GAP


def test_relu_branches_take_the_other_branch_where_flipped():
    x = torch.tensor([[0.5, 1.5e-8, -2e-9, -0.25]], requires_grad=True)
    flip = [torch.tensor([[False, True, True, False]])]
    with cs.relu_branches(torch, flip) as rb:
        y = torch.relu(x)
    assert torch.relu is rb.relu and rb.calls == 1
    y.sum().backward()
    assert y.tolist() == [[0.5, 0.0, pytest.approx(-2e-9), 0.0]]
    assert x.grad.tolist() == [[1.0, 0.0, 1.0, 0.0]]


def _card_hook(model, change):
    """``change(input, output)`` on ``model``'s gate layer alone: the copy
    that ``vs_cpu`` takes for the CPU shares the hook but not the layer."""
    gate = model.sc_sr[0].l1
    gate.register_forward_hook(
        lambda mod, inp, out: change(inp[0], out) if mod is gate else None)


def _gate_inputs(model, batch):
    from sessionrec_tpu_torch.train.runner import make_loss
    with cs.relu_inputs(torch) as rec:
        make_loss(model, batch, None)
    (x,) = rec.inputs
    return x


def test_vs_cpu_holds_the_card_to_the_other_branch_at_a_tie():
    """One gate input set to +d on the CPU and -d on the "card", d = 1e-6
    of the largest: the CPU's own branch misses the gradient bar, the
    other branch there meets it, and the check passes."""
    model, batch = _paper_head()
    x = _gate_inputs(model, batch)
    i = int(x.abs().flatten().argmin())
    d = 1e-6 * float(x.abs().max())
    with torch.no_grad():
        model.sc_sr[0].l1.bias[i % x.shape[-1]] += d - x.flatten()[i]
    assert float(_gate_inputs(model, batch).flatten()[i]) > 0.5 * d

    def flip_one(inp, out):
        out = out.clone()
        out.view(-1)[i] -= 2 * d
        return out

    _card_hook(model, flip_one)
    grads = ("embedding", "sc_sr.0.l1.weight")
    errs, ok = cs.vs_cpu(torch, model, batch, grads)
    assert ok and errs["relu_flips"][0] == 1
    assert errs["relu_gap"] <= cs.RELU_GAP
    own = errs["sc_sr.0.l1.weight"]
    assert own > 1e-3 * float(model.sc_sr[0].l1.weight.grad.abs().max())
    assert errs["at_ties"]["sc_sr.0.l1.weight"] <= 1e-6 * own
    assert "plain_on_card" not in errs


@pytest.mark.parametrize("wrong", ["bf16_weights", "one_input_off"])
def test_vs_cpu_refuses_a_wrong_gate_layer(wrong):
    """A gate layer with bf16-rounded weights, or one input moved by 10x
    RELU_GAP of the largest, on the "card" alone: the gap shows it."""
    model, batch = _paper_head()
    top = float(_gate_inputs(model, batch).abs().max())

    def change(inp, out):
        if wrong == "bf16_weights":
            w = model.sc_sr[0].l1.weight.bfloat16().float()
            return torch.nn.functional.linear(inp, w, model.sc_sr[0].l1.bias)
        out = out.clone()
        out.view(-1)[0] += 10 * cs.RELU_GAP * top
        return out

    _card_hook(model, change)
    errs, ok = cs.vs_cpu(torch, model, batch, ("sc_sr.0.l1.weight",))
    assert not ok and errs["relu_gap"] > 9 * cs.RELU_GAP
    assert "plain_on_card" in errs
