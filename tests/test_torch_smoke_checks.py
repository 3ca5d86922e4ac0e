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
