"""The check fails what it must: the timed path broken underneath, a run
reads ``correct`` false; the control (the reference in the program's
place at TF32) fails a limit; the program's own readings pass."""

import pytest
import torch

import control
import run


def frozen(monkeypatch):
    """A step that returns its state unchanged."""
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def half_batch(monkeypatch):
    """Half of each batch left out, the mean over the rest."""
    from sessionrec_tpu_torch.ops import xent, xent_multi

    def halve(fn, at):
        def wrapped(*a, **kw):
            a = list(a)
            v = a[at].clone()
            v[v.shape[0] // 2:] = 0
            a[at] = v
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(xent, "fused_nll_loss", halve(xent.fused_nll_loss, 3))
    monkeypatch.setattr(xent_multi, "multi_nll_loss",
                        halve(xent_multi.multi_nll_loss, 3))


def altered(monkeypatch):
    """Each session's first id altered where the top-k is taken."""
    from sessionrec_tpu_torch import serving
    topk = serving.stable_topk

    def wrong(x, k):
        vals, ids = topk(x, k)
        ids = ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % x.shape[-1]
        return vals, ids
    monkeypatch.setattr(serving, "stable_topk", wrong)


@pytest.mark.parametrize("name,fault", [
    ("o1-yc4-train", frozen), ("o1-yc4-train", half_batch),
    ("paper-yc4-train", frozen), ("paper-yc4-train", half_batch),
    ("paper-yc4-serve", altered)])
def test_fault_is_not_correct(tiny, monkeypatch, name, fault):
    fault(monkeypatch)
    res = run.run_cell(tiny(name), 2 ** 31 + 5, 0.3, 0, device="cpu")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", ["o1-yc4-train", "paper-yc4-train",
                                  "paper-yc4-serve"])
def test_control_fails_and_program_passes(tiny, name):
    cell = tiny(name, dim=64)
    limits = cell.params["limits"]
    for seed in (21, 22):
        for what, numbers in control.readings(cell, seed, "control", "cpu"):
            if what == "tf32":
                assert any(numbers[k] > lim for k, lim in limits.items()), \
                    numbers
        (_, numbers), = control.readings(cell, seed, "program", "cpu")
        assert all(numbers[k] <= lim for k, lim in limits.items()), numbers
