"""Checkpoint/resume of the port (``utils/checkpoint.py``), on the CPU.

Kill-and-resume reproduces the uninterrupted run bit for bit, on the
order-1 head and on the paper head: parameters, Adam's moments and step
counts, the schedule's counter and rate, the dropout counter, the
losses and the early-stop bookkeeping; the shuffle order of epoch k is a
pure function of (seed, k).  The counterpart of
tests/test_checkpoint_resume.py, with its bfloat16 case: a bf16 table
and bf16 compute, the table's float32 moments and the stochastic
rounding included, atol 0.  Also: ``checkpoint_every``, the migration of
catalog padding and of a table's dtype, the refusal of other shape
drift, and the sidecar's keys against the JAX package's
``Checkpointer``.
"""

import json
import pathlib
import types

import numpy as np
import pytest
import torch

from sessionrec_tpu_torch.data.io import read_dataset
from sessionrec_tpu_torch.data.loader import BatchLoader
from sessionrec_tpu_torch.models import MSGIFSR
from sessionrec_tpu_torch.train.runner import TrainRunner
from sessionrec_tpu_torch.train.session import _CappedLoader
from sessionrec_tpu_torch.utils import checkpoint as ck

SAMPLE_DIR = pathlib.Path(__file__).resolve().parent.parent / "datasets" \
    / "sample"
HEADS = {"o1": dict(order=1), "paper": dict(order=3, extra=True,
                                             fusion=True),
         "bfloat16": dict(order=1, table_dtype="bfloat16",
                          compute_dtype="bfloat16")}


def make_runner(ckpt_dir=None, head="o1", **kw):
    """MSGIFSR at d=16 on 400 train and 200 test sessions of
    datasets/sample, batch 128, unroll 2, shuffled (6 batches of each
    epoch's order), dropout on."""
    train, test, num_items = read_dataset(SAMPLE_DIR)
    order = HEADS[head]["order"]
    tl = _CappedLoader(BatchLoader(train[:400], "ccs", 128, 20,
                                   shuffle=True, seed=7, order=order,
                                   split_len=(4, 8)), 6)
    el = BatchLoader(test[:200], "ccs", 128, 20, order=order,
                     split_len=(4, 8))
    model = MSGIFSR(num_items, 16, 1, feat_drop=0.1, **HEADS[head])
    return TrainRunner(model, tl, el, lr=1e-3, weight_decay=1e-4,
                       patience=10, eval_before_train=False, seed=3,
                       checkpointer=ck.Checkpointer(ckpt_dir)
                       if ckpt_dir else None, unroll=2, device="cpu", **kw)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op CPU thread per test: the threaded ``index_put_`` with
    accumulation (the embedding gather's backward) adds in a varying
    order, so two identical runs may differ in the last bits; and the
    suite's parallel workers would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("head", list(HEADS))
def test_resume_reproduces_uninterrupted_run(tmp_path, head):
    """Two epochs against one, then a fresh runner that resumes for the
    second; the learning rate drops every epoch, so the schedule's state
    counts."""
    kw = dict(lr_step_size=1, lr_gamma=0.5)
    full = make_runner(tmp_path / "full", head, **kw)
    full.train(2, log_interval=10 ** 9)

    a = make_runner(tmp_path / "ab", head, **kw)
    a.train(1, log_interval=10 ** 9)
    b = make_runner(tmp_path / "ab", head, **kw)
    assert b.checkpointer.restore_latest(b)
    assert b.epoch == 1 and b.steps == a.steps
    b.train(2, log_interval=10 ** 9)

    assert b.steps == full.steps
    np.testing.assert_array_equal(b.losses, full.losses[a.steps:])
    want, got = full.named_state(), b.named_state()
    assert set(got) == set(want)
    assert sum(k.startswith("adam/") for k in got) == 3 * len(full.params)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
    assert got["adam/embedding/step"].dtype == torch.float32
    table = HEADS[head].get("table_dtype", "float32")
    assert b.model.embedding.dtype == getattr(torch, table)
    assert got["adam/embedding/exp_avg_sq"].dtype == torch.float32
    assert int(b.sched.count) == int(b.seeds.count) == full.steps
    assert float(b.sched.lr) == pytest.approx(1e-3 * 0.5 ** 2)
    assert (b.max_mrr, b.max_hit, b.bad_counter) == \
        (full.max_mrr, full.max_hit, full.bad_counter)


def test_checkpoint_every_epochs(tmp_path):
    r = make_runner(tmp_path / "every", checkpoint_every=2)
    r.train(4, log_interval=10 ** 9)
    saved = sorted(p.name for p in (tmp_path / "every").glob("epoch_*"))
    assert saved == ["epoch_0001", "epoch_0001.json", "epoch_0003",
                     "epoch_0003.json"]
    assert r.checkpointer.latest_epoch() == 3


def test_restore_casts_a_table_of_another_dtype(tmp_path, monkeypatch):
    """A float32 run's checkpoint restores into a bfloat16-table runner:
    the table is cast and the cast logged (the JAX package's dtype
    migration); its float32 moments restore exactly."""
    a = make_runner(tmp_path / "dt")
    a.train(1, log_interval=10 ** 9)
    b = make_runner(tmp_path / "dt", "bfloat16")
    warned = []
    monkeypatch.setattr(ck.log, "warning",
                        lambda msg, *args: warned.append(msg % args))
    assert b.checkpointer.restore_latest(b)
    assert warned == ["migrated embedding dtype torch.float32 -> "
                      "torch.bfloat16 (resume is no longer bit-identical)"]
    assert torch.equal(b.model.embedding,
                       a.model.embedding.detach().to(torch.bfloat16))
    for key in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(b.named_state()[f"adam/embedding/{key}"],
                           a.named_state()[f"adam/embedding/{key}"])
    b.train(2, log_interval=10 ** 9)


def _rewrite(path, fn):
    """Apply ``fn(name, tensor)`` to every leaf of a checkpoint file."""
    saved = torch.load(path, weights_only=True)
    torch.save({k: fn(k, v) for k, v in saved.items()}, path)


def test_restore_migrates_catalog_padding(tmp_path):
    """A checkpoint written under a 128-multiple ``pad_catalog`` restores
    into the 512-padded table: rows [:P_old] of the table are equal, its
    Adam moments are padded with zeros, the rest restores exactly, and
    training continues."""
    a = make_runner(tmp_path / "mig")
    a.train(1, log_interval=10 ** 9)
    P_new = a.model.padded_items
    P_old = -(-a.model.num_items // 128) * 128
    assert P_old < P_new
    path = tmp_path / "mig" / "epoch_0000"

    def shrink(name, t):
        return t[:P_old] if "embedding" in name and t.dim() == 2 else t

    _rewrite(path / ck.PARAMS, shrink)
    _rewrite(path / ck.TRAIN, shrink)
    b = make_runner(tmp_path / "mig")
    assert b.checkpointer.restore_latest(b)
    st = b.named_state()
    assert torch.equal(st["embedding"][:P_old], a.model.embedding[:P_old])
    for key in ("exp_avg", "exp_avg_sq"):
        m = st[f"adam/embedding/{key}"]
        assert m.shape[0] == P_new
        assert torch.equal(m[:P_old], a.named_state()[
            f"adam/embedding/{key}"][:P_old])
        assert not m[P_old:].any()
    assert torch.equal(st["fc_sr.0.weight"], a.model.fc_sr[0].weight)
    b.train(2, log_interval=10 ** 9)
    assert np.isfinite(b.losses).all()


@pytest.mark.parametrize("leaf", [ck.PARAMS, ck.TRAIN])
def test_restore_rejects_incompatible_shapes(tmp_path, leaf):
    a = make_runner(tmp_path / "bad")
    a.train(1, log_interval=10 ** 9)

    def corrupt(name, t):               # a wrong hidden width
        return t[:, :-1] if "fc_sr" in name and t.dim() == 2 else t

    _rewrite(tmp_path / "bad" / "epoch_0000" / leaf, corrupt)
    b = make_runner(tmp_path / "bad")
    with pytest.raises(ValueError, match="fc_sr.*incompatible"):
        b.checkpointer.restore_latest(b)


def test_sidecar_keys_match_the_jax_checkpointer(tmp_path):
    from sessionrec_tpu.utils.checkpoint import Checkpointer as JCheckpointer

    stub = types.SimpleNamespace(
        params={"w": np.zeros(2, np.float32)}, state={},
        opt_state={"m": np.zeros(2, np.float32)},
        step_key=np.zeros(2, np.uint32), batch=4, max_mrr=0.25,
        max_hit=0.5, bad_counter=1)
    JCheckpointer(tmp_path / "jax").save(0, stub, metrics={"mrr": 0.25})
    want = json.loads((tmp_path / "jax" / "epoch_0000.json").read_text())

    r = make_runner(tmp_path / "torch")
    r.train(1, log_interval=10 ** 9)
    got = json.loads((tmp_path / "torch" / "epoch_0000.json").read_text())
    assert list(got) == list(want)
    assert set(got["metrics"]) == {"mrr", "hit"}
    assert got["batch"] == r.steps and got["epoch"] == 0


def test_resume_needs_a_checkpoint_dir():
    from sessionrec_tpu_torch.train.session import run_training
    from sessionrec_tpu_torch.utils.config import preset
    cfg = preset("msgifsr", order=1, device="cpu", resume=True,
                 dataset_dir=str(SAMPLE_DIR))
    with pytest.raises(ValueError, match="checkpoint"):
        run_training(cfg)
