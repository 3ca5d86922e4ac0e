"""Serving in the port (``serving.py``, ``cli predict``) against the JAX
package's ``sessionrec_tpu/serving.py``, on the CPU.

``session_batches`` equals the JAX package's leaf by leaf, exactly.
``recommend`` from the same converted parameters returns the JAX ids at
every position whose JAX score is more than 1e-5 from its neighbours'
(closer ones may swap under float32 rounding; the JAX list is taken one
longer so the last position has a right neighbour too), and the same
scores to atol 1e-5, on the order-1 head and on the paper head.  Then
the contract: exact ids are the top-k of the model's log-probabilities
and rank 1..k under eval's ranking, out-of-catalog ids raise naming the
session, parameters restore without ``train.pt``, ``cli train
--checkpoint-dir`` then ``cli predict`` writes one JSONL line per
session, and ``approx`` serves the exact top-k, as the JAX package's
does off a TPU.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from sessionrec_tpu import serving as jserving
from sessionrec_tpu_torch import cli, serving
from sessionrec_tpu_torch.models import MSGIFSR
from sessionrec_tpu_torch.train.runner import eval_ranks
from test_torch_model import NUM_ITEMS, PAPER, make_pair

REPO = pathlib.Path(__file__).resolve().parent.parent
HEADS = {"o1": dict(), "paper": PAPER}
TIE = 1e-5
MAX_LEN = 8
K = 10


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op CPU thread per test: the suite's parallel workers
    would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sessions(seed, n=11):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, NUM_ITEMS,
                                       size=int(rng.integers(1, 12)))))
            for _ in range(n)]


def _assert_same_leaves(got, want, where="batch"):
    """Port batch against JAX batch, field by field, exactly."""
    if isinstance(got, tuple):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_leaves(g, w, f"{where}[{i}]")
    elif dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            _assert_same_leaves(getattr(got, f.name), getattr(want, f.name),
                                f"{where}.{f.name}")
    else:
        w = np.asarray(want)
        assert got.dtype == w.dtype, where
        np.testing.assert_array_equal(got, w, err_msg=where)


@pytest.mark.parametrize("order", [1, 3])
def test_session_batches_match_jax(order):
    sess = _sessions(1)                  # 11 sessions: a padded tail of 5
    got = list(serving.session_batches(sess, "ccs", 4, MAX_LEN, order))
    want = list(jserving.session_batches(sess, "ccs", 4, MAX_LEN, order))
    assert [n for _, n in got] == [n for _, n in want] == [4, 4, 3]
    for (g, _), (w, _) in zip(got, want):
        _assert_same_leaves(g, w)
    assert got[-1][0].valid.tolist() == [1.0, 1.0, 1.0, 0.0]


def test_session_batches_refuse_other_kinds():
    with pytest.raises(ValueError, match="unknown batch kind"):
        list(serving.session_batches([[1, 2]], "gru4rec", 4, MAX_LEN))


def _clear(scores):
    """[n, k] mask of positions more than TIE from both neighbours in a
    descending [n, k + 1] score list."""
    gap = np.abs(np.diff(scores, axis=1))                     # [n, k]
    left = np.concatenate([np.full((len(scores), 1), np.inf), gap[:, :-1]],
                          axis=1)
    return (gap > TIE) & (left > TIE)


def _assert_matches_jax(got, want, sess):
    """Port lists ``got`` (K ids) against JAX lists ``want`` (K + 1 ids):
    ids at every clear position, scores to TIE."""
    assert [s for s, _, _ in got] == sess
    w_ids = np.array([ids for _, ids, _ in want])
    w_scores = np.array([v for _, _, v in want], np.float64)
    g_ids = np.array([ids for _, ids, _ in got])
    g_scores = np.array([v for _, _, v in got], np.float64)
    clear = _clear(w_scores)
    np.testing.assert_array_equal(g_ids[clear], w_ids[:, :K][clear])
    np.testing.assert_allclose(g_scores, w_scores[:, :K], rtol=0, atol=TIE)
    assert clear.mean() > 0.9
    assert ((0 <= g_ids) & (g_ids < NUM_ITEMS)).all()


@pytest.mark.parametrize("head", list(HEADS))
def test_recommend_matches_jax(head):
    kw = HEADS[head]
    order = kw.get("order", 1)
    jm, jp, tm = make_pair(seed=3, **kw)
    sess = _sessions(2, n=23)
    want = list(jserving.recommend(jm, jp, {}, sess, max_len=MAX_LEN,
                                   k=K + 1, batch_size=8, order=order))
    got = list(serving.recommend(tm, sess, max_len=MAX_LEN, k=K,
                                 batch_size=8, order=order))
    _assert_matches_jax(got, want, sess)


@pytest.mark.parametrize("head", list(HEADS))
def test_exact_ids_are_the_top_k_of_the_model_scores(head):
    kw = HEADS[head]
    order = kw.get("order", 1)
    _, _, tm = make_pair(seed=4, **kw)
    sess = _sessions(3, n=9)
    got = list(serving.recommend(tm, sess, max_len=MAX_LEN, k=K,
                                 batch_size=4, order=order))
    for (batch, n), start in zip(
            serving.session_batches(sess, "ccs", 4, MAX_LEN, order),
            range(0, len(sess), 4)):
        batch = batch.to("cpu")
        lp = tm.apply(batch, training=False)[:n]
        ids = torch.tensor([i for _, i, _ in got[start:start + n]])
        want = torch.topk(lp, K, dim=-1)
        lv = torch.gather(lp, 1, ids)
        torch.testing.assert_close(lv, want.values, rtol=0, atol=1e-6)
        for j in range(K):                    # rank j + 1 under eval
            lab = torch.zeros(len(batch.labels), dtype=torch.int32)
            lab[:n] = ids[:, j].to(torch.int32)
            ranks = eval_ranks(tm, dataclasses.replace(batch, labels=lab),
                               K)[:n]
            assert (ranks == j + 1).all()


def test_recommend_rejects_out_of_catalog_ids():
    _, _, tm = make_pair()
    for bad in ([[3, NUM_ITEMS, 2]], [[1], [2, -1]]):
        with pytest.raises(ValueError, match=f"session {len(bad)}: .*"
                           "outside the catalog"):
            list(serving.recommend(tm, bad, max_len=MAX_LEN))


def _train_cli(tmp_path, *flags):
    ckpt = tmp_path / "ckpt"
    cli.main(["train", "--model", "msgifsr", "--order", "1", "--device",
              "cpu", "--dataset-dir", str(REPO / "datasets" / "sample"),
              "--epochs", "1", "--max-epoch-batches", "2", "--batch-size",
              "64", "--embedding-dim", "16", "--unroll", "2",
              "--checkpoint-dir", str(ckpt), *flags])
    return ckpt


def test_restore_params_without_train_state(tmp_path):
    from sessionrec_tpu_torch.data.io import read_dataset

    ckpt = _train_cli(tmp_path)
    (ckpt / "epoch_0000" / "train.pt").unlink()
    _, _, num_items = read_dataset(REPO / "datasets" / "sample")
    model = serving.restore_params(MSGIFSR(num_items, 16, 1), ckpt, "cpu")
    saved = torch.load(ckpt / "epoch_0000" / "params.pt", weights_only=True)
    for name, p in model.named_parameters():
        assert torch.equal(p, saved[name]), name
    with pytest.raises(FileNotFoundError):
        serving.restore_params(model, tmp_path / "empty", "cpu")


def test_cli_train_then_predict(tmp_path):
    ckpt = _train_cli(tmp_path, "--metrics-file", str(tmp_path / "m.jsonl"))
    sess_file = tmp_path / "sessions.txt"
    sess_file.write_text("5,9,5\n31,7\n")
    out = tmp_path / "recs.jsonl"
    cli.main(["predict", "--model", "msgifsr", "--order", "1", "--device",
              "cpu", "--dataset-dir", str(REPO / "datasets" / "sample"),
              "--embedding-dim", "16", "--checkpoint-dir", str(ckpt),
              "--sessions-file", str(sess_file), "--k", "5",
              "--output", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["session"] for r in recs] == [[5, 9, 5], [31, 7]]
    for r in recs:
        assert len(r["items"]) == len(set(r["items"])) == 5
        assert all(isinstance(i, int) for i in r["items"])
        assert r["scores"] == sorted(r["scores"], reverse=True)
    assert (tmp_path / "m.jsonl").read_text().count('"kind": "eval"') == 1


def test_predict_refuses_approx_and_a_missing_card(tmp_path):
    """``--topk-method approx`` serves what the JAX package's
    ``lax.approx_max_k`` serves off a TPU, the exact top-k: ``cli
    predict`` writes the exact method's lines, and ``recommend`` gives
    JAX's ``approx`` ids on the CPU; without a card the default device
    raises."""
    ckpt = _train_cli(tmp_path)
    args = ["predict", "--model", "msgifsr", "--order", "1",
            "--dataset-dir", str(REPO / "datasets" / "sample"),
            "--embedding-dim", "16", "--checkpoint-dir", str(ckpt)]
    lines = {}
    for method in ("exact", "approx"):
        out = tmp_path / f"{method}.jsonl"
        cli.main(args + ["--device", "cpu", "--topk-method", method,
                         "--recall-target", "0.9", "--output", str(out)])
        lines[method] = out.read_text()
    assert lines["approx"] == lines["exact"] and lines["exact"]
    jm, jp, tm = make_pair(seed=3)
    sess = _sessions(2, n=23)
    want = list(jserving.recommend(jm, jp, {}, sess, max_len=MAX_LEN,
                                   k=K + 1, batch_size=8, method="approx",
                                   recall_target=0.95))
    got = list(serving.recommend(tm, sess, max_len=MAX_LEN, k=K,
                                 batch_size=8, method="approx",
                                 recall_target=0.95))
    _assert_matches_jax(got, want, sess)
    with pytest.raises(ValueError, match="recall_target"):
        serving.make_recommend_step(tm, K, "approx", recall_target=1.5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(args + ["--output", str(tmp_path / "out.jsonl")])
