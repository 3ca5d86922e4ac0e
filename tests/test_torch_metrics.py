"""The port's metrics sink and profiler trace (``utils/metrics.py``,
``utils/profiling.py``), on the CPU: the JSONL logger round-trips its
events; a training run with ``metrics_file`` writes ``train`` and
``eval`` events whose keys are those of the JAX runner's events (a tiny
JAX run with the same sink supplies them); ``trace(None)`` is a no-op
and ``trace(dir)`` writes a trace file."""

import json
import pathlib

import pytest
import torch

import chip_smoke as cs
from sessionrec_tpu_torch.train.session import run_training
from sessionrec_tpu_torch.utils.config import preset
from sessionrec_tpu_torch.utils.metrics import MetricsLogger, MultiSink
from sessionrec_tpu_torch.utils.profiling import trace

SAMPLE_DIR = pathlib.Path(__file__).resolve().parent.parent / "datasets" \
    / "sample"


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op CPU thread per test: the suite's parallel workers
    would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _events(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_metrics_logger_round_trip(tmp_path):
    path = tmp_path / "m.jsonl"
    with MetricsLogger(path) as m:
        m.log("train", step=3, epoch=0, loss=torch.tensor(2.5), tag="x")
        MultiSink(m, None).log("eval", step=4, mrr=0.125)
    got = _events(path)
    assert [e["kind"] for e in got] == ["train", "eval"]
    assert got[0]["loss"] == 2.5 and got[0]["step"] == 3.0
    assert got[0]["tag"] == "x" and got[1]["mrr"] == 0.125
    assert all(list(e)[:2] == ["ts", "kind"] for e in got)
    with MetricsLogger(path) as m:           # appends
        m.log("eval", step=5)
    assert len(_events(path)) == 3


def _jax_event_keys(tmp_path):
    """{kind: keys} of the events the JAX runner logs."""
    from sessionrec_tpu.data.io import read_dataset
    from sessionrec_tpu.data.loader import BatchLoader
    from sessionrec_tpu.models import build_model
    from sessionrec_tpu.train.runner import TrainRunner
    from sessionrec_tpu.utils.config import preset as jpreset
    from sessionrec_tpu.utils.metrics import MetricsLogger as JLogger

    cfg = jpreset("msgifsr", order=1, embedding_dim=16, num_layers=1)
    train, test, num_items = read_dataset(SAMPLE_DIR)
    tl = BatchLoader(train[:60], "ccs", 64, 20, order=1)
    el = BatchLoader(test[:30], "ccs", 64, 20, order=1)
    path = tmp_path / "jax.jsonl"
    with JLogger(path) as m:
        TrainRunner(build_model(cfg.model, num_items), tl, el,
                    eval_before_train=False, unroll=1,
                    metrics=m).train(1, log_interval=1)
    return {e["kind"]: list(e) for e in _events(path)}


def test_training_events_have_the_jax_keys(tmp_path):
    path = tmp_path / "torch.jsonl"
    cfg = preset("msgifsr", order=1, embedding_dim=16, batch_size=64,
                 dataset_dir=str(SAMPLE_DIR), epochs=2, log_interval=2,
                 unroll=2, device="cpu", metrics_file=str(path))
    runner = run_training(cfg, max_epoch_batches=4)
    events = _events(path)
    kinds = [e["kind"] for e in events]
    assert kinds == ["train", "train", "eval"] * 2
    want = _jax_event_keys(tmp_path)
    for e in events:
        assert list(e) == want[e["kind"]], e
    assert cs.EVENT_KEYS == want            # what chip_smoke.py checks
    evals = [e for e in events if e["kind"] == "eval"]
    assert max(e["mrr"] for e in evals) == runner.max_mrr
    assert max(e["hit"] for e in evals) == runner.max_hit
    assert [e["step"] for e in evals] == [4.0, 8.0]


def test_trace_none_is_a_no_op(tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the profiler must not start")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with trace(None):
        x = torch.ones(3).sum()
    with trace(""):
        x = x + 1
    assert float(x) == 4.0


def test_trace_writes_a_trace_file(tmp_path):
    with trace(tmp_path / "prof"):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8)).sum()
    files = list((tmp_path / "prof").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
