"""Every model family the port runs is new files and new entries: a
configuration, a cell and a reference of SRGNN, NISER+, LESSR or MSGIFSR,
added to a copy of the benchmark, are trained and served by the drivers
as they stand, with the family's own batches, buffers and head; the
counts take the head the program gives the family, and MSGIFSR's counts
read what they read before."""

import json
import shutil
import time

import pytest
import torch

from conftest import HOME, ROOT
from counts import model as msgifsr_count
from counts import xent
from harness import check, data, program
from harness.cells import Bench, load_module
from harness.outcome import Context, Outcome, Run
from harness.spans import Spans

# weights by the port's own parameter names, drawn from the seed: a stand
# in for a family's plain reference, which these tests do not run
STUB = '''
import torch


def init_params(cfg, seed, device):
    from sessionrec_tpu_torch.models import build_model
    from sessionrec_tpu_torch.utils.config import ModelConfig
    n = cfg["catalog"]["num_items"]
    model = build_model(ModelConfig(**cfg["model"]), n)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for name, p in model.named_parameters():
        shape = (n, p.shape[1]) if name == "embedding" else tuple(p.shape)
        out[name] = torch.empty(shape, device=device).uniform_(
            -0.1, 0.1, generator=gen)
    return out
'''

MODELS = {
    "srgnn": {"name": "srgnn", "embedding_dim": 16, "num_layers": 1,
              "feat_drop": 0.1},
    "niser": {"name": "niser", "embedding_dim": 16, "num_layers": 1,
              "feat_drop": 0.1, "norm": True, "scale": 12.0},
    "lessr": {"name": "lessr", "embedding_dim": 16, "num_layers": 3,
              "feat_drop": 0.2, "batch_norm": True},
    "msgifsr": {"name": "msgifsr", "embedding_dim": 16, "num_layers": 1,
                "feat_drop": 0.1, "order": 2, "norm": True},
}
KINDS = {"srgnn": "session", "niser": "session", "lessr": "lessr",
         "msgifsr": "ccs"}
ITEMS, BATCH = 500, 32


def family_bench(tmp_path, family, traffic=("train", "serve")):
    """A copy of the benchmark with ``family``'s configuration, reference
    stub and one cell a mix in ``traffic``, new files only."""
    home = tmp_path / "benchmark"
    shutil.copytree(HOME, home, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg = {"name": f"{family}-tiny", "source": "x", "reference": "stub",
           "dtype": "float32", "model": MODELS[family],
           "catalog": {"num_items": ITEMS},
           "data": {"batch_size": BATCH, "max_len": 20, "tiers": [4, 8]},
           "train": {"lr": 0.001, "weight_decay": 0.0001, "lr_step_size": 3,
                     "lr_gamma": 0.1}}
    (home / "configs" / f"{family}-tiny.json").write_text(json.dumps(cfg))
    (home / "reference" / "stub.py").write_text(STUB)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": f"{family}-tiny", "source": "x",
                            "file": f"benchmark/configs/{family}-tiny.json",
                            "reduced": [], "why": "x"})
    for mix in traffic:
        name = f"{family}-{mix}"
        (home / "workloads" / f"{name}.json").write_text(json.dumps({
            "train_examples": 1500, "trace_chunks": 1, "pool_sessions": 64,
            "trace_requests": 1, "check_requests": 1, "limits": {}}))
        spec["workloads"].append({"name": name, "config": f"{family}-tiny",
                                  "traffic": mix, "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(tmp_path, home)


def context(cell, seed=2 ** 31 + 3):
    cell.traffic["unroll"] = 2
    cell.traffic["request_sessions"] = BATCH
    return Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                   device="cpu", t0=time.perf_counter())


@pytest.mark.parametrize("family", sorted(MODELS))
def test_a_family_trains_through_the_driver(tmp_path, family):
    cell = family_bench(tmp_path, family).cell(f"{family}-train")
    assert cell.role == "train"
    setup = cell.driver().Setup(context(cell))
    try:
        assert setup.loader.kind == KINDS[family]
        assert setup.loader.order == MODELS[family].get("order", 1)
        readings = setup.first_steps()
    finally:
        setup.close()
    assert len(readings["losses"]) == 3
    assert all(torch.isfinite(torch.tensor(readings["losses"])))
    assert set(readings["grad"]) == set(readings["change"])
    if family == "lessr":
        # the running statistics of every BatchNorm, moved by the steps
        names = set(readings["state"])
        assert {"bn.mean", "bn.var", "readout.bn.mean",
                "layers.0.bn.mean", "layers.2.bn.var"} <= names
        assert readings["state"]["bn.mean"] > 0
    else:
        assert readings["state"] == {}


def test_state_gap_reads_the_worst_buffer():
    prog = {"losses": [1.0], "grad": {"a": 1.0, "b": 2.0},
            "change": {"a": 1.0, "b": 2.0},
            "state": {"bn.mean": 0.5, "bn.var": 3.3}}
    ref = dict(prog, grad_raw={"a": 1.0, "b": 2.0}, projected=0,
               state={"bn.mean": 0.5, "bn.var": 3.0})
    numbers = check.train_numbers(prog, ref)
    assert numbers["state_gap"] == pytest.approx(0.1)
    assert numbers["_leaves"]["state_gap"] == "bn.var"
    del ref["state"]
    assert "state_gap" not in check.train_numbers(prog, ref)


@pytest.mark.parametrize("family", sorted(MODELS))
def test_a_family_serves_through_the_driver(tmp_path, family):
    cell = family_bench(tmp_path, family).cell(f"{family}-serve")
    assert cell.role == "serve"
    drv = cell.driver()
    server = drv.Server(context(cell))
    index, ids, scores = server.request(Spans())
    k = cell.traffic["k"]
    assert index == 0 and ids.shape == (BATCH, k)
    assert not drv.malformed(ids, scores, ITEMS)
    assert all(len(set(row)) == k for row in ids.tolist())


def with_plain_serve(spec):
    """``spec`` with the plain-head serving cell whose workload file
    (``workloads/o1-yc4-serve.json``) waits for a steadier host: order-1
    MSGIFSR under the serving mix."""
    spec["workloads"].append({"name": "o1-yc4-serve",
                              "config": "msgifsr-o1-yc4", "traffic": "serve",
                              "chips": 1, "why": "x"})
    for m in spec["end_to_end"]:
        if "paper-yc4-serve" in m.get("workloads", []):
            m["workloads"].append("o1-yc4-serve")
    return spec


def renamed(tmp_path, driver=None, as_name=None):
    """A copy of the benchmark with the plain-head serving cell, whose
    cells run a copy of ``driver`` under another name."""
    home = tmp_path / "benchmark"
    shutil.copytree(HOME, home, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = with_plain_serve(json.loads((ROOT / "BENCHMARK.json").read_text()))
    if driver:
        shutil.copy(home / "traffic" / f"{driver}.py",
                    home / "traffic" / f"{as_name}.py")
        mix = json.loads((home / "traffic" / f"{driver}.json").read_text())
        mix["driver"] = as_name
        (home / "traffic" / f"{as_name}.json").write_text(json.dumps(mix))
        for w in spec["workloads"]:
            if w["traffic"] == driver:
                w["traffic"] = as_name
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(tmp_path, home)


@pytest.mark.parametrize("driver,as_name,cell,number", [
    ("train", "fit", "o1-yc4-train", "loss_gap"),
    ("serve", "answer", "o1-yc4-serve", "score_gap")])
def test_a_driver_is_taken_by_its_role(tmp_path, driver, as_name, cell,
                                       number):
    import control
    from conftest import shrink
    c = shrink(renamed(tmp_path, driver, as_name).cell(cell))
    assert c.traffic["driver"] == as_name
    assert c.role == driver
    (what, numbers), = control.readings(c, 7, "program", "cpu")
    assert what == "program" and number in numbers


# model FLOPs and the fused losses' least time of the two MSGIFSR
# configurations on fixed sessions, as the counts read them before
# families had counts of their own
PINNED = {"msgifsr-o1-yc4": (3437531136, 0.0005872120358208956,
                             4.355106650746268e-05),
          "msgifsr-o3-paper-yc4": (17278718976, 0.0017604903278805972,
                                   0.00012775442340298506)}


def fixed_sessions():
    return data.make_sessions(2 ** 31 + 11, "train", 40, 37484,
                              data.load_profile("sample_lengths.json"),
                              data.load_profile(
                                  "sample_item_frequencies.json"))


@pytest.mark.parametrize("name", sorted(PINNED))
def test_msgifsr_counts_are_unchanged(name):
    cfg = json.loads((HOME / "configs" / f"{name}.json").read_text())
    flops, at512, at37 = PINNED[name]
    seqs = fixed_sessions()
    count = load_module(HOME / "counts" / "flops" / "msgifsr.py")
    assert count.step_flops(cfg, seqs) == flops
    assert msgifsr_count.step_flops(cfg, seqs) == flops
    head = program.head(program.build_model(cfg, "cpu"))
    assert head == msgifsr_count.head(cfg)
    for rows, want in ((512, at512), (37, at37)):
        assert xent.step_loss_seconds(cfg, rows, head) == want
        assert xent.step_loss_seconds(cfg, rows) == want


@pytest.mark.parametrize("family,plain,norm", [
    ("lessr", True, False), ("srgnn", True, False), ("niser", True, True)])
def test_a_plain_family_is_counted_by_its_head(tmp_path, family, plain,
                                               norm):
    bench = family_bench(tmp_path, family, traffic=("train",))
    cell = bench.cell(f"{family}-train")
    cfg = cell.config
    # ModelConfig's default ``norm`` is on: the head is the program's
    cfg["model"] = {"norm": True, "order": 3, "extra": True,
                    "fusion": True, **cfg["model"]}
    head = program.head(program.build_model(cfg, "cpu"))
    assert head == {"plain": plain, "table_norm": norm, "orders": 1}
    d = cfg["model"]["embedding_dim"]
    want = sum(xent.least_seconds(*f(20, ITEMS, d, norm=norm))
               for f in (xent.k1, xent.k2))
    assert xent.step_loss_seconds(cfg, 20, head) == want
    assert cell.flops() is None

    class Profile:
        window_s = 1.0
    out = Outcome(metrics={}, attempted=1, failed=0, checks=[],
                  memory_peak_bytes=0, profile=Profile(),
                  data={"profiled_steps": [[([1, 2], 3)]], "head": head})
    assert cell.reader("mfu.train").read(Run(cell, out, None)) is None


def test_plain_head_scores_are_compared_as_logits(tmp_path):
    from conftest import shrink
    cell = shrink(renamed(tmp_path).cell("o1-yc4-serve"))
    ref = cell.reference()
    cfg = cell.config
    weights = ref.init_params(cfg, 11, "cpu")
    sessions = data.make_sessions(11, "serve", 64, cfg["catalog"]["num_items"],
                                  data.load_profile("sample_lengths.json"),
                                  data.load_profile(
                                      "sample_item_frequencies.json"))
    logits = ref.serve_scores(cfg, weights, sessions, device="cpu")
    assert torch.equal(logits, ref.serve_logits(cfg, weights, sessions,
                                                device="cpu"))
    vals, ids = torch.topk(logits, 20, dim=1)
    numbers = check.serve_numbers(ids, vals + 1e-7, logits)
    assert numbers["score_gap"] < 1e-6 and numbers["rank_gap"] == 0.0
    off = ids.clone()
    off[:, 0] = (off[:, 0] + 1) % cfg["catalog"]["num_items"]
    numbers = check.serve_numbers(off, vals, logits)
    # unit session vectors against a normalised table: logits lie in
    # [-1, 1], so a wrong id reads a gap of that order, far over the limit
    limits = cell.params["limits"]
    for name in ("score_gap", "rank_gap"):
        assert numbers[name] > max(0.5, 1000 * limits[name])
    # the multi-order head's log-probabilities are another quantity
    lp = ref.serve_log_probs(cfg, weights, sessions, device="cpu")
    assert check.serve_numbers(ids, vals, lp)["score_gap"] > 1


def test_the_plain_head_serving_cell_is_checked(tmp_path, monkeypatch):
    """The plain-head serving cell at test size: a run is correct, its
    control (the reference at TF32) fails a limit, and an answer altered
    where the top-k is taken reads ``correct`` false."""
    import control
    import run
    from conftest import shrink
    from test_bench_faults import altered
    cell = shrink(renamed(tmp_path).cell("o1-yc4-serve"))
    res = run.run_cell(cell, 2 ** 31 + 99, 0.5, 0, device="cpu")
    assert res["correct"], res["checks"]
    limits = cell.params["limits"]
    low = dict(control.readings(cell, 21, "control", "cpu"))["tf32"]
    assert any(low[k] > lim for k, lim in limits.items()), low
    altered(monkeypatch)
    res = run.run_cell(cell, 2 ** 31 + 5, 0.3, 0, device="cpu")
    assert not res["correct"], res["checks"]
