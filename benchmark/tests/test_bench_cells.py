"""Cells, configurations, mixes and metrics are found by name, so a later
one is new files and new entries in ``BENCHMARK.json`` alone."""

import json
import shutil

from conftest import HOME, ROOT
from harness.cells import Bench


def test_every_cell_resolves():
    bench = Bench(ROOT)
    for w in bench.spec["workloads"]:
        cell = bench.cell(w["name"])
        assert cell.driver().run
        assert cell.reference().param_spec(cell.config)
        assert [m["name"] for m in cell.end_to_end][-1] == "setup_s" or \
            "setup_s" in [m["name"] for m in cell.end_to_end]
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]).read)


def test_new_files_are_found_by_name(tmp_path):
    home = tmp_path / "benchmark"
    shutil.copytree(HOME, home, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((home / "configs" / "msgifsr-o1-yc4.json").read_text())
    cfg["name"] = "msgifsr-o2-yc4"
    cfg["model"]["order"] = 2
    (home / "configs" / "msgifsr-o2-yc4.json").write_text(json.dumps(cfg))
    mix = json.loads((home / "traffic" / "train.json").read_text())
    mix["unroll"] = 4
    (home / "traffic" / "train-unroll4.json").write_text(json.dumps(mix))
    cell = json.loads((home / "workloads" / "o1-yc4-train.json").read_text())
    (home / "workloads" / "o2-yc4-train.json").write_text(json.dumps(cell))
    (home / "metrics" / "steps.train.py").write_text(
        "def read(run):\n    return 42.0\n")
    spec["configs"].append({"name": "msgifsr-o2-yc4", "source": "x",
                            "file": "benchmark/configs/msgifsr-o2-yc4.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "o2-yc4-train",
                              "config": "msgifsr-o2-yc4",
                              "traffic": "train-unroll4", "chips": 1,
                              "why": "x"})
    spec["end_to_end"][0]["workloads"].append("o2-yc4-train")
    spec["per_layer"].append({"name": "steps.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "x", "moves": "train_examples_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    new = Bench(tmp_path, home).cell("o2-yc4-train")
    assert new.config["model"]["order"] == 2
    assert new.traffic["unroll"] == 4
    names = [m["name"] for m in new.per_layer]
    assert "steps.train" in names and "dispatch_ms.train" not in names
    assert new.reader("steps.train").read(None) == 42.0
    # a metric without a workloads list reaches every cell of its metric
    old = Bench(tmp_path, home).cell("o1-yc4-train")
    assert "steps.train" in [m["name"] for m in old.per_layer]
    serve = Bench(tmp_path, home).cell("paper-yc4-serve")
    assert "steps.train" not in [m["name"] for m in serve.per_layer]
