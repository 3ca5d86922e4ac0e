"""Whole runs at the test size on the CPU: the program against the
reference in every cell, and the result line's keys."""

import json
import shutil
import subprocess
import sys

import pytest

from conftest import HOME, ROOT

import run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", ["o1-yc4-train", "paper-yc4-train",
                                  "paper-yc4-serve"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_is_correct(tiny, name, trace):
    cell = tiny(name)
    res = run.run_cell(cell, 2 ** 31 + 99, 0.5, trace, device="cpu")
    assert res["correct"], res["checks"]
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(res) == want
    assert res["attempted"] > 0 and res["failed"] == 0
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == names
    else:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "o1-yc4-train", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_no_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HOME, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, runpy; sys.argv = ['run.py', '--workload', "
            "'o1-yc4-train', '--seed', '1', '--seconds', '1']; "
            "import torch; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; "
            "runpy.run_path('benchmark/run.py', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "sessionrec_tpu_torch" in out.stderr
    assert "{" not in out.stdout


@pytest.mark.gpu
def test_a_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "paper-yc4-serve", "--seed", "2147483999",
                          "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
