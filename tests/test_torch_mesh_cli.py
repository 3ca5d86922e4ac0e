"""``cli train`` on a mesh, on the CPU (mirrors tests/test_multihost.py):
two processes launched with ``--coordinator`` (each builds its rows of
every global batch; no tiers) and the two that ``cli train`` starts
itself for ``--model-parallel 2`` both print the one-process run's
metrics (to the print's 3 decimals), dropout on; only rank 0 prints; a
mesh with more ranks than visible cards raises."""

import re
import subprocess
import sys

import pytest

import _torch_mesh_worker as W
from sessionrec_tpu_torch import cli

FLAGS = ["train", "--model", "niser", "--dataset-dir", str(W.SAMPLE),
         "--device", "cpu", "--embedding-dim", "16", "--num-layers", "1",
         "--epochs", "1", "--max-epoch-batches", "6", "--batch-size", "64",
         "--log-interval", "1000000", "--split-len", "0",
         "--valid-split", "0.02"]


def _metrics(out):
    m = re.search(r"^([\d.]+)%\t([\d.]+)%\s*$", out, re.M)
    return None if m is None else (float(m.group(1)), float(m.group(2)))


def _run(extra, n=1):
    port = str(W._free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sessionrec_tpu_torch.cli", *FLAGS, *extra,
         *([] if n == 1 else ["--coordinator", f"127.0.0.1:{port}",
                              "--num-processes", str(n),
                              "--process-id", str(i)])],
        cwd=W.REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(n)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


@pytest.fixture(scope="module")
def single():
    """The one-process run's metrics."""
    return _metrics(_run([])[0])


@pytest.mark.parametrize("launch", ["coordinator", "spawn"])
def test_mesh_cli_matches_one_process(single, launch):
    if launch == "coordinator":
        outs = _run(["--data-parallel", "2"], n=2)
        assert _metrics(outs[1]) is None          # the primary prints
    else:
        outs = _run(["--model-parallel", "2"])
    got = _metrics(outs[0])
    assert single is not None and got is not None
    assert got == pytest.approx(single, abs=2e-3)


def test_mesh_with_more_ranks_than_cards_raises(monkeypatch):
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    with pytest.raises(SystemExit, match="card per rank"):
        cli.main([*FLAGS[:FLAGS.index("--device")], "--data-parallel", "2",
                  "--model-parallel", "2"])
