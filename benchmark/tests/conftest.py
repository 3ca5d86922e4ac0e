"""The benchmark's CPU tests: the harness's modules on the path, and its
cells cut to a size the CPU runs in seconds (width 32, 2,000 items,
batch 64: test sizes, never a benchmark configuration)."""

import sys
from pathlib import Path

import pytest

HOME = Path(__file__).resolve().parents[1]
ROOT = HOME.parent
for p in (str(HOME), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def shrink(cell, dim=32, items=2000, batch=64):
    cell.config["model"]["embedding_dim"] = dim
    cell.config["catalog"]["num_items"] = items
    cell.config["data"]["batch_size"] = batch
    cell.params.update(train_examples=3000, trace_chunks=2,
                       pool_sessions=4 * batch, trace_requests=2,
                       check_requests=2)
    cell.traffic["request_sessions"] = batch
    cell.traffic["unroll"] = 2
    return cell


@pytest.fixture
def tiny():
    """``tiny(name)``: the benchmark's cell ``name`` at the test size."""
    from harness.cells import Bench

    def make(name, **kw):
        return shrink(Bench(ROOT).cell(name), **kw)
    return make
