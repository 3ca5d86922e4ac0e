"""No module a run loads is JAX or the JAX package, top-level names
compared whole; the reference imports nothing of the program."""

import ast
import subprocess
import sys

from conftest import HOME, ROOT
from harness.imports import forbidden_modules


def test_whole_names():
    assert forbidden_modules(["sessionrec_tpu_torch",
                              "sessionrec_tpu_torch.models.msgifsr",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["sessionrec_tpu.models", "jax.numpy",
                              "jaxlib", "flax.linen", "optax"]) == \
        ["flax", "jax", "jaxlib", "optax", "sessionrec_tpu"]


def test_a_run_loads_none(tiny):
    code = f"""
import sys
sys.path[:0] = [{str(HOME)!r}, {str(ROOT)!r}]
import run
from conftest import shrink
from harness.cells import Bench
for name in ("o1-yc4-train", "paper-yc4-serve"):
    cell = shrink(Bench(run.ROOT).cell(name))
    assert run.run_cell(cell, 5, 0.2, 0, device="cpu") is not None
from harness.imports import forbidden_modules
print("FOUND", forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600,
                         env={"PYTHONPATH": str(HOME / "tests"),
                              "PATH": "/usr/bin:/bin"})
    assert "FOUND []" in out.stdout, out.stderr[-3000:]


def imports_of(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_torch_and_numpy_only():
    for path in (HOME / "reference").glob("*.py"):
        tops = {n.split(".")[0] for n in imports_of(path)}
        assert tops <= {"__future__", "math", "numpy", "torch"}, path


def test_no_harness_file_names_jax():
    for path in HOME.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert forbidden_modules(list(imports_of(path))) == [], path
