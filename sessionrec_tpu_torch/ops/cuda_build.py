"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into one shared library
with a plain C interface, loaded with ctypes.  The library is built at
first use into ``build/`` at the repository root, named by a hash of
every source and header under ``csrc/``, so a changed source builds anew
and an unchanged one is loaded as it is.  Each kernel module
(``ops/xent.py``, ``ops/xent_multi.py``) declares the argument types of
its own entry points.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lib = None


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "sessionrec_tpu_torch need the CUDA toolkit")


def sources():
    """The kernel sources, one compile each."""
    return sorted(CSRC.glob("*.cu"))


def _digest():
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:12]


def build_library():
    """Compile and link every ``csrc/*.cu`` (once per version of the
    sources) and return the path of the shared library."""
    out = BUILD / f"libsrt_kernels-{_digest()}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=BUILD))
    try:
        procs = []
        for src in sources():
            obj = tmp / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, _, proc in procs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{stdout}\n"
                              f"{stderr}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        so = tmp / "lib.so"
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(so),
             *(str(obj) for _, obj, _ in procs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(so, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def library():
    """The loaded kernel library (built first if need be)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build_library()))
    return _lib
