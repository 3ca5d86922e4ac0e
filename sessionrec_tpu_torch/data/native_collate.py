"""ctypes binding of the C++ batch builders (``csrc/collate.cc``).

Counterpart of ``sessionrec_tpu/data/native_collate.py``:
``build_session_batch``, ``build_lessr_batch`` and ``build_ccs_batch``
return the same dicts of numpy arrays as their namesakes in
``graph/builders.py``, bit for bit.  The C calls release
the interpreter lock (ctypes ``CDLL``), so the loader's prefetch thread
builds batches while the training loop dispatches.

The library is compiled with the host C++ compiler (``$CXX``, else
``g++``) at first use into ``build/`` at the repository root, named by a
digest of the source, as ``ops/cuda_build.py`` names the kernels' library.
Unlike the JAX package's binding, nothing falls back: a compiler that is
missing or fails, or a library that does not load, raises with the
compiler's message.  The pure-Python builders run only where the caller
asks for them (``BatchLoader(use_native=False)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from sessionrec_tpu_torch.graph.builders import mailbox_depth

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "collate.cc"
BUILD = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_lib = None
_lock = threading.Lock()

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_ppv = ctypes.POINTER(ctypes.c_void_p)


def _compiler():
    name = os.environ.get("CXX", "g++")
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(
            f"C++ compiler {name!r} not found: the native batch builders "
            "(sessionrec_tpu_torch/csrc/collate.cc) needs one; set $CXX, or "
            "build batches in Python with use_native_collate=False")
    return found


def library_path(build_dir=None):
    """Where the library for the current source lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return Path(build_dir or BUILD) / f"libsrt_collate-{digest}.so"


def build_library(build_dir=None):
    """Compile ``csrc/collate.cc`` (once per version of the source) and
    return the path of the shared library."""
    out = library_path(build_dir)
    if out.exists():
        return out
    cxx = _compiler()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        so = tmp / out.name
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(so), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) on "
                               f"{SOURCE.name}:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(so, out)        # atomic: concurrent builders agree
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def library():
    """The loaded builder library (built first if need be)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            i = ctypes.c_int
            lib.srt_build_session.restype = None
            lib.srt_build_session.argtypes = [
                _i32p, _i32p, i, i, _i32p, _f32p, _f32p, _i32p]
            lib.srt_build_lessr.restype = None
            lib.srt_build_lessr.argtypes = [
                _i32p, _i32p, i, i, i, _i32p, _f32p, _i32p, _f32p, _f32p,
                _i32p]
            lib.srt_build_ccs.restype = None
            lib.srt_build_ccs.argtypes = [
                _i32p, _i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _ppv, _ppv, _ppv, _ppv, _ppv, _ppv, _i32p]
            _lib = lib
    return _lib


def _flatten(seqs, batch_size, max_len):
    """The sequences as one int32 array and its offsets, after the check
    that they fit the caller's arrays: at most ``batch_size`` of them, none
    longer than ``max_len`` (the C builders index without bounds)."""
    if len(seqs) > batch_size:
        raise ValueError(f"{len(seqs)} sequences for a batch of "
                         f"{batch_size}")
    longest = max(map(len, seqs), default=0)
    if longest > max_len:
        raise ValueError(f"a sequence of {longest} items exceeds the node "
                         f"cap {max_len}")
    offsets = np.zeros(len(seqs) + 1, dtype=np.int32)
    for i, s in enumerate(seqs):
        offsets[i + 1] = offsets[i] + len(s)
    flat = np.fromiter((x for s in seqs for x in s), dtype=np.int32,
                       count=int(offsets[-1]))
    return flat, offsets


def _ptr_array(arrs):
    return (ctypes.c_void_p * len(arrs))(
        *[a.ctypes.data_as(ctypes.c_void_p) for a in arrs]) \
        if arrs else (ctypes.c_void_p * 1)()


def _labels_valid(n, labels, batch_size):
    labels_arr = np.zeros(batch_size, dtype=np.int32)
    labels_arr[:len(labels)] = labels
    valid = np.zeros(batch_size, dtype=np.float32)
    valid[:n] = 1.0
    return labels_arr, valid


def build_session_batch(seqs, labels, max_nodes, batch_size):
    """``graph/builders.py:build_session_batch`` through the C++ builder."""
    lib = library()
    flat, offsets = _flatten(seqs, batch_size, max_nodes)
    B, N = batch_size, max_nodes
    node_iid = np.zeros((B, N), dtype=np.int32)
    node_mask = np.zeros((B, N), dtype=np.float32)
    adj = np.zeros((B, N, N), dtype=np.float32)
    last_idx = np.zeros(B, dtype=np.int32)
    lib.srt_build_session(flat, offsets, len(seqs), N, node_iid, node_mask,
                          adj, last_idx)
    labels_arr, valid = _labels_valid(len(seqs), labels, B)
    return dict(node_iid=node_iid, node_mask=node_mask, adj=adj,
                last_idx=last_idx, labels=labels_arr, valid=valid)


def build_lessr_batch(seqs, labels, max_nodes, batch_size):
    """``graph/builders.py:build_lessr_batch`` through the C++ builder."""
    lib = library()
    flat, offsets = _flatten(seqs, batch_size, max_nodes)
    B, N = batch_size, max_nodes
    M = mailbox_depth(max_nodes)
    node_iid = np.zeros((B, N), dtype=np.int32)
    node_mask = np.zeros((B, N), dtype=np.float32)
    mail_idx = np.zeros((B, N, M), dtype=np.int32)
    mail_mask = np.zeros((B, N, M), dtype=np.float32)
    sc_adj = np.zeros((B, N, N), dtype=np.float32)
    last_idx = np.zeros(B, dtype=np.int32)
    lib.srt_build_lessr(flat, offsets, len(seqs), N, M, node_iid, node_mask,
                        mail_idx, mail_mask, sc_adj, last_idx)
    labels_arr, valid = _labels_valid(len(seqs), labels, B)
    return dict(node_iid=node_iid, node_mask=node_mask, mail_idx=mail_idx,
                mail_mask=mail_mask, sc_adj=sc_adj, last_idx=last_idx,
                labels=labels_arr, valid=valid)


def build_ccs_batch(seqs, labels, order, max_len, batch_size):
    """``graph/builders.py:build_ccs_batch`` through the C++ builder."""
    lib = library()
    flat, offsets = _flatten(seqs, batch_size, max_len)
    B, K = batch_size, order
    caps = np.asarray([max(max_len - k + 1, 1) for k in range(1, K + 1)],
                      dtype=np.int32)
    levels = []
    for k in range(1, K + 1):
        Nk = int(caps[k - 1])
        levels.append(dict(
            iid=np.zeros((B, Nk, k), dtype=np.int32),
            mask=np.zeros((B, Nk), dtype=np.float32),
            intra_adj=np.zeros((B, Nk, Nk), dtype=np.float32),
            last_idx=np.zeros(B, dtype=np.int32)))
    inter_in = [np.zeros((B, int(caps[0]), int(caps[k - 1])),
                         dtype=np.float32) for k in range(2, K + 1)]
    inter_out = [np.zeros((B, int(caps[k - 1]), int(caps[0])),
                          dtype=np.float32) for k in range(2, K + 1)]
    lib.srt_build_ccs(
        flat, offsets, len(seqs), K, max_len,
        _ptr_array([lv["iid"] for lv in levels]),
        _ptr_array([lv["mask"] for lv in levels]),
        _ptr_array([lv["intra_adj"] for lv in levels]),
        _ptr_array([lv["last_idx"] for lv in levels]),
        _ptr_array(inter_in), _ptr_array(inter_out), caps)
    labels_arr, valid = _labels_valid(len(seqs), labels, B)
    return dict(levels=levels, inter_in=inter_in, inter_out=inter_out,
                labels=labels_arr, valid=valid)
