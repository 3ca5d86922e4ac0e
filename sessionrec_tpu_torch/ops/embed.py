"""The embedding gather of a training step and its backward.

Every model gathers table rows by item id once per length tier (MSGIFSR
once per tier and level: 3 gathers a step at order 1, 9 for the WSDM'22
paper head at tiers (4, 8)).  ``gather(table, ids)`` returns each id
tensor's rows, ``table[ids]``.  For CUDA tensors with gradients on, it is
one autograd node over all of them, whose backward is one launch of
``csrc/embed_bwd.cu``: the table's dense gradient, written once, summed
over every gather of the step in a fixed order (no atomics), in float32,
rounded once to the table's type.  Each piece's forward stays torch's
indexing.

The kernel is built for the padding.  Every tier is padded to static row
and node caps with id 0, so about two thirds of a step's slots gather row
0; torch's index backward walked that run serially, one dependent load a
slot, once per gather.  Here the slots are ordered by id with a stable
``torch.sort``; runs are cut into tiles of ``TILE`` slots, each tile's
pieces summed in slot order (the tile partials), and a run longer than a
tile reduced from its partials in ``ways(D)`` interleaved ways, added in
order (``csrc/embed_bwd.cu`` says how the kernels do it).

Beside the kernel sits its plain version, ``_bwd_plain``: the same sums
in the same order, in PyTorch, so the card's result equals it to the bit.
``embed_bwd`` launches the kernel for CUDA tensors (counted in
``embed.bwd``, ``utils/profiling.py``; a capture counts once) and takes
the plain version for CPU tensors.  ``gather`` itself keeps ``table[ids]``
for CPU tensors and without gradients (eval, serving), so the CPU path and
its autograd are as they were.
"""

from __future__ import annotations

import ctypes

import torch

from sessionrec_tpu_torch.ops import cuda_build
from sessionrec_tpu_torch.utils import profiling

TILE = 32           # slots a tile (csrc/embed_bwd.cu RUN_TILE)
MAX_PIECES = 32     # gradient tensors one launch takes
_RED_FLOATS = 4096  # the long-run tree's shared floats
_MAX_WAYS = 32


def ways(D):
    """Ways of the long-run tree at width ``D`` (``csrc/embed_bwd.cu``)."""
    return max(1, min(_MAX_WAYS, _RED_FLOATS // D))


# ---------------------------------------------------------------------------
# plain version (the oracle)
# ---------------------------------------------------------------------------

def _run_sums(rows, starts, ends):
    """``rows[s:e]`` summed in row order from 0 for each ``(s, e)``, runs
    of at most ``TILE`` rows; ``[len(starts), D]`` float32."""
    acc = torch.zeros(starts.numel(), rows.shape[1], dtype=torch.float32,
                      device=rows.device)
    for j in range(TILE):
        live = starts + j < ends
        if not bool(live.any()):
            break
        acc[live] += rows[starts[live] + j]
    return acc


def _long_run(rows, h, e, D):
    """A run ``[h, e)`` of the sorted slots longer than a tile: its tile
    partials, then ``ways(D)`` ways over every W-th partial, added in
    order."""
    t0, t1 = h // TILE, (e - 1) // TILE
    cuts = [h] + [t * TILE for t in range(t0 + 1, t1 + 1)] + [e]
    dev = rows.device
    part = _run_sums(rows, torch.tensor(cuts[:-1], device=dev),
                     torch.tensor(cuts[1:], device=dev))
    W = ways(D)
    acc = torch.zeros(W, D, dtype=torch.float32, device=dev)
    for i in range(part.shape[0]):
        acc[i % W] += part[i]
    out = acc[0].clone()
    for w in range(1, W):
        out += acc[w]
    return out


def _bwd_plain(grads, ids, P):
    """``d_table [P, D]`` in the gradients' type: for each row the
    gradient rows (``grads``, each ``[..., D]``, in the order of ``ids``)
    of the slots whose id it is, summed as the kernel sums them; ids
    outside ``[0, P)`` land nowhere."""
    D = grads[0].shape[-1]
    g = torch.cat([x.reshape(-1, D) for x in grads]).to(torch.float32)
    ids = ids.reshape(-1).to(torch.int64)
    out = torch.zeros(P, D, dtype=torch.float32, device=g.device)
    if ids.numel():
        s, perm = torch.sort(ids, stable=True)
        rows = g[perm]
        run, counts = torch.unique_consecutive(s, return_counts=True)
        ends = torch.cumsum(counts, 0)
        starts = ends - counts
        keep = (run >= 0) & (run < P)
        short = keep & (counts <= TILE)
        out[run[short]] = _run_sums(rows, starts[short], ends[short])
        for r, h, e in zip(*(x[keep & ~short].tolist()
                             for x in (run, starts, ends))):
            out[r] = _long_run(rows, h, e, D)
    return out.to(grads[0].dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel (csrc/embed_bwd.cu)
# ---------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.library()
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.srt_embed_bwd.argtypes = [ctypes.POINTER(vp),
                                      ctypes.POINTER(ctypes.c_longlong), i,
                                      vp, vp, i, i, i, i, i, vp, vp, vp, vp,
                                      vp]
        lib.srt_embed_bwd.restype = i
        lib.srt_embed_bwd_attrs.argtypes = [i, i, ctypes.POINTER(i)]
        lib.srt_embed_bwd_attrs.restype = i
        for name in ("srt_embed_tile", "srt_embed_max_pieces"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        lib.srt_embed_ways.argtypes = [i]
        lib.srt_embed_ways.restype = i
        if (lib.srt_embed_tile(), lib.srt_embed_max_pieces(),
                lib.srt_embed_ways(256)) != (TILE, MAX_PIECES, ways(256)):
            raise RuntimeError("csrc/embed_bwd.cu and ops/embed.py disagree "
                               "on the tile, the pieces or the ways")
        _lib = lib
    return _lib


def kernel_attrs(dtype, vec=True):
    """``{kernel: (registers, local bytes) a thread}`` of the three kernels
    in ``dtype`` (``vec``: four elements a lane)."""
    out = (ctypes.c_int * 6)()
    err = _library().srt_embed_bwd_attrs(int(dtype == torch.bfloat16),
                                         int(vec), out)
    if err:
        raise RuntimeError(f"embed_bwd attributes: CUDA error {err}")
    return {k: (out[2 * i], out[2 * i + 1]) for i, k in enumerate(
        ("embed_bwd_tiles", "embed_bwd_long", "embed_bwd_rows"))}


def _check(grads, ids):
    """Raise on anything the kernels do not take."""
    dtype, dev, D = grads[0].dtype, grads[0].device, grads[0].shape[-1]
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gradients must be float32 or bfloat16, got {dtype}")
    if D == 0:
        raise ValueError("empty feature width")
    for g in grads:
        if g.dtype != dtype or g.device != dev or g.shape[-1] != D:
            raise ValueError("gradients of one type, device and width")
    if ids.dtype not in (torch.int32, torch.int64) or ids.device != dev:
        raise TypeError(f"ids must be integers on {dev}, got {ids.dtype} "
                        f"on {ids.device}")
    if ids.numel() != sum(g.numel() // D for g in grads):
        raise ValueError("one id a gradient row")


def _bwd_cuda(grads, ids, P):
    _check(grads, ids)
    lib = _library()
    D = grads[0].shape[-1]
    rows = [g.reshape(-1, D).contiguous() for g in grads]
    if len(rows) > MAX_PIECES:
        rows = [torch.cat(rows)]
    n = ids.numel()
    srt, perm = torch.sort(ids.reshape(-1).to(torch.int32), stable=True)
    dev, dtype = rows[0].device, rows[0].dtype
    src = torch.empty(max(1, n), dtype=torch.int64, device=dev)
    head_tail = torch.empty(2 * P, dtype=torch.int32, device=dev)
    part = torch.empty(max(1, 2 * -(-n // TILE)), D, dtype=torch.float32,
                       device=dev)
    dtab = torch.empty(P, D, dtype=dtype, device=dev)
    begins, at = [], 0
    for r in rows:
        begins.append(at)
        at += r.shape[0]
    align = 4 * rows[0].element_size()
    vec = int(D % 4 == 0 and all(t.data_ptr() % align == 0
                                 for t in rows + [dtab]))
    k = len(rows)
    err = lib.srt_embed_bwd(
        (ctypes.c_void_p * k)(*(r.data_ptr() for r in rows)),
        (ctypes.c_longlong * k)(*begins), k, srt.data_ptr(),
        perm.data_ptr(), n, P, D, int(dtype == torch.bfloat16), vec,
        src.data_ptr(), head_tail.data_ptr(), part.data_ptr(),
        dtab.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"embed_bwd launch: CUDA error {err}")
    profiling.count("embed.bwd")
    return dtab


def embed_bwd(grads, ids, P):
    """The table's gradient ``[P, D]`` (the gradients' type) from the
    gradient rows ``grads`` (``[..., D]`` tensors, in the order of ``ids``)
    of the slots ``ids`` (all the tensors' ids, flattened in order)."""
    if grads[0].is_cuda:
        return _bwd_cuda(grads, ids, P)
    if grads[0].device.type != "cpu":
        raise NotImplementedError(f"no embed_bwd kernel for "
                                  f"{grads[0].device}")
    return _bwd_plain(grads, ids, P)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, *ids):
        ctx.save_for_backward(*ids)
        ctx.rows = table.shape[0]
        return tuple(table[i.to(torch.int64)] for i in ids)

    @staticmethod
    def backward(ctx, *grads):
        ids = ctx.saved_tensors
        flat = torch.cat([i.reshape(-1) for i in ids])
        return (embed_bwd(grads, flat, ctx.rows), *([None] * len(ids)))


def gather(table, ids):
    """``[table[i] for i in ids]``; on the card, with gradients on, one
    autograd node whose backward is one ``embed_bwd`` of them all."""
    if table.is_cuda and table.requires_grad and torch.is_grad_enabled():
        return list(_Gather.apply(table, *ids))
    return [table[i.to(torch.int64)] for i in ids]
