"""Fused full-catalog softmax cross-entropy.

Counterpart of ``sessionrec_tpu/ops/xent.py``.  Every training step's loss
is ``nll(log_softmax(scale * sr @ table^T))`` over the whole item catalog,
optionally against ``l2norm(table)``.  On CUDA tensors the loss runs the
hand-written kernels of ``csrc/xent.cu`` (K1) and ``csrc/xent_bwd.cu``
(K2); the ``[B, P]`` logits never exist in device memory:

* K1 (``xent_fwd``, replaces the Pallas ``_fwd_kernel``) takes the table's
  norms once, streams the catalog and keeps a running row max, sum-exp
  and label logit, on a grid that ``_fwd_grid`` sizes to the card's
  resident block slots; it returns the per-row loss and the log-partition
  ``lse``, the only residual the backward pass needs.
* K2 (``xent_bwd``, replaces the Pallas ``_bwd_kernel``) normalises the
  table once, recomputes the logits tile by tile and writes ``d_sr`` and
  ``d_table`` with the l2norm VJP folded in, on a grid that ``_bwd_grid``
  sizes to the card's resident block slots.

In bfloat16 both kernels multiply on the tensor cores at every width
(``mma.sync`` m16n8k16, float32 sums; ``product`` in their launch
shapes), in float32 on the FMA pipes.

Up to 256 features a row the kernels above run in one pass; past it
(``--embedding-dim 512``) the same wrappers run the slab path of
``csrc/tiles.cuh``: K1 streams its split's catalog tiles in k-chunks of
64 features through a ring of cp.async stages; K2 computes dz once per
catalog chunk into a scratch of at most ``DZ_SCRATCH_BYTES``, then
d_table's and d_sr's products over it in feature slabs of at most 256
(``slabs``, ``slab_bwd_plan``).

Beside each kernel sits its plain PyTorch version (``_fwd_plain``,
``_bwd_plain``), the oracle: a wrapper takes it only for tensors on the
CPU.  For CUDA tensors it launches the kernel or raises, and counts the
launch in ``xent.fwd`` or ``xent.bwd`` (``utils/profiling.py``, tracing
on; a capture counts once).  Logits and the softmax always accumulate in
float32, also for bfloat16 inputs.

The kernels and their plain versions take ``sr`` and the table in one
type; ``catalog_xent`` maps the four combinations of the table's type and
the compute type onto them:

* both float32, or both bfloat16: as they are (bf16 products accumulate
  in float32; the backward's operands are bf16, as the JAX kernels'
  ``mxu_dtype``; ``d_table`` is bf16);
* a bfloat16 table with float32 ``sr``: both go to float32 and the
  float32 kernels run, exactly the JAX numbers (a bf16 table upcasts
  losslessly; the JAX backward takes its operand type from ``sr``); the
  backward of the cast rounds ``d_table`` to bf16, as the JAX kernel's
  output type does;
* a float32 table with bfloat16 ``sr``: both go to float32 as well.  The
  forward is the JAX forward (bf16 values of ``sr`` against the float32
  table); the backward keeps its operands float32 where the JAX kernel
  rounds ``dz`` and the table operand to bf16, so the gradients differ
  from JAX's by bf16 rounding (about 2^-8 of their magnitude,
  ``tests/test_torch_bf16.py``); ``d_sr`` is rounded to bf16 by the
  cast's backward.

The kernels are built at first use with ``nvcc`` for ``sm_90a`` into
``build/`` at the repository root and loaded with ctypes
(``ops/cuda_build.py``).
"""

from __future__ import annotations

import ctypes

import torch

from sessionrec_tpu_torch.ops import cuda_build
from sessionrec_tpu_torch.ops.masked import NEG_INF
from sessionrec_tpu_torch.parallel.mesh import (MODEL_AXIS, all_reduce,
                                                shard_span)
from sessionrec_tpu_torch.utils import profiling

_NORM_EPS = 1e-12   # torch F.normalize eps (layers.l2norm)
_TINY = torch.finfo(torch.float32).tiny

# ---------------------------------------------------------------------------
# plain versions (the oracles)
# ---------------------------------------------------------------------------

def _columns(P, col_offset, device):
    return col_offset + torch.arange(P, device=device)


def _fwd_plain(sr, table, labels, n_valid, col_offset=0, *, scale,
               normalize_table):
    """``(m, s, zl)`` per row over the whole table, as one tile of the
    Pallas forward kernel computes them: running max, sum-exp relative to
    it, and the label logit (0 when no column matches the label)."""
    t = table.to(torch.float32)
    z = scale * torch.matmul(sr.to(torch.float32), t.T)
    if normalize_table:
        n = torch.linalg.vector_norm(t, dim=1)
        z = z / torch.clamp(n, min=_NORM_EPS)[None, :]
    col = _columns(table.shape[0], col_offset, sr.device)[None, :]
    z = torch.where(col < n_valid, z, NEG_INF)
    lbl = labels.to(torch.int64)[:, None]
    zl = torch.sum(torch.where(col == lbl, z, 0.0), dim=1)
    m = torch.amax(z, dim=1)
    m_safe = torch.clamp(m, min=NEG_INF * 0.5)
    s = torch.sum(torch.exp(z - m_safe[:, None]), dim=1)
    return m, s, zl


def _finish_lse(m, s):
    """log-sum-exp from a (running max, relative sum-exp) pair."""
    return torch.clamp(m, min=NEG_INF * 0.5) + \
        torch.log(torch.clamp(s, min=_TINY))


def _operand(table, normalize_table):
    """The backward products' table operand: ``t / max(||t||, eps)`` in
    float32, rounded to the table's type (the JAX kernel's MXU operand),
    and the clamped norms."""
    t = table.to(torch.float32)
    n = torch.clamp(torch.linalg.vector_norm(t, dim=1, keepdim=True),
                    min=_NORM_EPS)
    if normalize_table:
        that = t / n
        return that, that.to(table.dtype).to(torch.float32), n
    return t, t, n


def _bwd_plain(g, sr, table, labels, lse, n_valid, col_offset=0, *, scale,
               normalize_table):
    """``(d_sr [B, D] float32, d_table [P, D] in the table's type)`` for the
    per-row loss cotangent ``g`` — the Pallas backward kernel's math over
    the whole table as one tile."""
    mxu = table.dtype
    that, tmm, n = _operand(table, normalize_table)
    srf = sr.to(torch.float32)
    z = scale * torch.matmul(srf, tmm.T)
    col = _columns(table.shape[0], col_offset, sr.device)[None, :]
    p = torch.where(col < n_valid, torch.exp(z - lse[:, None]), 0.0)
    onehot = (col == labels.to(torch.int64)[:, None]).to(torch.float32)
    dz = ((p - onehot) * (scale * g.to(torch.float32))[:, None]) \
        .to(mxu).to(torch.float32)
    gtab = torch.matmul(dz.T, srf)
    if normalize_table:
        # VJP of t_hat = t / max(||t||, eps):
        #   dt = (G - (G . t_hat) t_hat [n > eps]) / max(n, eps)
        gdot = torch.sum(gtab * that, dim=1, keepdim=True)
        live = (n > _NORM_EPS).to(torch.float32)
        gtab = (gtab - gdot * that * live) / n
    dsr = torch.matmul(dz, tmm)
    return dsr, gtab.to(table.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/xent.cu, csrc/xent_bwd.cu)
# ---------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.library()
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.srt_xent_fwd.argtypes = [vp, vp, vp, i, i, i, i, i, f, i, i, i,
                                     i, i, vp, vp, vp, vp, vp]
        lib.srt_xent_fwd.restype = i
        lib.srt_xent_bwd.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, f, i,
                                     i, i, i, i, i, i, vp, vp, vp, vp, vp,
                                     vp, vp]
        lib.srt_xent_bwd.restype = i
        lib.srt_xent_bwd_slab.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i,
                                          f, i, i, i, i, i, i, i, vp, vp, vp,
                                          vp, vp, vp, vp, vp]
        lib.srt_xent_bwd_slab.restype = i
        for name in ("srt_xent_fwd_slots", "srt_xent_bwd_slots",
                     "srt_xent_bwd_dz_slots"):
            getattr(lib, name).argtypes = [i, i, ctypes.POINTER(i)]
            getattr(lib, name).restype = i
        lib.srt_xent_bwd_tile.argtypes = []
        lib.srt_xent_bwd_tile.restype = i
        lib.srt_xent_slabs.argtypes = [i]
        lib.srt_xent_slabs.restype = i
        lib.srt_xent_slab_width.argtypes = [i, i]
        lib.srt_xent_slab_width.restype = i
        _lib = lib
    return _lib


def _check(sr, table, labels, *vectors):
    """Raise on anything the kernels do not take."""
    dev = sr.device
    if sr.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sr must be float32 or bfloat16, got {sr.dtype}")
    same_dtype(sr, table)
    if sr.dim() != 2 or table.dim() != 2 or sr.shape[1] != table.shape[1]:
        raise ValueError(f"need sr [B, D] and table [P, D], got "
                         f"{tuple(sr.shape)} and {tuple(table.shape)}")
    if labels.dtype != torch.int32 or labels.shape != (sr.shape[0],):
        raise TypeError(f"labels must be int32 [B], got {labels.dtype} "
                        f"{tuple(labels.shape)}")
    for v in vectors:
        if v.dtype != torch.float32 or v.shape != (sr.shape[0],):
            raise TypeError(f"row vectors must be float32 [B], got "
                            f"{v.dtype} {tuple(v.shape)}")
    for t in (sr, table, labels) + vectors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if sr.shape[0] == 0 or table.shape[0] == 0 or sr.shape[1] == 0:
        raise ValueError("empty batch, catalog or feature width")


def _split(n, want):
    """(groups, per): ``n`` items cut into at most ``want`` contiguous
    groups of ``per`` items, none empty."""
    per = -(-n // max(1, min(want, n)))
    return -(-n // per), per


def _fwd_grid(B, P, slots, tile):
    """K1's grid, and K2's d_sr's: ``rows`` batch tiles of ``tile`` rows
    times ``s_split`` catalog splits of ``s_per`` ``tile``-row catalog
    tiles (``tiles`` in all).  The blocks fill at most ``slots`` (resident
    blocks per SM times SMs), with one split when the row tiles alone reach
    that."""
    tiles, rows = -(-P // tile), -(-B // tile)
    s_split, s_per = _split(tiles, slots // rows)
    return dict(tiles=tiles, rows=rows, s_split=s_split, s_per=s_per)


def _bwd_grid(B, P, slots, tile):
    """K2's grid up to 256 features.  d_table: ``tiles`` catalog tiles of
    ``tile`` rows times ``t_split`` row splits of ``t_per`` ``tile``-row
    chunks; d_sr: ``_fwd_grid``'s ``rows`` batch tiles times ``s_split``
    catalog splits of ``s_per`` tiles.  Each kernel's blocks fill at most
    ``slots``, with one split when its tiles alone reach that."""
    grid = _fwd_grid(B, P, slots, tile)
    t_split, t_per = _split(grid["rows"], slots // grid["tiles"])
    return dict(grid, t_split=t_split, t_per=t_per)


# the most bytes of the slab backward's dz scratch (csrc/tiles.cuh): one
# catalog chunk's dz, [round_up(R, 64), chunk] in the operand type.  256 MiB
# holds K4's 1,536 rows against the north-star catalog (37,888 rows) in
# float32 in one chunk; larger catalogs go in several.
DZ_SCRATCH_BYTES = 256 << 20
_MAX_GRID_Y = 65535          # CUDA's limit on a grid's y extent


def slab_bwd_plan(R, P, esz, slots, n_slabs, tile=64):
    """K2's and K4's plan past 256 features (``csrc/tiles.cuh``'s
    ``slab_bwd_chunks``), over ``R`` rows against a ``P``-row table of
    ``esz``-byte elements with ``slots`` resident product blocks:

    * ``chunk`` catalog tiles of ``tile`` rows a chunk (``chunks`` of them,
      the last one shorter), as many as keep the dz scratch ``dz_shape``
      (``rows`` row tiles by ``chunk`` tiles, padded to whole tiles) within
      ``DZ_SCRATCH_BYTES``;
    * d_table's product: a chunk's tiles times ``n_slabs`` slabs times
      ``t_split`` row splits of ``t_per`` row tiles;
    * d_sr's product: ``rows`` row tiles times ``n_slabs`` times
      ``s_split`` catalog splits of ``s_per`` tiles of a full chunk
      (``ceil(tiles / s_per)`` of the last one), ``dsr_parts`` partials in
      all.

    A full chunk's products fill at most ``slots`` blocks, with one split
    when their output tiles alone reach that."""
    rows, tiles = -(-R // tile), -(-P // tile)
    chunk = max(1, min(tiles, _MAX_GRID_Y,
                       DZ_SCRATCH_BYTES // (rows * tile * tile * esz)))
    chunks = -(-tiles // chunk)
    t_split, t_per = _split(rows, slots // (chunk * n_slabs))
    s_split, s_per = _split(chunk, slots // (rows * n_slabs))
    last = tiles - (chunks - 1) * chunk
    return dict(rows=rows, tiles=tiles, chunk=chunk, chunks=chunks,
                slabs=n_slabs, t_split=t_split, t_per=t_per,
                s_split=s_split, s_per=s_per,
                dsr_parts=(chunks - 1) * s_split + -(-last // s_per),
                dz_shape=(rows * tile, chunk * tile))


def slabs(D):
    """Feature slabs of K1-K4 at width ``D``: 1 up to 256 features, where
    the one-pass kernels run; more past it, where the slab path runs
    (``csrc/tiles.cuh``)."""
    return _library().srt_xent_slabs(D)


def slab_width(D, dtype):
    """Features of every feature slab but the last past 256 features, in
    ``dtype``: ceil(D / slabs) rounded up to 4 in float32 and to 16 in
    bfloat16, where each slab starts on a tensor-core k step
    (``csrc/tiles.cuh:slab_width``)."""
    return _library().srt_xent_slab_width(D, int(dtype == torch.bfloat16))


_slots = {}


def slots_query(fn, n, device, D, dtype):
    """The ``n`` numbers that the library's occupancy query ``fn`` (resident
    blocks per SM of a kernel family's product kernels at width ``D``, the
    SM count, their registers and local memory bytes per thread) gives for
    ``device``, cached per device."""
    key = (fn.__name__, device.index, D, dtype)
    if key not in _slots:
        out = (ctypes.c_int * n)()
        with torch.cuda.device(device):
            _raise_on(fn(D, int(dtype == torch.bfloat16), out),
                      f"{fn.__name__} occupancy")
        _slots[key] = tuple(out)
    return _slots[key]


def product(on_tensor_cores):
    """The name a launch line gives a product kernel's arithmetic: bfloat16
    runs on the tensor cores (``mma.sync``) at every width, float32 on the
    FMA pipes."""
    return "tensor_core" if on_tensor_cores else "fma"


def _fwd_attrs(device, D, dtype):
    """``srt_xent_fwd_slots``'s seven numbers for ``device``: resident
    blocks per SM of K1's partial kernel at width ``D``, the SM count, its
    registers and local memory bytes per thread, its dynamic shared memory
    bytes, the stages its staging pipelines and whether it runs on the
    tensor cores."""
    return slots_query(_library().srt_xent_fwd_slots, 7, device, D, dtype)


def _fwd_launch_grid(device, B, P, D, dtype):
    """K1's grid for ``B`` rows against a ``P``-row table on ``device``,
    from the partial kernel's own resident slots."""
    per_sm, sms = _fwd_attrs(device, D, dtype)[:2]
    return _fwd_grid(B, P, per_sm * sms, _library().srt_xent_bwd_tile())


def fwd_launch_shape(sr, P):
    """K1's launch for ``sr`` against a ``P``-row table: blocks, row tiles,
    catalog splits and tiles per split, resident blocks per SM, SMs, and
    the partial kernel's registers and local memory (spill) bytes per
    thread, its shared memory bytes, its staging stages (past 256
    features the chunk ring's: three in float32, four in bfloat16) and its
    ``product``."""
    (B, D), dev = sr.shape, sr.device
    per_sm, sms, regs, local, smem, stages, tc = _fwd_attrs(dev, D,
                                                            sr.dtype)
    grid = _fwd_launch_grid(dev, B, P, D, sr.dtype)
    return dict(blocks=grid["rows"] * grid["s_split"], row_tiles=grid["rows"],
                catalog_splits=grid["s_split"], tiles_per_split=grid["s_per"],
                resident_per_sm=per_sm, sms=sms, registers=regs,
                local_bytes=local, smem_bytes=smem, ring_stages=stages,
                product=product(tc))


def _bwd_attrs(device, D, dtype):
    """``srt_xent_bwd_slots``'s eight numbers for ``device``: resident
    blocks per SM of the d_table and d_sr product kernels at width ``D``
    (past 256 features the slab path's products), the SM count, the two
    kernels' registers and local memory bytes per thread, and whether they
    run on the tensor cores."""
    return slots_query(_library().srt_xent_bwd_slots, 8, device, D, dtype)


def _bwd_slots(device, D, dtype):
    """(resident K2 product blocks per SM, SMs) on ``device`` at width
    ``D``, the fewer of the d_table and d_sr kernels'."""
    a = _bwd_attrs(device, D, dtype)
    return min(a[0], a[1]), a[2]


def grid_shape(rows, P, per_sm, sms):
    """The blocks and splits of ``_bwd_grid`` over ``rows`` rows and a
    ``P``-row table with ``per_sm`` resident blocks on each of ``sms`` SMs:
    the d_table-like kernel's (catalog tiles x row splits) and the
    d_sr-like kernel's (row tiles x catalog splits)."""
    grid = _bwd_grid(rows, P, per_sm * sms, _library().srt_xent_bwd_tile())
    return dict(dtable_blocks=grid["tiles"] * grid["t_split"],
                dsr_blocks=grid["rows"] * grid["s_split"],
                row_splits=grid["t_split"], catalog_splits=grid["s_split"],
                slabs=1, resident_per_sm=per_sm)


def slab_grid_shape(rows, P, esz, per_sm, sms, n_slabs):
    """``slab_bwd_plan``'s blocks over ``rows`` rows and a ``P``-row table
    with ``per_sm`` resident product blocks on each of ``sms`` SMs: the dz
    kernel's, d_table's product's and d_sr's over all chunks, the chunks,
    the splits (d_sr's partials in all) and the dz scratch in MiB."""
    plan = slab_bwd_plan(rows, P, esz, per_sm * sms, n_slabs,
                         _library().srt_xent_bwd_tile())
    return dict(dz_blocks=plan["rows"] * plan["tiles"],
                dtable_blocks=plan["tiles"] * n_slabs * plan["t_split"],
                dsr_blocks=plan["rows"] * n_slabs * plan["dsr_parts"],
                chunks=plan["chunks"], row_splits=plan["t_split"],
                catalog_splits=plan["dsr_parts"], slabs=n_slabs,
                resident_per_sm=per_sm,
                dz_mib=plan["dz_shape"][0] * plan["dz_shape"][1] * esz
                / 2**20)


def bwd_launch_shape(sr, P):
    """K2's launch for ``sr`` against a ``P``-row table: blocks of each
    product kernel, row and catalog splits, resident blocks per SM, and
    each product kernel's registers and local memory (spill) bytes per
    thread and their ``product``; past 256 features the dz kernel's too,
    and the chunks."""
    (B, D), dev = sr.shape, sr.device
    per_sm, sms = _bwd_slots(dev, D, sr.dtype)
    a = _bwd_attrs(dev, D, sr.dtype)
    regs, local = {"dtable": a[3], "dsr": a[4]}, {"dtable": a[5], "dsr": a[6]}
    if slabs(D) == 1:
        shape = grid_shape(B, P, per_sm, sms)
    else:
        dz = slots_query(_library().srt_xent_bwd_dz_slots, 3, dev, D,
                         sr.dtype)
        shape = dict(slab_grid_shape(B, P, sr.element_size(), per_sm, sms,
                                     slabs(D)), dz_resident_per_sm=dz[0])
        regs["dz"], local["dz"] = dz[1], dz[2]
    return dict(shape, sms=sms, registers=regs, local_bytes=local,
                product=product(a[7]))


def _vec(sr, table):
    """1 when four-element cp.async copies may stage ``sr`` and ``table``:
    D % 4 == 0 and both aligned to four elements."""
    align = 4 * sr.element_size()
    return int(sr.shape[-1] % 4 == 0
               and all(t.data_ptr() % align == 0 for t in (sr, table)))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _table_scratch(table, normalize_table):
    """t (the table's type) and its float32 norms when the table is
    normalised, else (None, None)."""
    if not normalize_table:
        return None, None
    return torch.empty_like(table), torch.empty(
        table.shape[0], dtype=torch.float32, device=table.device)


def _bwd_scratch(table, rows, grid, normalize_table):
    """The scratch of K2's and K4's backward up to 256 features over
    ``rows`` rows on ``grid``, None where unused: ``_table_scratch``, the
    row splits' float32 d_table partials and the catalog splits' float32
    d_sr partials, each when there are several."""
    (P, D), f32 = table.shape, dict(dtype=torch.float32, device=table.device)
    dtab_part = dsr_part = None
    if grid["t_split"] > 1:
        dtab_part = torch.empty(grid["t_split"], P, D, **f32)
    if grid["s_split"] > 1:
        dsr_part = torch.empty(grid["s_split"], rows, D, **f32)
    return (*_table_scratch(table, normalize_table), dtab_part, dsr_part)


def slab_bwd_scratch(table, rows, plan, normalize_table):
    """The scratch of K2's and K4's backward past 256 features over
    ``rows`` rows on ``plan`` (``slab_bwd_plan``): ``_table_scratch``, the
    dz scratch in the table's type, d_table's float32 partials and, when
    there are several, d_sr's."""
    (P, D), f32 = table.shape, dict(dtype=torch.float32, device=table.device)
    dz = torch.empty(plan["dz_shape"], dtype=table.dtype, device=table.device)
    dtab_part = torch.empty(plan["t_split"], P, D, **f32)
    dsr_part = (torch.empty(plan["dsr_parts"], rows, D, **f32)
                if plan["dsr_parts"] > 1 else None)
    return (*_table_scratch(table, normalize_table), dz, dtab_part, dsr_part)


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _fwd_cuda(sr, table, labels, n_valid, col_offset, *, scale,
              normalize_table):
    _check(sr, table, labels)
    lib = _library()
    B, D = sr.shape
    P = table.shape[0]
    grid = _fwd_launch_grid(sr.device, B, P, D, sr.dtype)
    f32 = dict(dtype=torch.float32, device=sr.device)
    nrm = torch.empty(P, **f32) if normalize_table else None
    part = torch.empty(3, grid["s_split"], B, **f32)
    loss = torch.empty(B, **f32)
    lse = torch.empty(B, **f32)
    stream = torch.cuda.current_stream(sr.device).cuda_stream
    err = lib.srt_xent_fwd(
        sr.data_ptr(), table.data_ptr(), labels.data_ptr(), B, P, D,
        int(n_valid), int(col_offset), float(scale), int(normalize_table),
        int(sr.dtype == torch.bfloat16), _vec(sr, table), grid["s_split"],
        grid["s_per"], _ptr(nrm), part.data_ptr(), loss.data_ptr(),
        lse.data_ptr(), stream)
    _raise_on(err, "xent_fwd launch")
    profiling.count("xent.fwd")
    return loss, lse


def _bwd_cuda(g, sr, table, labels, lse, n_valid, col_offset, *, scale,
              normalize_table):
    _check(sr, table, labels, g, lse)
    lib = _library()
    B, D = sr.shape
    P = table.shape[0]
    per_sm, sms = _bwd_slots(sr.device, D, sr.dtype)
    dsr = torch.empty(B, D, dtype=torch.float32, device=sr.device)
    dtab = torch.empty_like(table)
    stream = torch.cuda.current_stream(sr.device).cuda_stream
    args = (g.data_ptr(), sr.data_ptr(), table.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), B, P, D, int(n_valid), int(col_offset),
            float(scale), int(normalize_table),
            int(sr.dtype == torch.bfloat16), _vec(sr, table))
    if slabs(D) == 1:
        grid = _bwd_grid(B, P, per_sm * sms, lib.srt_xent_bwd_tile())
        scratch = _bwd_scratch(table, B, grid, normalize_table)
        err = lib.srt_xent_bwd(
            *args, grid["t_split"], grid["t_per"], grid["s_split"],
            grid["s_per"], *map(_ptr, scratch), dsr.data_ptr(),
            dtab.data_ptr(), stream)
    else:
        plan = slab_bwd_plan(B, P, sr.element_size(), per_sm * sms,
                             slabs(D), lib.srt_xent_bwd_tile())
        scratch = slab_bwd_scratch(table, B, plan, normalize_table)
        err = lib.srt_xent_bwd_slab(
            *args, plan["chunk"], plan["t_split"], plan["t_per"],
            plan["s_per"], *map(_ptr, scratch), dsr.data_ptr(),
            dtab.data_ptr(), stream)
    _raise_on(err, "xent_bwd launch")
    profiling.count("xent.bwd")
    return dsr, dtab


# ---------------------------------------------------------------------------
# dispatch: the kernel for CUDA tensors, the plain version for CPU tensors
# ---------------------------------------------------------------------------

def same_dtype(sr, table):
    """Raise unless ``sr`` and ``table`` have one type, as the kernels
    take them (the plain versions keep the kernels' rule)."""
    if table.dtype != sr.dtype:
        raise TypeError(f"table dtype {table.dtype} != sr dtype {sr.dtype}")


def common_dtype(sr, table):
    """``(sr, table)`` in the one type the kernels take: as they are when
    their types agree, else both float32 (see the module docstring)."""
    if sr.dtype == table.dtype:
        return sr, table
    return sr.to(torch.float32), table.to(torch.float32)


def xent_fwd(sr, table, labels, n_valid, col_offset=0, *, scale,
             normalize_table):
    """K1: ``(per-row loss [B], lse [B])``, float32."""
    if sr.is_cuda:
        return _fwd_cuda(sr, table, labels, n_valid, col_offset,
                         scale=scale, normalize_table=normalize_table)
    if sr.device.type != "cpu":
        raise NotImplementedError(f"no xent kernel for {sr.device}")
    same_dtype(sr, table)
    m, s, zl = _fwd_plain(sr, table, labels, n_valid, col_offset,
                          scale=scale, normalize_table=normalize_table)
    lse = _finish_lse(m, s)
    return lse - zl, lse


def xent_bwd(g, sr, table, labels, lse, n_valid, col_offset=0, *, scale,
             normalize_table):
    """K2: ``(d_sr [B, D] float32, d_table [P, D])`` for cotangent ``g``."""
    if sr.is_cuda:
        return _bwd_cuda(g, sr, table, labels, lse, n_valid, col_offset,
                         scale=scale, normalize_table=normalize_table)
    if sr.device.type != "cpu":
        raise NotImplementedError(f"no xent kernel for {sr.device}")
    same_dtype(sr, table)
    return _bwd_plain(g, sr, table, labels, lse, n_valid, col_offset,
                      scale=scale, normalize_table=normalize_table)


# ---------------------------------------------------------------------------
# catalog-sharded forms (the table row-sharded over the mesh's model axis;
# parallel/sharded.py stitches forward and backward into one autograd
# Function with the collectives written out, as the JAX package's
# custom_vjp does)
# ---------------------------------------------------------------------------

def _localize_labels(labels, offset, n_valid):
    """Global labels shifted into a shard's rows, ``[0, n_valid)``.

    Off-shard labels become -1, so they can never match a column.  (Merely
    lying outside ``[0, n_valid)`` is not enough: a kernel's tile runs past
    ``n_valid`` over masked columns, and a label there would pick up a
    masked logit in the label term and the backward's one-hot.)"""
    lbl = labels.to(torch.int32) - offset
    return torch.where((lbl >= 0) & (lbl < n_valid), lbl,
                       -1).to(torch.int32)


def merge_partial_max_sum(m, s, mesh):
    """Every shard's (max, sum-exp relative to it) merged over the mesh's
    model group with one max and one sum all-reduce: ``(m, s)`` of the
    whole catalog, ``m`` clamped above ``NEG_INF`` (all-masked rows)."""
    m_g = all_reduce(m, mesh, MODEL_AXIS, "max")
    m_safe = torch.clamp(m_g, min=NEG_INF * 0.5)
    s_g = all_reduce(s * torch.exp(torch.clamp(m, min=NEG_INF) - m_safe),
                     mesh, MODEL_AXIS)
    return m_safe, s_g


def merge_partial_lse(m, s, mesh):
    """Finish a log-sum-exp from every shard's (max, relative sum-exp)
    over the mesh's model group (``merge_partial_max_sum``)."""
    m_safe, s_g = merge_partial_max_sum(m, s, mesh)
    return m_safe + torch.log(torch.clamp(s_g, min=_TINY))


def _shard_operands(labels, ploc, num_items, mesh):
    """K1/K2's ``(labels, n_valid, col_offset)`` on this rank's shard of
    ``ploc`` rows: they compare global columns, so the labels are the
    global ids this shard holds (-1 elsewhere) and ``n_valid`` is the
    shard's end in global ids."""
    offset, n_valid = shard_span(mesh, ploc, num_items)
    lbl = _localize_labels(labels, offset, n_valid)
    return torch.where(lbl >= 0, lbl + offset, -1).to(torch.int32), \
        offset + n_valid, offset


def sharded_xent_fwd(sr, table_local, labels, *, scale, num_items,
                     normalize_table, mesh):
    """Per-row catalog cross-entropy with the table row-sharded over the
    mesh's model axis (``sessionrec_tpu/ops/xent.py:sharded_xent_fwd``).

    ``sr [B, D]`` and ``labels [B]`` are this rank's data rows (the same on
    every rank of its model group); ``table_local`` its ``[P/mp, D]``
    shard.  K1 runs over the shard's rows only; its ``lse`` and the label
    logit ``zl = lse - loss`` (exactly 0 where the shard lacks the label)
    merge with a max and two sum all-reduces of ``[B]`` vectors.  Returns
    ``(per-row loss [B], global lse [B])``."""
    lbl, n_valid, offset = _shard_operands(labels, table_local.shape[0],
                                           num_items, mesh)
    loss, lse_local = xent_fwd(sr, table_local, lbl, n_valid, offset,
                               scale=scale, normalize_table=normalize_table)
    lse = merge_partial_lse(lse_local, torch.ones_like(lse_local), mesh)
    zl = all_reduce(lse_local - loss, mesh, MODEL_AXIS)
    return lse - zl, lse


def sharded_xent_bwd(g_row, sr, table_local, labels, lse, *, scale,
                     num_items, normalize_table, mesh):
    """Backward of ``sharded_xent_fwd``: K2 over the shard's rows against
    the global ``lse``.  Returns ``(d_sr [B, D] float32, summed over the
    model group, d_table_local [P/mp, D])``; the caller sums the table's
    gradient over the data group."""
    lbl, n_valid, offset = _shard_operands(labels, table_local.shape[0],
                                           num_items, mesh)
    dsr, dtab = xent_bwd(g_row, sr, table_local, lbl, lse, n_valid, offset,
                         scale=scale, normalize_table=normalize_table)
    return all_reduce(dsr, mesh, MODEL_AXIS), dtab


class _CatalogXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sr, table, labels, scale, num_items, normalize_table):
        sr, table = sr.contiguous(), table.contiguous()
        labels = labels.to(torch.int32).contiguous()
        loss, lse = xent_fwd(sr, table, labels, num_items, scale=scale,
                             normalize_table=normalize_table)
        ctx.save_for_backward(sr, table, labels, lse)
        ctx.cfg = (scale, num_items, normalize_table)
        return loss

    @staticmethod
    def backward(ctx, g):
        sr, table, labels, lse = ctx.saved_tensors
        scale, num_items, normalize_table = ctx.cfg
        dsr, dtab = xent_bwd(g.to(torch.float32).contiguous(), sr, table,
                             labels, lse, num_items, scale=scale,
                             normalize_table=normalize_table)
        return dsr.to(sr.dtype), dtab, None, None, None, None


def catalog_xent(sr, table, labels, *, scale: float, num_items: int,
                 normalize_table: bool = False):
    """Per-row ``-log softmax(scale * sr @ table^T)[label]`` over the first
    ``num_items`` table rows (the rest are padding).  ``sr [B, D]``,
    ``table [P, D]``, each float32 or bfloat16 (``common_dtype``),
    ``labels [B]``.  Returns ``[B]`` float32.  ``normalize_table`` scores
    against ``l2norm(table)`` with the normalisation folded into the
    kernels."""
    sr, table = common_dtype(sr, table)
    return _CatalogXent.apply(sr, table, labels, float(scale),
                              int(num_items), bool(normalize_table))


def reference_xent(sr, table, labels, *, scale: float, num_items: int,
                   normalize_table: bool = False):
    """Plain autograd oracle with the semantics of ``catalog_xent``."""
    if normalize_table:
        # sqrt(max(.)) so all-zero rows get a zero (not NaN) gradient
        nsq = torch.sum(table.to(torch.float32) ** 2, dim=-1, keepdim=True)
        n = torch.sqrt(torch.clamp(nsq, min=_NORM_EPS * _NORM_EPS))
        table = table / n.to(table.dtype)
    logits = scale * torch.matmul(sr.to(torch.float32),
                                  table.to(torch.float32).T)
    imask = torch.arange(table.shape[0], device=sr.device) < num_items
    logits = torch.where(imask[None, :], logits, NEG_INF)
    lp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(lp, 1, labels.to(torch.int64)[:, None])[:, 0]


def fused_nll_loss(sr, table, labels, valid, *, scale: float, num_items: int,
                   normalize_table: bool = False):
    """Masked-mean catalog cross-entropy (train.py:99 semantics)."""
    per_row = catalog_xent(sr, table, labels, scale=scale,
                           num_items=num_items,
                           normalize_table=normalize_table)
    v = valid.to(per_row.dtype)
    return torch.sum(per_row * v) / torch.clamp(torch.sum(v), min=1.0)
