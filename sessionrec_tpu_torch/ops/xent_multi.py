"""Fused MSGIFSR head loss: multi-order REnorm + IFR fusion.

Counterpart of ``sessionrec_tpu/ops/xent_multi.py``.  The WSDM'22 paper
head (``--order 3 --extra --fusion``, reference msgifsr.py:283-321) scores
every order's session vector against the whole catalog, splits the
catalog per example into the session's own items and the rest, softmaxes
each part separately (REnorm), blends the two with a learned gate ``phi``
and combines the orders with ``softmax(alpha)`` weights (IFR).  The label
probability needs only three numbers per (order, row): ``zl``, the label's
logit, and ``lse_in`` / ``lse_ex``, the log-sum-exp of the logits over the
in-session and the other columns.  On CUDA tensors they come from the
hand-written kernels of ``csrc/xent_multi.cu``; neither the ``[K, B, P]``
logits nor the ``[B, P]`` session mask exist in device memory:

* K3 (``xent_multi_fwd``, replaces the Pallas ``_fwd_kernel``) streams the
  catalog once for all orders and keeps five running stats per (order,
  row): ``(m_in, s_in)``, ``(m_ex, s_ex)`` and ``zl``.
* K4 (``xent_multi_bwd``, replaces the Pallas ``_bwd_kernel``) turns the
  stats' cotangents ``(gz, gin, gex)`` into ``d_sr`` and ``d_table`` with
  the l2norm VJP folded in.

Both run on K2's tiles (``csrc/tiles.cuh``) over the ``K * B`` rows, on
grids that ``ops/xent.py:_bwd_grid`` sizes to the card's resident block
slots of their own kernels; in bfloat16 their products run on the tensor
cores (``mma.sync``, float32 sums) at every width, as K1's and K2's do;
past 256 features, as K1/K2 do, on the slab
path (``xent.slabs``): K4 computes dz once per catalog chunk and runs K2's
two slab products over it (``xent.slab_bwd_plan``).  Session item lists
may be of any length (the paper head at ``--max-len`` above 256): the
kernels scan each row's list while a catalog tile stages.

The small ``[K, B]`` stats feed the plain-torch combiner
(``combine_stats``: phi, alpha, fusion), whose gradients come from
autograd.  Beside each kernel sits its plain PyTorch version
(``_fwd_plain``, ``_bwd_plain``), taken only for tensors on the CPU; for
CUDA tensors a wrapper launches the kernel or raises, and counts the
launch in ``xent_multi.fwd`` or ``xent_multi.bwd`` (``utils/profiling.py``,
tracing on).  They take ``sr3``
and the table in one type; ``catalog_multi_stats`` maps the combinations
of table and compute type onto them as ``ops/xent.py`` does
(``xent.common_dtype``: equal types as they are, mixed ones float32).
"""

from __future__ import annotations

import ctypes

import torch

from sessionrec_tpu_torch.ops import xent
from sessionrec_tpu_torch.ops.masked import NEG_INF
from sessionrec_tpu_torch.parallel.mesh import (MODEL_AXIS, all_reduce,
                                                shard_span)
from sessionrec_tpu_torch.utils import profiling

# safe-log floor of the label probability (models/msgifsr.py:_TINY)
_TINY = 1e-30

# ---------------------------------------------------------------------------
# plain versions (the oracles)
# ---------------------------------------------------------------------------

def _member(iids, P, col_offset):
    """[B, P] bool: local column j holds global item ``col_offset + j``,
    one of the row's iids (-1 and ids outside the table match nothing)."""
    B = iids.shape[0]
    idx = iids.to(torch.int64) - col_offset
    idx = torch.where((idx >= 0) & (idx < P), idx, P)
    member = torch.zeros(B, P + 1, dtype=torch.bool, device=iids.device)
    member.scatter_(1, idx, True)
    return member[:, :P]


def _masks(labels, iids, P, n_valid, col_offset, device):
    """(live [1, 1, P], member [1, B, P], onehot [1, B, P]): live and the
    label compare local columns, membership global ids, as the Pallas
    kernels do."""
    col = torch.arange(P, device=device)
    live = (col < n_valid)[None, None, :]
    member = _member(iids, P, col_offset)[None]
    onehot = (col[None, :] == labels.to(torch.int64)[:, None])[None]
    return live, member, onehot


def _fwd_plain(sr3, table, labels, iids, n_valid, col_offset=0, *, scale,
               normalize_table):
    """``(m_in, s_in, m_ex, s_ex, zl)``, each ``[K, B]`` float32, over the
    whole table as one tile of the Pallas forward kernel computes them:
    running max and sum-exp relative to it of the in-session and the other
    columns, and the label logit (0 when no column matches the label)."""
    t = table.to(torch.float32)
    z = scale * torch.matmul(sr3.to(torch.float32), t.T)      # [K, B, P]
    if normalize_table:
        n = torch.linalg.vector_norm(t, dim=1)
        z = z / torch.clamp(n, min=xent._NORM_EPS)
    live, member, onehot = _masks(labels, iids, table.shape[0], n_valid,
                                  col_offset, sr3.device)
    z = torch.where(live, z, NEG_INF)
    zl = torch.sum(torch.where(onehot, z, 0.0), dim=-1)

    def stats(x):
        m = torch.amax(x, dim=-1)
        m_safe = torch.clamp(m, min=NEG_INF * 0.5)
        return m, torch.sum(torch.exp(x - m_safe[..., None]), dim=-1)

    m_in, s_in = stats(torch.where(member, z, NEG_INF))
    m_ex, s_ex = stats(torch.where(member, NEG_INF, z))
    return m_in, s_in, m_ex, s_ex, zl


def _bwd_plain(gz, gin, gex, sr3, table, labels, iids, lse_in, lse_ex,
               n_valid, col_offset=0, *, scale, normalize_table):
    """``(d_sr [K, B, D] float32, d_table [P, D] in the table's type)`` for
    the stats' cotangents ``gz, gin, gex [K, B]`` — the Pallas backward
    kernel's math over the whole table as one tile."""
    mxu = table.dtype
    that, tmm, n = xent._operand(table, normalize_table)
    srf = sr3.to(torch.float32)
    z = scale * torch.matmul(srf, tmm.T)                      # [K, B, P]
    live, member, onehot = _masks(labels, iids, table.shape[0], n_valid,
                                  col_offset, sr3.device)
    lin = torch.clamp(lse_in, min=NEG_INF * 0.5)[..., None]
    lex = torch.clamp(lse_ex, min=NEG_INF * 0.5)[..., None]
    p_in = torch.where(member & live, torch.exp(z - lin), 0.0)
    p_ex = torch.where(~member & live, torch.exp(z - lex), 0.0)
    dz = ((gin[..., None] * p_in + gex[..., None] * p_ex
           + gz[..., None] * onehot.to(torch.float32)) * scale) \
        .to(mxu).to(torch.float32)
    K, B, D = sr3.shape
    gtab = torch.matmul(dz.reshape(K * B, -1).T, srf.reshape(K * B, D))
    if normalize_table:
        # VJP of t_hat = t / max(||t||, eps), as ops/xent._bwd_plain
        gdot = torch.sum(gtab * that, dim=1, keepdim=True)
        keep = (n > xent._NORM_EPS).to(torch.float32)
        gtab = (gtab - gdot * that * keep) / n
    return torch.matmul(dz, tmm), gtab.to(table.dtype)


# log-sum-exp from a (running max, relative sum-exp) pair
_finish = xent._finish_lse


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/xent_multi.cu)
# ---------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = xent._library()          # the tile size's entry point too
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.srt_xent_multi_fwd.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i,
                                           i, f, i, i, i, i, i, vp, vp, vp,
                                           vp]
        lib.srt_xent_multi_fwd.restype = i
        lib.srt_xent_multi_bwd.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i,
                                           i, i, f, i, i, i, i, i, i, i, vp,
                                           vp, vp, vp, vp, vp, vp]
        lib.srt_xent_multi_bwd.restype = i
        lib.srt_xent_multi_bwd_slab.argtypes = [vp, vp, vp, vp, vp, i, i, i,
                                                i, i, i, i, f, i, i, i, i, i,
                                                i, i, vp, vp, vp, vp, vp, vp,
                                                vp, vp]
        lib.srt_xent_multi_bwd_slab.restype = i
        for name in ("srt_xent_multi_slots", "srt_xent_multi_dz_slots"):
            getattr(lib, name).argtypes = [i, i, ctypes.POINTER(i)]
            getattr(lib, name).restype = i
        _lib = lib
    return _lib


def _check(sr3, table, labels, iids, *stats):
    """Raise on anything the kernels do not take."""
    if sr3.dim() != 3 or sr3.shape[0] == 0:
        raise ValueError(f"need sr3 [K, B, D], got {tuple(sr3.shape)}")
    K, B, D = sr3.shape
    # types, the feature width, labels int32 [B], devices, contiguity
    xent._check(sr3[0], table, labels)
    if iids.dtype != torch.int32 or iids.dim() != 2 or iids.shape[0] != B:
        raise TypeError(f"iids must be int32 [B, Ns], got {iids.dtype} "
                        f"{tuple(iids.shape)}")
    for t in (sr3, iids) + stats:
        if t.device != sr3.device:
            raise ValueError(f"tensors on {t.device} and {sr3.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    for v in stats:
        if v.dtype != torch.float32 or v.shape != (5, K, B):
            raise TypeError(f"row stats must be float32 [5, K, B], got "
                            f"{v.dtype} {tuple(v.shape)}")


def _attrs(device, D, dtype):
    """``srt_xent_multi_slots``'s fourteen numbers for ``device``: resident
    blocks per SM of K3's partial kernel and K4's d_table and d_sr kernels
    at width ``D`` (past 256 features the slab path's products; in bfloat16
    the tensor-core kernels at every width), the SM count, the three kernels'
    registers and local memory bytes per thread, K3's dynamic shared memory
    bytes and staging stages, and whether K3's and K4's products run on
    the tensor cores."""
    return xent.slots_query(_library().srt_xent_multi_slots, 14, device, D,
                            dtype)


def _grid(device, R, P, D, dtype, k4):
    """``xent._bwd_grid`` over the ``R = K * B`` rows for K4 up to 256
    features (``k4``; the fewer resident blocks of the two product kernels
    that run at ``dtype``: on the tensor cores in bfloat16) or K3."""
    a = _attrs(device, D, dtype)
    per_sm = min(a[1], a[2]) if k4 else a[0]
    return xent._bwd_grid(R, P, per_sm * a[3],
                          _library().srt_xent_bwd_tile())


def multi_launch_shape(sr3, P):
    """K3's and K4's launches for ``sr3 [K, B, D]`` against a ``P``-row
    table: blocks, splits and resident blocks per SM of each (K3's shared
    memory bytes and staging stages too), each one's ``product`` (both on
    the tensor cores in bfloat16, at every width), and each product
    kernel's registers and local memory (spill) bytes per thread; past 256
    features K4's dz kernel's too, and its chunks."""
    (K, B, D), dev = sr3.shape, sr3.device
    a = _attrs(dev, D, sr3.dtype)
    k3 = xent.grid_shape(K * B, P, a[0], a[3])
    regs = {"fwd": a[4], "dtable": a[5], "dsr": a[6]}
    local = {"fwd": a[7], "dtable": a[8], "dsr": a[9]}
    if xent.slabs(D) == 1:
        k4 = xent.grid_shape(K * B, P, min(a[1], a[2]), a[3])
    else:
        dz = xent.slots_query(_library().srt_xent_multi_dz_slots, 3, dev, D,
                              sr3.dtype)
        k4 = dict(xent.slab_grid_shape(K * B, P, sr3.element_size(),
                                       min(a[1], a[2]), a[3], xent.slabs(D)),
                  dz_resident_per_sm=dz[0])
        regs["dz"], local["dz"] = dz[1], dz[2]
    return dict(k3=dict(blocks=k3["dsr_blocks"],
                        catalog_splits=k3["catalog_splits"],
                        resident_per_sm=a[0], smem_bytes=a[10],
                        ring_stages=a[11], product=xent.product(a[12])),
                k4=dict(k4, product=xent.product(a[13])), sms=a[3],
                registers=regs, local_bytes=local)


def _fwd_cuda(sr3, table, labels, iids, n_valid, col_offset, *, scale,
              normalize_table):
    _check(sr3, table, labels, iids)
    lib = _library()
    K, B, D = sr3.shape
    P = table.shape[0]
    grid = _grid(sr3.device, K * B, P, D, sr3.dtype, k4=False)
    f32 = dict(dtype=torch.float32, device=sr3.device)
    nrm = torch.empty(P, **f32) if normalize_table else None
    part = torch.empty(5, grid["s_split"], K * B, **f32)
    out = torch.empty(5, K, B, **f32)
    stream = torch.cuda.current_stream(sr3.device).cuda_stream
    err = lib.srt_xent_multi_fwd(
        sr3.data_ptr(), table.data_ptr(), labels.data_ptr(), iids.data_ptr(),
        K, B, P, D, iids.shape[1], int(n_valid), int(col_offset),
        float(scale), int(normalize_table), int(sr3.dtype == torch.bfloat16),
        xent._vec(sr3, table), grid["s_split"], grid["s_per"], xent._ptr(nrm),
        part.data_ptr(), out.data_ptr(), stream)
    xent._raise_on(err, "xent_multi_fwd launch")
    profiling.count("xent_multi.fwd")
    return tuple(out)


def _bwd_cuda(gz, gin, gex, sr3, table, labels, iids, lse_in, lse_ex,
              n_valid, col_offset, *, scale, normalize_table):
    g5 = torch.stack([gz, gin, gex, lse_in, lse_ex]).to(torch.float32) \
        .contiguous()
    _check(sr3, table, labels, iids, g5)
    lib = _library()
    K, B, D = sr3.shape
    P = table.shape[0]
    dsr = torch.empty(K, B, D, dtype=torch.float32, device=sr3.device)
    dtab = torch.empty_like(table)
    stream = torch.cuda.current_stream(sr3.device).cuda_stream
    args = (g5.data_ptr(), sr3.data_ptr(), table.data_ptr(),
            labels.data_ptr(), iids.data_ptr(), K, B, P, D, iids.shape[1],
            int(n_valid), int(col_offset), float(scale),
            int(normalize_table), int(sr3.dtype == torch.bfloat16),
            xent._vec(sr3, table))
    if xent.slabs(D) == 1:
        grid = _grid(sr3.device, K * B, P, D, sr3.dtype, k4=True)
        scratch = xent._bwd_scratch(table, K * B, grid, normalize_table)
        err = lib.srt_xent_multi_bwd(
            *args, grid["t_split"], grid["t_per"], grid["s_split"],
            grid["s_per"], *map(xent._ptr, scratch), dsr.data_ptr(),
            dtab.data_ptr(), stream)
    else:
        a = _attrs(sr3.device, D, sr3.dtype)
        plan = xent.slab_bwd_plan(K * B, P, sr3.element_size(),
                                  min(a[1], a[2]) * a[3], xent.slabs(D),
                                  lib.srt_xent_bwd_tile())
        scratch = xent.slab_bwd_scratch(table, K * B, plan, normalize_table)
        err = lib.srt_xent_multi_bwd_slab(
            *args, plan["chunk"], plan["t_split"], plan["t_per"],
            plan["s_per"], *map(xent._ptr, scratch), dsr.data_ptr(),
            dtab.data_ptr(), stream)
    xent._raise_on(err, "xent_multi_bwd launch")
    profiling.count("xent_multi.bwd")
    return dsr, dtab


# ---------------------------------------------------------------------------
# dispatch: the kernel for CUDA tensors, the plain version for CPU tensors
# ---------------------------------------------------------------------------

def xent_multi_fwd(sr3, table, labels, iids, n_valid, col_offset=0, *, scale,
                   normalize_table):
    """K3: ``(m_in, s_in, m_ex, s_ex, zl)``, each ``[K, B]`` float32."""
    if sr3.is_cuda:
        return _fwd_cuda(sr3, table, labels, iids, n_valid, col_offset,
                         scale=scale, normalize_table=normalize_table)
    if sr3.device.type != "cpu":
        raise NotImplementedError(f"no xent_multi kernel for {sr3.device}")
    xent.same_dtype(sr3, table)
    return _fwd_plain(sr3, table, labels, iids, n_valid, col_offset,
                      scale=scale, normalize_table=normalize_table)


def xent_multi_bwd(gz, gin, gex, sr3, table, labels, iids, lse_in, lse_ex,
                   n_valid, col_offset=0, *, scale, normalize_table):
    """K4: ``(d_sr [K, B, D] float32, d_table [P, D])``."""
    if sr3.is_cuda:
        return _bwd_cuda(gz, gin, gex, sr3, table, labels, iids, lse_in,
                         lse_ex, n_valid, col_offset, scale=scale,
                         normalize_table=normalize_table)
    if sr3.device.type != "cpu":
        raise NotImplementedError(f"no xent_multi kernel for {sr3.device}")
    xent.same_dtype(sr3, table)
    return _bwd_plain(gz, gin, gex, sr3, table, labels, iids, lse_in, lse_ex,
                      n_valid, col_offset, scale=scale,
                      normalize_table=normalize_table)


# ---------------------------------------------------------------------------
# catalog-sharded forms (parallel/sharded.py:fused_multi_loss_sharded
# stitches them into one autograd Function, as the JAX package's
# _fused_multi_mesh custom_vjp does)
# ---------------------------------------------------------------------------

def _shard_operands(labels, ploc, num_items, mesh):
    """K3/K4's ``(labels, n_valid, col_offset)`` on this rank's shard of
    ``ploc`` rows: they compare local columns with ``n_valid`` and the
    labels (shifted into the shard, -1 elsewhere) and global ids with the
    session items (``col_offset``)."""
    offset, n_valid = shard_span(mesh, ploc, num_items)
    return xent._localize_labels(labels, offset, n_valid), n_valid, offset


def sharded_multi_fwd(sr3, table_local, labels, iids, *, scale, num_items,
                      normalize_table, mesh):
    """``(zl, lse_in, lse_ex)``, each ``[K, B]``, of the whole catalog with
    the table row-sharded over the mesh's model axis: K3 over this rank's
    shard, its per-partition (max, sum-exp) merged by
    ``xent.merge_partial_lse`` and the label logits summed over the model
    group (``sessionrec_tpu/parallel/sharded.py:_fused_multi_mesh_fwd``).
    """
    lbl, n_valid, offset = _shard_operands(labels, table_local.shape[0],
                                           num_items, mesh)
    m_in, s_in, m_ex, s_ex, zl = xent_multi_fwd(
        sr3, table_local, lbl, iids, n_valid, offset, scale=scale,
        normalize_table=normalize_table)
    return (all_reduce(zl, mesh, MODEL_AXIS),
            xent.merge_partial_lse(m_in, s_in, mesh),
            xent.merge_partial_lse(m_ex, s_ex, mesh))


def sharded_multi_bwd(gz, gin, gex, sr3, table_local, labels, iids, lse_in,
                      lse_ex, *, scale, num_items, normalize_table, mesh):
    """Backward of ``sharded_multi_fwd``: K4 over this rank's shard against
    the global log-sum-exps.  Returns ``(d_sr [K, B, D] float32, summed
    over the model group, d_table_local [P/mp, D])``."""
    lbl, n_valid, offset = _shard_operands(labels, table_local.shape[0],
                                           num_items, mesh)
    dsr, dtab = xent_multi_bwd(gz, gin, gex, sr3, table_local, lbl, iids,
                               lse_in, lse_ex, n_valid, offset, scale=scale,
                               normalize_table=normalize_table)
    return all_reduce(dsr, mesh, MODEL_AXIS), dtab


class _CatalogMultiStats(torch.autograd.Function):
    """``(zl, lse_in, lse_ex)``, each ``[K, B]``: K3 forward, K4 backward."""

    @staticmethod
    def forward(ctx, sr3, table, labels, iids, scale, num_items,
                normalize_table):
        sr3, table = sr3.contiguous(), table.contiguous()
        labels = labels.to(torch.int32).contiguous()
        iids = iids.to(torch.int32).contiguous()
        m_in, s_in, m_ex, s_ex, zl = xent_multi_fwd(
            sr3, table, labels, iids, num_items, scale=scale,
            normalize_table=normalize_table)
        lse_in, lse_ex = _finish(m_in, s_in), _finish(m_ex, s_ex)
        ctx.save_for_backward(sr3, table, labels, iids, lse_in, lse_ex)
        ctx.cfg = (scale, num_items, normalize_table)
        return zl, lse_in, lse_ex

    @staticmethod
    def backward(ctx, gz, gin, gex):
        sr3, table, labels, iids, lse_in, lse_ex = ctx.saved_tensors
        scale, num_items, normalize_table = ctx.cfg
        dsr, dtab = xent_multi_bwd(
            gz.to(torch.float32), gin.to(torch.float32),
            gex.to(torch.float32), sr3, table, labels, iids, lse_in, lse_ex,
            num_items, scale=scale, normalize_table=normalize_table)
        return dsr.to(sr3.dtype), dtab, None, None, None, None, None


def catalog_multi_stats(sr3, table, labels, iids, *, scale: float,
                        num_items: int, normalize_table: bool = False):
    """``(zl, lse_in, lse_ex)``, each ``[K, B]`` float32, of
    ``scale * sr3 @ t^T`` over the first ``num_items`` rows of ``table``
    (``t = l2norm(table)`` when ``normalize_table``), with membership from
    ``iids [B, Ns]`` (-1 = padding); ``sr3`` and ``table`` each float32 or
    bfloat16 (``xent.common_dtype``)."""
    sr3, table = xent.common_dtype(sr3, table)
    return _CatalogMultiStats.apply(sr3, table, labels, iids, float(scale),
                                    int(num_items), bool(normalize_table))


def reference_multi_stats(sr3, table, labels, iids, *, scale, num_items,
                          normalize_table):
    """Plain autograd oracle with the semantics of ``catalog_multi_stats``;
    materialises the ``[K, B, P]`` logits."""
    if normalize_table:
        nsq = torch.sum(table.to(torch.float32) ** 2, dim=-1, keepdim=True)
        table = table / torch.sqrt(torch.clamp(
            nsq, min=xent._NORM_EPS * xent._NORM_EPS)).to(table.dtype)
    z = scale * torch.matmul(sr3.to(torch.float32),
                             table.to(torch.float32).T)
    live, member, onehot = _masks(labels, iids, table.shape[0], num_items,
                                  0, sr3.device)
    z = torch.where(live, z, NEG_INF)

    def lse(x):
        m_safe = torch.clamp(torch.amax(x, dim=-1), min=NEG_INF * 0.5)
        return m_safe + torch.log(torch.clamp(
            torch.sum(torch.exp(x - m_safe[..., None]), dim=-1),
            min=torch.finfo(torch.float32).tiny))

    zl = torch.sum(torch.where(onehot, z, 0.0), dim=-1)
    return (zl, lse(torch.where(member, z, NEG_INF)),
            lse(torch.where(member, NEG_INF, z)))


# ---------------------------------------------------------------------------
# public loss
# ---------------------------------------------------------------------------

def combine_stats(zl, lse_in, lse_ex, phi, alpha, lbl_in, *, extra, fusion):
    """Per-row ``-log`` label probability, ``[B]`` float32.  Stats arrive
    ``[K, B]``; ``phi [B, K, 2]`` (REnorm gate) or None; ``alpha [K]``.
    The exponent clamps keep empty-partition stats (lse near -inf on
    padded rows) from producing inf * 0 NaNs in the gradients; they are
    ``torch.minimum``/``maximum``, which split the gradient on ties as
    ``jnp.minimum``/``maximum`` do."""
    zl, lse_in, lse_ex = zl.T, lse_in.T, lse_ex.T              # [B, K]
    K = zl.shape[1]
    zero = zl.new_zeros(())
    if extra:
        p_in = torch.exp(torch.minimum(zl - lse_in, zero))
        p_ex = torch.exp(torch.minimum(zl - lse_ex, zero))
        li = lbl_in.to(torch.float32)[:, None]
        p_lbl = phi[..., 0] * p_in * li + phi[..., 1] * p_ex * (1.0 - li)
    else:
        p_lbl = torch.exp(torch.minimum(
            zl - torch.logaddexp(lse_in, lse_ex), zero))
    if K > 1 and fusion:
        w = torch.softmax(alpha.to(torch.float32), dim=0)[None, :]
        score = torch.sum(p_lbl * w, dim=1)
    else:
        score = p_lbl[:, 0]                                    # msgifsr.py:317
    return -torch.log(torch.maximum(score, zl.new_full((), _TINY)))


def multi_nll_loss(sr, table, labels, valid, iids, phi, alpha, *,
                   scale: float, num_items: int, normalize_table: bool,
                   extra: bool, fusion: bool):
    """Masked-mean MSGIFSR loss with REnorm/fusion (train.py:99 +
    msgifsr.py:283-321 semantics).

    ``sr [B, K, D]``, ``table [P, D]`` (rows >= num_items are padding),
    ``labels [B]``, ``valid [B]``, ``iids [B, N]`` level-1 session item
    ids with -1 padding, ``phi [B, K, 2]`` (None unless ``extra``),
    ``alpha [K]``.  The kernels take all ``K * B`` rows in one call.
    """
    sr3 = sr.transpose(0, 1)                                  # [K, B, D]
    zl, lse_in, lse_ex = catalog_multi_stats(
        sr3, table, labels, iids, scale=scale, num_items=num_items,
        normalize_table=normalize_table)
    lbl_in = torch.any(iids.to(torch.int64)
                       == labels.to(torch.int64)[:, None], dim=1)
    per_row = combine_stats(zl, lse_in, lse_ex, phi, alpha, lbl_in,
                            extra=extra, fusion=fusion)
    v = valid.to(per_row.dtype)
    return torch.sum(per_row * v) / torch.clamp(torch.sum(v), min=1.0)
