"""The embedding lookup over the (data, model) mesh.

Counterpart of ``sessionrec_tpu/parallel/lookup.py:sharded_lookup``.
``table[ids]`` with the table row-sharded over ``model`` and the ids split
over ``data`` is a cross-shard gather:

* forward: each rank gathers the rows its shard holds (ids shifted into
  the shard, the others zeroed) and one sum over the model group
  assembles them, in the table's type.  Exactly one shard contributes a
  non-zero row per id, so a bfloat16 sum is exact (x + 0 == x).
* backward: each rank adds its rows' cotangents into a dense ``[P/mp, D]``
  float32 gradient of its shard, with the index backward of the plain
  gather (``index_put_`` with ``accumulate``; a sum whose order atomics
  decide would break the card's bit-identical checks).  The gradient goes
  to ``table_grad``, the shard's float32 gradient leaf, where the fused
  loss's table gradient lands too; the trainer reduces their sum over the
  data group in float32 and casts once.  The JAX package casts each
  gradient to the table's type before its data reduction
  (``lookup.py:125-133``): for a bfloat16 table the two differ by that
  rounding.

The JAX package falls back to the plain gather where a ``shard_map``
cannot split the global ids over ``data`` or the table over ``model``
(``lookup.py:69-71``).  Here each rank holds its own ids and rows, so the
explicit form always applies; with ``mp == 1`` it masks nothing and sums
over no one.
"""

from __future__ import annotations

import torch

from sessionrec_tpu_torch.parallel.mesh import MODEL_AXIS, all_reduce


class _ShardedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, table_grad, ids, mesh):
        rows = table.shape[0]
        lid = ids.to(torch.int64) - mesh.m * rows
        ok = (lid >= 0) & (lid < rows)
        lid = lid.clamp(0, rows - 1)
        out = torch.where(ok[..., None], table[lid],
                          torch.zeros((), dtype=table.dtype,
                                      device=table.device))
        ctx.save_for_backward(lid, ok)
        ctx.shape = tuple(table_grad.shape)
        return all_reduce(out, mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        lid, ok = ctx.saved_tensors
        rows, D = ctx.shape
        g32 = torch.where(ok[..., None], g.to(torch.float32), 0.0)
        dtab = torch.zeros(rows, D, dtype=torch.float32, device=g.device)
        dtab.index_put_((lid.reshape(-1),), g32.reshape(-1, D),
                        accumulate=True)
        return None, dtab, None, None


def sharded_lookup(mesh, table, ids, table_grad):
    """``table[ids]`` over the mesh (see the module docstring): ``table``
    is this rank's ``[P/mp, D]`` shard, ``ids [B, ...]`` this rank's
    global item ids; returns ``[B, ..., D]`` rows in the table's type.
    The shard's gradient accumulates in ``table_grad``, a float32 leaf of
    the shard's shape."""
    return _ShardedLookup.apply(table.detach(), table_grad, ids, mesh)
