"""Fixed-shape batch containers — the dense replacement for ``dgl.batch``.

Counterpart of ``sessionrec_tpu/graph/batch.py``: one row per session,
padded to static maxima, with masks marking the real entries.  The
conventions are the same:

  * ``intra_adj[b, u, v]`` marks edge ``u -> v`` (src-major); in-neighbour
    aggregation for destinations contracts axis 1.
  * node indices 0 .. n_nodes-1 are real, the rest padding; padded
    ``iid`` entries are 0 (in range for gathers, never selected).
  * ``valid`` marks real examples; a partial batch is padded with
    ``valid = 0`` rows.

The containers are plain dataclasses.  The loader's prefetch thread fills
them with numpy arrays; ``to(device)`` turns every array into a tensor on
``device`` (through pinned host memory when the device is a GPU), and
``copy_(src)`` copies a batch of the same nested shape into this one's
tensors in place, as the CUDA-graph trainer fills its static batch slots.
Both are called on the consuming thread only.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


def _staged(x, device):
    """``x`` as a tensor ready to copy to ``device``: pinned host memory
    for a host array bound to a GPU, so that the copy does not block."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    if device.type == "cuda" and not x.is_cuda:
        return x.pin_memory()
    return x


def _move(x, device):
    device = torch.device(device)
    # Only a copy onto the GPU may skip the wait: a non-blocking copy from
    # the GPU to the host returns before its bytes have landed.
    return _staged(x, device).to(device,
                                 non_blocking=device.type == "cuda")


def _copy_leaf(dst, src):
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"batch slot of shape {tuple(dst.shape)} cannot "
                         f"take an array of shape {tuple(src.shape)}")
    dst.copy_(_staged(src, dst.device),
              non_blocking=dst.device.type == "cuda")


def _block(x, d, dp):
    """Rows ``[d n/dp, (d + 1) n/dp)`` of ``x``'s ``n`` rows."""
    n = x.shape[0]
    if n % dp:
        raise ValueError(f"a batch block of {n} rows does not divide over "
                         f"data={dp}")
    return x[d * (n // dp):(d + 1) * (n // dp)]


class _Container:
    def data_block(self, d, dp):
        """This batch's rows of data position ``d`` of ``dp``: block ``d``
        of every array's rows, and of each tier's rows in a SplitBatch
        (the layout of a batch sharded over a mesh's data axis)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, tuple):
                out[f.name] = tuple(e.data_block(d, dp)
                                    if isinstance(e, _Container)
                                    else _block(e, d, dp) for e in v)
            elif isinstance(v, _Container):
                out[f.name] = v.data_block(d, dp)
            else:
                out[f.name] = _block(v, d, dp)
        return type(self)(**out)

    def nbytes(self):
        """Bytes of this batch's arrays (host or device), every tier's."""
        total = 0
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            for e in (v if isinstance(v, tuple) else (v,)):
                total += e.nbytes() if isinstance(e, _Container) \
                    else e.nbytes
        return total

    def to(self, device):
        """Copy of this batch with every array a tensor on ``device``."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, tuple):
                out[f.name] = tuple(e.to(device) if isinstance(e, _Container)
                                    else _move(e, device) for e in v)
            elif isinstance(v, _Container):
                out[f.name] = v.to(device)
            else:
                out[f.name] = _move(v, device)
        return type(self)(**out)

    def copy_(self, src):
        """Copy ``src``, a batch of the same nested shape (numpy arrays or
        tensors), into this batch's tensors in place, leaf by leaf, on the
        current stream; host arrays go through pinned memory and do not
        block."""
        if type(src) is not type(self):
            raise TypeError(f"cannot copy a {type(src).__name__} into a "
                            f"{type(self).__name__}")
        for f in dataclasses.fields(self):
            d, s = getattr(self, f.name), getattr(src, f.name)
            if isinstance(d, tuple):
                if len(d) != len(s):
                    raise ValueError(f"{f.name}: {len(s)} entries for a "
                                     f"slot of {len(d)}")
                for de, se in zip(d, s):
                    if isinstance(de, _Container):
                        de.copy_(se)
                    else:
                        _copy_leaf(de, se)
            elif isinstance(d, _Container):
                d.copy_(s)
            else:
                _copy_leaf(d, s)
        return self


@dataclass
class SessionGraphBatch(_Container):
    """Weighted session graph for SRGNN/NISER (collate.py:61-85): nodes are
    the session's unique items in ascending item order, ``adj[b, u, v]``
    the count of consecutive pairs u -> v, and a session of one item gets
    the self-loop 0 -> 0 of weight 1 (collate.py:74-76)."""

    node_iid: torch.Tensor   # [B, N] int32
    node_mask: torch.Tensor  # [B, N] float32
    adj: torch.Tensor        # [B, N, N] float32
    last_idx: torch.Tensor   # [B] int32 node of the session's last item
    labels: torch.Tensor     # [B] int32
    valid: torch.Tensor      # [B] float32


@dataclass
class LessrBatch(_Container):
    """EOP multigraph as ordered mailboxes plus the shortcut graph, for
    LESSR (collate.py:29-59): ``mail_idx[b, v, j]`` is the node of the
    source of v's j-th in-edge in temporal order (duplicates kept), and
    ``sc_adj[b, u, v]`` marks "u occurred at or before v" (self-loops
    included, deduplicated)."""

    node_iid: torch.Tensor   # [B, N] int32
    node_mask: torch.Tensor  # [B, N] float32
    mail_idx: torch.Tensor   # [B, N, M] int32, M = max(N - 1, 1)
    mail_mask: torch.Tensor  # [B, N, M] float32
    sc_adj: torch.Tensor     # [B, N, N] float32 0/1
    last_idx: torch.Tensor   # [B] int32
    labels: torch.Tensor     # [B] int32
    valid: torch.Tensor      # [B] float32


@dataclass
class CcsLevel(_Container):
    """One granularity level of the CCS heterograph (collate.py:87-217).

    Level ``k`` nodes are the distinct consecutive k-grams of the session
    in first-occurrence order; ``iid`` stores the k member item ids per
    node.  A session shorter than ``k`` gets a single pad node whose iid
    is the session's smallest item id repeated (collate.py:203-207).
    """

    iid: torch.Tensor        # [B, Nk, k] int32 member item ids
    mask: torch.Tensor       # [B, Nk] float32
    intra_adj: torch.Tensor  # [B, Nk, Nk] float32 0/1 (dedup)
    last_idx: torch.Tensor   # [B] int32


@dataclass
class CcsBatch(_Container):
    """Multi-granularity CCS heterograph batch for MSGIFSR."""

    levels: tuple     # tuple[CcsLevel] for k = 1..K
    inter_in: tuple   # [B, N1, Nk] 0/1 per k >= 2 (s1 -> sk)
    inter_out: tuple  # [B, Nk, N1] 0/1 per k >= 2 (sk -> s1)
    labels: torch.Tensor  # [B] int32
    valid: torch.Tensor   # [B] float32

    @property
    def order(self) -> int:
        return len(self.levels)


def _cat(a, b):
    if isinstance(a, np.ndarray):
        return np.concatenate([a, b], axis=0)
    return torch.cat([a, b], dim=0)


@dataclass
class SplitBatch(_Container):
    """Length-bucketed batch: the SAME example set as an unsplit batch,
    partitioned by prefix length into sub-blocks built at different
    static node caps (see ``sessionrec_tpu/graph/batch.py:SplitBatch``).

    ``short`` may itself be a SplitBatch (three or more tiers, shortest
    first); every consumer recurses.  ``labels`` / ``valid`` are the
    row-concatenated views, in the order the model heads concatenate
    their session vectors.
    """

    short: object    # a SessionGraphBatch, LessrBatch or CcsBatch
    long: object

    @property
    def labels(self):
        return _cat(self.short.labels, self.long.labels)

    @property
    def valid(self):
        return _cat(self.short.valid, self.long.valid)

    @property
    def order(self) -> int:
        return self.long.order


def flatten_blocks(batch):
    """Leaf blocks of a (possibly nested) SplitBatch, shortest tier
    first; ``[batch]`` for an unsplit batch."""
    if isinstance(batch, SplitBatch):
        return flatten_blocks(batch.short) + flatten_blocks(batch.long)
    return [batch]


def nest_blocks(blocks):
    """Left-nested SplitBatch over ``blocks`` (inverse of
    ``flatten_blocks``); identity for a single block."""
    nested = blocks[0]
    for b in blocks[1:]:
        nested = SplitBatch(short=nested, long=b)
    return nested
