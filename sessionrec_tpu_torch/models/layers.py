"""Neural layers over the dense graph layout.

Counterpart of ``sessionrec_tpu/models/layers.py``.  Parameters live in
``nn.Module``s whose attribute names follow the JAX parameter tree (a
JAX linear's ``{w, b}`` is a ``Linear``'s ``weight`` and ``bias``), and
the layer math is plain tensor functions over them.  Dropout takes a
``SeedSource`` (None disables).  The masked BatchNorm keeps its running
statistics as buffers, ``mean`` and ``var``, which a training forward
updates in place, so a captured CUDA graph replays the update.  A layer
with a BatchNorm takes its input normalised by the caller, who runs
``batchnorm_parts`` over all the tiers of a batch at once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sessionrec_tpu_torch.ops import dropout as _dropout
from sessionrec_tpu_torch.ops import embed as _embed
from sessionrec_tpu_torch.ops.gru import gru_cell, gru_scan, masked_mailbox_gru
from sessionrec_tpu_torch.ops.masked import masked_mean, masked_softmax
from sessionrec_tpu_torch.parallel.lookup import sharded_lookup
from sessionrec_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce_sum


class SeedSource:
    """Per-site dropout seeds computed on the device (the role of the JAX
    package's ``RngGen`` of PRNG keys).

    ``count`` is an int64 step counter on ``device``; ``begin_step``
    advances it in place and hashes it with the run's key into the step's
    base seed, and the i-th ``next`` of a step returns ``base ^ site_i``
    (``site_i`` a hash of i).  Every step has the same sites in the same
    order, so a CUDA graph captured over steps replays fresh masks from
    the counter, and an eager step from the same counter draws the same
    masks as the graph.

    On a mesh (``data``: the rank's data position and the data axis's
    size) every rank draws the same seeds, and ``offset`` places the
    rank's rows in the global batch, so each rank hashes the global flat
    indices of its block, as GSPMD does in the JAX package: the masks are
    the single-device run's."""

    def __init__(self, seed: int, device=None, data=(0, 1)):
        self.key = self._hash(seed)
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.data = data
        self._base()

    @staticmethod
    def _hash(x: int) -> int:
        return int(_dropout.fmix32(torch.tensor(x & _dropout._M32)))

    def _base(self):
        self.base = _dropout.fmix32((self.count ^ self.key) & _dropout._M32)
        self.site = 0

    def begin_step(self):
        """Advance to the next step's seeds (in place on the device)."""
        self.count.add_(1)
        self._base()

    def next(self):
        """The next site's seed: a 0-d int64 tensor on the device."""
        self.site += 1
        return self.base ^ self._hash(self.site)

    def offset(self, x, tiers=None):
        """Where this rank's ``x`` starts in the global tensor of which it
        holds the data block, in flat elements: 0 on one device.  ``x``'s
        leading axis is its rows; where it joins the blocks of several
        length tiers (``tiers``: each tier's rows here), each tier's rows
        sit after the whole of the earlier tiers, and the offset is an
        ``[R, 1]`` tensor, one per row of ``x`` viewed as ``[R, C]``."""
        d, dp = self.data
        if dp == 1:
            return 0
        if tiers is None:
            return d * x.numel()
        per_row = x.numel() // x.shape[0]
        offs, done, here = [], 0, 0
        for rows in tiers:
            offs.append(torch.full((rows,), (done + d * rows - here)
                                   * per_row, dtype=torch.int64,
                                   device=x.device))
            done += rows * dp
            here += rows
        return torch.repeat_interleave(
            torch.cat(offs), per_row // x.shape[-1])[:, None]


class _Cast:
    """A read-only view of module ``m`` whose parameters read in
    ``dtype``: attribute reads give the parameters cast (once per view),
    submodules as views, and buffers and everything else as they are
    (LESSR's running BatchNorm statistics stay float32 and are updated in
    place); calling a ``Linear``'s view applies it."""

    def __init__(self, m, dtype):
        self._m = m
        self._dtype = dtype
        self._cache = {}

    def _view(self, key, v):
        if key not in self._cache:
            if isinstance(v, nn.Parameter):
                v = v.to(self._dtype)
            elif isinstance(v, nn.Module):
                v = _Cast(v, self._dtype)
            self._cache[key] = v
        return self._cache[key]

    def __getattr__(self, name):
        return self._view(name, getattr(self._m, name))

    def __getitem__(self, key):
        return self._view(("item", key), self._m[key])

    def __iter__(self):
        return (self[i] for i in range(len(self._m)))

    def __len__(self):
        return len(self._m)

    def __call__(self, x):
        if not isinstance(self._m, nn.Linear):
            raise TypeError(f"cannot apply a cast view of "
                            f"{type(self._m).__name__}")
        return F.linear(x, self.weight, self.bias)


def cast_floats(module, dtype):
    """``module`` with its parameters read in ``dtype`` (the JAX package's
    ``cast_floats`` of a parameter tree), or ``module`` itself for None.
    The master parameters stay float32 and the casts are part of the
    forward, so the gradients land on the masters in float32."""
    return module if dtype is None else _Cast(module, dtype)


def compute_dtype(name: str):
    """The torch dtype a model computes in for config value ``name``; None
    for float32 (no casts anywhere)."""
    return None if name == "float32" else getattr(torch, name)


def embedding_lookups(table, ids, shard=None):
    """``[table[i] for i in ids]`` — a step's gathers, each id tensor's
    rows; callers cast them.  On the card, with gradients on, one autograd
    node whose backward writes the table's gradient once
    (``ops/embed.py``).  With a ``shard`` (``parallel/sharded.py:
    TableShard``; ``table`` is then this rank's rows) the mesh's lookup
    (``parallel/lookup.py``) of each."""
    if shard is not None:
        return [sharded_lookup(shard.mesh, table, i, shard.grad) for i in ids]
    return _embed.gather(table, ids)


def l2norm(x, eps=1e-12, dim=-1):
    """torch F.normalize: x / max(||x||, eps) (norm computed in f32)."""
    n = torch.linalg.vector_norm(x.to(torch.float32), dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps).to(x.dtype)


def dropout(rng, x, rate: float, training: bool, tiers=None):
    """Inverted dropout with a counter-hash mask (ops/dropout.py); ``tiers``
    as ``SeedSource.offset`` takes them."""
    if not training or rate == 0.0 or rng is None:
        return x
    return _dropout.dropout(x, rate, rng.next(), rng.offset(x, tiers))


class Linear(nn.Linear):
    """``nn.Linear`` whose construction draws nothing: the model's reset
    fills every parameter from its own generator (models/init.py), and
    the global RNG stays untouched."""

    def reset_parameters(self):
        pass


class PReLU(nn.Module):
    """Per-channel PReLU slopes ``a`` (JAX ``init.prelu_params``)."""

    def __init__(self, dim):
        super().__init__()
        self.a = nn.Parameter(torch.empty(dim))


def prelu(p: PReLU, x):
    return torch.where(x >= 0, x, p.a * x)


# ---------------------------------------------------------------------------
# Masked BatchNorm1d (torch semantics, running statistics included)
# ---------------------------------------------------------------------------

class BatchNorm(nn.Module):
    """BatchNorm1d over the last axis: ``scale`` and ``bias`` parameters,
    ``mean`` and ``var`` running buffers (JAX ``init.batchnorm_params``)."""

    def __init__(self, dim):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))


def bn_batch_moments(parts, mesh=None):
    """Masked BatchNorm batch statistics taken jointly over several arrays.

    ``parts`` is a list of ``(x [..., C], mask [...])``.  Returns ``(mean
    [C], biased var [C], n)`` in float32: the mean first, then the centred
    second moment, over the rows whose mask is 1 (n at least 1).  One
    array gives that array's own statistics; the tiers of a SplitBatch
    give those of the unsplit batch, up to float summation order.  On a
    ``mesh`` the counts, sums and squared deviations are summed over its
    data group, so every rank normalises with the global batch's
    statistics, as GSPMD computes them in the JAX package."""
    flats = [(x.to(torch.float32).reshape(-1, x.shape[-1]),
              m.reshape(-1, 1).to(torch.float32)) for x, m in parts]
    n = torch.clamp(all_reduce_sum(sum(torch.sum(mf) for _, mf in flats),
                                   mesh, DATA_AXIS), min=1.0)
    mean = all_reduce_sum(sum(torch.sum(xf * mf, 0) for xf, mf in flats),
                          mesh, DATA_AXIS) / n
    var = all_reduce_sum(sum(torch.sum((xf - mean) ** 2 * mf, 0)
                             for xf, mf in flats), mesh, DATA_AXIS) / n
    return mean, var, n


def batchnorm_parts(p: BatchNorm, xs, masks, *, training, momentum=0.1,
                    eps=1e-5, mesh=None):
    """BatchNorm over all leading axes of the tiers ``xs [..., C]`` of one
    batch, in float32; ``masks`` mark their real rows.

    Training normalises with the batch statistics of the real rows of all
    tiers together (``bn_batch_moments``, biased variance) and moves the
    running buffers once, in place: ``(1 - momentum) * running + momentum
    * batch``, with the unbiased variance ``var * n / (n - 1)`` (torch's
    rule).  Eval normalises with the running buffers.  ``mesh`` as
    ``bn_batch_moments`` takes it: the buffers move alike on every
    rank."""
    if training:
        mean, var, n = bn_batch_moments(list(zip(xs, masks)), mesh)
        with torch.no_grad():
            unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
            p.mean.mul_(1 - momentum).add_(momentum * mean)
            p.var.mul_(1 - momentum).add_(momentum * unbiased)
    else:
        mean, var = p.mean, p.var
    inv = torch.rsqrt(var + eps)
    return [((x.to(torch.float32) - mean) * inv * p.scale + p.bias)
            .to(x.dtype) for x in xs]


# ---------------------------------------------------------------------------
# SRGNNLayer (reference srgnn.py:11-51, niser.py:11-49)
# ---------------------------------------------------------------------------

class SRGNNLayer(nn.Module):
    """A gated-GNN step: the GRU over ``[W1 neigh_in, W2 neigh_out]``
    (JAX ``init_srgnn_layer``)."""

    def __init__(self, dim):
        super().__init__()
        self.gru = GRU(2 * dim, dim)
        self.W1 = Linear(dim, dim, bias=False)
        self.W2 = Linear(dim, dim, bias=False)


def srgnn_layer_apply(p: SRGNNLayer, feat, adj, rng, *, feat_drop, training):
    """One gated-GNN step on the weighted session graph: messages are the
    dropped features, the GRU's hidden state the undropped ones
    (srgnn.py:35,45); weighted-mean aggregation in both edge directions,
    a node with no in-weight aggregating to 0."""
    ft = dropout(rng, feat, feat_drop, training)
    neigh1 = torch.einsum("buv,bud->bvd", adj, ft) \
        / torch.clamp(torch.sum(adj, dim=1), min=1e-24)[..., None]
    neigh2 = torch.einsum("buv,bvd->bud", adj, ft) \
        / torch.clamp(torch.sum(adj, dim=2), min=1e-24)[..., None]
    hn = torch.cat([p.W1(neigh1), p.W2(neigh2)], dim=-1)
    return gru_cell(p.gru, hn, feat)


def gather_rows(x, idx):
    """``x[b, idx[b]]`` for ``x [B, N, d]`` and ``idx [B]``."""
    idx = idx.to(torch.int64)[:, None, None].expand(-1, 1, x.shape[-1])
    return torch.gather(x, 1, idx)[:, 0]


# ---------------------------------------------------------------------------
# AttnReadout (homogeneous; srgnn.py:53-91, lessr.py:80-118)
# ---------------------------------------------------------------------------

class AttnReadout(nn.Module):
    """Soft-attention pooling (JAX ``init_attn_readout``): ``fc_u`` without
    bias, ``fc_v`` with, ``fc_e``; ``fc_out`` when the widths differ, and
    optionally a BatchNorm ``bn`` of the input and a PReLU ``act``."""

    def __init__(self, in_dim, hidden_dim, out_dim, *, batch_norm=False,
                 activation=False):
        super().__init__()
        if batch_norm:
            self.bn = BatchNorm(in_dim)
        self.fc_u = Linear(in_dim, hidden_dim, bias=False)
        self.fc_v = Linear(in_dim, hidden_dim, bias=True)
        self.fc_e = Linear(hidden_dim, 1, bias=False)
        if out_dim != in_dim:
            self.fc_out = Linear(in_dim, out_dim, bias=False)
        if activation:
            self.act = PReLU(out_dim)


def attn_readout_apply(p: AttnReadout, feat, mask, last_idx, rng, *,
                       feat_drop, training):
    """One session vector per graph: attention of every node against the
    last one, softmax over the real nodes, weighted sum.  ``feat`` comes
    normalised already where the readout has a ``bn``
    (``batchnorm_parts``)."""
    feat = dropout(rng, feat, feat_drop, training)
    feat_u = p.fc_u(feat)                                  # [B, N, H]
    feat_v = p.fc_v(gather_rows(feat, last_idx))           # [B, H]
    e = p.fc_e(torch.sigmoid(feat_u + feat_v[:, None, :]))
    alpha = masked_softmax(e, mask[..., None], dim=1)
    rst = torch.sum(feat * alpha, dim=1)
    if hasattr(p, "fc_out"):
        rst = p.fc_out(rst)
    if hasattr(p, "act"):
        rst = prelu(p.act, rst)
    return rst


# ---------------------------------------------------------------------------
# EOPA and SGAT (reference lessr.py:8-77)
# ---------------------------------------------------------------------------

class EOPA(nn.Module):
    """Edge-order-preserving aggregation (JAX ``init_eopa``)."""

    def __init__(self, in_dim, out_dim, *, batch_norm=True):
        super().__init__()
        if batch_norm:
            self.bn = BatchNorm(in_dim)
        self.gru = GRU(in_dim, in_dim)
        self.fc_self = Linear(in_dim, out_dim, bias=False)
        self.fc_neigh = Linear(in_dim, out_dim, bias=False)
        self.act = PReLU(out_dim)


def eopa_apply(p: EOPA, feat, mail_idx, mail_mask, rng, *, feat_drop,
               training):
    """The mailbox GRU over each node's in-messages in temporal order
    (DGL's edge-insertion mailbox, lessr.py:21-26), then ``fc_self(feat)
    + fc_neigh(neigh)`` and the PReLU.  ``feat`` comes normalised where
    the layer has a ``bn``.  The mailbox gather is a one-hot product over
    the N source nodes, as in the JAX package: its backward is a product
    too, with no scatter of atomics, so a step repeats its bits."""
    ft = dropout(rng, feat, feat_drop, training)
    N = feat.shape[1]
    onehot = (mail_idx.to(torch.int64)[..., None]
              == torch.arange(N, device=feat.device)).to(ft.dtype)
    mail = torch.einsum("bvjn,bnd->bvjd", onehot, ft)
    neigh = masked_mailbox_gru(p.gru, mail, mail_mask)
    return prelu(p.act, p.fc_self(feat) + p.fc_neigh(neigh))


class SGAT(nn.Module):
    """Shortcut-graph attention (JAX ``init_sgat``)."""

    def __init__(self, in_dim, hidden_dim, out_dim, *, batch_norm=True):
        super().__init__()
        if batch_norm:
            self.bn = BatchNorm(in_dim)
        self.fc_q = Linear(in_dim, hidden_dim, bias=True)
        self.fc_k = Linear(in_dim, hidden_dim, bias=False)
        self.fc_v = Linear(in_dim, out_dim, bias=False)
        self.fc_e = Linear(hidden_dim, 1, bias=False)
        self.act = PReLU(out_dim)


def sgat_apply(p: SGAT, feat, sc_adj, rng, *, feat_drop, training):
    """``e_uv = fc_e(sigmoid(q_u + k_v))``, softmax over each destination's
    in-edges of the shortcut graph, weighted sum of ``v_u``, PReLU.
    ``feat`` comes normalised where the layer has a ``bn``."""
    feat = dropout(rng, feat, feat_drop, training)
    q, k, v = p.fc_q(feat), p.fc_k(feat), p.fc_v(feat)
    e = p.fc_e(torch.sigmoid(q[:, :, None, :] + k[:, None, :, :]))
    a = masked_softmax(e, sc_adj[..., None], dim=1)        # by destination
    rst = torch.einsum("buv,bud->bvd", a[..., 0], v)
    return prelu(p.act, rst)


# ---------------------------------------------------------------------------
# SemanticExpander (reference msgifsr.py:14-45)
# ---------------------------------------------------------------------------

class GRU(nn.Module):
    """One GRU layer's weights in torch's layout (ops/gru.py), named as
    the JAX package's ``init.gru_params``."""

    def __init__(self, in_dim, hidden):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(3 * hidden, in_dim))
        self.w_hh = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.b_ih = nn.Parameter(torch.empty(3 * hidden))
        self.b_hh = nn.Parameter(torch.empty(3 * hidden))


class SemanticExpander(nn.Module):
    """One GRU per gram size k >= 2 (``grus[k - 2]``) and, under the
    ``concat`` reducer, one linear ``Ws[k - 2]`` from ``k * d`` to ``d``
    (``sessionrec_tpu/models/layers.py:init_semantic_expander``)."""

    def __init__(self, dim, reducer: str, order: int):
        super().__init__()
        self.grus = nn.ModuleList(GRU(dim, dim) for _ in range(order - 1))
        self.Ws = nn.ModuleList(
            nn.Linear(dim * (i + 1), dim, bias=True)
            for i in range(1, order)) if reducer == "concat" \
            else nn.ModuleList()


def semantic_expander_apply(p: SemanticExpander, feat, level: int,
                            reducer: str):
    """Embed a k-gram node set ``feat [B, Nk, k, d]`` -> ``[B, Nk, d]``:
    the single member at level 1, else the mean of the reducer's output
    (mean, max or a linear over the concatenated members) and the GRU's
    final hidden state over the k members."""
    if level == 1:
        return feat[:, :, 0, :]
    if reducer == "mean":
        invar = torch.mean(feat, dim=2)
    elif reducer == "max":
        invar = torch.amax(feat, dim=2)
    elif reducer == "concat":
        B, Nk = feat.shape[0], feat.shape[1]
        invar = p.Ws[level - 2](feat.reshape(B, Nk, -1))
    else:
        raise ValueError(f"unknown reducer {reducer!r}")
    var = gru_scan(p.grus[level - 2], feat)
    return 0.5 * invar + 0.5 * var


# ---------------------------------------------------------------------------
# GATConv (vendored DGL layer; reference gatconv.py:254-319), dense form
# ---------------------------------------------------------------------------

class GAT(nn.Module):
    """GATConv parameters (``sessionrec_tpu/models/init.py:gat_params``);
    the residual is the identity, so it has none."""

    def __init__(self, in_dim, out_dim, num_heads):
        super().__init__()
        self.fc = nn.Parameter(torch.empty(out_dim * num_heads, in_dim))
        self.attn_l = nn.Parameter(torch.empty(num_heads, out_dim))
        self.attn_r = nn.Parameter(torch.empty(num_heads, out_dim))
        self.bias = nn.Parameter(torch.empty(num_heads * out_dim))


def gat_apply(p: GAT, f_src, f_dst, adj, rng, *, num_heads, feat_drop,
              attn_drop, training):
    """8-head additive-attention conv on a relation ``adj [B, Ns, Nd]``
    (src -> dst).  Returns ``[B, Nd, H, dh]``; the caller reduces heads.

    The attention logits use the folded form of the JAX package:
    ``el = h_src @ (fc^T attn_l)``, a [d, H] matrix built from the weights
    once per call, instead of reducing the projected [*, H, dh] tensor.
    """
    if f_src is f_dst:
        # homogeneous relation: one dropout mask for both roles
        h_src = h_dst = dropout(rng, f_src, feat_drop, training)
    else:
        h_src = dropout(rng, f_src, feat_drop, training)
        h_dst = dropout(rng, f_dst, feat_drop, training)
    B, Ns = h_src.shape[0], h_src.shape[1]
    dh = p.attn_l.shape[-1]
    fs = (h_src @ p.fc.T).reshape(B, Ns, num_heads, dh)
    fc3 = p.fc.reshape(num_heads, dh, -1)                  # [H, dh, d]
    w_el = torch.einsum("hfd,hf->dh", fc3, p.attn_l)       # [d, H]
    w_er = torch.einsum("hfd,hf->dh", fc3, p.attn_r)
    el = h_src @ w_el                                      # [B, Ns, H]
    er = h_dst @ w_er                                      # [B, Nd, H]
    e = F.leaky_relu(el[:, :, None, :] + er[:, None, :, :], 0.2)
    a = masked_softmax(e, adj[..., None], dim=1)           # softmax over src
    a = dropout(rng, a, attn_drop, training)
    rst = torch.einsum("bsdh,bshf->bdhf", a, fs)
    rst = rst + h_dst[:, :, None, :]                       # identity residual
    return rst + p.bias.reshape(1, 1, num_heads, dh)


# ---------------------------------------------------------------------------
# MSHGNN (reference msgifsr.py:47-91)
# ---------------------------------------------------------------------------

class MSHGNN(nn.Module):
    """Two HeteroGraphConvs (forward + reversed graph), each a dict of
    GATConvs: one per intra relation and one 'inter' module shared by
    every inter relation (``sessionrec_tpu/models/layers.py:init_mshgnn``).
    At order 1 the 'inter' modules exist, as in the reference, but no
    relation uses them."""

    def __init__(self, dim, order, num_heads=8):
        super().__init__()
        for conv in ("conv1", "conv2"):
            mods = {f"intra{i + 1}": GAT(dim, dim, num_heads)
                    for i in range(order)}
            mods["inter"] = GAT(dim, dim, num_heads)
            setattr(self, conv, nn.ModuleDict(mods))


def mshgnn_apply(p: MSHGNN, feats, batch, rng, *, feat_drop, training,
                 num_heads=8):
    """Hetero message passing over the CCS batch.  For each level: GAT over
    the forward relations (conv1) plus GAT over the reversed graph (conv2),
    summed per destination, max over the heads, plus the broadcast
    per-graph mean of the input features (msgifsr.py:84-89).

    The inter relations join level 1 with each level k >= 2: at level 1,
    conv1 reads ``inter_out[k - 2]`` (sk -> s1) and conv2 the transpose of
    ``inter_in[k - 2]``; at level l >= 2 it is the mirror image.  Their
    source is another level, so each applies its own dropout mask to the
    source and the destination features."""
    K = batch.order
    kw = dict(num_heads=num_heads, feat_drop=feat_drop, attn_drop=feat_drop,
              training=training)
    out = []
    for l in range(1, K + 1):
        lv = batch.levels[l - 1]
        f = feats[l - 1]
        acc = gat_apply(p.conv1[f"intra{l}"], f, f, lv.intra_adj, rng, **kw)
        acc = acc + gat_apply(p.conv2[f"intra{l}"], f, f,
                              lv.intra_adj.transpose(1, 2), rng, **kw)
        if l == 1:
            for k in range(2, K + 1):
                fk = feats[k - 1]
                acc = acc + gat_apply(p.conv1["inter"], fk, f,
                                      batch.inter_out[k - 2], rng, **kw)
                acc = acc + gat_apply(p.conv2["inter"], fk, f,
                                      batch.inter_in[k - 2].transpose(1, 2),
                                      rng, **kw)
        else:
            acc = acc + gat_apply(p.conv1["inter"], feats[0], f,
                                  batch.inter_in[l - 2], rng, **kw)
            acc = acc + gat_apply(p.conv2["inter"], feats[0], f,
                                  batch.inter_out[l - 2].transpose(1, 2),
                                  rng, **kw)
        h = torch.amax(acc, dim=2)                         # head max
        h_mean = masked_mean(f, lv.mask[..., None], dim=1)  # per-graph mean
        out.append(h + h_mean[:, None, :])
    return out
