"""Plain PyTorch reference of MSGIFSR (Guo et al., WSDM'22), for the check
that decides a run's ``correct``.

Written from the model of SpaceLearner/SessionRec-pytorch
(``src/models/msgifsr.py``: the semantic expander, the two
HeteroGraphConvs of 8-head GATConvs per layer, the attention readout over
the nodes of every order, ``fc_sr``, REnorm's ``sc_sr[0]`` gate and the IFR
fusion over ``softmax(alpha)``), its collate (``src/utils/data/collate.py``:
the multi-granularity consecutive-intent-unit graph) and its trainer
(``src/utils/train.py``: Adam with a no-decay group for biases, StepLR,
``nn.Embedding(max_norm=1)``), in a dense padded layout: one row a
session, nodes padded to a cap with a mask.  It imports torch and numpy
only, builds its own graphs from the item sequences it is given, and
takes its weights from the benchmark, never from the program.

Dropout is the configuration's counter hash: the keep bit of element
``i`` of a tensor is murmur3's finalizer of ``i`` mixed with the seed of
the dropout site, and a site's seed hashes the run's dropout key, the
step and the site's number in the step (the sites are counted in the
order the model's forward meets them).  Element indices run over the
tensor in the dense layout, so the reference lays its batches out as the
configuration states: examples split by length into tiers (``tiers``,
then the node cap), each tier at its own node cap, rows in stream order.

``precision`` rounds the inputs of every product (matmul, linear,
einsum) before a float32 product: ``"float32"`` leaves them, ``"tf32"``
rounds to TF32's 10-bit mantissa (what a TF32 tensor core reads) and
``"bfloat16"`` to bfloat16, and the gradients that flow back into those
inputs alike.  The lower two are the check's controls.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

M32 = 0xFFFFFFFF
HEADS = 8
NEG = -1e30
TINY = 1e-30


# -- the dropout hash ---------------------------------------------------------

def _mul32(a, c: int):
    """``(a * c) mod 2**32`` for int64 ``a`` in [0, 2**32), with no product
    above 2**48."""
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (hi + a * (c & 0xFFFF)) & M32


def fmix32(h):
    """murmur3's 32-bit finalizer of an int64 tensor of 32-bit values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def fmix32_int(h: int) -> int:
    """``fmix32`` of a Python integer."""
    h &= M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


class StepSeeds:
    """The dropout sites of one training step: site ``i`` (from 1) has the
    seed ``base ^ fmix32(i)``, ``base = fmix32(step ^ fmix32(key))``."""

    def __init__(self, key: int, step: int):
        self.base = fmix32_int((step ^ fmix32_int(key)) & M32)
        self.site = 0

    def next(self) -> int:
        self.site += 1
        return self.base ^ fmix32_int(self.site)


def dropout(x, rate: float, seeds):
    """Inverted dropout of ``x`` (features on the last axis) with the next
    site's mask; ``seeds`` None leaves ``x``."""
    if seeds is None or rate == 0.0:
        return x
    seed = seeds.next()
    C = x.shape[-1]
    R = x.numel() // C
    mixed = ((seed & M32) * 0x9E3779B9) & M32
    idx = torch.arange(R * C, dtype=torch.int64, device=x.device)
    bits = fmix32((idx & M32) ^ mixed).reshape(R, C)
    keep = bits < min(int((1.0 - rate) * 4294967296.0), M32)
    scale = float(np.float32(1.0 / (1.0 - rate)))
    return torch.where(keep, x.reshape(R, C) * scale, 0.0).reshape(x.shape)


# -- precision of the products ------------------------------------------------

def _round_tf32(x):
    """float32 ``x`` rounded to the nearest TF32 value (10 mantissa bits,
    ties to even)."""
    i = x.contiguous().view(torch.int32)
    bias = ((i >> 13) & 1) + 0xFFF
    return ((i + bias) & ~0x1FFF).view(torch.float32)


def _round_bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


class _Rounded(torch.autograd.Function):
    """``fn(x)`` forward; the gradient that reaches ``x`` rounded by
    ``fn`` too, as a product's backward at that precision reads it."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def exact_float32():
    """float32 products in float32 on the card: no TF32 in matmuls or
    convolutions (the lower precisions are emulated by ``rounder``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rounder(precision: str):
    if precision == "float32":
        return lambda x: x
    fn = {"tf32": _round_tf32, "bfloat16": _round_bf16}.get(precision)
    if fn is None:
        raise ValueError(f"unknown precision {precision!r}")
    return lambda x: _Rounded.apply(x, fn)


# -- parameters ---------------------------------------------------------------

def param_spec(cfg):
    """``[(name, shape, decays)]`` of the model: the names are the ones the
    benchmark loads into the program by; ``decays`` is the Adam group
    (biases take no weight decay, train.py:12-23)."""
    m = cfg["model"]
    d, K, n = m["embedding_dim"], m["order"], cfg["catalog"]["num_items"]
    spec = [("embedding", (n, d), True), ("alpha", (K,), True),
            ("beta", (1,), True)]
    for i in range(K - 1):
        spec += [(f"expander.grus.{i}.w_ih", (3 * d, d), True),
                 (f"expander.grus.{i}.w_hh", (3 * d, d), True),
                 (f"expander.grus.{i}.b_ih", (3 * d,), False),
                 (f"expander.grus.{i}.b_hh", (3 * d,), False)]
    for layer in range(m["num_layers"]):
        for conv in ("conv1", "conv2"):
            for rel in [f"intra{k}" for k in range(1, K + 1)] + ["inter"]:
                p = f"layers.{layer}.{conv}.{rel}"
                spec += [(f"{p}.fc", (HEADS * d, d), True),
                         (f"{p}.attn_l", (HEADS, d), True),
                         (f"{p}.attn_r", (HEADS, d), True),
                         (f"{p}.bias", (HEADS * d,), False)]
    for i in range(K):
        spec += [(f"readout.fc_u.{i}.weight", (d, d), True),
                 (f"readout.fc_u.{i}.bias", (d,), False),
                 (f"readout.fc_v.{i}.weight", (d, d), True),
                 (f"readout.fc_e.{i}.weight", (1, d), True),
                 (f"fc_sr.{i}.weight", (d, 2 * d), True),
                 (f"sc_sr.{i}.l1.weight", (d, d), True),
                 (f"sc_sr.{i}.l1.bias", (d,), False),
                 (f"sc_sr.{i}.l2.weight", (2, d), True)]
    return spec


@torch.no_grad()
def init_params(cfg, seed: int, device):
    """The weights of ``seed``: every parameter U(-1/sqrt(d), 1/sqrt(d))
    (msgifsr.py:224-227), drawn on ``device`` in one call of a generator
    there, in ``param_spec`` order; then ``alpha`` one-hot and ``beta`` 1
    (msgifsr.py:213-216)."""
    spec = param_spec(cfg)
    bound = 1.0 / math.sqrt(cfg["model"]["embedding_dim"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sizes = [math.prod(shape) for _, shape, _ in spec]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.uniform_(-bound, bound, generator=gen)
    out = {name: t.view(shape) for (name, shape, _), t in
           zip(spec, torch.split(flat, sizes))}
    out["alpha"].zero_()
    out["alpha"][0] = 1.0
    out["beta"].fill_(1.0)
    return out


# -- graphs -------------------------------------------------------------------

def _kgrams(seq, k):
    """Distinct consecutive k-grams in first-occurrence order, and the
    gram at each position."""
    grams, at = {}, []
    for j in range(len(seq) - k + 1):
        g = tuple(seq[j:j + k])
        at.append(grams.setdefault(g, len(grams)))
    return list(grams), at


def build_graphs(seqs, order: int, cap: int, device):
    """The dense CCS graphs of ``seqs`` at node cap ``cap``
    (collate.py:87-217): level ``k`` holds the distinct k-grams, level 1
    in ascending item order and the others in first-occurrence order;
    intra edges join consecutive grams, inter edges join an item to the
    k-gram that starts after it and a k-gram to the item after it; a
    level above the session's length holds one node, its smallest item
    repeated, with no edges."""
    R, K = len(seqs), order
    caps = [max(cap - k + 1, 1) for k in range(1, K + 1)]
    iid = [np.zeros((R, c, k), np.int64) for k, c in zip(range(1, K + 1),
                                                         caps)]
    mask = [np.zeros((R, c), np.float32) for c in caps]
    intra = [np.zeros((R, c, c), np.float32) for c in caps]
    last = [np.zeros(R, np.int64) for _ in caps]
    inter_in = [np.zeros((R, caps[0], caps[k - 1]), np.float32)
                for k in range(2, K + 1)]
    inter_out = [np.zeros((R, caps[k - 1], caps[0]), np.float32)
                 for k in range(2, K + 1)]
    for b, seq in enumerate(seqs):
        L = len(seq)
        items = sorted(set(seq))
        nid = {x: i for i, x in enumerate(items)}
        pos1 = [nid[x] for x in seq]
        iid[0][b, :len(items), 0] = items
        mask[0][b, :len(items)] = 1.0
        for u, v in zip(pos1, pos1[1:]):
            intra[0][b, u, v] = 1.0
        last[0][b] = pos1[-1]
        for k in range(2, K + 1):
            if k > L:
                iid[k - 1][b, 0, :] = items[0]
                mask[k - 1][b, 0] = 1.0
                continue
            grams, at = _kgrams(seq, k)
            iid[k - 1][b, :len(grams), :] = grams
            mask[k - 1][b, :len(grams)] = 1.0
            for u, v in zip(at, at[1:]):
                intra[k - 1][b, u, v] = 1.0
            last[k - 1][b] = at[-1]
            for i in range(L - k):
                inter_in[k - 2][b, pos1[i], at[i + 1]] = 1.0
                inter_out[k - 2][b, at[i], pos1[i + k]] = 1.0

    def t(x):
        return torch.from_numpy(x).to(device)
    return {"iid": [t(x) for x in iid], "mask": [t(x) for x in mask],
            "intra": [t(x) for x in intra], "last": [t(x) for x in last],
            "inter_in": [t(x) for x in inter_in],
            "inter_out": [t(x) for x in inter_out]}


def tier_split(examples, tiers, max_len):
    """``[(cap, examples)]``: each example goes to the first tier whose
    cap holds its items, in stream order; caps are ``tiers`` below
    ``max_len``, then ``max_len``."""
    caps = sorted({t for t in tiers if 0 < t < max_len}) + [max_len]
    groups = [[] for _ in caps]
    for ex in examples:
        for g, cap in zip(groups, caps):
            if len(ex[0]) <= cap:
                g.append(ex)
                break
    return [(cap, g) for cap, g in zip(caps, groups) if g]


def prefix_examples(sessions):
    """Every session's prefixes with the item after each, in stream order
    (dataset.py:6-13)."""
    return [(s[:i], s[i]) for s in sessions for i in range(1, len(s))]


# -- the model ----------------------------------------------------------------

def l2norm(x, eps=1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def masked_softmax(e, mask, dim):
    """Softmax over ``dim`` restricted to ``mask``; all masked gives 0."""
    mask = mask.bool()
    e = torch.where(mask, e, NEG)
    m = torch.clamp(torch.amax(e, dim=dim, keepdim=True), min=NEG * 0.5)
    ex = torch.where(mask, torch.exp(e - m), 0.0)
    s = torch.sum(ex, dim=dim, keepdim=True)
    return ex / torch.clamp(s, min=torch.finfo(torch.float32).tiny)


class MSGIFSR:
    """The model's forward, its loss and its scores over weights ``p`` (a
    dict by ``param_spec`` names)."""

    def __init__(self, cfg, precision="float32"):
        m = cfg["model"]
        self.d = m["embedding_dim"]
        self.K = m["order"]
        self.layers = m["num_layers"]
        self.rate = m["feat_drop"]
        self.norm = m["norm"]
        self.extra = m["extra"]
        self.fusion = m["fusion"]
        self.scale = m["scale"]
        self.n_items = cfg["catalog"]["num_items"]
        self.low = rounder(precision)

    # products, with their inputs at the chosen precision
    def mm(self, a, b):
        return self.low(a) @ self.low(b)

    def linear(self, x, w, b=None):
        y = self.mm(x, w.T)
        return y if b is None else y + b

    def gru(self, p, pre, xs):
        """Final hidden state of a torch GRU over ``xs [..., T, d]``."""
        h = xs.new_zeros(xs.shape[:-2] + (self.d,))
        for t in range(xs.shape[-2]):
            gi = self.linear(xs[..., t, :], p[pre + "w_ih"], p[pre + "b_ih"])
            gh = self.linear(h, p[pre + "w_hh"], p[pre + "b_hh"])
            ir, iz, inn = gi.chunk(3, -1)
            hr, hz, hn = gh.chunk(3, -1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            h = (1.0 - z) * torch.tanh(inn + r * hn) + z * h
        return h

    def gat(self, p, pre, f_src, f_dst, adj, seeds):
        """GATConv (gatconv.py:254-319): 8 heads, identity residual, one
        dropout mask for both roles of a relation within one level."""
        if f_src is f_dst:
            h_src = h_dst = dropout(f_src, self.rate, seeds)
        else:
            h_src = dropout(f_src, self.rate, seeds)
            h_dst = dropout(f_dst, self.rate, seeds)
        R, Ns, Nd, H, d = h_src.shape[0], h_src.shape[1], h_dst.shape[1], \
            HEADS, self.d
        fs = self.mm(h_src, p[pre + "fc"].T).reshape(R, Ns, H, d)
        fd = self.mm(h_dst, p[pre + "fc"].T).reshape(R, Nd, H, d)
        el = torch.sum(fs * p[pre + "attn_l"], -1)
        er = torch.sum(fd * p[pre + "attn_r"], -1)
        e = F.leaky_relu(el[:, :, None, :] + er[:, None, :, :], 0.2)
        a = masked_softmax(e, adj[..., None], dim=1)
        a = dropout(a, self.rate, seeds)
        rst = torch.einsum("bsdh,bshf->bdhf", self.low(a), self.low(fs))
        return rst + h_dst[:, :, None, :] + p[pre + "bias"].reshape(1, 1, H, d)

    def mshgnn(self, p, pre, feats, g, seeds):
        out = []
        K = self.K
        for l in range(1, K + 1):
            f = feats[l - 1]
            a = self.gat(p, f"{pre}conv1.intra{l}.", f, f, g["intra"][l - 1],
                         seeds)
            a = a + self.gat(p, f"{pre}conv2.intra{l}.", f, f,
                             g["intra"][l - 1].transpose(1, 2), seeds)
            if l == 1:
                for k in range(2, K + 1):
                    a = a + self.gat(p, f"{pre}conv1.inter.", feats[k - 1], f,
                                     g["inter_out"][k - 2], seeds)
                    a = a + self.gat(p, f"{pre}conv2.inter.", feats[k - 1], f,
                                     g["inter_in"][k - 2].transpose(1, 2),
                                     seeds)
            else:
                a = a + self.gat(p, f"{pre}conv1.inter.", feats[0], f,
                                 g["inter_in"][l - 2], seeds)
                a = a + self.gat(p, f"{pre}conv2.inter.", feats[0], f,
                                 g["inter_out"][l - 2].transpose(1, 2), seeds)
            m = g["mask"][l - 1][..., None]
            mean = torch.sum(f * m, 1) / torch.clamp(torch.sum(m, 1), min=1.0)
            out.append(torch.amax(a, dim=2) + mean[:, None, :])
        return out

    def session_vectors(self, p, g, seeds):
        """``[R, K, d]`` session vectors of one tier's graphs."""
        feats = []
        for l in range(1, self.K + 1):
            x = p["embedding"][g["iid"][l - 1]]              # [R, N, l, d]
            x = dropout(x, self.rate, seeds)
            if l == 1:
                x = x[:, :, 0, :]
            else:
                x = 0.5 * torch.mean(x, 2) + 0.5 * self.gru(
                    p, f"expander.grus.{l - 2}.", x)
            feats.append(l2norm(x) if self.norm else x)
        for layer in range(self.layers):
            feats = self.mshgnn(p, f"layers.{layer}.", feats, g, seeds)
        if self.norm:
            feats = [l2norm(x) for x in feats]
        every = torch.cat(feats, 1)
        mask = torch.cat(g["mask"], 1)[..., None]
        rows = torch.arange(every.shape[0], device=every.device)
        out = []
        for i in range(self.K):
            last = feats[i][rows, g["last"][i]]
            e = self.linear(torch.sigmoid(
                self.linear(every, p[f"readout.fc_u.{i}.weight"],
                            p[f"readout.fc_u.{i}.bias"])
                + self.linear(last, p[f"readout.fc_v.{i}.weight"])[:, None]),
                p[f"readout.fc_e.{i}.weight"])
            att = masked_softmax(e, mask, dim=1)
            pooled = torch.sum(every * att, 1)
            out.append(self.linear(torch.cat([last, pooled], -1),
                                   p[f"fc_sr.{i}.weight"]))
        sr = torch.stack(out, 1)
        return l2norm(sr) if self.norm else sr

    def forward(self, p, examples, tiers, max_len, seeds, device):
        """Session vectors ``[B, K, d]``, labels, and the ``[B, n]`` 0/1
        mask of each row's session items, tiers concatenated in order."""
        srs, labels, smask = [], [], []
        for cap, group in tier_split(examples, tiers, max_len):
            g = build_graphs([s for s, _ in group], self.K, cap, device)
            srs.append(self.session_vectors(p, g, seeds))
            labels += [y for _, y in group]
            m = torch.zeros(len(group), self.n_items, device=device)
            for b, (s, _) in enumerate(group):
                m[b, sorted(set(s))] = 1.0
            smask.append(m)
        return (torch.cat(srs), torch.tensor(labels, device=device),
                torch.cat(smask))

    def logits(self, p, sr):
        table = l2norm(p["embedding"]) if self.norm else p["embedding"]
        return self.scale * self.mm(sr, table.T)             # [B, K, n]

    def phi(self, p, sr):
        h = torch.relu(self.linear(sr, p["sc_sr.0.l1.weight"],
                                   p["sc_sr.0.l1.bias"]))
        return torch.softmax(self.linear(h, p["sc_sr.0.l2.weight"]), -1)

    def _fuse(self, p, per_order):
        """The orders' probabilities ``[B, K, ...]`` joined: the IFR fusion
        over ``softmax(alpha)``, else order 1 (msgifsr.py:316-321)."""
        if self.K > 1 and self.fusion:
            w = torch.softmax(p["alpha"], 0)
            return torch.sum(per_order * w.reshape((1, -1) + (1,) * (
                per_order.dim() - 2)), 1)
        return per_order[:, 0]

    def nll(self, p, sr, labels, smask):
        """Mean ``-log`` label probability (train.py:99)."""
        z = self.logits(p, sr)
        zl = torch.gather(z, 2, labels[:, None, None].expand(-1, self.K, 1))[
            ..., 0]
        if not self.extra:
            if self.K == 1 or not self.fusion:
                return torch.mean(torch.logsumexp(z[:, 0], -1) - zl[:, 0])
            prob = torch.exp(zl - torch.logsumexp(z, -1))
        else:
            inside = smask[:, None, :].bool()
            lse_in = torch.logsumexp(torch.where(inside, z, NEG), -1)
            lse_ex = torch.logsumexp(torch.where(inside, NEG, z), -1)
            li = torch.gather(smask, 1, labels[:, None]).bool()
            ph = self.phi(p, sr)
            prob = torch.where(li, ph[..., 0] * torch.exp(zl - lse_in),
                               ph[..., 1] * torch.exp(zl - lse_ex))
        score = self._fuse(p, prob)
        return torch.mean(-torch.log(torch.clamp(score, min=TINY)))

    @torch.no_grad()
    def log_probs(self, p, sr, smask):
        """``[B, n]`` log-probabilities over the catalog: REnorm's split of
        each order's softmax into session and other items, blended by
        ``phi``, then the fusion (msgifsr.py:276-321)."""
        z = self.logits(p, sr)
        if self.extra:
            inside = smask[:, None, :]
            ph = self.phi(p, sr)
            prob = ph[..., 0:1] * masked_softmax(z, inside, -1) \
                + ph[..., 1:2] * masked_softmax(z, 1.0 - inside, -1)
        else:
            prob = torch.softmax(z, -1)
        return torch.log(torch.clamp(self._fuse(p, prob), min=TINY))


# -- training -----------------------------------------------------------------

def train_readings(cfg, params, batches, *, dropout_key, steps_per_epoch,
                   device, precision="float32", fault=None):
    """Runs ``len(batches)`` training steps (each a list of ``(items,
    label)`` examples) from ``params`` and returns the readings the check
    compares: each step's loss, each parameter's first gradient as Adam
    gets it (weight decay added), its raw gradient, and its change over
    the steps; and how many table rows the projection scaled down after
    the updates (``projected``).  Adam (torch's rule, betas 0.9, 0.999,
    eps 1e-8) with its two groups, StepLR on the step count and the
    max-norm projection of the table after each update
    (train.py:56-127).  ``fault`` "half" drops the second half of every
    batch (a fault the check must catch)."""
    exact_float32()
    model = MSGIFSR(cfg, precision)
    t = cfg["train"]
    data = cfg["data"]
    spec = param_spec(cfg)
    decays = {n: dec for n, _, dec in spec}
    names = [n for n, _, _ in spec]
    p0 = {n: params[n].detach().to(device, torch.float32).clone()
          for n in names}
    with torch.no_grad():
        _renorm(p0["embedding"])
    p = {n: v.clone().requires_grad_(True) for n, v in p0.items()}
    m = {n: torch.zeros_like(v) for n, v in p0.items()}
    v2 = {n: torch.zeros_like(v) for n, v in p0.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, grad, grad_raw, projected = [], {}, {}, 0
    for step, examples in enumerate(batches, 1):
        if fault == "half":
            examples = examples[:len(examples) // 2]
        lr = t["lr"] * t["lr_gamma"] ** ((step - 1) // steps_per_epoch
                                         // t["lr_step_size"])
        seeds = StepSeeds(dropout_key, step)
        sr, labels, smask = model.forward(p, examples, data["tiers"],
                                          data["max_len"], seeds, device)
        loss = model.nll(p, sr, labels, smask)
        gs = torch.autograd.grad(loss, [p[n] for n in names],
                                 allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for n, g in zip(names, gs):
                g = torch.zeros_like(p[n]) if g is None else g
                if step == 1:
                    grad_raw[n] = float(torch.linalg.vector_norm(g))
                if decays[n]:
                    g = g + t["weight_decay"] * p[n]
                if step == 1:
                    grad[n] = float(torch.linalg.vector_norm(g))
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v2[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                den = (v2[n] / (1 - b2 ** step)).sqrt() + eps
                p[n].sub_(lr / (1 - b1 ** step) * m[n] / den)
            projected += _renorm(p["embedding"])
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(p[n] - p0[n]))
                  for n in names}
    return {"losses": losses, "grad": grad, "grad_raw": grad_raw,
            "change": change, "projected": projected}


def _renorm(table, max_norm=1.0, eps=1e-7):
    """``nn.Embedding(max_norm=1)``'s renorm of every row, in place;
    returns how many rows it scaled."""
    n = torch.linalg.vector_norm(table, dim=-1, keepdim=True)
    over = n > max_norm
    table.mul_(torch.where(over, max_norm / (n + eps), 1.0))
    return int(over.sum())


# -- serving ------------------------------------------------------------------

@torch.no_grad()
def serve_log_probs(cfg, params, sessions, *, device, precision="float32"):
    """``[S, n]`` log-probabilities of the next item of each whole session
    (no dropout), sessions longer than the node cap keeping their latest
    items, all at the cap (a served batch has no tiers)."""
    exact_float32()
    model = MSGIFSR(cfg, precision)
    cap = cfg["data"]["max_len"]
    p = {n: params[n].detach().to(device, torch.float32).clone()
         for n, _, _ in param_spec(cfg)}
    _renorm(p["embedding"])
    seqs = [list(s[-cap:]) for s in sessions]
    g = build_graphs(seqs, model.K, cap, device)
    sr = model.session_vectors(p, g, None)
    smask = torch.zeros(len(seqs), model.n_items, device=device)
    for b, s in enumerate(seqs):
        smask[b, sorted(set(s))] = 1.0
    return model.log_probs(p, sr, smask)


def plain_head(cfg) -> bool:
    """The configuration's head is the plain softmax of the order-1
    logits: no REnorm, and order 1 or no fusion (msgifsr.py:316-317)."""
    m = cfg["model"]
    return not m["extra"] and (m["order"] == 1 or not m["fusion"])


@torch.no_grad()
def serve_logits(cfg, params, sessions, *, device, precision="float32"):
    """``[S, n]`` catalog logits of the plain head for each whole session
    (no dropout, the node cap as ``serve_log_probs``): the order-1 session
    vector against the table, l2-normalised where the configuration
    normalises it, with no scale.  A positive scale and the softmax keep
    each row's order, so these are what a plain head ranks by and serves."""
    exact_float32()
    model = MSGIFSR(cfg, precision)
    cap = cfg["data"]["max_len"]
    p = {n: params[n].detach().to(device, torch.float32).clone()
         for n, _, _ in param_spec(cfg)}
    _renorm(p["embedding"])
    seqs = [list(s[-cap:]) for s in sessions]
    g = build_graphs(seqs, model.K, cap, device)
    sr = model.session_vectors(p, g, None)[:, 0]
    table = l2norm(p["embedding"]) if model.norm else p["embedding"]
    return model.mm(sr, table.T)


def serve_scores(cfg, params, sessions, *, device, precision="float32"):
    """``[S, n]``: what the configuration's head serves for each whole
    session, in its own terms: the plain head's catalog logits
    (``serve_logits``), the multi-order head's log-probabilities
    (``serve_log_probs``)."""
    fn = serve_logits if plain_head(cfg) else serve_log_probs
    return fn(cfg, params, sessions, device=device, precision=precision)
