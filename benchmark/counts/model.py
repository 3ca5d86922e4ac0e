"""Model FLOPs of an MSGIFSR training step, counted from the examples,
and the head its configuration's keys state.  The harness finds it by the
family's name (``counts/flops/msgifsr.py``).

The products of the forward (2 FLOPs a multiply-add) over each example's
own graph, its real nodes and no padding, and the catalog loss over the
valid examples; the backward of a product costs twice its forward, so a
step is three times the forward.  Elementwise work (activations,
softmaxes, dropout, the optimizer) is left out.  The count is fixed by
the inputs, whatever kernels or layout the program uses.

Per example with ``n_k`` distinct k-grams at level ``k`` (``N`` in all),
width ``d``, 8 heads of width ``d``:

* expander, level k >= 2: a GRU over the k members of each node,
  ``k * 12 d^2`` a node (input and hidden products, 3 gates);
* a GATConv from ``n_s`` source to ``n_d`` destination nodes: ``fc``
  ``2 (n_s + n_d) d 8d`` (``2 n d 8d`` within a level, where DGL's
  GATConv projects the one node set once), the attention logits
  ``2 (n_s + n_d) 8d``, the aggregation ``2 n_s n_d 8d``; two convs
  (the graph and its reverse) for each relation of each level, per
  layer: level 1 with itself and with each level k >= 2, level k >= 2
  with itself and with level 1;
* readout, per order: ``fc_u`` on every node ``2 N d^2``, ``fc_v``
  ``2 d^2``, ``fc_e`` and the pooling ``4 N d``; ``fc_sr`` ``4 d^2``;
  REnorm's gate ``2 d^2 + 4 d``;
* the catalog logits, ``2 K n_items d`` (``2 n_items d`` for the plain
  head, which scores order 1 only); per step the table's norms,
  ``2 n_items d``.
"""

from __future__ import annotations

HEADS = 8


def plain_head(model) -> bool:
    """The loss is plain softmax cross-entropy of the order-1 logits (no
    REnorm, and order 1 or no fusion; msgifsr.py:316-317)."""
    return not model["extra"] and (model["order"] == 1
                                   or not model["fusion"])


def head(cfg):
    """The head that MSGIFSR's keys state, in ``harness/program.py``'s
    terms (``head``)."""
    m = cfg["model"]
    plain = plain_head(m)
    return {"plain": plain, "table_norm": bool(m["norm"]),
            "orders": 1 if plain else m["order"]}


def level_sizes(seq, order):
    """``[n_1, .., n_K]``: distinct items, then distinct k-grams (one pad
    node where the session is shorter than k)."""
    out = [len(set(seq))]
    for k in range(2, order + 1):
        out.append(len({tuple(seq[j:j + k])
                        for j in range(len(seq) - k + 1)}) or 1)
    return out


def gat_flops(n_src, n_dst, d, same=False):
    """One GATConv; ``same``: source and destination are one node set."""
    hd = HEADS * d
    fc = 2 * n_src * d * hd if same else 2 * (n_src + n_dst) * d * hd
    return fc + 2 * (n_src + n_dst) * hd + 2 * n_src * n_dst * hd


def example_forward_flops(seq, model):
    d, K = model["embedding_dim"], model["order"]
    n = level_sizes(seq, K)
    f = sum(k * 12 * d * d * n[k - 1] for k in range(2, K + 1))
    per_layer = 0
    for level in range(1, K + 1):
        nl = n[level - 1]
        per_layer += 2 * gat_flops(nl, nl, d, same=True)
        if level == 1:
            per_layer += sum(2 * gat_flops(n[k - 1], n[0], d)
                             for k in range(2, K + 1))
        else:
            per_layer += 2 * gat_flops(n[0], nl, d)
    f += model["num_layers"] * per_layer
    total = sum(n)
    f += K * (2 * total * d * d + 2 * d * d + 4 * total * d + 4 * d * d)
    if model["extra"]:
        f += K * (2 * d * d + 4 * d)
    return f


def step_flops(cfg, seqs):
    """Model FLOPs of one training step over the valid examples whose
    item sequences are ``seqs``."""
    m = cfg["model"]
    n_items, d, K = cfg["catalog"]["num_items"], m["embedding_dim"], \
        m["order"]
    rows = 1 if plain_head(m) else K
    fwd = sum(example_forward_flops(s, m) for s in seqs)
    fwd += len(seqs) * 2 * rows * n_items * d + 2 * n_items * d
    return 3 * fwd
