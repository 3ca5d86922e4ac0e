"""Host-side (numpy) dense graph builders.

These reproduce the graph semantics of the reference's collate module
(src/utils/data/collate.py) but emit fixed-shape dense arrays instead of
DGL graphs.  They run on the CPU in the input pipeline's prefetch thread;
``sessionrec_tpu_torch.data.loader`` wraps their arrays into the batch
containers and the consumer moves them to the device.

Copies of ``sessionrec_tpu/graph/builders.py``: the weighted session
graph of SRGNN/NISER, LESSR's ordered mailboxes and shortcut graph, and
MSGIFSR's CCS heterograph.
"""

from __future__ import annotations

import numpy as np


def _unique_nodes(seq):
    """Unique items ascending + per-position node ids.

    Matches ``np.unique`` + iid2nid in the reference (collate.py:30-32):
    node order is ascending item-id order.
    """
    items, seq_nid = np.unique(seq, return_inverse=True)
    return items, seq_nid


# ---------------------------------------------------------------------------
# SRGNN / NISER: weighted session graph (collate.py:61-85)
# ---------------------------------------------------------------------------

def build_session_batch(seqs, labels, max_nodes: int, batch_size: int):
    """Dense weighted session graphs: consecutive pairs with count weights
    (accumulated into the adjacency); a session of one item gets the
    self-loop 0 -> 0 of weight 1 (collate.py:74-76)."""
    B, N = batch_size, max_nodes
    node_iid = np.zeros((B, N), dtype=np.int32)
    node_mask = np.zeros((B, N), dtype=np.float32)
    adj = np.zeros((B, N, N), dtype=np.float32)
    last_idx = np.zeros(B, dtype=np.int32)
    labels_arr = np.zeros(B, dtype=np.int32)
    valid = np.zeros(B, dtype=np.float32)

    for b, seq in enumerate(seqs):
        items, seq_nid = _unique_nodes(seq)
        n = len(items)
        node_iid[b, :n] = items
        node_mask[b, :n] = 1.0
        if len(seq) > 1:
            np.add.at(adj[b], (seq_nid[:-1], seq_nid[1:]), 1.0)
        else:
            adj[b, 0, 0] = 1.0
        last_idx[b] = seq_nid[-1]
        labels_arr[b] = labels[b]
        valid[b] = 1.0

    return dict(node_iid=node_iid, node_mask=node_mask, adj=adj,
                last_idx=last_idx, labels=labels_arr, valid=valid)


# ---------------------------------------------------------------------------
# LESSR: EOP multigraph mailboxes + shortcut graph (collate.py:29-59)
# ---------------------------------------------------------------------------

def mailbox_depth(max_nodes: int) -> int:
    """Mailbox slots of a LESSR batch at node cap ``max_nodes``: a node's
    in-degree in the EOP multigraph is at most the session length - 1."""
    return max(max_nodes - 1, 1)


def build_lessr_batch(seqs, labels, max_nodes: int, batch_size: int):
    """The EOP multigraph as ordered mailboxes (every consecutive pair,
    duplicates too, in temporal order: ``mail_idx[b, v, j]`` is the source
    node of v's j-th in-edge, as DGL's mailbox delivers them,
    lessr.py:21-26) and the deduplicated shortcut adjacency of position
    pairs i <= j, self-loops included (collate.py:52-53)."""
    B, N = batch_size, max_nodes
    M = mailbox_depth(max_nodes)
    node_iid = np.zeros((B, N), dtype=np.int32)
    node_mask = np.zeros((B, N), dtype=np.float32)
    mail_idx = np.zeros((B, N, M), dtype=np.int32)
    mail_mask = np.zeros((B, N, M), dtype=np.float32)
    sc_adj = np.zeros((B, N, N), dtype=np.float32)
    last_idx = np.zeros(B, dtype=np.int32)
    labels_arr = np.zeros(B, dtype=np.int32)
    valid = np.zeros(B, dtype=np.float32)

    for b, seq in enumerate(seqs):
        items, seq_nid = _unique_nodes(seq)
        n = len(items)
        node_iid[b, :n] = items
        node_mask[b, :n] = 1.0
        deg = np.zeros(n, dtype=np.int64)
        for t in range(1, len(seq)):
            v, u = seq_nid[t], seq_nid[t - 1]
            mail_idx[b, v, deg[v]] = u
            mail_mask[b, v, deg[v]] = 1.0
            deg[v] += 1
        for i in range(len(seq)):
            sc_adj[b, seq_nid[i], seq_nid[i:]] = 1.0
        last_idx[b] = seq_nid[-1]
        labels_arr[b] = labels[b]
        valid[b] = 1.0

    return dict(node_iid=node_iid, node_mask=node_mask, mail_idx=mail_idx,
                mail_mask=mail_mask, sc_adj=sc_adj, last_idx=last_idx,
                labels=labels_arr, valid=valid)


# ---------------------------------------------------------------------------
# MSGIFSR: CCS heterograph (collate.py:87-217)
# ---------------------------------------------------------------------------

def _kgram_ids(seq, k):
    """Distinct consecutive k-grams in first-occurrence order.

    Returns (gram_of_pos [len-k+1], grams list-of-tuples).  Matches the
    reference's stringified-slice dedup (collate.py:99-140): gram ids are
    assigned in first-occurrence order of the k-gram *value*.
    """
    grams = {}
    gram_of_pos = np.empty(len(seq) - k + 1, dtype=np.int64)
    for j in range(len(seq) - k + 1):
        g = tuple(seq[j:j + k])
        if g not in grams:
            grams[g] = len(grams)
        gram_of_pos[j] = grams[g]
    return gram_of_pos, list(grams.keys())


def build_ccs_batch(seqs, labels, order: int, max_len: int, batch_size: int):
    """Dense multi-granularity CCS heterograph batch.

    Per level k (gram size k), nodes are distinct consecutive k-grams.
    Level 1 nodes are ``np.unique(seq)`` (ascending item order,
    collate.py:91); levels >= 2 are in first-occurrence order
    (collate.py:127-132).  Edges (all deduplicated — the reference stores
    only Counter *keys*, collate.py:150-189):

      intra_k: gram i -> gram i+1 for consecutive positions
      inter  : s1 item at pos i -> k-gram starting at i+1 (s1->sk), and
               k-gram at pos i -> s1 item at pos i+k (sk->s1)

    Effective order is clamped to len(seq) (collate.py:90); levels above
    it get one pad node with iid = smallest item repeated, no edges, and
    last_idx = 0 (collate.py:134-137, 203-207).
    """
    B, K = batch_size, order
    n1 = max_len                      # level-1 node cap
    caps = [max(max_len - k + 1, 1) for k in range(1, K + 1)]

    levels = []
    for k in range(1, K + 1):
        Nk = caps[k - 1]
        levels.append(dict(
            iid=np.zeros((B, Nk, k), dtype=np.int32),
            mask=np.zeros((B, Nk), dtype=np.float32),
            intra_adj=np.zeros((B, Nk, Nk), dtype=np.float32),
            last_idx=np.zeros(B, dtype=np.int32),
        ))
    inter_in = [np.zeros((B, n1, caps[k - 1]), dtype=np.float32)
                for k in range(2, K + 1)]
    inter_out = [np.zeros((B, caps[k - 1], n1), dtype=np.float32)
                 for k in range(2, K + 1)]
    labels_arr = np.zeros(B, dtype=np.int32)
    valid = np.zeros(B, dtype=np.float32)

    for b, seq in enumerate(seqs):
        L = len(seq)
        eff_order = min(K, L)
        items, seq_nid = _unique_nodes(seq)

        # level 1
        lv = levels[0]
        n = len(items)
        lv["iid"][b, :n, 0] = items
        lv["mask"][b, :n] = 1.0
        if L > 1:
            lv["intra_adj"][b][seq_nid[:-1], seq_nid[1:]] = 1.0
        lv["last_idx"][b] = seq_nid[-1]

        gram_of_pos_by_k = {1: seq_nid}
        for k in range(2, K + 1):
            lv = levels[k - 1]
            if k <= eff_order:
                gram_of_pos, grams = _kgram_ids(seq, k)
                gram_of_pos_by_k[k] = gram_of_pos
                m = len(grams)
                lv["iid"][b, :m, :] = np.asarray(grams, dtype=np.int32)
                lv["mask"][b, :m] = 1.0
                if L - k >= 1:
                    lv["intra_adj"][b][gram_of_pos[:-1], gram_of_pos[1:]] = 1.0
                # last kgram of the session (collate.py:134-137)
                lv["last_idx"][b] = gram_of_pos[-1]
                # inter edges exist when L - k >= 1 (ranges over len(seq)-k)
                ii = inter_in[k - 2][b]
                io = inter_out[k - 2][b]
                for i in range(L - k):
                    ii[seq_nid[i], gram_of_pos[i + 1]] = 1.0
                    io[gram_of_pos[i], seq_nid[i + k]] = 1.0
            else:
                # pad level: 1 node, iid = smallest item repeated, no edges
                lv["iid"][b, 0, :] = items[0]
                lv["mask"][b, 0] = 1.0
                lv["last_idx"][b] = 0

        labels_arr[b] = labels[b]
        valid[b] = 1.0

    return dict(levels=levels, inter_in=inter_in, inter_out=inter_out,
                labels=labels_arr, valid=valid)
