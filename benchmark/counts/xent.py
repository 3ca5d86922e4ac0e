"""Operations and bytes of the fused catalog losses, K1-K4, and their
least time on the card.

``rows`` session rows (the valid examples of a step) of width ``dim``
against ``n_items`` catalog rows; the multi-order loss takes ``order``
rows a session and each row's ``ns`` session item ids.  Each input byte
is counted read once and each output byte written once; the operations
are the products' multiply-adds (2 each) and the table's l2 norms.  A
row's scalars (label, log-sum-exps, the loss and its cotangent) are 4
bytes each.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())

# every K1-K4 kernel of the port is named ``xent_*``
_KERNEL = re.compile(r"(^|[^A-Za-z0-9_])xent_")


def is_kernel(name: str) -> bool:
    """True for a device trace name of a K1-K4 kernel."""
    return bool(_KERNEL.search(name))


def k1(rows, n_items, dim, esz=4, norm=True):
    """Forward of the plain head's loss: ``(operations, bytes)``."""
    ops = 2 * rows * n_items * dim + (2 * n_items * dim if norm else 0)
    nbytes = (rows * dim + n_items * dim) * esz + rows * 4 + 2 * rows * 4
    return ops, nbytes


def k2(rows, n_items, dim, esz=4, norm=True):
    """Backward: the logits again, d_sr and d_table (written whole)."""
    ops = 3 * 2 * rows * n_items * dim + (2 * n_items * dim if norm else 0)
    nbytes = ((rows * dim + 2 * n_items * dim) * esz + 3 * rows * 4
              + rows * dim * 4)
    return ops, nbytes


def k3(rows, order, n_items, dim, ns, esz=4):
    """Forward of the multi-order REnorm/fusion loss over ``order * rows``
    rows (normalised table)."""
    small = rows * 4 + rows * ns * 4
    ops = 2 * order * rows * n_items * dim + 2 * n_items * dim
    nbytes = (order * rows * dim + n_items * dim) * esz + small \
        + 5 * order * rows * 4
    return ops, nbytes


def k4(rows, order, n_items, dim, ns, esz=4):
    """Backward of the multi-order loss."""
    small = rows * 4 + rows * ns * 4
    ops = 3 * 2 * order * rows * n_items * dim + 2 * n_items * dim
    nbytes = ((order * rows * dim + 2 * n_items * dim) * esz + small
              + 5 * order * rows * 4 + order * rows * dim * 4)
    return ops, nbytes


def least_seconds(ops, nbytes, dtype="float32", peaks=PEAKS):
    """The larger of bytes over the memory rate and operations over the
    ``dtype`` peak."""
    return max(nbytes / peaks["hbm_bytes_per_s"],
               ops / peaks["flops_per_s"][dtype])


def step_loss_seconds(cfg, rows):
    """Least time of one training step's fused loss, forward and
    backward, at ``rows`` valid examples: K1 + K2 for the plain head, K3 +
    K4 for the multi-order head."""
    m = cfg["model"]
    n, d, dtype = cfg["catalog"]["num_items"], m["embedding_dim"], \
        cfg["dtype"]
    if plain_head(m):
        parts = (k1(rows, n, d, norm=m["norm"]), k2(rows, n, d,
                                                    norm=m["norm"]))
    else:
        ns = cfg["data"]["max_len"]
        parts = (k3(rows, m["order"], n, d, ns), k4(rows, m["order"], n, d,
                                                    ns))
    return sum(least_seconds(o, b, dtype) for o, b in parts)


def plain_head(model) -> bool:
    """The loss is plain softmax cross-entropy of the order-1 logits (no
    REnorm, and order 1 or no fusion; msgifsr.py:316-317)."""
    return not model["extra"] and (model["order"] == 1
                                   or not model["fusion"])
