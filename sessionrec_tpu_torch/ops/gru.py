"""GRU steps with torch's weight layout and gate order.

Counterpart of ``sessionrec_tpu/ops/gru.py`` (``gru_cell``, ``gru_scan``,
``masked_mailbox_gru``).
``p`` is any object with tensors ``w_ih [3H, In]``, ``w_hh [3H, H]``,
``b_ih [3H]`` and ``b_hh [3H]``, gates stacked (reset, update, new) as in
``torch.nn.GRU`` — the layout the JAX package also keeps, so weights carry
across unchanged.
"""

from __future__ import annotations

import torch


def gru_cell(p, x, h):
    """One torch-semantics GRU step.

    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h
    """
    return _update(x @ p.w_ih.T + p.b_ih, h @ p.w_hh.T + p.b_hh, h)


def _update(gi, gh, h):
    """The next hidden state from the input and hidden gate products."""
    i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_scan(p, xs, h0=None):
    """Run a GRU over ``xs [..., T, In]``; returns the final hidden state
    ``[..., H]`` (``nn.GRU(batch_first=True)(xs)[1][0]`` for one layer).
    PyTorch runs eagerly, so the JAX package's split between unrolled
    (T <= 4) and scanned steps is one Python loop here."""
    T = xs.shape[-2]
    H = p.w_hh.shape[1]
    h = h0 if h0 is not None else xs.new_zeros(xs.shape[:-2] + (H,))
    for t in range(T):
        h = gru_cell(p, xs[..., t, :], h)
    return h


def masked_mailbox_gru(p, mail, mail_mask):
    """Ordered-mailbox GRU, LESSR's EOPA reducer (lessr.py:20-27).

    ``mail [..., M, In]`` holds each node's in-messages in temporal order,
    left-aligned, ``mail_mask [..., M]`` marks the real ones.  A row
    advances its hidden state only on real slots, so its final state is a
    torch GRU's over exactly its messages; a row with none returns 0 (DGL
    leaves an unmessaged node at zero).  The input gates of all ``M``
    slots are one product; the recurrence runs slot by slot."""
    M = mail.shape[-2]
    H = p.w_hh.shape[1]
    gi = mail @ p.w_ih.T + p.b_ih                       # [..., M, 3H]
    keep = mail_mask.to(torch.bool)[..., None]          # [..., M, 1]
    h = mail.new_zeros(mail.shape[:-2] + (H,))
    for t in range(M):
        h_new = _update(gi[..., t, :], h @ p.w_hh.T + p.b_hh, h)
        h = torch.where(keep[..., t, :], h_new, h)
    return h
