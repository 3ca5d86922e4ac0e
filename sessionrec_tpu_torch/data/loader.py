"""Host input pipeline: ordered/shuffled batching + background prefetch.

Counterpart of ``sessionrec_tpu/data/loader.py``, which replaces the
reference's torch DataLoader with multiprocess workers
(src/scripts/main_msgifsr.py:148-166).  Graph building runs on the host in
a background thread that produces numpy arrays only; the consuming thread
moves each batch to the device (pinned host memory, non-blocking copy),
so the prefetch thread never touches CUDA.  Train order is *sequential*
by default to reproduce the reference's ordered-training semantics
(README.md:37).  With tracing on (``utils/profiling.py``) each build is a
``loader.build`` span (in the prefetch thread) and each wait for a built
batch a ``loader.wait`` span, counted in ``loader.queue_empty`` where the
queue was empty.

The batch kinds are the JAX package's: 'session' (SRGNN, NISER),
'lessr' and 'ccs' (MSGIFSR).  Batches come from the C++ builders
(``data/native_collate.py``) by default, as in the JAX package;
``use_native=False`` runs the pure-Python builders.  A native
builder that does not build or load raises: nothing falls back to
Python.

On a (data, model) mesh a rank takes its data position's rows of each
global batch in one of two ways: ``data_block`` builds the global batch,
tiers included, and keeps block ``d`` of every tier's rows (the layout
GSPMD gives a batch in the JAX package; each rank pays the whole build);
``batch_slice`` builds only the rank's rows of the global stream, as the
JAX package's multi-host loader does, and takes no tiers.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from sessionrec_tpu_torch.data import native_collate
from sessionrec_tpu_torch.data.augment import AugmentedIndex
from sessionrec_tpu_torch.graph import batch as B
from sessionrec_tpu_torch.graph import builders
from sessionrec_tpu_torch.utils import profiling


def _make_batch(kind, seqs, labels, max_len, batch_size, order,
                use_native=True):
    bl = native_collate if use_native else builders
    if kind == "session":
        return B.SessionGraphBatch(
            **bl.build_session_batch(seqs, labels, max_len, batch_size))
    if kind == "lessr":
        return B.LessrBatch(
            **bl.build_lessr_batch(seqs, labels, max_len, batch_size))
    if kind == "ccs":
        d = bl.build_ccs_batch(seqs, labels, order, max_len, batch_size)
        levels = tuple(B.CcsLevel(**lv) for lv in d["levels"])
        return B.CcsBatch(levels=levels, inter_in=tuple(d["inter_in"]),
                          inter_out=tuple(d["inter_out"]),
                          labels=d["labels"], valid=d["valid"])
    raise ValueError(f"unknown batch kind {kind!r}")


class BatchLoader:
    """Iterable over fixed-shape graph batches.

    Args:
      sessions: list of item-id sequences.
      kind: 'session' (SRGNN, NISER), 'lessr' or 'ccs' (MSGIFSR).
      batch_size: static batch size; the final partial batch is padded
        with ``valid=0`` rows.
      max_len: static per-session node cap.
      shuffle: shuffle example order each epoch, else the time-ordered
        stream.
      order: CCS order (MSGIFSR only).
      seed: shuffle seed.
      prefetch: number of batches built ahead in a background thread.
      split_len: length-bucketed batches — an int or an ascending list of
        ints; each threshold adds a tier built at its own smaller node cap
        and each batch is a (nested) ``SplitBatch`` holding the same
        example set as the unsplit batch.  Tier row caps are exact maxima
        over the deterministic epoch orders (``_split_caps``).
      device: where yielded batches live; None keeps numpy arrays.
      use_native: build batches with the C++ builder
        (``data/native_collate.py``; built here, at construction, so a
        missing compiler raises at once), else the pure-Python one.
      data_block: ``(d, dp)`` — yield data position ``d``'s block of each
        global batch's rows, per tier (``graph.batch`` ``data_block``);
        the batch size and the tier caps must divide over ``dp``.
      batch_slice: ``(start, stop)`` rows of each global batch that this
        process builds (``parallel/multihost.py:local_batch_slice``); the
        epoch order stays the global stream.  Raises with ``split_len``.
    """

    def __init__(self, sessions, kind, batch_size, max_len, shuffle=False,
                 order=1, seed=0, prefetch=2, drop_last=False,
                 split_len=None, device=None, use_native=True,
                 data_block=None, batch_slice=None):
        self.index = AugmentedIndex(sessions)
        self.kind = kind
        self.batch_size = batch_size
        self.max_len = max_len
        self.shuffle = shuffle
        self.order = order
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.device = device
        self.use_native = use_native
        self.data_block = data_block
        self.batch_slice = batch_slice
        if use_native:
            native_collate.library()
        self.split = None
        if split_len is not None:
            ts = (split_len,) if np.isscalar(split_len) else tuple(split_len)
            thresholds = tuple(sorted({int(t) for t in ts
                                       if 0 < int(t) < max_len}))
            if thresholds:
                if batch_slice is not None:
                    raise ValueError(
                        "split_len tiers cannot take a batch_slice: each "
                        "process's tier caps would disagree with the "
                        "global batch's layout")
                self.split = (thresholds, self._split_caps(thresholds))

    # Epochs whose shuffle orders are scanned when sizing the split
    # sub-blocks (orders are a pure function of (seed, epoch), so the caps
    # are exact for runs of up to this many epochs; ordered streams reuse
    # one order).
    _SPLIT_CAP_EPOCHS = 64

    def _split_caps(self, thresholds):
        """Static per-tier row caps (one per threshold + the final
        ``max_len`` tier): exact per-batch maxima of each tier's row count
        over the epoch orders this loader will produce, rounded up to a
        multiple of 32 (or 8) of the batch size."""
        lens = np.minimum(self.index.index[:, 1], self.max_len) \
            if len(self.index) else np.empty(0, np.int64)
        B = self.batch_size
        n = len(lens)
        nb = (n + B - 1) // B
        bounds = list(thresholds) + [self.max_len]
        lows = [0] + list(thresholds)
        maxes = [0] * len(bounds)
        for epoch in range(self._SPLIT_CAP_EPOCHS if self.shuffle else 1):
            order = np.arange(n)
            if self.shuffle:
                np.random.default_rng((self.seed, epoch)).shuffle(order)
            lp = np.full(nb * B, -1, dtype=np.int64)
            lp[:n] = lens[order]
            lp = lp.reshape(nb, B)
            if not nb:
                continue
            for gi, (lo, hi) in enumerate(zip(lows, bounds)):
                ng = ((lp > lo) & (lp <= hi)).sum(axis=1) if gi \
                    else ((lp >= 0) & (lp <= hi)).sum(axis=1)
                maxes[gi] = max(maxes[gi], int(ng.max()))
        # round up so that every tier's rows divide over a mesh's data
        # axis (any dp that divides the multiple; ``data_block``)
        mult = 32 if B % 32 == 0 else (8 if B % 8 == 0 else 1)

        def cap(x):
            return max(min(-(-x // mult) * mult, B), mult)
        return tuple(cap(x) for x in maxes)

    def set_epoch(self, epoch: int):
        """Pin the shuffle stream to an epoch."""
        self.epoch = int(epoch)

    def __len__(self):
        n = len(self.index)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def num_examples(self):
        return len(self.index)

    def _epoch_order(self):
        order = np.arange(len(self.index))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        self.epoch += 1
        return order

    def _build(self, ids):
        batch = self._build_rows(ids)
        if self.data_block is not None:
            batch = batch.data_block(*self.data_block)
        return batch

    def _build_rows(self, ids):
        size = self.batch_size
        if self.batch_slice is not None:
            start, stop = self.batch_slice
            ids, size = ids[start:stop], stop - start
        seqs, labels = [], []
        for i in ids:
            s, l = self.index.example(i)
            # prefixes longer than the node cap keep their most recent items
            if len(s) > self.max_len:
                s = s[-self.max_len:]
            seqs.append(s)
            labels.append(l)
        if self.split is not None:
            return self._build_split(seqs, labels)
        return _make_batch(self.kind, seqs, labels, self.max_len, size,
                           self.order, self.use_native)

    def _build_split(self, seqs, labels):
        """Partition one batch's examples by prefix length into the
        statically-capped tiers (nested SplitBatch, shortest tier
        first)."""
        thresholds, caps = self.split
        bounds = list(thresholds) + [self.max_len]
        groups = [([], []) for _ in bounds]
        for s, l in zip(seqs, labels):
            for gi, hi in enumerate(bounds):
                if len(s) <= hi:
                    groups[gi][0].append(s)
                    groups[gi][1].append(l)
                    break
        for (gs, _), cap, hi in zip(groups, caps, bounds):
            if len(gs) > cap:
                raise RuntimeError(
                    f"split tier overflow: batch has {len(gs)} rows of "
                    f"length <= {hi} vs cap {cap} — a shuffled run "
                    f"exceeded the {self._SPLIT_CAP_EPOCHS} epochs the "
                    f"caps were sized for")
        return B.nest_blocks([
            _make_batch(self.kind, gs, gl, hi, cap, self.order,
                        self.use_native)
            for (gs, gl), cap, hi in zip(groups, caps, bounds)])

    def _host_batches(self):
        order = self._epoch_order()
        nb = len(self)
        bs = self.batch_size
        if self.prefetch <= 0:
            for k in range(nb):
                with profiling.span("loader.build"):
                    batch = self._build(order[k * bs:(k + 1) * bs])
                yield batch
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item):
            # bounded wait, so a consumer that stopped early releases us
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for k in range(nb):
                    with profiling.span("loader.build"):
                        batch = self._build(order[k * bs:(k + 1) * bs])
                    if not put(batch):
                        return
                put(None)
            except Exception as e:  # surface builder errors to the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                if profiling.enabled() and q.empty():
                    profiling.count("loader.queue_empty")
                with profiling.span("loader.wait"):
                    item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10.0)

    def __iter__(self):
        for b in self._host_batches():
            yield b if self.device is None else b.to(self.device)
