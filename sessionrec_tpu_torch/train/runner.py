"""TrainRunner — the training loop (reference src/utils/train.py:56-127).

Counterpart of ``sessionrec_tpu/train/runner.py``, whose default loop
runs ``unroll`` optimizer steps per dispatch (``make_unrolled_train_step``,
a ``lax.scan`` over a stacked chunk of batches).  Here the loop takes the
loader's host batches in chunks of ``unroll``:

* on CUDA, the first chunk runs as plain eager steps (real steps, which
  create Adam's state before any capture); after it, a full chunk is
  copied into ``unroll`` static device batch slots and replays one CUDA
  graph that captured ``unroll`` consecutive steps, and a shorter chunk
  (an epoch's tail) replays a one-step graph once per real batch, so
  weight decay and the schedule see exactly the real steps, as the JAX
  package's ``lax.cond`` skip does.  Both graphs are captured at first
  use and share one memory pool.  A capture or replay error raises; the
  loop never drops back to eager steps.
* on the CPU, each batch runs the plain per-step ``train_step``, which is
  also the reference the graph is held against.

Every step is forward, backward, Adam, the schedule and the max-norm
projection, with no host synchronisation (dropout seeds, the learning
rate and Adam's step counts live on the device).  Metrics and early
stopping follow the reference: one evaluation before any training
(train.py:91), early stop only when *both* MRR and HR worsened against
the running maxima (train.py:118-123), and the running maximum of each
metric returned (train.py:124-127).  Eval runs per batch.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import torch

from sessionrec_tpu_torch.models.layers import SeedSource, l2norm
from sessionrec_tpu_torch.ops import scoring, xent, xent_multi
from sessionrec_tpu_torch.train.optim import make_optimizer
from sessionrec_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def set_precision():
    """float32 products mean float32 on the card, as on the TPU reference:
    no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(name: str) -> torch.device:
    """The trainer's device; a CUDA device that is missing raises (the CPU
    must be asked for explicitly)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; pass "
            "--device cpu to train on the CPU")
    return device


def make_loss(model, batch, seeds):
    """Training loss of one batch (runner.py:55-111 of the JAX package,
    one device): the fused catalog cross-entropy of the plain head
    (ops/xent.py, K1/K2), else the fused multi-order REnorm/fusion loss
    of the multi head (ops/xent_multi.py, K3/K4); the table l2norm folds
    into either.  ``seeds`` (a ``SeedSource``) drives dropout; None
    disables it."""
    kw = dict(scale=model.scale, num_items=model.num_items,
              normalize_table=model.table_norm)
    if model.has_plain_head:
        sr, table = model.head(batch, training=True, seeds=seeds)
        return xent.fused_nll_loss(sr, table, batch.labels, batch.valid, **kw)
    sr, table, phi, alpha, iids = model.head_multi(batch, training=True,
                                                   seeds=seeds)
    return xent_multi.multi_nll_loss(sr, table, batch.labels, batch.valid,
                                     iids, phi, alpha, extra=model.extra,
                                     fusion=model.fusion, **kw)


# Eval materialises the [B, P] float32 scores plus about as many bytes of
# comparison temporaries in label_ranks_by_count.  2^31 elements (8 GiB of
# scores, ~16 GiB with temporaries) leaves most of an 80 GB H100 to the
# table, its Adam moments and the activations even at a 2^20-item
# catalog.  Above it eval has to stream the catalog, which is not ported.
_STREAM_EVAL_ELEMS = 2 ** 31


def _auto_stream(batch_size: int, padded_items: int,
                 score_rows: int = 1) -> bool:
    """``score_rows`` is the score tensor's rows per example: K for the
    multi head's ``[B, K, P]`` scores."""
    return batch_size * score_rows * padded_items >= _STREAM_EVAL_ELEMS


@torch.no_grad()
def eval_ranks(model, batch, cutoff):
    """Label ranks for one eval batch on materialised scores
    (runner.py:407-430 of the JAX package).  The plain head ranks the raw
    masked logits: positive scaling and log_softmax preserve each row's
    order and ties.  The multi head ranks ``model.apply``'s
    log-probabilities.  Padded catalog columns score below every item."""
    B = batch.labels.shape[0]
    rows = 1 if model.has_plain_head else model.order
    if _auto_stream(B, model.padded_items, rows):
        raise NotImplementedError(
            f"eval of {B} x {rows} x {model.padded_items} scores exceeds "
            f"{_STREAM_EVAL_ELEMS} elements and needs streamed eval, which "
            "is not ported yet (ROADMAP.md, queue 1 item 9)")
    if model.has_plain_head:
        sr, table = model.head(batch, training=False)
        if model.table_norm:
            table = l2norm(table)
        logits = scoring.catalog_logits(sr, table)
        imask = scoring.item_mask(model.num_items, model.padded_items,
                                  logits.device)
        scores = torch.where(imask, logits, -math.inf)
    else:
        scores = model.apply(batch, training=False)
    return scoring.label_ranks_by_count(scores, batch.labels, cutoff)


@torch.no_grad()
def evaluate(model, loader, cutoff=20):
    """(MRR@cutoff, HR@cutoff) over a loader (reference train.py:36-55)."""
    hit = mrr = n = 0.0
    for batch in loader:
        ranks = eval_ranks(model, batch, cutoff)
        v = batch.valid
        hit = hit + torch.sum((ranks > 0) * v)
        mrr = mrr + torch.sum(
            torch.where(ranks > 0, 1.0 / torch.clamp(ranks, min=1), 0.0) * v)
        n = n + torch.sum(v)
    n = max(float(n), 1.0)
    return float(mrr) / n, float(hit) / n


def launch_counts():
    """The K1-K4 wrappers' launch counters, by kernel."""
    return {"xent_fwd": xent.fwd_launches, "xent_bwd": xent.bwd_launches,
            "xent_multi_fwd": xent_multi.fwd_launches,
            "xent_multi_bwd": xent_multi.bwd_launches}


def chunks(iterable, size: int):
    """Lists of ``size`` consecutive items, the last one shorter."""
    buf = []
    for item in iterable:
        buf.append(item)
        if len(buf) == size:
            yield buf
            buf = []
    if buf:
        yield buf


@dataclass
class StepGraph:
    """A captured run of ``steps`` optimizer steps over batch slots
    ``0 .. steps - 1``: its graph, its static ``[steps]`` losses, the
    kernel launches it recorded (the wrappers' counters during the
    capture, which runs nothing) and how often it replayed."""

    graph: object
    losses: torch.Tensor
    captured: dict
    replays: int = 0


class TrainRunner:
    """Training loop on one device.

    Invariant (as in the JAX package): parameters enter every step
    max-norm-projected, gradients are taken at the projected table, and
    ``project_params`` runs right after each update.
    """

    def __init__(self, model, train_loader, test_loader, *, lr=1e-3,
                 weight_decay=1e-4, patience=3, seed=123, cutoff=20,
                 lr_step_size=3, lr_gamma=0.1, eval_before_train=True,
                 unroll=8, device="cuda"):
        set_precision()
        self.device = resolve_device(str(device))
        self.model = model
        self.train_loader = train_loader
        self.test_loader = test_loader
        self.patience = patience
        self.cutoff = cutoff
        self.eval_before_train = eval_before_train
        self.unroll = max(int(unroll), 1)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        model.to(self.device)
        self.seeds = SeedSource(seed + 1, self.device)
        # establish the step invariant; identity for fresh inits
        model.project_params()
        self.params = list(model.parameters())
        # every parameter holds its gradient from the start, zeroed in
        # place before each backward: the parameters the loss does not
        # reach (the 'inter' GATs at order 1, sc_sr[k > 0], beta) still
        # take the weight-decay step, as in the JAX package, whose
        # gradient of them is zero rather than absent; and a captured
        # graph finds every gradient where it left it
        for p in self.params:
            p.grad = torch.zeros_like(p)
        self.opt, self.sched = make_optimizer(
            model, lr, weight_decay, steps_per_epoch=len(train_loader),
            lr_step_size=lr_step_size, lr_gamma=lr_gamma)
        self.graphs = {}          # steps -> StepGraph, captured at first use
        self._slots = []          # static device batches the graphs read
        self._pool = None         # the graphs' shared memory pool
        self.epoch = 0
        self.steps = 0
        self.max_mrr = 0.0
        self.max_hit = 0.0
        self.bad_counter = 0
        self.losses = []          # every step's loss, drained to the host
        self.train_seconds = 0.0  # of the last epoch, host clock
        self.train_examples = 0   # of the last epoch

    @property
    def uses_graph(self):
        """True where ``run_chunk`` replays CUDA graphs (on CUDA)."""
        return self.device.type == "cuda"

    def _step(self, batch):
        """fwd -> bwd -> Adam -> schedule -> project on a device batch;
        the loss, on the device.  Nothing here reads the device from the
        host, so it captures into a CUDA graph as it stands."""
        self.model.train()
        self.seeds.begin_step()
        loss = make_loss(self.model, batch, self.seeds)
        self.opt.zero_grad(set_to_none=False)
        loss.backward()
        self.opt.step()
        self.sched.step()
        self.model.project_params()
        return loss.detach()

    def train_step(self, batch):
        """One plain eager step on ``batch`` (on the device); returns the
        loss (on the device)."""
        loss = self._step(batch)
        self.steps += 1
        return loss

    def state_tensors(self):
        """Every tensor a step reads and writes besides the batch and the
        gradients: parameters (detached, so cloning them keeps no
        autograd node alive), Adam's moments and step counts, the
        schedule's counter and rate, the dropout counter.  Copying values
        into them in place leaves the captured graphs valid."""
        out = [p.detach() for p in self.params]
        for p in self.params:
            st = self.opt.state.get(p, {})
            out += [st[k] for k in ("step", "exp_avg", "exp_avg_sq")
                    if k in st]
        return out + [self.sched.count, self.sched.lr, self.seeds.count]

    def _stage(self, i, batch):
        """Copy ``batch`` into static device slot ``i`` (made from it at
        first use); returns the slot."""
        if i == len(self._slots):
            self._slots.append(batch.to(self.device))
        else:
            self._slots[i].copy_(batch)
        return self._slots[i]

    def _graph(self, steps):
        """The ``steps``-step graph over slots ``0 .. steps - 1``,
        captured at first use into the shared pool."""
        g = self.graphs.get(steps)
        if g is None:
            graph = torch.cuda.CUDAGraph()
            before = launch_counts()
            with torch.cuda.graph(graph, pool=self._pool):
                losses = torch.stack([self._step(self._slots[i])
                                      for i in range(steps)])
            after = launch_counts()
            self._pool = graph.pool()
            g = self.graphs[steps] = StepGraph(
                graph, losses, {k: after[k] - before[k] for k in after})
        return g

    def _replay(self, g):
        g.graph.replay()
        g.replays += 1
        return g.losses.clone()

    def run_chunk(self, chunk):
        """Train on ``chunk``, at most ``unroll`` batches of the loader
        (host arrays or tensors); returns their losses, one device
        tensor."""
        if not self.uses_graph:
            return torch.stack([self.train_step(b.to(self.device))
                                for b in chunk])
        if not self._slots:
            return self._warm_up(chunk)
        if len(chunk) == self.unroll:
            for i, b in enumerate(chunk):
                self._stage(i, b)
            out = self._replay(self._graph(self.unroll))
        else:
            out = []
            for b in chunk:
                self._stage(0, b)
                out.append(self._replay(self._graph(1)))
            out = torch.cat(out)
        self.steps += len(chunk)
        return out

    def _warm_up(self, chunk):
        """The first chunk's real steps, eager, on a side stream (as
        ``torch.cuda.graphs`` asks of the work before a capture)."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = torch.stack([self.train_step(self._stage(i, b))
                               for i, b in enumerate(chunk)])
        main.wait_stream(side)
        return out

    def evaluate(self):
        self.model.eval()
        self.model.project_params()
        return evaluate(self.model, self.test_loader, self.cutoff)

    def _drain_losses(self, pending):
        """Pull pending losses to the host -> mean; abort on non-finite
        (the reference asserts no NaN on every batch, train.py:98)."""
        vals = torch.cat([p.reshape(-1) for p in pending]).tolist() \
            if pending else []
        self.losses.extend(vals)
        total = math.fsum(vals)
        if not math.isfinite(total):
            raise FloatingPointError(
                f"non-finite training loss at step {self.steps} "
                f"(epoch {self.epoch}) — aborting (parity with the "
                "reference's per-batch NaN assert, train.py:98)")
        return total / max(len(vals), 1)

    def train(self, epochs, log_interval=100):
        if self.eval_before_train:
            mrr, hit = self.evaluate()
            log.info("initial eval: MRR = %.3f%%, Hit = %.3f%%",
                     mrr * 100, hit * 100)

        while self.epoch < epochs:
            epoch_t = t = time.perf_counter()
            pending = []
            examples = interval_examples = 0.0
            if hasattr(self.train_loader, "set_epoch"):
                self.train_loader.set_epoch(self.epoch)
            since_log = 0
            for chunk in chunks(self.train_loader, self.unroll):
                pending.append(self.run_chunk(chunk))
                examples += sum(float(b.valid.sum()) for b in chunk)
                since_log += len(chunk)
                if since_log >= log_interval:
                    mean_loss = self._drain_losses(pending)
                    pending, since_log = [], 0
                    dt = time.perf_counter() - t
                    log.info("step %d: loss = %.4f, %.1f examples/s, %.2fs",
                             self.steps, mean_loss,
                             (examples - interval_examples) / max(dt, 1e-9),
                             dt)
                    interval_examples = examples
                    t = time.perf_counter()
            self._drain_losses(pending)
            self.train_examples = int(examples)
            self.train_seconds = time.perf_counter() - epoch_t

            mrr, hit = self.evaluate()
            log.info("epoch %d: MRR = %.3f%%, Hit = %.3f%% "
                     "(%.1f train examples/s)", self.epoch, mrr * 100,
                     hit * 100,
                     self.train_examples / max(self.train_seconds, 1e-9))

            # early stop only when BOTH metrics worsened (train.py:118-123)
            stop = False
            if mrr < self.max_mrr and hit < self.max_hit:
                self.bad_counter += 1
                stop = self.bad_counter == self.patience
            else:
                self.bad_counter = 0
            self.max_mrr = max(self.max_mrr, mrr)
            self.max_hit = max(self.max_hit, hit)
            self.epoch += 1
            if stop:
                break
        return self.max_mrr, self.max_hit
