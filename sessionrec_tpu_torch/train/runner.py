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
  loop never drops back to eager steps.  With tracing on
  (``utils/profiling.py``) each staged batch is a ``runner.stage`` span,
  each launch a ``runner.replay`` span, and a graph captured then keeps
  the map of which span (``loss``, ``step.optimizer``, the model's
  spans) owns each of its device nodes (``StepGraph.owners``).
* on the CPU, each batch runs the plain per-step ``train_step``, which is
  also the reference the graph is held against.

Every step is forward, backward, Adam, the schedule and the max-norm
projection, with no host synchronisation (dropout seeds, the learning
rate and Adam's step counts live on the device).  A bfloat16 table
(``table_dtype``) takes the bf16 branch of the JAX package's
``_apply_updates_project`` (runner.py:195-231): its float32 update
(``optim.TableAdam``) is added to the table in float32, the max-norm
projection runs on that float32 sum, and the sum is rounded back to bf16
stochastically (``ops/sround.py``) with a seed drawn on the device from
the step's ``SeedSource``.  A graph replay therefore rounds anew, an
eager step from the same counter rounds as the graph does, and a resume
replays the rounding.  The JAX package folds its seed out of the step's
PRNG key instead, so the two streams differ.  Metrics and early
stopping follow the reference: one evaluation before any training
(train.py:91), early stop only when *both* MRR and HR worsened against
the running maxima (train.py:118-123), and the running maximum of each
metric returned (train.py:124-127).

Eval is the counterpart of ``make_unrolled_eval_step`` and ``evaluate``
(runner.py:449-516 of the JAX package): a sweep adds each batch's
``(hits, reciprocal-rank sum, valid rows)`` into one float64 device
vector and reads the host once.  On CUDA the test batches go into their
own static slots in chunks of ``unroll``: the first chunk ever runs
eagerly, a full chunk replays one captured ``unroll``-batch eval graph,
and a shorter tail replays a one-batch graph per batch, as the training
tail does.  The eval graphs have a memory pool of their own, apart from
the training graphs'.  On the CPU eval runs per batch.  A batch whose
``[B, (K,) P]`` scores reach 2^30 elements ranks by streaming the catalog
in slabs (``ops/streamed_eval.py``, ``_auto_stream``), inside the same
eval graphs.

With a ``mesh`` (``parallel/mesh.py``; the mesh branches of
runner.py:29-232 and :549-597 of the JAX package) the runner is one rank
of a (data, model) mesh: its model holds its table shard
(``parallel/sharded.py:bind_mesh``), its loaders yield its data
position's rows, the loss and eval run K1-K4 and the rankers on the
shard, the replicated parameters' gradients are summed over the data
group and the table steps with ``optim.ShardedTableAdam`` (the ZeRO
layout).  Mesh steps and evals run eagerly, as the CPU's do: a CUDA graph
that holds collectives needs NCCL's graph capture, which is not part of
this port.

With a ``Checkpointer`` the runner saves after every
``checkpoint_every``-th epoch and at an early stop (runner.py:701-704);
with a metrics sink it logs ``train`` events at log intervals and an
``eval`` event per epoch (runner.py:668-689).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import torch

from sessionrec_tpu_torch.models.layers import SeedSource, l2norm
from sessionrec_tpu_torch.ops import scoring, streamed_eval, xent, xent_multi
from sessionrec_tpu_torch.ops.sround import stochastic_round_bf16
from sessionrec_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce
from sessionrec_tpu_torch.parallel.multihost import place_chunk
from sessionrec_tpu_torch.parallel.sharded import (bind_mesh,
                                                   sharded_eval_ranks,
                                                   sharded_loss,
                                                   sum_data_grads)
from sessionrec_tpu_torch.train.optim import make_optimizer
from sessionrec_tpu_torch.utils import profiling
from sessionrec_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def set_precision():
    """float32 products mean float32 on the card, as on the TPU reference:
    no TF32 in matmuls or convolutions; and bfloat16 products accumulate
    in float32 in cuBLAS, as JAX's ``preferred_element_type=float32``
    (no reduced-precision reduction)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


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
    disables it.  A model that computes in its table's type gives the
    loss ``sr`` in that type too, and the kernels run in it (their bf16
    branch for a bf16 table and bf16 compute); anything else raises.  A
    model on a mesh (``model.shard``) takes the sharded losses
    (``parallel/sharded.py:sharded_loss``)."""
    if model.shard is not None:
        return sharded_loss(model, batch, seeds)
    kw = dict(scale=model.scale, num_items=model.num_items,
              normalize_table=model.table_norm)
    if model.has_plain_head:
        sr, table = model.head(batch, training=True, seeds=seeds)
        _check_loss_dtype(model, sr, table)
        with profiling.span("loss") as s:
            s.inputs(sr)
            return s.outputs(xent.fused_nll_loss(
                sr, table, batch.labels, batch.valid, **kw))
    sr, table, phi, alpha, iids = model.head_multi(batch, training=True,
                                                   seeds=seeds)
    _check_loss_dtype(model, sr, table)
    with profiling.span("loss") as s:
        s.inputs((sr, phi))
        return s.outputs(xent_multi.multi_nll_loss(
            sr, table, batch.labels, batch.valid, iids, phi, alpha,
            extra=model.extra, fusion=model.fusion, **kw))


@torch.no_grad()
def apply_table_update(model, update, seed):
    """The bf16 branch of the JAX package's ``_apply_updates_project``
    (runner.py:195-231): the float32 ``update`` is added to the bfloat16
    ``model.embedding`` in float32, ``model.project_table`` projects the
    float32 sum, and the sum is rounded back into the table in place with
    ``stochastic_round_bf16(., seed)``."""
    table = model.embedding
    new = model.project_table(table.to(torch.float32) + update)
    table.copy_(stochastic_round_bf16(new, seed))


def _check_loss_dtype(model, sr, table):
    if table.dtype == (model.cdt or torch.float32) and sr.dtype != table.dtype:
        raise TypeError(f"the loss gets sr in {sr.dtype} from a model that "
                        f"computes in its {table.dtype} table's type")


# Eval streams the catalog (ops/streamed_eval.py) from 2^30 score
# elements on, as the JAX package does (sessionrec_tpu/train/runner.py:
# 329-342), so both packages take the same path at every shape.  Below it
# the materialised [B, (K,) P] float32 scores (4 GiB at the threshold,
# about as much again in comparison temporaries) sit beside the table,
# its Adam moments and the activations on an 80 GB H100.
_STREAM_EVAL_ELEMS = 2 ** 30


def _auto_stream(batch_size: int, padded_items: int,
                 score_rows: int = 1) -> bool:
    """True where eval streams instead of materialising the scores.
    ``score_rows`` is the score tensor's rows per example: K for the
    multi head's ``[B, K, P]`` scores."""
    return batch_size * score_rows * padded_items >= _STREAM_EVAL_ELEMS


def _streams(model, batch, streamed):
    """``streamed``, or where it is None the auto policy at ``batch``'s
    size, with the JAX package's score rows: the order K for every MSGIFSR
    (``has_multi_head``), whichever head ranks, else 1."""
    if streamed is not None:
        return streamed
    rows = model.order if getattr(model, "has_multi_head", False) else 1
    return _auto_stream(batch.labels.shape[0], model.padded_items, rows)


@torch.no_grad()
def eval_scores(model, batch):
    """``[B, P]`` materialised scores whose per-row order ranks the catalog
    (runner.py:407-430 of the JAX package); eval ranks them below the
    streaming threshold, and serving takes their top-k.  The plain head
    gives the raw masked logits: positive scaling and log_softmax preserve
    each row's order and ties.  The multi head gives ``model.apply``'s
    log-probabilities.  Padded catalog columns score -inf."""
    if model.has_plain_head:
        sr, table = model.head(batch, training=False)
        with profiling.span("serve.score"):
            if model.table_norm:
                table = l2norm(table)
            logits = scoring.catalog_logits(sr, table, model.cdt)
            imask = scoring.item_mask(model.num_items, model.padded_items,
                                      logits.device)
            return torch.where(imask, logits, -math.inf)
    return model.apply(batch, training=False)


@torch.no_grad()
def eval_ranks(model, batch, cutoff, streamed=None, rank_method=None):
    """Label ranks of one eval batch (``_eval_ranks``, runner.py:356-430 of
    the JAX package).  ``streamed``: None picks by ``_auto_stream``, True
    walks the catalog in slabs (``ops/streamed_eval.py``), False ranks
    ``eval_scores``.  ``rank_method``: None or "count" counts, "topk"
    takes the stable top-k; both give the same ranks.  On a mesh the
    catalog shards stream (``parallel/sharded.py:sharded_eval_ranks``),
    whatever ``streamed`` says."""
    if model.shard is not None:
        return sharded_eval_ranks(model, batch, cutoff, rank_method)[0]
    count = scoring.use_count_ranks(rank_method)
    if not _streams(model, batch, streamed):
        scores = eval_scores(model, batch)
        if count:
            return scoring.label_ranks_by_count(scores, batch.labels, cutoff)
        return scoring.topk_ranks(scores, batch.labels, cutoff)
    kw = dict(num_items=model.num_items, k=cutoff,
              normalize_table=model.table_norm, compute_dtype=model.cdt)
    if model.has_plain_head:
        sr, table = model.head(batch, training=False)
        if count:
            return streamed_eval.streamed_count_ranks(sr, table, batch.labels,
                                                      **kw)
        return streamed_eval.streamed_topk_ranks(
            sr, table, batch.labels, scale=float(model.scale), **kw)
    sr, table, phi, alpha, iids = model.head_multi(batch, training=False)
    fn = (streamed_eval.streamed_multi_count_ranks if count
          else streamed_eval.streamed_multi_topk_ranks)
    return fn(sr, table, batch.labels, iids, phi, alpha, extra=model.extra,
              fusion=model.fusion, scale=float(model.scale), **kw)


@torch.no_grad()
def eval_sums(model, batch, cutoff, streamed=None, rank_method=None):
    """``[hits@cutoff, sum of reciprocal ranks, valid rows]`` of one batch:
    a float64 vector on the batch's device (float32 sums within the batch,
    as the JAX eval step); ``streamed`` and ``rank_method`` as in
    ``eval_ranks``."""
    ranks = eval_ranks(model, batch, cutoff, streamed, rank_method)
    v = batch.valid
    hit = torch.sum((ranks > 0) * v)
    mrr = torch.sum(
        torch.where(ranks > 0, 1.0 / torch.clamp(ranks, min=1), 0.0) * v)
    return torch.stack([hit, mrr, torch.sum(v)]).to(torch.float64)


def sweep_metrics(sums):
    """(MRR@cutoff, HR@cutoff) from a sweep's summed ``eval_sums``; the one
    host read of a sweep."""
    hit, mrr, n = sums.tolist()
    n = max(n, 1.0)
    return mrr / n, hit / n


@torch.no_grad()
def eager_sums(model, batches, cutoff, device, streamed=None,
               rank_method=None):
    """Summed ``eval_sums`` of ``batches`` (host or device batches, moved
    to ``device``), one eager batch at a time, added in order."""
    total = torch.zeros(3, dtype=torch.float64, device=device)
    for batch in batches:
        total += eval_sums(model, batch.to(device), cutoff, streamed,
                           rank_method)
    return total


def evaluate(model, loader, cutoff=20):
    """(MRR@cutoff, HR@cutoff) over a loader, one eager batch at a time on
    the model's device (reference train.py:36-55)."""
    device = next(model.parameters()).device
    return sweep_metrics(eager_sums(model, loader, cutoff, device))


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
    """A captured run over batch slots ``0 .. n - 1``: its graph, its
    static output (a training chunk's ``[n]`` losses, or an eval chunk's
    summed ``eval_sums``), its ``key`` (``"train.8"``, ``"eval.1"``,
    ``"serve.1"``: the ``graph.capture.<key>`` and ``graph.replay.<key>``
    counters) and how often it replayed.  Captured with tracing on
    (``utils/profiling.py``) it also holds its ``nodes`` (device-work
    nodes), ``owners`` (``profiling.Owner``: the span that owns each run
    of nodes) and ``counts`` (the counters the capture added to, such as
    the kernel wrappers' ``xent.fwd``); else None, [] and {}."""

    graph: object
    out: torch.Tensor
    key: str
    nodes: int | None = None
    owners: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)
    replays: int = 0


def launches(graph: StepGraph) -> dict:
    """The launches the replays of ``graph`` made on the device, by
    counter: what its capture counted times its replays."""
    return {k: n * graph.replays for k, n in graph.counts.items()}


class _Slots:
    """Static device batches that captured graphs read, made from the
    first batch staged into each and then copied into in place."""

    def __init__(self, device):
        self.device = device
        self.batches = []

    def __bool__(self):
        return bool(self.batches)

    def __getitem__(self, i):
        return self.batches[i]

    def stage(self, i, batch):
        """Copy ``batch`` into slot ``i``; returns the slot (span
        ``runner.stage``, counter ``runner.staged_bytes``)."""
        with profiling.span("runner.stage"):
            if profiling.enabled():
                profiling.count("runner.staged_bytes", batch.nbytes())
            if i == len(self.batches):
                self.batches.append(batch.to(self.device))
            else:
                self.batches[i].copy_(batch)
            return self.batches[i]


def _capture(graphs, n, pool, body, kind):
    """The graph of ``n`` slots in ``graphs``, captured at first use from
    ``body()`` (which returns its static output) into ``pool``, under the
    key ``"<kind>.<n>"``; returns (the StepGraph, the pool)."""
    g = graphs.get(n)
    if g is None:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            with profiling.capturing() as cmap:
                out = body()
        key = f"{kind}.{n}"
        g = graphs[n] = StepGraph(graph, out, key)
        if cmap is not None:
            g.nodes, g.owners, g.counts = cmap.total, cmap.owners, cmap.counts
        profiling.count(f"graph.capture.{key}")
    return g, g.graph.pool()


def _launch(g):
    """Replay ``g`` (span ``runner.replay``, counter
    ``graph.replay.<key>``)."""
    with profiling.span("runner.replay"):
        g.graph.replay()
    g.replays += 1
    profiling.count(f"graph.replay.{g.key}")


def _replay(g):
    _launch(g)
    return g.out.clone()


def _on_side_stream(device, fn):
    """``fn()`` on a side stream, as ``torch.cuda.graphs`` asks of the
    work before a capture; the current stream waits for it."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    return out


class TrainRunner:
    """Training loop on one device, or one rank of a ``mesh``.

    Invariant (as in the JAX package): parameters enter every step
    max-norm-projected, gradients are taken at the projected table, and
    ``project_params`` runs right after each update.
    """

    def __init__(self, model, train_loader, test_loader, *, lr=1e-3,
                 weight_decay=1e-4, patience=3, seed=123, cutoff=20,
                 lr_step_size=3, lr_gamma=0.1, eval_before_train=True,
                 checkpointer=None, checkpoint_every=1, unroll=8,
                 metrics=None, device="cuda", mesh=None):
        set_precision()
        self.mesh = mesh
        self.device = resolve_device(str(device)) if mesh is None \
            else mesh.device
        self.model = model
        self.train_loader = train_loader
        self.test_loader = test_loader
        self.patience = patience
        self.cutoff = cutoff
        self.eval_before_train = eval_before_train
        self.checkpointer = checkpointer
        self.checkpoint_every = max(int(checkpoint_every), 1)
        self.unroll = max(int(unroll), 1)
        self.metrics = metrics
        model.reset_parameters(torch.Generator().manual_seed(seed))
        model.to(self.device)
        # on a mesh every rank draws the whole table from the seed, keeps
        # its shard, and hashes its rows' global indices
        self.seeds = SeedSource(seed + 1, self.device, data=(0, 1)
                                if mesh is None else (mesh.d, mesh.dp))
        if mesh is not None:
            bind_mesh(model, mesh)
        # establish the step invariant; identity for fresh inits
        model.project_params()
        self.params = [p for p in model.parameters() if p.requires_grad]
        # every parameter holds its gradient from the start, zeroed in
        # place before each backward: the parameters the loss does not
        # reach (the 'inter' GATs at order 1, sc_sr[k > 0], beta) still
        # take the weight-decay step, as in the JAX package, whose
        # gradient of them is zero rather than absent; and a captured
        # graph finds every gradient where it left it
        for p in self.params:
            p.grad = torch.zeros_like(p)
        self.opt, self.sched, self.table_opt = make_optimizer(
            model, lr, weight_decay, steps_per_epoch=len(train_loader),
            lr_step_size=lr_step_size, lr_gamma=lr_gamma)
        self.graphs = {}          # steps -> StepGraph, captured at first use
        self._slots = _Slots(self.device)   # the training graphs' batches
        self._pool = None         # the training graphs' shared memory pool
        self.eval_graphs = {}     # batches -> StepGraph of eval sums
        self._eval_slots = _Slots(self.device)
        self._eval_pool = None    # the eval graphs' own memory pool
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
        """True where ``run_chunk`` and eval replay CUDA graphs (on CUDA,
        off a mesh)."""
        return self.device.type == "cuda" and self.mesh is None

    def _step(self, batch):
        """fwd -> bwd -> Adam -> schedule -> project on a device batch;
        the loss, on the device.  Nothing here reads the device from the
        host, so it captures into a CUDA graph as it stands."""
        self.model.train()
        self.seeds.begin_step()
        loss = make_loss(self.model, batch, self.seeds)
        with profiling.span("step.optimizer"):
            self.opt.zero_grad(set_to_none=False)
            if self.table_opt is not None:
                self.table_opt.zero_grad()
        loss.backward()
        if self.mesh is not None:
            sum_data_grads(self.params, self.mesh)
            with profiling.span("step.optimizer"):
                self.opt.step()
                bf16 = self.model.embedding.dtype == torch.bfloat16
                self.table_opt.step(self.seeds.next() if bf16 else None)
                self.sched.step()
            return loss.detach()
        with profiling.span("step.optimizer"):
            self.opt.step()
            update = self.table_opt.update() if self.table_opt else None
            self.sched.step()
            self._project(update)
        return loss.detach()

    def _project(self, table_update):
        """The max-norm projection after the optimizer's step: in place on
        a float32 table; a bfloat16 table takes ``table_update`` through
        ``apply_table_update`` with the step's next device seed."""
        if table_update is None:
            self.model.project_params()
        else:
            apply_table_update(self.model, table_update, self.seeds.next())

    def train_step(self, batch):
        """One plain eager step on ``batch`` (on the device); returns the
        loss (on the device)."""
        loss = self._step(batch)
        self.steps += 1
        return loss

    def init_opt_state(self):
        """Create Adam's state where its first step has not yet: zero
        moments and a zero step count, a float32 tensor on the parameter's
        device where Adam is capturable (as ``torch.optim.Adam`` makes
        them).  A checkpoint restore copies into it."""
        for group in self.opt.param_groups:
            for p in group["params"]:
                st = self.opt.state[p]
                if st:
                    continue
                st["step"] = (torch.zeros((), dtype=torch.float32,
                                          device=p.device)
                              if group["capturable"] else torch.tensor(0.0))
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)

    def named_state(self):
        """Every tensor a step reads and writes besides the batch and the
        gradients, by name: the parameters and the model's buffers (LESSR's
        running BatchNorm statistics) under their own names (detached, so
        cloning them keeps no autograd node alive), Adam's moments and step
        counts as ``adam/<parameter>/<key>``, the schedule's counter and
        rate and the dropout counter.  Copying values into them in place
        leaves the captured graphs valid."""
        named = dict(self.model.named_parameters())
        out = {n: p.detach() for n, p in named.items()}
        out.update(self.model.named_buffers())
        for n, p in named.items():
            st = (self.table_opt.state if self.table_opt is not None
                  and p is self.table_opt.param else self.opt.state.get(p, {}))
            out.update({f"adam/{n}/{k}": st[k]
                        for k in ("step", "exp_avg", "exp_avg_sq")
                        if k in st})
        out.update({"sched/count": self.sched.count,
                    "sched/lr": self.sched.lr,
                    "seeds/count": self.seeds.count})
        return out

    def state_tensors(self):
        """``named_state``'s tensors."""
        return list(self.named_state().values())

    def _graph(self, steps):
        """The ``steps``-step training graph over slots ``0 .. steps -
        1``, captured at first use into the training pool."""
        g, self._pool = _capture(
            self.graphs, steps, self._pool,
            lambda: torch.stack([self._step(self._slots[i])
                                 for i in range(steps)]), "train")
        return g

    def run_chunk(self, chunk):
        """Train on ``chunk``, at most ``unroll`` batches of the loader
        (host arrays or tensors); returns their losses, one device
        tensor."""
        if self.mesh is not None:
            return torch.stack([self.train_step(b) for b in
                                place_chunk(self.mesh, chunk)])
        if not self.uses_graph:
            return torch.stack([self.train_step(b.to(self.device))
                                for b in chunk])
        if not self._slots:
            # the first chunk's real steps, eager: Adam's state exists
            # before any capture
            return _on_side_stream(self.device, lambda: torch.stack(
                [self.train_step(self._slots.stage(i, b))
                 for i, b in enumerate(chunk)]))
        if len(chunk) == self.unroll:
            for i, b in enumerate(chunk):
                self._slots.stage(i, b)
            out = _replay(self._graph(self.unroll))
        else:
            out = []
            for b in chunk:
                self._slots.stage(0, b)
                out.append(_replay(self._graph(1)))
            out = torch.cat(out)
        self.steps += len(chunk)
        return out

    def _chunk_sums(self, batches):
        """``eager_sums`` of ``batches`` on the runner's device."""
        return eager_sums(self.model, batches, self.cutoff, self.device)

    def _eval_graph(self, n):
        """The graph of ``n`` eval batches over the eval slots, summing
        their ``eval_sums``; captured at first use into the eval pool."""
        g, self._eval_pool = _capture(
            self.eval_graphs, n, self._eval_pool,
            lambda: self._chunk_sums(self._eval_slots[:n]), "eval")
        return g

    def _eval_chunk(self, chunk):
        """Summed ``eval_sums`` of ``chunk``, at most ``unroll`` test
        batches, through the eval graphs (the first chunk ever eager)."""
        slots = self._eval_slots
        if not slots:
            return _on_side_stream(self.device, lambda: self._chunk_sums(
                [slots.stage(i, b) for i, b in enumerate(chunk)]))
        if len(chunk) == self.unroll:
            for i, b in enumerate(chunk):
                slots.stage(i, b)
            return _replay(self._eval_graph(self.unroll))
        total = 0
        for b in chunk:
            slots.stage(0, b)
            total = total + _replay(self._eval_graph(1))
        return total

    def eval_sweep(self):
        """Summed ``eval_sums`` over the test loader, a float64 device
        vector: per chunk of eval graphs on CUDA, per batch on the CPU.
        The table is max-norm-projected first (identity under the step
        invariant; it covers parameters loaded from elsewhere)."""
        self.model.eval()
        self.model.project_params()
        if self.mesh is not None:
            # each data position's sums, then the whole test set's
            return all_reduce(self._chunk_sums(self.test_loader), self.mesh,
                              DATA_AXIS)
        if not self.uses_graph:
            return self._chunk_sums(self.test_loader)
        total = torch.zeros(3, dtype=torch.float64, device=self.device)
        with torch.no_grad():
            for chunk in chunks(self.test_loader, self.unroll):
                total += self._eval_chunk(chunk)
        return total

    def evaluate(self):
        """(MRR@cutoff, HR@cutoff) of the test loader."""
        return sweep_metrics(self.eval_sweep())

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

    def _global_count(self, n):
        """``n``, a count over this rank's rows, summed over the data
        group (``n`` itself off a mesh)."""
        if self.mesh is None:
            return n
        t = torch.tensor(float(n), dtype=torch.float64, device=self.device)
        return float(all_reduce(t, self.mesh, DATA_AXIS))

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
                    rate = self._global_count(examples - interval_examples) \
                        / max(dt, 1e-9)
                    log.info("step %d: loss = %.4f, %.1f examples/s, %.2fs",
                             self.steps, mean_loss, rate, dt)
                    if self.metrics is not None:
                        self.metrics.log("train", step=self.steps,
                                         epoch=self.epoch, loss=mean_loss,
                                         examples_per_s=rate)
                    interval_examples = examples
                    t = time.perf_counter()
            self._drain_losses(pending)
            self.train_examples = int(self._global_count(examples))
            self.train_seconds = time.perf_counter() - epoch_t
            rate = self.train_examples / max(self.train_seconds, 1e-9)

            mrr, hit = self.evaluate()
            log.info("epoch %d: MRR = %.3f%%, Hit = %.3f%% "
                     "(%.1f train examples/s)", self.epoch, mrr * 100,
                     hit * 100, rate)
            if self.metrics is not None:
                self.metrics.log("eval", step=self.steps, epoch=self.epoch,
                                 mrr=mrr, hit=hit, examples_per_s=rate)

            # early stop only when BOTH metrics worsened (train.py:118-123)
            stop = False
            if mrr < self.max_mrr and hit < self.max_hit:
                self.bad_counter += 1
                stop = self.bad_counter == self.patience
            else:
                self.bad_counter = 0
            self.max_mrr = max(self.max_mrr, mrr)
            self.max_hit = max(self.max_hit, hit)

            if self.checkpointer is not None and (
                    stop or (self.epoch + 1) % self.checkpoint_every == 0):
                self.checkpointer.save(self.epoch, self,
                                       metrics={"mrr": mrr, "hit": hit})

            self.epoch += 1
            if stop:
                break
        return self.max_mrr, self.max_hit
