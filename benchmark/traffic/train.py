"""Training traffic: the port's training loop over synthetic sessions.

Sessions from the seed (``harness/data.py``) go to the port's own
``BatchLoader`` (the C++ builder, length tiers, prefix augmentation, the
ordered stream) and its ``TrainRunner`` takes them in chunks of
``unroll`` steps (``run_chunk``: a CUDA-graph replay a chunk on the card),
as ``TrainRunner.train`` does without the per-epoch eval; the stream runs
on into the next epoch where a window outlasts one.

Set-up builds the runner once, loads the seed's weights, and drives it
through its first ``1 + unroll`` steps with the window's own call and
feed: step 1 (the runner's eager first chunk, one batch), then the first
full chunk, steps 2 to ``1 + unroll``, which captures the ``unroll``-step
graph and replays it: the same graph object, over the same slots, that
the window replays.  After the window the reference follows those steps
from the same weights and sessions, and the check compares every step's
loss, each leaf's first gradient as Adam holds it after step 1, and each
leaf's change after the first full chunk.

Spans: ``loader_wait`` around each chunk's ``next()``, ``dispatch``
around ``run_chunk``, both per step.
"""

from __future__ import annotations

import time

import numpy as np

from harness import check, data, program, stalls, trace
from harness.outcome import Outcome

SPANS = ("loader_wait", "dispatch")


def first_steps(cell):
    """The steps set-up takes: the eager first one and one full chunk."""
    return 1 + cell.traffic["unroll"]


def endless(loader):
    """The loader's batches, epoch after epoch."""
    while True:
        yield from loader


class Stream:
    """The example stream of the sessions, as the loader takes it: each
    session's prefixes in order, ``batch`` examples a step, the epoch's
    last step short."""

    def __init__(self, sessions, batch):
        lens = np.fromiter((len(s) for s in sessions), np.int64,
                           len(sessions))
        self.sessions = sessions
        self.ends = np.cumsum(lens - 1)
        self.total = int(self.ends[-1])
        self.batch = batch
        self.steps_per_epoch = -(-self.total // batch)

    def step(self, s):
        """``[(items, label)]`` of step ``s`` (from 0)."""
        j = s % self.steps_per_epoch
        out = []
        for e in range(j * self.batch, min((j + 1) * self.batch,
                                           self.total)):
            sid = int(np.searchsorted(self.ends, e, side="right"))
            pos = e - (int(self.ends[sid - 1]) if sid else 0) + 1
            seq = self.sessions[sid]
            out.append((seq[:pos], seq[pos]))
        return out


def make_stream(ctx):
    """The seed's training sessions, as the stream of their examples."""
    cfg, mix = ctx.cell.config, ctx.cell.traffic
    lengths = data.load_profile(mix["lengths"])
    n = data.sessions_for_examples(lengths, ctx.cell.params["train_examples"])
    return Stream(data.make_sessions(ctx.seed, "train", n,
                                     cfg["catalog"]["num_items"], lengths,
                                     data.load_profile(mix["items"])),
                  cfg["data"]["batch_size"])


class Setup:
    """The program set up for a seed: loader, runner and stream."""

    def __init__(self, ctx):
        from sessionrec_tpu_torch.data.loader import BatchLoader
        from sessionrec_tpu_torch.train.runner import TrainRunner, chunks
        cfg, mix = ctx.cell.config, ctx.cell.traffic
        d = cfg["data"]
        self.n_items = cfg["catalog"]["num_items"]
        self.stream = make_stream(ctx)
        self.sessions = self.stream.sessions
        self.loader = BatchLoader(
            self.sessions, "ccs", d["batch_size"], d["max_len"],
            shuffle=False, order=cfg["model"]["order"],
            prefetch=mix["prefetch"], split_len=tuple(d["tiers"]),
            use_native=True)
        model = program.build_model(cfg, ctx.device)
        t = cfg["train"]
        self.runner = TrainRunner(
            model, self.loader, None, lr=t["lr"],
            weight_decay=t["weight_decay"], seed=ctx.seed,
            lr_step_size=t["lr_step_size"], lr_gamma=t["lr_gamma"],
            eval_before_train=False, unroll=mix["unroll"],
            device=ctx.device)
        self.weights = ctx.cell.reference().init_params(cfg, ctx.seed,
                                                        ctx.device)
        program.load_weights(model, self.weights)
        self.batches = endless(self.loader)
        self.chunks = chunks(self.batches, mix["unroll"])

    def first_steps(self):
        """Step 1 and the first full chunk through ``run_chunk``; the
        program's readings."""
        import torch
        r = self.runner
        params = dict(r.model.named_parameters())
        losses = [r.run_chunk([next(self.batches)])]
        beta1 = r.opt.param_groups[0]["betas"][0]
        # a parameter Adam holds no moment of reads a zero gradient
        grad = program.leaf_norms(
            {n: r.opt.state[p].get("exp_avg", torch.zeros_like(p))
             / (1 - beta1) for n, p in params.items()}, self.n_items)
        losses.append(r.run_chunk(next(self.chunks)))
        change = program.leaf_norms(
            {n: p.detach() - self.weights[n].to(p.device) if n != "embedding"
             else p.detach()[:self.n_items] - self.weights[n]
             for n, p in params.items()}, self.n_items)
        self.weights = None
        return {"losses": torch.cat([x.reshape(-1) for x in losses]).tolist(),
                "grad": grad, "change": change}

    def close(self):
        self.chunks.close()
        self.batches.close()


def reference_readings(ctx, stream, precision="float32", fault=None):
    """The reference's readings of the set-up's steps of ``stream``, from
    the seed's weights made again."""
    ref = ctx.cell.reference()
    cfg = ctx.cell.config
    weights = ref.init_params(cfg, ctx.seed, ctx.device)
    return ref.train_readings(
        cfg, weights,
        [stream.step(s) for s in range(first_steps(ctx.cell))],
        dropout_key=ctx.seed + 1, steps_per_epoch=stream.steps_per_epoch,
        device=ctx.device, precision=precision, fault=fault)


def valid_rows(chunk):
    return int(sum(float(np.sum(b.valid)) for b in chunk))


def run(ctx):
    import torch
    cell = ctx.cell
    spans = ctx.spans
    marks = [("imports", time.perf_counter())]
    setup = Setup(ctx)
    marks.append(("sessions, loader, runner, weights", time.perf_counter()))
    prog = setup.first_steps()
    program.synchronize(ctx.device)
    start = time.perf_counter()
    marks.append(("eager step, graph capture and first replay", start))
    unroll = cell.traffic["unroll"]
    stream = setup.chunks
    done = first_steps(cell)
    setup_s = start - ctx.t0
    stalls.report_setup(ctx.t0, marks)
    outs, steps, examples, ends = [], 0, 0, []
    while True:
        with spans.span("loader_wait") as s:
            chunk = next(stream)
            s.units = len(chunk)
        with spans.span("dispatch", units=len(chunk)):
            outs.append(setup.runner.run_chunk(chunk))
        steps += len(chunk)
        examples += valid_rows(chunk)
        ends.append(time.perf_counter() - start)
        if ends[-1] >= ctx.seconds:
            break
    program.synchronize(ctx.device)
    wall = time.perf_counter() - start
    stalls.report("chunk", ends, wall)
    done += steps
    profile, profiled = None, []
    if ctx.trace:
        n = cell.params["trace_chunks"]

        def sub_window():
            for _ in range(n):
                with spans.span("loader_wait"):
                    chunk = next(stream)
                with spans.span("dispatch"):
                    outs.append(setup.runner.run_chunk(chunk))
            program.synchronize(ctx.device)
        spans.profiling = True
        _, profile = trace.profile(sub_window, SPANS)
        spans.profiling = False
        profiled = [setup.stream.step(s)
                    for s in range(done, done + n * unroll)]
    peak = program.peak_memory(ctx.device)
    losses = torch.cat([o.reshape(-1) for o in outs]).cpu()
    failed = int(torch.sum(~torch.isfinite(losses)))
    setup.close()
    del outs, setup.runner, stream
    program.free(ctx.device)
    ref = reference_readings(ctx, setup.stream)
    numbers = check.train_numbers(prog, ref)
    check.print_unlimited(numbers, cell.params["limits"])
    checks = check.verdict(numbers, cell.params["limits"])
    return Outcome(
        metrics={"train_examples_per_s": examples / wall, "setup_s": setup_s},
        attempted=steps, failed=failed, checks=checks,
        memory_peak_bytes=peak, profile=profile,
        data={"profiled_steps": profiled, "readings": numbers})
