"""Serving traffic: one closed-loop client ranking live sessions.

Each request hands the program ``request_sessions`` whole sessions (no
prefix augmentation) and waits for their top-``k`` item ids and scores on
the host: ``serving.session_batches`` builds the batch (``build``), the
step made once by ``serving.make_recommend_step`` ranks it (``dispatch``;
a CUDA-graph replay on the card), and the results are copied to the host
(``result_copy``), as ``serving.recommend`` composes them.  A request's
latency runs from the first to the last of the three; the next request
follows at once.  Sessions come from a pool made from the seed, taken in
turn.

Set-up makes the pool and the step and serves two requests, the eager
one and the one that captures the graph.  After the window the reference
scores a sample of the window's requests, drawn from the seed and
holding the pool's longest session, and the check compares what was
served with it, in the served quantity of the configuration's head
(the reference's ``serve_scores``: log-probabilities of a multi-order
head, the masked catalog logits of a plain one).  Batches are of the
kind the program gives the configuration's model.
"""

from __future__ import annotations

import time

import numpy as np

from harness import check, data, program, stalls, trace
from harness.outcome import Outcome
from harness.spans import Spans

SPANS = ("build", "dispatch", "result_copy")


class Cycle:
    """The pool's sessions taken in turn, as long a sequence as a run
    can ask for."""

    def __init__(self, pool, length):
        self.pool = pool
        self.length = length

    def __len__(self):
        return self.length

    def __getitem__(self, sl):
        n = len(self.pool)
        return [self.pool[i % n] for i in range(sl.start, min(sl.stop,
                                                              self.length))]


class Server:
    """The program set up to serve a seed's pool."""

    def __init__(self, ctx):
        from sessionrec_tpu_torch import serving
        from sessionrec_tpu_torch.train.runner import set_precision
        cfg, mix, cell = ctx.cell.config, ctx.cell.traffic, ctx.cell.params
        self.cfg, self.ctx = cfg, ctx
        self.n_items = cfg["catalog"]["num_items"]
        self.rows = mix["request_sessions"]
        lengths = data.load_profile(mix["lengths"])
        items = data.load_profile(mix["items"])
        self.pool = data.make_sessions(ctx.seed, "serve",
                                       cell["pool_sessions"], self.n_items,
                                       lengths, items)
        set_precision()
        self.model = program.build_model(cfg, ctx.device)
        program.load_weights(self.model, ctx.cell.reference().init_params(
            cfg, ctx.seed, ctx.device))
        self.step = serving.make_recommend_step(self.model, k=mix["k"])
        kind, order = program.batch_kind(cfg)
        self.batches = serving.session_batches(
            Cycle(self.pool, self.rows * 10 ** 7), kind, self.rows,
            cfg["data"]["max_len"], order=order)
        self.served = 0

    def request(self, spans):
        """One request: ``(its index, ids [n, k], scores [n, k])`` on the
        host."""
        with spans.span("build"):
            batch, n = next(self.batches)
        with spans.span("dispatch"):
            scores, ids = self.step(batch)
        with spans.span("result_copy"):
            ids, scores = ids[:n].cpu(), scores[:n].cpu()
        self.served += 1
        return self.served - 1, ids, scores

    def sessions_of(self, index):
        start = index * self.rows
        return [self.pool[(start + j) % len(self.pool)]
                for j in range(self.rows)]


def sample(server, indices, seed, count):
    """``count`` of the served requests ``indices``, drawn from the seed,
    with the first one that holds the pool's longest session."""
    rng = np.random.default_rng([int(seed), 7])
    picked = [int(i) for i in rng.choice(indices, size=min(count,
                                                          len(indices)),
                                         replace=False)]
    longest = max(map(len, server.pool))
    for i in indices:
        if any(len(s) == longest for s in server.sessions_of(i)):
            if i not in picked:
                picked[-1] = i
            break
    return sorted(picked)


def reference_numbers(ctx, server, answers, precision="float32"):
    """The check's numbers over ``answers`` ``{request: (ids, scores)}``,
    the worst of every request."""
    ref = ctx.cell.reference()
    weights = ref.init_params(ctx.cell.config, ctx.seed, ctx.device)
    worst = {}
    for i, (ids, scores) in answers.items():
        want = ref.serve_scores(ctx.cell.config, weights,
                                server.sessions_of(i), device=ctx.device,
                                precision=precision)
        for k, v in check.serve_numbers(ids, scores, want).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def malformed(ids, scores, n_items):
    """True where an answer is not ``k`` distinct catalog ids a session
    with finite scores."""
    ids = ids.numpy()
    s = np.sort(ids, axis=1)
    return bool(np.any(ids < 0) or np.any(ids >= n_items)
                or np.any(s[:, 1:] == s[:, :-1])
                or not np.all(np.isfinite(scores.numpy())))


def run(ctx):
    cell = ctx.cell
    spans = ctx.spans
    marks = [("imports", time.perf_counter())]
    server = Server(ctx)
    marks.append(("pool, model, weights, step", time.perf_counter()))
    warm = Spans()
    for _ in range(2):
        server.request(warm)
    program.synchronize(ctx.device)
    start = time.perf_counter()
    marks.append(("eager request, graph capture", start))
    setup_s = start - ctx.t0
    stalls.report_setup(ctx.t0, marks)
    lat, answers, ends = [], {}, []
    while time.perf_counter() - start < ctx.seconds:
        t = time.perf_counter()
        i, ids, scores = server.request(spans)
        lat.append(time.perf_counter() - t)
        answers[i] = (ids, scores)
        ends.append(time.perf_counter() - start)
    program.synchronize(ctx.device)
    wall = time.perf_counter() - start
    stalls.report("request", ends, wall)
    profile = None
    if ctx.trace:
        def sub_window():
            for _ in range(cell.params["trace_requests"]):
                server.request(spans)
            program.synchronize(ctx.device)
        spans.profiling = True
        _, profile = trace.profile(sub_window, SPANS)
        spans.profiling = False
    peak = program.peak_memory(ctx.device)
    failed = sum(malformed(ids, s, server.n_items)
                 for ids, s in answers.values())
    keep = sample(server, sorted(answers), ctx.seed,
                  cell.params["check_requests"])
    picked = {i: answers[i] for i in keep}
    sessions = len(answers) * server.rows
    del server.step, server.model
    program.free(ctx.device)
    numbers = reference_numbers(ctx, server, picked)
    return Outcome(
        metrics={"serve_sessions_per_s": sessions / wall,
                 "serve_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                 "setup_s": setup_s},
        attempted=len(answers), failed=int(failed),
        checks=check.verdict(numbers, cell.params["limits"]),
        memory_peak_bytes=peak, profile=profile,
        data={"readings": numbers, "requests": len(answers)})
