"""One rank of the port's (data, model) mesh on the CPU, for the mesh tests.

    python tests/_torch_mesh_worker.py SUITE OUT_DIR PORT RANK WORLD DP MP

Joins a gloo process group of WORLD processes on 127.0.0.1:PORT, builds
the DP x MP mesh of CPU ranks, runs SUITE and pickles what it computed to
OUT_DIR/SUITE_RANK.pkl.  The inputs come from fixed numpy seeds, from
functions that the tests call too.  This file imports nothing of JAX
(the port's processes must not), so the JAX side of each comparison runs
in the test process.

Suites:
* ``ops`` — the shard losses (K1/K2's and K3/K4's plain versions), the
  lookup and the rankers on a catalog of ``OPS_ITEMS`` items padded to
  1,024 rows (the last shard partial), each rank its rows and shard;
* ``train`` — 3 steps of each of ``TRAIN_CASES`` on the mesh, with
  dropout on, and rank 0 the same steps on one device; every dropout
  mask and (bf16) rounding recorded; the eval sweep after them; o1 saves
  a checkpoint and takes a 4th step, and loads the state of 3 one-device
  steps into a fresh mesh runner;
* ``jax_train`` — 3 steps of o1 from the parameters in
  OUT_DIR/jax_start.pt on the sessions in OUT_DIR/jax_sessions.pkl.
"""

from __future__ import annotations

import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# ---------------------------------------------------------------------------
# inputs (the tests call these too)
# ---------------------------------------------------------------------------

OPS_ITEMS, OPS_ROWS = 900, 1024          # two shards: 512 and 388 items
OPS_B, OPS_D, OPS_K, OPS_NS, OPS_IDS = 16, 32, 3, 6, 5
TOPK = 20
TIE = (100, 700)       # item 700 (shard 1) is a copy of item 100 (shard 0)


def op_inputs(seed=11):
    """The ops suite's global inputs as numpy arrays: session vectors
    ``sr`` ``[B, D]`` and ``srk`` ``[B, K, D]`` near their labels' rows
    for half the rows (so that labels rank inside the top 20), a table
    with padding rows and an exact cross-shard tie, labels (one on each
    side of the tie, on rows that are otherwise equal), valid rows, session items (-1 padded; some hold the
    label), REnorm gates ``phi``, fusion weights ``alpha``, lookup ids and
    their cotangent."""
    rng = np.random.default_rng(seed)
    B, D, K = OPS_B, OPS_D, OPS_K
    table = rng.normal(size=(OPS_ROWS, D)).astype(np.float32) / 4
    table[OPS_ITEMS:] = 0.0
    table[TIE[1]] = table[TIE[0]]
    labels = rng.integers(0, OPS_ITEMS, size=B).astype(np.int32)
    labels[:2] = TIE
    near = table[labels] * 3.0
    sr = rng.normal(size=(B, D)).astype(np.float32)
    sr[::2] = near[::2] + 0.1 * sr[::2]
    srk = rng.normal(size=(B, K, D)).astype(np.float32)
    srk[::2] = near[::2, None] + 0.1 * srk[::2]
    valid = np.ones(B, np.float32)
    valid[[5, 12]] = 0.0
    iids = rng.integers(0, OPS_ITEMS, size=(B, OPS_NS)).astype(np.int32)
    iids[:, 4:] = -1
    iids[3, 0] = labels[3]
    iids[9, 1] = labels[9]
    phi = rng.uniform(0.1, 0.9, size=(B, K, 1)).astype(np.float32)
    phi = np.concatenate([phi, 1.0 - phi], axis=-1)
    # row 1 is row 0 with the tied copy as its label
    sr[1], srk[1], iids[1], phi[1] = sr[0], srk[0], iids[0], phi[0]
    alpha = rng.normal(size=K).astype(np.float32)
    ids = rng.integers(0, OPS_ITEMS, size=(B, OPS_IDS)).astype(np.int32)
    ids[0, :2] = (OPS_ROWS // 2 - 1, OPS_ROWS // 2)   # both sides of the cut
    g = rng.normal(size=(B, OPS_IDS, D)).astype(np.float32)
    return dict(sr=sr, srk=srk, table=table, labels=labels, valid=valid,
                iids=iids, phi=phi, alpha=alpha, ids=ids, g=g)


SAMPLE = REPO / "datasets" / "sample"
TRAIN_SESSIONS, TEST_SESSIONS = 200, 64
TRAIN_BATCH, TRAIN_STEPS = 64, 3
TRAIN_CASES = ("o1", "paper", "lessr", "o1_bf16")


def train_data():
    """``(train sessions, test sessions, items)`` of the train suite: the
    first sessions of datasets/sample."""
    from sessionrec_tpu_torch.data.io import read_dataset
    train, test, n = read_dataset(str(SAMPLE))
    return train[:TRAIN_SESSIONS], test[:TEST_SESSIONS], n


def train_model(case, num_items):
    """The train suite's model of ``case``: narrow widths, dropout on."""
    from sessionrec_tpu_torch.models import LESSR, MSGIFSR
    if case == "lessr":
        return LESSR(num_items, 16, 3, feat_drop=0.2)
    kw = dict(order=3, extra=True, fusion=True) if case == "paper" \
        else dict(order=1)
    return MSGIFSR(num_items, 16, 1, feat_drop=0.5,
                   table_dtype="bfloat16" if case == "o1_bf16"
                   else "float32", **kw)


def train_loaders(case, sessions, test, data_block=None):
    from sessionrec_tpu_torch.data.loader import BatchLoader
    from sessionrec_tpu_torch.models import graph_kind
    kind = graph_kind("lessr" if case == "lessr" else "msgifsr")
    order = 3 if case == "paper" else 1
    kw = dict(split_len=(4, 8), prefetch=0, order=order,
              data_block=data_block)
    return (BatchLoader(sessions, kind, TRAIN_BATCH, 20, **kw),
            BatchLoader(test, kind, TRAIN_BATCH, 20, **kw))


def train_runner(case, mesh=None, data_block=None, **kw):
    """A CPU runner of ``case`` (on ``mesh`` when given): seed 7, the
    StepLR drop every step (one step an epoch)."""
    from sessionrec_tpu_torch.train.runner import TrainRunner
    sessions, test, n = train_data()
    tl, el = train_loaders(case, sessions, test, data_block)
    return TrainRunner(train_model(case, n), tl, el, lr=1e-3,
                       weight_decay=1e-4, seed=7, device="cpu",
                       lr_step_size=1, lr_gamma=0.5, mesh=mesh, **kw)


def per_shard_round(new, seed, mp, dp):
    """The bf16 bits of ``new`` (a whole table) rounded as a (dp, mp) mesh
    rounds its ZeRO slices: slice ``(m, d)`` with ``seed + (m dp + d) *
    0x27D4EB2F`` over its own flat indices."""
    from sessionrec_tpu_torch.ops.sround import stochastic_round_bf16_bits
    rows = new.shape[0] // (mp * dp)
    out = torch.empty(new.shape, dtype=torch.int16)
    for m in range(mp):
        for d in range(dp):
            lo = (m * dp + d) * rows
            out[lo:lo + rows] = stochastic_round_bf16_bits(
                new[lo:lo + rows], seed + (m * dp + d) * 0x27D4EB2F)
    return out


# ---------------------------------------------------------------------------
# recorders
# ---------------------------------------------------------------------------

def record_masks(log):
    """Patch the dropout op to append each call's ``(global flat indices,
    keep bits)`` to ``log``."""
    from sessionrec_tpu_torch.ops import dropout as D
    orig = D.dropout

    def rec(x, rate, seed, offset=0):
        C = x.shape[-1]
        R = x.numel() // C
        bits = D._hash_bits(seed, (R, C), x.device, offset)
        idx = torch.arange(R * C).reshape(R, C) + offset
        log.append((idx.reshape(-1).numpy(),
                    (bits < D._keep_threshold(rate)).reshape(-1).numpy()))
        return orig(x, rate, seed, offset)
    D.dropout = rec


def record_rounding(log):
    """Patch the mesh table update to append each rounding's ``(float32
    rows, seed, shard id, bits)`` to ``log``."""
    from sessionrec_tpu_torch.train.optim import ShardedTableAdam
    orig = ShardedTableAdam._round

    def rec(self, new, seed):
        bits = orig(self, new, seed)
        mesh = self.shard.mesh
        log.append((new.numpy().copy(), int(seed),
                    mesh.m * mesh.dp + mesh.d, bits.numpy().copy()))
        return bits
    ShardedTableAdam._round = rec


def state_numpy(runner):
    """The runner's ``named_state`` as numpy (float32 for bf16)."""
    return {k: v.detach().float().numpy().copy()
            for k, v in runner.named_state().items()}


# ---------------------------------------------------------------------------
# suites
# ---------------------------------------------------------------------------

def ops_suite(mesh, out_dir):
    from sessionrec_tpu_torch.parallel import sharded as S
    from sessionrec_tpu_torch.parallel.lookup import sharded_lookup
    from sessionrec_tpu_torch.parallel.mesh import (DATA_AXIS, all_reduce,
                                                    shard_rows)
    x = {k: torch.from_numpy(v) for k, v in op_inputs().items()}
    per = OPS_B // mesh.dp
    rows = slice(mesh.d * per, (mesh.d + 1) * per)
    table = shard_rows(x["table"], mesh)
    offset = mesh.m * table.shape[0]
    lbl, valid, iids = x["labels"][rows], x["valid"][rows], x["iids"][rows]

    def leaf():
        return torch.zeros(table.shape, requires_grad=True)

    def data_sum(t):
        return all_reduce(t, mesh, DATA_AXIS).numpy()

    out = {}
    for norm in (True, False):
        sr, g = x["sr"][rows].clone().requires_grad_(), leaf()
        loss = S.fused_nll_loss_sharded(
            mesh, sr, table, lbl, valid, scale=12.0, num_items=OPS_ITEMS,
            normalize_table=norm, table_grad=g)
        loss.backward()
        out[f"nll_norm{int(norm)}"] = dict(
            loss=float(loss), dsr=sr.grad.numpy(), dtab=data_sum(g.grad))
    srk = x["srk"][rows].clone().requires_grad_()
    phi = x["phi"][rows].clone().requires_grad_()
    alpha = x["alpha"].clone().requires_grad_()
    g = leaf()
    loss = S.fused_multi_loss_sharded(
        mesh, srk, table, lbl, valid, iids, phi, alpha, scale=12.0,
        num_items=OPS_ITEMS, normalize_table=True, extra=True, fusion=True,
        table_grad=g)
    loss.backward()
    out["multi"] = dict(loss=float(loss), dsr=srk.grad.numpy(),
                        dtab=data_sum(g.grad), dphi=phi.grad.numpy(),
                        dalpha=data_sum(alpha.grad))
    g = leaf()
    got = sharded_lookup(mesh, table, x["ids"][rows], g)
    torch.sum(got * x["g"][rows]).backward()
    out["lookup"] = dict(rows=got.detach().numpy(), dtab=data_sum(g.grad))
    with torch.no_grad():
        sr, srk, phi = x["sr"][rows], x["srk"][rows], x["phi"][rows]
        kw = dict(num_items=OPS_ITEMS, normalize_table=True)
        out["head_count"] = S.sharded_head_count_ranks(
            mesh, sr, table, lbl, TOPK, **kw).numpy()
        out["multi_count"] = S.sharded_multi_count_ranks(
            mesh, srk, table, lbl, iids, phi, x["alpha"], extra=True,
            fusion=True, k=TOPK, **kw).numpy()
        _, idx = S.sharded_topk(mesh, _masked_logits(sr, table, offset),
                                TOPK, offset)
        out["head_topk"] = S._ranks_of(idx, lbl).numpy()
        out["count_scores"] = S.sharded_count_ranks(
            mesh, _masked_logits(sr, table, offset), lbl, TOPK,
            offset).numpy()
        vals, idxs = S.streamed_multi_topk(
            srk, table, iids, phi, x["alpha"], num_items=OPS_ITEMS,
            extra=True, fusion=True, k=TOPK, col_offset=offset,
            n_valid=min(max(OPS_ITEMS - offset, 0), table.shape[0]),
            axis_name=mesh)
        out["multi_topk"] = S._ranks_of(
            S._gather_candidates(mesh, vals, idxs, TOPK)[1], lbl).numpy()
    return out


def _masked_logits(sr, table, offset):
    """Raw logits of ``sr`` against the l2-normalised shard, padded items
    -inf (the materialised scores a ranker counts over)."""
    from sessionrec_tpu_torch.models.layers import l2norm
    logits = sr @ l2norm(table).T
    col = offset + torch.arange(table.shape[0])
    return torch.where(col < OPS_ITEMS, logits, -torch.inf)


def _batches(loader, n):
    it = iter(loader)
    return [next(it) for _ in range(n)]


def _steps(runner, batches):
    return [float(runner.train_step(b.to(runner.device))) for b in batches]


def train_suite(mesh, out_dir):
    from sessionrec_tpu_torch.train import runner as R
    from sessionrec_tpu_torch.utils.checkpoint import (Checkpointer,
                                                       global_state,
                                                       load_state)
    block = (mesh.d, mesh.dp)
    out = {}
    masks, rounds = [], []
    record_masks(masks)
    record_rounding(rounds)
    for case in TRAIN_CASES:
        masks.clear()
        rounds.clear()
        runner = train_runner(case, mesh, block)
        batches = _batches(runner.train_loader, TRAIN_STEPS + 1)
        res = dict(losses=_steps(runner, batches[:TRAIN_STEPS]),
                   masks=masks[:], rounds=rounds[:],
                   state=state_numpy(runner),
                   sums=runner.eval_sweep().numpy())
        if case == "o1":
            Checkpointer(Path(out_dir) / "ckpt").save(0, runner)
            res["step4"] = _steps(runner, batches[TRAIN_STEPS:])
            res["state4"] = state_numpy(runner)
            one = train_runner(case)
            _steps(one, _batches(one.train_loader, TRAIN_STEPS))
            fresh = train_runner(case, mesh, block)
            load_state(fresh, global_state(one))
            res["loaded"] = state_numpy(fresh)
            res["loaded_from"] = state_numpy(one)
        if mesh.rank == 0:
            masks.clear()
            ref = train_runner(case)
            if case == "o1_bf16":
                def table_update(model, update, seed):
                    new = model.project_table(
                        model.embedding.float() + update)
                    model.embedding.data.copy_(per_shard_round(
                        new, seed, mesh.mp, mesh.dp).view(torch.bfloat16))
                R.apply_table_update = table_update
            ref_batches = _batches(ref.train_loader, TRAIN_STEPS)
            res["ref"] = dict(losses=_steps(ref, ref_batches),
                              masks=masks[:], state=state_numpy(ref),
                              sums=ref.eval_sweep().numpy())
        out[case] = res
    return out


def jax_train_suite(mesh, out_dir):
    """3 steps of o1 (feat_drop 0: the JAX package draws its masks from
    PRNG keys) from the JAX package's converted parameters."""
    from sessionrec_tpu_torch.data.loader import BatchLoader
    from sessionrec_tpu_torch.models import MSGIFSR
    from sessionrec_tpu_torch.parallel.mesh import shard_rows
    from sessionrec_tpu_torch.train.runner import TrainRunner
    start = torch.load(Path(out_dir) / "jax_start.pt", weights_only=True)
    with open(Path(out_dir) / "jax_sessions.pkl", "rb") as f:
        sessions, num_items, dim, lr = pickle.load(f)
    loader = BatchLoader(sessions, "ccs", 32, 11, prefetch=0,
                         split_len=(4, 8), data_block=(mesh.d, mesh.dp))
    model = MSGIFSR(num_items, dim, 1)
    runner = TrainRunner(model, [None], [], lr=lr, weight_decay=1e-4,
                         device="cpu", lr_step_size=1, lr_gamma=0.5,
                         mesh=mesh)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(shard_rows(start[name], mesh) if name == "embedding"
                    else start[name])
    losses = _steps(runner, _batches(loader, TRAIN_STEPS))
    return dict(losses=losses, state=state_numpy(runner))


SUITES = {"ops": ops_suite, "train": train_suite,
          "jax_train": jax_train_suite}


def main(argv):
    import torch.distributed as dist
    from sessionrec_tpu_torch.parallel.mesh import make_mesh
    suite, out_dir, port, rank, world, dp, mp = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh(int(dp), int(mp),
                         devices=[torch.device("cpu")] * world,
                         backend="gloo")
        out = SUITES[suite](mesh, out_dir)
        with open(Path(out_dir) / f"{suite}_{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests' side
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(suite, out_dir, dp=2, mp=2, timeout=600):
    """Run ``suite`` on a dp x mp mesh of worker processes; returns
    ``(the ranks' results by rank, seconds)``.  A failing rank fails the
    caller with its output."""
    import time
    t0 = time.perf_counter()
    port, world = str(_free_port()), dp * mp
    procs = [subprocess.Popen(
        [sys.executable, __file__, suite, str(out_dir), port, str(r),
         str(world), str(dp), str(mp)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"mesh rank {r} failed:\n{text[-4000:]}")
    results = []
    for r in range(world):
        with open(Path(out_dir) / f"{suite}_{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results, time.perf_counter() - t0


if __name__ == "__main__":
    main(sys.argv[1:])
