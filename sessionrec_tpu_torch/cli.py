"""Command line of the port.

    python -m sessionrec_tpu_torch.cli train --model msgifsr --order 1 \
        --dataset-dir datasets/sample
    python -m sessionrec_tpu_torch.cli train --model lessr   # srgnn, niser
    python -m sessionrec_tpu_torch.cli train --model msgifsr --order 3 \
        --extra --fusion                       # the WSDM'22 paper head
    python -m sessionrec_tpu_torch.cli train --model msgifsr --order 1 \
        --checkpoint-dir ckpt --metrics-file metrics.jsonl
    python -m sessionrec_tpu_torch.cli predict --model msgifsr --order 1 \
        --checkpoint-dir ckpt --sessions-file sessions.txt --k 20
    python -m sessionrec_tpu_torch.cli train --model msgifsr --order 1 \
        --table-dtype bfloat16 --compute-dtype bfloat16   # mixed precision
    python -m sessionrec_tpu_torch.cli train --model msgifsr --order 1 \
        --data-parallel 2 --model-parallel 2   # a mesh: 4 processes, 4 cards
    python -m sessionrec_tpu_torch.cli preprocess --dataset gowalla \
        --input checkins.txt --output-dir datasets/gowalla   # no device

Flag names and defaults follow ``sessionrec_tpu/cli.py`` ``train``,
``predict`` and ``preprocess`` (the reference scripts' surface, see
utils/config.py) for the flags the port runs, plus ``--device`` (default
``cuda``; the CPU must be asked for).  ``preprocess`` is host code
(``data/preprocess.py``, numpy only) and has no device.

``train`` with ``--data-parallel x --model-parallel > 1`` runs a (data,
model) mesh of that many ranks, one process each: without
``--coordinator`` it starts them on this host, one per visible card (NCCL;
fewer cards raise), or on the CPU with ``--device cpu`` (gloo); with
``--coordinator host:port --num-processes N --process-id I`` this process
is rank I of a launch that starts each process itself.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import socket
import sys


def _add_train_flags(p):
    p.add_argument("--model", required=True,
                   choices=["srgnn", "niser", "lessr", "msgifsr"])
    p.add_argument("--dataset-dir", default="datasets/sample")
    p.add_argument("--embedding-dim", type=int, default=None)
    p.add_argument("--num-layers", type=int, default=None)
    p.add_argument("--feat-drop", type=float, default=None)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--patience", type=int, default=None)
    p.add_argument("--valid-split", type=float, default=None)
    p.add_argument("--max-len", type=int, default=None,
                   help="static per-example node cap (default: longest "
                        "session in the data)")
    p.add_argument("--split-len", type=str, default=None,
                   help="length-bucketed batches: comma-separated "
                        "ascending length thresholds (default '4,8'); 0 "
                        "disables")
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--order", type=int, default=None, help="MSGIFSR order")
    p.add_argument("--reducer", default=None, choices=["mean", "max", "concat"])
    p.add_argument("--no-norm", action="store_true",
                   help="NISER/MSGIFSR without the l2-normalised table and "
                        "session vectors")
    p.add_argument("--extra", action="store_true", help="MSGIFSR REnorm")
    p.add_argument("--fusion", action="store_true", help="MSGIFSR IFR")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--shuffle", action="store_true", default=None)
    p.add_argument("--no-shuffle", dest="shuffle", action="store_false")
    p.add_argument("--max-epoch-batches", type=int, default=None,
                   help="cap batches per epoch (smoke runs)")
    p.add_argument("--unroll", type=int, default=8,
                   help="optimizer steps per dispatch: on CUDA one captured "
                        "CUDA graph replays this many steps")
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--table-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="embedding-table storage dtype; bfloat16 keeps "
                        "float32 Adam moments and rounds the table's "
                        "updates stochastically")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save a checkpoint every epoch here (train), or "
                        "serve the latest one (predict)")
    p.add_argument("--resume", action="store_true",
                   help="resume training from the latest checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--metrics-file", default=None,
                   help="append train/eval events here as JSONL")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of training here")
    p.add_argument("--data-parallel", type=int, default=1)
    p.add_argument("--model-parallel", type=int, default=1,
                   help="catalog shards: the table is row-sharded over "
                        "this many ranks")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 in a launch that starts one "
                        "process per rank itself")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def build_config(args):
    from sessionrec_tpu_torch.utils.config import preset
    cfg = preset(args.model)
    m, d, t = cfg.model, cfg.data, cfg.train
    if args.embedding_dim is not None:
        m.embedding_dim = args.embedding_dim
    if args.num_layers is not None:
        m.num_layers = args.num_layers
    if args.feat_drop is not None:
        m.feat_drop = args.feat_drop
    if args.order is not None:
        m.order = args.order
    if args.reducer is not None:
        m.reducer = args.reducer
    if args.no_norm:
        m.norm = False
    m.extra = args.extra
    m.fusion = args.fusion
    m.compute_dtype = args.compute_dtype
    m.table_dtype = args.table_dtype
    d.dataset_dir = args.dataset_dir
    if args.batch_size is not None:
        d.batch_size = args.batch_size
    if args.shuffle is not None:
        d.shuffle_train = args.shuffle
    d.valid_split = args.valid_split
    if args.max_len is not None:
        d.max_len = args.max_len
    if args.split_len is not None:
        ts = tuple(int(x) for x in str(args.split_len).split(",")
                   if x.strip())
        ts = tuple(x for x in ts if x > 0)
        d.split_len = (ts if len(ts) > 1 else (ts[0] if ts else None))
    t.lr = args.lr
    t.epochs = args.epochs
    t.weight_decay = args.weight_decay
    if args.patience is not None:
        t.patience = args.patience
    t.log_interval = args.log_interval
    t.seed = args.seed
    t.device = args.device
    t.unroll = args.unroll
    t.checkpoint_dir = args.checkpoint_dir
    t.resume = args.resume
    t.metrics_file = args.metrics_file
    t.profile_dir = args.profile_dir
    t.data_parallel = args.data_parallel
    t.model_parallel = args.model_parallel
    return cfg


def _backend(device):
    return "gloo" if device == "cpu" else "nccl"


def _train(args, **kw):
    """``run_training`` as ``args`` say (``kw``: its further arguments);
    the primary prints the metrics."""
    from sessionrec_tpu_torch.parallel.multihost import is_primary
    from sessionrec_tpu_torch.train.session import run_training
    runner = run_training(build_config(args),
                          max_epoch_batches=args.max_epoch_batches, **kw)
    if is_primary():
        print("MRR@20\tHR@20")
        print(f"{runner.max_mrr * 100:.3f}%\t{runner.max_hit * 100:.3f}%")


def _mesh_worker(argv, rank, world, port):
    """One rank of a mesh that ``cmd_train`` started on this host."""
    import torch.distributed as dist
    from sessionrec_tpu_torch.parallel.multihost import initialize
    args = _parser().parse_args(argv)
    if args.device == "cpu":
        import os
        import torch
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    initialize(f"127.0.0.1:{port}", world, rank, _backend(args.device))
    try:
        _train(args)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_mesh(argv, args, world):
    """Run ``world`` ranks of the mesh on this host, one process each; a
    rank that fails stops the others."""
    if args.device != "cpu":
        import torch
        n = torch.cuda.device_count()
        if world > n:
            sys.exit(f"a mesh of {world} ranks needs a card per rank, but "
                     f"only {n} devices are visible (--device cpu runs it "
                     "on the CPU)")
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_mesh_worker, args=(argv, r, world, port))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            procs[0].join(timeout=1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        sys.exit(f"mesh ranks {failed} failed")


def cmd_train(args, argv):
    from sessionrec_tpu_torch.parallel.multihost import initialize
    world = args.data_parallel * args.model_parallel
    if initialize(args.coordinator, args.num_processes, args.process_id,
                  _backend(args.device)):
        import torch.distributed as dist
        try:
            _train(args, slice_batches=True)
        finally:
            dist.destroy_process_group()
    elif world > 1:
        _spawn_mesh(argv, args, world)
    else:
        _train(args)


def cmd_predict(args):
    """Serve top-k recommendations from a checkpoint (serving.py)."""
    from sessionrec_tpu_torch import serving
    from sessionrec_tpu_torch.data.io import (max_session_len, read_dataset,
                                              read_sessions)
    from sessionrec_tpu_torch.models import build_model

    if not args.checkpoint_dir:
        sys.exit("predict requires --checkpoint-dir (a directory written "
                 "by train --checkpoint-dir)")
    cfg = build_config(args)
    train_sessions, test_sessions, num_items = read_dataset(
        args.dataset_dir)
    sessions = (read_sessions(args.sessions_file) if args.sessions_file
                else test_sessions)
    max_len = cfg.data.max_len or max(max_session_len(train_sessions),
                                      max_session_len(test_sessions))
    model = serving.restore_params(build_model(cfg.model, num_items),
                                   args.checkpoint_dir, cfg.train.device)
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for sess, ids, scores in serving.recommend(
                model, sessions, max_len=max_len, k=args.k,
                batch_size=cfg.data.batch_size, method=args.topk_method,
                recall_target=args.recall_target, order=cfg.model.order,
                use_native=cfg.data.use_native_collate):
            out.write(json.dumps({"session": sess, "items": ids,
                                  "scores": [round(s, 4) for s in scores]})
                      + "\n")
    finally:
        if out is not sys.stdout:
            out.close()


def cmd_preprocess(args):
    from sessionrec_tpu_torch.data import preprocess as pp
    pp.run(args.dataset, args.input, args.output_dir)


def _parser():
    parser = argparse.ArgumentParser(prog="sessionrec_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    pt = sub.add_parser("train", help="train a model")
    _add_train_flags(pt)
    pp = sub.add_parser("preprocess", help="offline dataset preprocessing")
    pp.add_argument("--dataset", required=True,
                    choices=["diginetica", "gowalla", "lastfm", "yoochoose",
                             "yoochoose_stage1"])
    pp.add_argument("--input", required=True,
                    help="raw csv/dat file")
    pp.add_argument("--output-dir", required=True)
    pr = sub.add_parser(
        "predict", help="serve top-k recommendations from a checkpoint")
    _add_train_flags(pr)   # model geometry + --dataset-dir + --checkpoint-dir
    pr.add_argument("--sessions-file", default=None,
                    help="sessions to score, one comma-joined id list per "
                         "line (default: the dataset's test split)")
    pr.add_argument("--k", type=int, default=20)
    pr.add_argument("--output", default=None,
                    help="JSONL output path (default: stdout)")
    pr.add_argument("--topk-method", default="exact",
                    choices=["exact", "approx"],
                    help="exact = the stable top-k of lax.top_k; approx "
                         "is lax.approx_max_k in the JAX package, "
                         "approximate only on a TPU and exact elsewhere: "
                         "here the exact top-k, recall 1")
    pr.add_argument("--recall-target", type=float, default=0.95,
                    help="approx's recall target, in (0, 1]; the exact "
                         "top-k meets any")
    return parser


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.cmd == "train":
        cmd_train(args, argv)
    elif args.cmd == "predict":
        cmd_predict(args)
    elif args.cmd == "preprocess":
        cmd_preprocess(args)


if __name__ == "__main__":
    main()
