"""Command line of the port.

    python -m sessionrec_tpu_torch.cli train --model msgifsr --order 1 \
        --dataset-dir datasets/sample
    python -m sessionrec_tpu_torch.cli train --model msgifsr --order 3 \
        --extra --fusion                       # the WSDM'22 paper head

Flag names and defaults follow ``sessionrec_tpu/cli.py train`` (the
reference scripts' surface, see utils/config.py) for the flags this slice
runs, plus ``--device`` (default ``cuda``; the CPU must be asked for).
"""

from __future__ import annotations

import argparse


def _add_train_flags(p):
    p.add_argument("--model", required=True, choices=["msgifsr"])
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
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")


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
    m.extra = args.extra
    m.fusion = args.fusion
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
    return cfg


def cmd_train(args):
    from sessionrec_tpu_torch.train.session import run_training
    cfg = build_config(args)
    runner = run_training(cfg, max_epoch_batches=args.max_epoch_batches)
    print("MRR@20\tHR@20")
    print(f"{runner.max_mrr * 100:.3f}%\t{runner.max_hit * 100:.3f}%")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="sessionrec_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    pt = sub.add_parser("train", help="train a model")
    _add_train_flags(pt)
    args = parser.parse_args(argv)
    if args.cmd == "train":
        cmd_train(args)


if __name__ == "__main__":
    main()
