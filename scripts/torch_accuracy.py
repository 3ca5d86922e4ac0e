#!/usr/bin/env python3
"""Accuracy of a ``chip_smoke.py`` path over seeds on a card, with the
float32 ReLU readings of its end-of-epoch states.

    python scripts/torch_accuracy.py [--path o1_bf16] [--seeds 123 223 323]
        [--epochs 30] [--relu-every 0]

For each seed the path's configuration (``chip_smoke.path_config``: the
preset's widths, tiers (4, 8), the path's dtypes) on ``datasets/sample``
trains for ``--epochs`` epochs as ``cli train`` trains it (an eval each
epoch; MRR@20 and HR@20 their running maxima; early stop when both
worsen, train.py:118-123), then one ``accuracy`` line gives both and the
epochs run.  With ``--relu-every N``, every N-th epoch's end state and
the last one are read once more: one test batch's training forward and
backward on the card against the CPU (``chip_smoke.vs_cpu``) in float32
compute from the state's own table, one ``relu`` line with its
``relu_gap`` (each ``torch.relu`` input's largest card-CPU gap over its
call's largest, ``chip_smoke.RELU_GAP``'s reading) and ``relu_flips``.
Paths with a REnorm gate (the paper head) call ``torch.relu``; order 1
does not.  One JSON line each on stdout; exits 2 without a CUDA device.
"""

import argparse
import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class _EpochEnd:
    """Takes the runner's checkpointer's place: ``save`` runs at each
    epoch's end (with ``checkpoint_every`` 1) and calls ``fn(epoch,
    runner)`` on the epochs it is given, and on the last."""

    def __init__(self, fn, every, epochs):
        self.fn, self.every, self.epochs = fn, every, epochs

    def save(self, epoch, runner, metrics=None):
        last = epoch + 1 == self.epochs or runner.bad_counter == \
            runner.patience
        if (epoch + 1) % self.every == 0 or last:
            self.fn(epoch, runner)


def relu_reading(torch, cs, epoch, runner):
    """``chip_smoke.vs_cpu``'s ReLU readings of the runner's state, in
    float32 compute, on its first test batch."""
    model = copy.deepcopy(runner.model)
    model.compute_dtype = "float32"
    batch = next(iter(runner.test_loader)).to("cuda")
    errs, ok = cs.vs_cpu(torch, model, batch, ())
    cs.emit({"phase": "relu", "epoch": epoch, "relu_gap": errs["relu_gap"],
             "relu_flips": errs["relu_flips"], "loss_err": errs["loss"],
             "ok": ok})
    del model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", default="o1_bf16")
    ap.add_argument("--seeds", type=int, nargs="+", default=[123, 223, 323])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--relu-every", type=int, default=0)
    ap.add_argument("--dataset-dir", default=str(ROOT / "datasets" / "sample"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("torch_accuracy: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from sessionrec_tpu_torch.models import build_model
    from sessionrec_tpu_torch.train.runner import TrainRunner, set_precision
    from sessionrec_tpu_torch.train.session import make_loaders
    set_precision()
    smi = cs.phase_device(torch)
    for seed in args.seeds:
        cfg = cs.path_config(args.path, seed, args.dataset_dir,
                             epochs=args.epochs)
        t, m = cfg.train, cfg.model
        train, test, num_items, _ = make_loaders(cfg.data, m.name.lower(),
                                                 m.order)
        probe = None
        if args.relu_every:
            probe = _EpochEnd(lambda e, r: relu_reading(torch, cs, e, r),
                              args.relu_every, t.epochs)
        runner = TrainRunner(
            build_model(m, num_items), train, test, lr=t.lr,
            weight_decay=t.weight_decay, patience=t.patience, seed=t.seed,
            cutoff=t.cutoff, lr_step_size=t.lr_step_size,
            lr_gamma=t.lr_gamma, eval_before_train=t.eval_before_train,
            checkpointer=probe, checkpoint_every=1, unroll=t.unroll,
            device="cuda")
        mrr, hit = runner.train(t.epochs, t.log_interval)
        cs.emit({"phase": "accuracy", "path": args.path, "seed": seed,
                 "mrr20": mrr, "hr20": hit, "epochs": runner.epoch,
                 "card": smi})
        del runner
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
