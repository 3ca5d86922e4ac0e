"""The port's trainer against the JAX package's: from the same converted
parameters, with feat_drop 0 and the same batches, three optimizer steps
give the same losses (rtol 1e-4) and parameters (atol 1e-5), with the
StepLR drop on the same step, at order 1 and for the order-3 paper head;
the CLI trains on the CPU; the package imports nothing of JAX."""

import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sessionrec_tpu.data.loader import BatchLoader as JLoader
from sessionrec_tpu.train.optim import make_optimizer as j_make_optimizer
from sessionrec_tpu.train.runner import make_train_step
from sessionrec_tpu_torch import cli
from sessionrec_tpu_torch.convert import params_from_jax
from sessionrec_tpu_torch.data.loader import BatchLoader as TLoader
from sessionrec_tpu_torch.train import optim as t_optim
from sessionrec_tpu_torch.train.runner import TrainRunner, resolve_device

from test_torch_model import PAPER, _sessions, make_pair

REPO = pathlib.Path(__file__).resolve().parent.parent
STEPS = 3
LR, WD = 5e-3, 1e-4
# Adam's first step is about lr * g / (|g| + eps): a gradient element near
# eps = 1e-8, where the two frameworks' float32 sums differ in their last
# bits, moves by a different share of lr.  The paper head has such
# elements (readouts of orders 2 and 3), so it runs at the preset's lr
# 1e-3, where that share stays inside the parameters' atol 1e-5.
PAPER_LR = 1e-3


def _three_steps_match_jax(kw, lr):
    jm, jp, tm = make_pair(seed=5, **kw)
    order = kw.get("order", 1)
    sess = _sessions(2, n=120)
    jl = JLoader(sess, "ccs", 32, 11, use_native=False, prefetch=0,
                 split_len=(4, 8), order=order)
    tl = TLoader(sess, "ccs", 32, 11, prefetch=0, split_len=(4, 8),
                 device="cpu", order=order)
    jbs, tbs = list(jl)[:STEPS], list(tl)[:STEPS]
    start = params_from_jax(jax.device_get(jp))

    # one step per "epoch" and a drop every epoch: the LR changes at each
    # step, so a schedule that counts differently shows in the params
    sched = dict(steps_per_epoch=1, lr_step_size=1, lr_gamma=0.5)
    tx = j_make_optimizer(jp, lr, WD, **sched)
    opt_state = tx.init(jp)
    step = make_train_step(jm, tx)
    jlosses = []
    for b in jbs:
        jp, _, opt_state, loss = step(jp, {}, opt_state, b,
                                      jax.random.PRNGKey(0))
        jlosses.append(float(loss))

    runner = TrainRunner(tm, tbs[:1], [], lr=lr, weight_decay=WD,
                         device="cpu", lr_step_size=1, lr_gamma=0.5)
    tm.load_state_dict(start)        # the runner drew its own init
    tlosses = [float(runner.train_step(b)) for b in tbs]

    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    want = params_from_jax(jax.device_get(jp))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)
    assert float(runner.sched.lr) == pytest.approx(lr * 0.5 ** STEPS)


def test_three_steps_match_jax():
    _three_steps_match_jax(dict(), LR)


def test_paper_head_three_steps_match_jax():
    _three_steps_match_jax(PAPER, PAPER_LR)


def test_no_decay_groups_follow_the_jax_mask():
    _, _, tm = make_pair()
    names = {n for n, _ in tm.named_parameters() if not t_optim.decays(n)}
    assert names == {"layers.0.conv1.intra1.bias", "layers.0.conv1.inter.bias",
                     "layers.0.conv2.intra1.bias", "layers.0.conv2.inter.bias",
                     "readout.fc_u.0.bias", "sc_sr.0.l1.bias"}


def _cli_train_on_cpu(capsys, flags):
    cli.main(["train", "--model", "msgifsr", *flags, "--device", "cpu",
              "--embedding-dim", "32", "--max-epoch-batches", "2",
              "--epochs", "1", "--dataset-dir",
              str(REPO / "datasets" / "sample")])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-2] == "MRR@20\tHR@20"
    mrr, hit = (float(x.rstrip("%")) for x in out[-1].split("\t"))
    assert 0.0 <= mrr <= hit <= 100.0


def test_cli_train_on_cpu(capsys):
    _cli_train_on_cpu(capsys, ["--order", "1"])


def test_cli_trains_the_paper_head_on_cpu(capsys):
    _cli_train_on_cpu(capsys, ["--order", "3", "--extra", "--fusion"])


def test_cuda_device_is_not_silently_replaced():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            resolve_device("cuda")


@pytest.mark.parametrize("option", [
    dict(table_dtype="float16"), dict(compute_dtype="float8_e4m3fn"),
    dict(tensor_parallel=4), dict(pipeline_parallel=2)])
def test_preset_refuses_options_the_port_does_not_run(option):
    """Fields neither package has raise (unknown fields); the dtypes are
    taken for float32 and bfloat16 only, as the JAX package's flags."""
    from sessionrec_tpu_torch.utils.config import preset
    dtype = next(iter(option)).endswith("_dtype")
    with pytest.raises(ValueError if dtype else KeyError,
                       match="must be one of" if dtype
                       else "unknown config field"):
        preset("msgifsr", order=1, **option)
    with pytest.raises(KeyError):
        preset("gru4rec")


def test_preset_takes_the_mesh_sizes():
    """``data_parallel`` and ``model_parallel`` are the JAX package's
    fields (a mesh of their product of ranks, parallel/mesh.py)."""
    from sessionrec_tpu_torch.utils.config import preset
    t = preset("msgifsr", order=1, data_parallel=4, model_parallel=2).train
    assert (t.data_parallel, t.model_parallel) == (4, 2)


def test_non_finite_loss_aborts():
    _, _, tm = make_pair()
    runner = TrainRunner(tm, [None], [], device="cpu")
    with pytest.raises(FloatingPointError):
        runner._drain_losses([torch.tensor(1.0), torch.tensor(float("nan"))])


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sessionrec_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "importlib.import_module('chip_smoke')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'sessionrec_tpu'))\n"
        "print(len([k for k in sys.modules if k.startswith(p.__name__)]))\n"
        "sys.exit(f'imported {bad}' if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20
