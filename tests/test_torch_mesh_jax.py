"""Three training steps of the port's (2, 2) mesh against the JAX
package's ``make_train_step(model, tx, mesh=mesh)`` on 4 of the
conftest's 8 virtual CPU devices (the setup of
tests/test_runner_sharded.py): MSGIFSR order 1, d 32, on 600 items (1,024
rows: the second shard holds 88 real rows), batches of 32 with the (4, 8)
tiers, from the same converted parameters, feat_drop 0 (the JAX package
draws its dropout masks from PRNG keys, the port from a counter hash).
Losses to rtol 1e-4 and parameters to atol 1e-5, as
tests/test_torch_train.py holds the one-device step; the JAX side runs
while the port's 4 gloo processes (``_torch_mesh_worker.py``
``jax_train``) do."""

import pickle
import threading

import jax
import numpy as np
import torch

import _torch_mesh_worker as W
from sessionrec_tpu.data.loader import BatchLoader as JLoader
from sessionrec_tpu.parallel.mesh import make_mesh
from sessionrec_tpu.parallel.sharded import (init_opt_state, place_batch,
                                             place_params)
from sessionrec_tpu.train.optim import make_optimizer as j_make_optimizer
from sessionrec_tpu.train.runner import make_train_step
from sessionrec_tpu_torch.convert import params_from_jax
from test_torch_model import _sessions, make_pair

NUM_ITEMS, DIM, LR = 600, 32, 5e-3


def test_three_mesh_steps_match_jax(tmp_path):
    jm, jp, _ = make_pair(seed=5, num_items=NUM_ITEMS, dim=DIM)
    sess = _sessions(2, n=120)
    torch.save(params_from_jax(jax.device_get(jp)), tmp_path / "jax_start.pt")
    with open(tmp_path / "jax_sessions.pkl", "wb") as f:
        pickle.dump((sess, NUM_ITEMS, DIM, LR), f)
    port = {}
    worker = threading.Thread(target=lambda: port.update(
        res=W.spawn("jax_train", tmp_path, 2, 2)[0]))
    worker.start()

    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    batches = list(JLoader(sess, "ccs", 32, 11, use_native=False,
                           prefetch=0, split_len=(4, 8)))[:W.TRAIN_STEPS]
    tx = j_make_optimizer(jp, LR, 1e-4, steps_per_epoch=1, lr_step_size=1,
                          lr_gamma=0.5)
    jp = place_params(mesh, jp)
    opt_state = init_opt_state(mesh, tx, jp)
    step = make_train_step(jm, tx, mesh=mesh)
    jlosses = []
    for b in batches:
        jp, _, opt_state, loss = step(jp, {}, opt_state,
                                      place_batch(mesh, b),
                                      jax.random.PRNGKey(0))
        jlosses.append(float(loss))
    want = params_from_jax(jax.device_get(jp))

    worker.join(timeout=600)
    assert "res" in port, "the mesh's ranks did not finish"
    for rank, r in enumerate(port["res"]):
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-4)
        m = rank % 2
        for name, w in want.items():
            w = w.numpy()
            if name == "embedding":
                w = w[m * len(w) // 2:(m + 1) * len(w) // 2]
            np.testing.assert_allclose(r["state"][name], w, atol=1e-5,
                                       err_msg=f"rank {rank} {name}")
