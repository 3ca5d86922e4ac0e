"""The port's mesh functions against the JAX package's, on a (2, 2) mesh.

The port runs as 4 gloo processes on the CPU (``_torch_mesh_worker.py``
``ops``, started once for the file), the JAX package on 4 of the
conftest's 8 virtual CPU devices, from the same numpy inputs: a catalog
of 900 items padded to 1,024 rows, so the second model shard holds 388
real rows of 512, with an exact tie across the shard cut.  Each rank is
held against its rows of the JAX result (data position d: batch rows
``[8 d, 8 d + 8)``; model position m: table rows ``[512 m, 512 m +
512)``):

* ``fused_nll_loss_sharded`` (normalised table and not) and
  ``fused_multi_loss_sharded`` (order 3, REnorm, fusion): the loss to
  rtol 1e-5, every gradient to atol 5e-5, as the single-device parity
  tests hold them; the table's gradient summed over the data group;
* ``sharded_lookup``: the rows exactly, the table's gradient to 5e-5;
* the rankers (``sharded_head_count_ranks``, ``sharded_multi_count_ranks``,
  ``sharded_topk``, ``sharded_count_ranks``, and the multi head's per-shard
  top-k with gathered candidates against the JAX counting ranks): equal
  ranks, the cross-shard tie included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_worker as W
from sessionrec_tpu.parallel import sharded as JS
from sessionrec_tpu.parallel.lookup import sharded_lookup
from sessionrec_tpu.parallel.mesh import make_mesh

DP = MP = 2
GRAD_ATOL = 5e-5
PER_B, PER_P = W.OPS_B // DP, W.OPS_ROWS // MP


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return W.spawn("ops", tmp_path_factory.mktemp("mesh_ops"), DP, MP)[0]


@pytest.fixture(scope="module")
def jax_side():
    x = {k: jnp.asarray(v) for k, v in W.op_inputs().items()}
    return make_mesh(data=DP, model=MP, devices=jax.devices()[:DP * MP]), x


@pytest.fixture(scope="module")
def jax_multi_ranks(jax_side):
    """The JAX multi head's counting ranks, which both of the port's
    multi-head rankers must give."""
    mesh, x = jax_side
    return np.asarray(JS.sharded_multi_count_ranks(
        mesh, x["srk"], x["table"], x["labels"], x["iids"], x["phi"],
        x["alpha"], num_items=W.OPS_ITEMS, extra=True, fusion=True,
        k=W.TOPK, scale=12.0, normalize_table=True))


def _ranks():
    """(rank, data rows, table rows) of every rank of the mesh."""
    for r in range(DP * MP):
        d, m = divmod(r, MP)
        yield (r, slice(d * PER_B, (d + 1) * PER_B),
               slice(m * PER_P, (m + 1) * PER_P))


def _jax_nll(jax_side, norm):
    mesh, x = jax_side

    def loss(sr, table):
        return JS.fused_nll_loss_sharded(
            mesh, sr, table, x["labels"], x["valid"], scale=12.0,
            num_items=W.OPS_ITEMS, normalize_table=norm)
    val, (dsr, dtab) = jax.value_and_grad(loss, argnums=(0, 1))(
        x["sr"], x["table"])
    return dict(loss=float(val), dsr=np.asarray(dsr), dtab=np.asarray(dtab))


def _jax_multi(jax_side):
    mesh, x = jax_side

    def loss(sr, table, phi, alpha):
        return JS.fused_multi_loss_sharded(
            mesh, sr, table, x["labels"], x["valid"], x["iids"], phi, alpha,
            scale=12.0, num_items=W.OPS_ITEMS, normalize_table=True,
            extra=True, fusion=True)
    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
        x["srk"], x["table"], x["phi"], x["alpha"])
    return dict(loss=float(val), **{k: np.asarray(g) for k, g in zip(
        ("dsr", "dtab", "dphi", "dalpha"), grads)})


@pytest.mark.parametrize("case", ["nll_norm1", "nll_norm0", "multi"])
def test_sharded_losses_match_jax(port, jax_side, case):
    want = (_jax_multi(jax_side) if case == "multi"
            else _jax_nll(jax_side, case == "nll_norm1"))
    for r, rows, trows in _ranks():
        got = port[r][case]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["dsr"], want["dsr"][rows],
                                   atol=GRAD_ATOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["dtab"], want["dtab"][trows],
                                   atol=GRAD_ATOL, err_msg=f"rank {r}")
        if case == "multi":
            np.testing.assert_allclose(got["dphi"], want["dphi"][rows],
                                       atol=GRAD_ATOL)
            np.testing.assert_allclose(got["dalpha"], want["dalpha"],
                                       atol=GRAD_ATOL)


def test_sharded_lookup_matches_jax(port, jax_side):
    mesh, x = jax_side
    rows, vjp = jax.vjp(lambda t: sharded_lookup(mesh, t, x["ids"]),
                        x["table"])
    (dtab,) = vjp(x["g"])
    for r, brows, trows in _ranks():
        got = port[r]["lookup"]
        np.testing.assert_array_equal(got["rows"], np.asarray(rows)[brows])
        np.testing.assert_allclose(got["dtab"], np.asarray(dtab)[trows],
                                   atol=GRAD_ATOL)


def _masked_logits(x):
    t = x["table"] / jnp.maximum(
        jnp.linalg.norm(x["table"], axis=-1, keepdims=True), 1e-12)
    logits = x["sr"] @ t.T
    return jnp.where(jnp.arange(W.OPS_ROWS) < W.OPS_ITEMS, logits,
                     -jnp.inf)


def _jax_ranks(jax_side, case):
    mesh, x = jax_side
    if case == "head_count":
        return JS.sharded_head_count_ranks(
            mesh, x["sr"], x["table"], x["labels"], W.TOPK,
            num_items=W.OPS_ITEMS, normalize_table=True)
    scores = _masked_logits(x)
    if case == "count_scores":
        return JS.sharded_count_ranks(mesh, scores, x["labels"], W.TOPK)
    _, idx = JS.sharded_topk(mesh, scores, W.TOPK)
    hit = idx == x["labels"][:, None]
    return jnp.where(jnp.any(hit, -1), jnp.argmax(hit, -1) + 1, 0)


@pytest.mark.parametrize("case", ["head_count", "multi_count", "head_topk",
                                  "count_scores", "multi_topk"])
def test_sharded_ranks_match_jax(port, jax_side, jax_multi_ranks, case):
    want = (jax_multi_ranks if case.startswith("multi")
            else np.asarray(_jax_ranks(jax_side, case)))
    # the cross-shard tie: label 700 ranks after its copy, item 100
    assert want[1] == want[0] + 1
    assert (want > 0).sum() >= 4
    for r, rows, _ in _ranks():
        np.testing.assert_array_equal(port[r][case], want[rows],
                                      err_msg=f"rank {r}")
