"""Parity of the port's mesh-sharded bitmask SpMM
(dgl_tpu_torch/parallel/bitspmd.py) with the JAX package's on identical
inputs.

The builders (host and device) must emit exactly the JAX builder's arrays.
``bit_sharded_spmm`` runs on 4 gloo ranks (``torch_ranks.spmm_ranks``,
spawned once for the module) and is held to the JAX one on a 4-device CPU
mesh, whose K1 runs in Pallas interpret mode with f32 operands: forward
and gradient at rtol 1e-5 / atol 1e-5 (f32 sums of at most a few dozen
terms in another order), the GCN train step of ``tests/test_bitspmd.py``
for 15 Adam steps at rtol 1e-4 on every loss and rtol 1e-4 / atol 1e-5
on the final weights: Adam moves a weight by about lr = 2e-2 a step
whatever the size of its gradient, so the sums' last bits in a small
gradient move it by a few 1e-6.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dgl_tpu.parallel import bitspmd as jbs
from dgl_tpu_torch.parallel import bitspmd as tbs
from dgl_tpu_torch.parallel import comm

import torch_ranks as tr

FIELDS = ("shards", "shards_rev", "rem_src_g", "rem_dst_l", "rem_w",
          "brem_src_g", "brem_dst_l", "brem_w")


def _mesh():
    return Mesh(np.array(jax.devices()[:tr.WORLD]), ("data",))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What the 4 gloo ranks of ``spmm_ranks`` computed."""
    path = os.path.join(tmp_path_factory.mktemp("spmm"), "ranks.npz")
    comm.run_ranks(tr.spmm_ranks, tr.WORLD, "cpu", path)
    with np.load(path) as res:
        return {k: res[k] for k in res.files}


def _multi_case(symmetric, n=300, e=2500, seed=13):
    rng = np.random.default_rng(seed)
    row, col = tr.rand_graph(rng, n, e, symmetric)
    row[:30], col[:30] = row[30:60], col[30:60]   # multi-edges
    if symmetric:
        row[e // 2:e // 2 + 30] = col[30:60]
        col[e // 2:e // 2 + 30] = row[30:60]
    return row, col, n


@pytest.mark.parametrize("parts", [1, 2, 4, 3])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("builder", ["host", "device"])
def test_builders_match_jax(builder, symmetric, parts):
    row, col, n = _multi_case(symmetric)
    want = jbs.build_bit_sharded_format(row, col, n, parts,
                                        symmetric=symmetric)
    build = (tbs.build_bit_sharded_format if builder == "host"
             else tbs.build_bit_sharded_format_device)
    got = build(row, col, n, parts, symmetric=symmetric, device="cpu")
    for name in FIELDS:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in ("num_nodes", "num_parts", "npp", "kp", "symmetric",
                 "has_remainder", "bytes_per_device"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.has_remainder
    assert (got.shards_rev is got.shards) == symmetric


def test_device_builder_simple_graph():
    """``assume_simple`` skips the host pass: the same shards, no
    remainder."""
    rng = np.random.default_rng(2)
    key = np.unique(rng.integers(0, 700, 5000) * 700
                    + rng.integers(0, 700, 5000))
    row, col = key % 700, key // 700
    want = jbs.build_bit_sharded_format(row, col, 700, 2)
    got = tbs.build_bit_sharded_format_device(row, col, 700, 2,
                                              assume_simple=True,
                                              device="cpu")
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert not got.has_remainder


def test_shard_format_and_layout():
    row, col, n = _multi_case(False)
    fmt = tbs.build_bit_sharded_format(row, col, n, 4, device="cpu")
    view = tbs.shard_format(fmt, 2, "cpu")
    assert view.shards.shape == (1, fmt.kp, fmt.npp // 32)
    torch.testing.assert_close(view.shards[0], fmt.shards[2], rtol=0,
                               atol=0)
    torch.testing.assert_close(view.brem_w[0], fmt.brem_w[2], rtol=0, atol=0)
    x = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
    xp = tbs.pad_nodes(fmt, x)
    assert xp.shape == (4 * fmt.npp, 3) and not xp[n:].any()
    torch.testing.assert_close(tbs.local_rows(fmt, xp, 0)[:n], x)
    deg = tbs.sharded_in_degrees(fmt, row, col, device="cpu")
    want = jbs.sharded_in_degrees(fmt, row, col, _mesh())
    np.testing.assert_array_equal(deg.numpy(), np.asarray(want))


def test_collectives_need_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        comm.all_gather_rows(torch.zeros(2, 3))
    with pytest.raises(RuntimeError, match="process group"):
        comm.reduce_scatter_rows(torch.zeros(4, 3))


def _jax_spmm(symmetric):
    """(out, d/dx of (out^2).sum()) of the JAX op on a 4-device mesh."""
    row, col, n, x = tr.spmm_case(symmetric)
    mesh = _mesh()
    fmt = jbs.shard_format(jbs.build_bit_sharded_format(
        row, col, n, tr.WORLD, symmetric=symmetric), mesh)
    xp = jax.device_put(jbs.pad_nodes(fmt, jnp.asarray(x)),
                        NamedSharding(mesh, P("data")))

    def loss(xp):
        out = jbs.bit_sharded_spmm(fmt, xp, mesh, "data")
        return (out ** 2).sum(), out

    (_, out), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(xp)
    return np.asarray(out), np.asarray(grad)


@pytest.mark.parametrize("symmetric", [True, False])
def test_sharded_spmm_matches_jax(ranks, symmetric):
    out, grad = _jax_spmm(symmetric)
    np.testing.assert_allclose(ranks[f"out_{symmetric}"], out, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ranks[f"grad_{symmetric}"], grad, rtol=1e-5,
                               atol=1e-5)
    n = tr.spmm_case(symmetric)[2]
    assert not ranks[f"out_{symmetric}"][n:].any()


def test_sharded_gcn_train_step_matches_jax(ranks):
    """tests/test_bitspmd.py::test_bit_sharded_train_step on 4 devices
    against the same step on 4 gloo ranks."""
    row, col, n, x_np, y_np, w1, w2 = tr.gcn_case()
    mesh = _mesh()
    fmt = jbs.shard_format(jbs.build_bit_sharded_format(
        row, col, n, tr.WORLD, symmetric=True), mesh)
    sh = NamedSharding(mesh, P("data"))
    x = jax.device_put(jbs.pad_nodes(fmt, jnp.asarray(x_np)), sh)
    y = jax.device_put(jbs.pad_nodes(
        fmt, jnp.asarray(y_np)[:, None])[:, 0], sh)
    mask = jax.device_put(jbs.pad_nodes(
        fmt, jnp.ones((n, 1), jnp.float32))[:, 0], sh)
    deg = jnp.maximum(jbs.sharded_in_degrees(fmt, row, col, mesh),
                      1.0)[:, None]
    params = {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)}
    tx = optax.adam(2e-2)
    opt = tx.init(params)

    @jax.jit
    def step(p, o):
        def loss_fn(p):
            h = jax.nn.relu(jbs.bit_sharded_spmm(fmt, x @ p["w1"], mesh,
                                                 "data") / deg)
            logits = jbs.bit_sharded_spmm(fmt, h, mesh,
                                          "data") / deg @ p["w2"]
            ls = optax.softmax_cross_entropy_with_integer_labels(logits, y)
            return (ls * mask).sum() / mask.sum()
        l, g = jax.value_and_grad(loss_fn)(p)
        up, o = tx.update(g, o)
        return optax.apply_updates(p, up), o, l

    losses = []
    for _ in range(tr.GCN_STEPS):
        params, opt, l = step(params, opt)
        losses.append(float(l))
    np.testing.assert_allclose(ranks["gcn_losses"], losses, rtol=1e-4)
    assert ranks["gcn_losses"][-1] < ranks["gcn_losses"][0] * 0.8
    for name in ("w1", "w2"):
        np.testing.assert_allclose(ranks[f"gcn_{name}"],
                                   np.asarray(params[name]), rtol=1e-4,
                                   atol=1e-5)
