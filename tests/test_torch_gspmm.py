"""Parity of the port's g-SpMM (dgl_tpu_torch/ops/gspmm.py) with the JAX
package's on the CPU: every op x reduce on the gather path, and the
kernel route for graphs that carry a bit format.  Tolerance rtol 1e-5 /
atol 1e-5: f32 sums in another order."""
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu as dgl
import dgl_tpu_torch as dgt
import dgl_tpu_torch.ops.kernels.bitmm as tbm
from dgl_tpu.ops import gspmm as jgspmm
from dgl_tpu_torch.ops import gspmm as tgspmm
from dgl_tpu_torch.utils import config

RTOL, ATOL = 1e-5, 1e-5
OPS = ["add", "sub", "mul", "div", "copy_lhs", "copy_rhs"]
REDUCES = ["sum", "max", "min", "mean"]


def _case(seed=0, n=60, e=500, f=5):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, e)
    col = rng.integers(0, n - 5, e)     # 5 nodes with no in-edge
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (rng.uniform(0.5, 1.5, size=(e, f)).astype(np.float32)
         * rng.choice([-1, 1], size=(e, f)).astype(np.float32))
    w = rng.normal(size=(n, f)).astype(np.float32)   # output cotangent
    return row, col, n, x, y, w


def _jax_run(row, col, n, op, red, x, y, w):
    g = dgl.graph((row, col), num_nodes=n)

    def f(x, y):
        return jgspmm(g, op, red, x, y)

    out = f(jnp.asarray(x), jnp.asarray(y))
    gx, gy = jax.grad(lambda a, b: (f(a, b) * w).sum(), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    return np.asarray(out), np.asarray(gx), np.asarray(gy)


def _torch_run(g, op, red, x, y, w):
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    out = tgspmm(g, op, red, xt, yt)
    (out * torch.from_numpy(w)).sum().backward()
    gx = xt.grad if xt.grad is not None else torch.zeros_like(xt)
    gy = yt.grad if yt.grad is not None else torch.zeros_like(yt)
    return out.detach().numpy(), gx.numpy(), gy.numpy()


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("red", REDUCES)
def test_gspmm_gather_path_matches(op, red):
    row, col, n, x, y, w = _case()
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    want = _jax_run(row, col, n, op, red, x, y, w)
    got = _torch_run(g, op, red, x, y, w)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    # zero in-degree -> 0 for every reduce
    assert np.all(got[0][n - 5:] == 0)


def test_gspmm_broadcasts_edge_scalars():
    row, col, n, x, y, w = _case(1)
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    ye = y[:, 0]
    want = jgspmm(dgl.graph((row, col), num_nodes=n), "mul", "sum",
                  jnp.asarray(x), jnp.asarray(ye))
    got = tgspmm(g, "mul", "sum", torch.from_numpy(x), torch.from_numpy(ye))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(ValueError):
        tgspmm(g, "dot", "sum", torch.from_numpy(x), None)


@pytest.mark.parametrize("red", ["sum", "mean"])
@pytest.mark.parametrize("f", [16, 120])
def test_gspmm_bit_route_matches(red, f, monkeypatch):
    """With a bit format and a lowered min-edges gate, copy_lhs sum/mean
    take the bit route (the kernels' plain versions on the CPU)."""
    rng = np.random.default_rng(f)
    n, e = 400, 5000
    row, col = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=(n, f)).astype(np.float32)
    gj = dgl.graph((row, col), num_nodes=n)
    out_j, vjp = jax.vjp(lambda v: jgspmm(gj, "copy_lhs", red, v, None),
                         jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(w))
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    g.unit().create_bitmask_format()
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    spy = mock.patch.object(tbm, "bit_spmm", wraps=tbm.bit_spmm)
    with spy as called:
        xt = torch.from_numpy(x).requires_grad_()
        out = tgspmm(g, "copy_lhs", red, xt, None)
        out.backward(torch.from_numpy(w))
    assert called.call_count == 1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=RTOL,
                               atol=1e-4)
    # below the gate, or with the kernels off, the gather path runs
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", e + 1)
    with mock.patch.object(tbm, "bit_spmm", wraps=tbm.bit_spmm) as called:
        tgspmm(g, "copy_lhs", red, torch.from_numpy(x), None)
        monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
        config.set_use_kernels(False)
        try:
            gathered = tgspmm(g, "copy_lhs", red, torch.from_numpy(x), None)
        finally:
            config.set_use_kernels(True)
    assert called.call_count == 0
    np.testing.assert_allclose(gathered.numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=1e-4)


def test_update_all_builtins():
    row, col, n, x, y, w = _case(2)
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    g.ndata["h"] = torch.from_numpy(x)
    g.edata["w"] = torch.from_numpy(y)
    fn = dgt.function
    out = dgt.update_all(g, fn.u_mul_e("h", "w", "m"), fn.max("m", "o"))
    np.testing.assert_allclose(
        out["o"].numpy(), tgspmm(g, "mul", "max", g.ndata["h"],
                                 g.edata["w"]).numpy())
    g.update_all(fn.copy_u("h", "m"), fn.mean("m", "o"))
    gj = dgl.graph((row, col), num_nodes=n)
    np.testing.assert_allclose(
        g.ndata["o"].numpy(),
        np.asarray(jgspmm(gj, "copy_lhs", "mean", jnp.asarray(x), None)),
        rtol=RTOL, atol=ATOL)
    with pytest.raises(NotImplementedError):
        dgt.update_all(g, lambda edges: {}, fn.sum("m", "o"))
