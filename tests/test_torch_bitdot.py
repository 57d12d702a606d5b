"""Parity of the port's bit-masked dot-product attention
(dgl_tpu_torch/ops/kernels/bitdot.py, K7) and of ``DotGatConv``'s route
onto it with the JAX package on identical inputs.

Tolerances:
* the plain versions against a float64 oracle over the COO (the K7
  contract: scores clipped to +-40 with a gradient of 0 at saturated
  scores, no max subtraction): rtol 1e-4 / atol 1e-5;
* against JAX's K7, whose Pallas kernels run in interpret mode with f32
  operands off the TPU (``bitmm._op_dtype``), on the same bit arrays:
  out and l rtol 1e-5 / atol 1e-5, dz and dq rtol 1e-4 / atol 1e-5 (f32
  on both sides; the TPU kernels sum plane by plane, the plain versions
  edge by edge);
* ``DotGatConv`` and three Adam steps against the JAX module on K7: rtol
  1e-4 / atol 1e-5, the dense projections also taken in another order.
"""
import math
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dgl_tpu as dgl
import dgl_tpu.ops.pallas.bitdot as jbd
import dgl_tpu.ops.pallas.bitmm as jbm
import dgl_tpu_torch as dgt
import dgl_tpu_torch.ops.kernels.bitdot as tbd
import dgl_tpu_torch.ops.kernels.bitgat as tbg
import dgl_tpu_torch.ops.kernels.bitmm as tbm
from dgl_tpu import nn as jnn
from dgl_tpu.utils import config as jconfig
from dgl_tpu_torch.params import dotgatconv_state_dict
from dgl_tpu_torch.utils import config
from test_torch_gat_fused import _routes

ORACLE = dict(rtol=1e-4, atol=1e-5)
FWD = dict(rtol=1e-5, atol=1e-5)
BWD = dict(rtol=1e-4, atol=1e-5)
MODULE = dict(rtol=1e-4, atol=1e-5)
N_SRC, N_DST, E = 300, 220, 4000


def _simple_graph(rng, n_src, n_dst, e, no_in=0):
    """Deduplicated random edges; the last ``no_in`` dst have none."""
    row = rng.integers(0, n_src, e)
    col = rng.integers(0, n_dst - no_in, e)
    key = np.unique(col.astype(np.int64) * n_src + row)
    return key % n_src, key // n_src


def _inputs(seed, n_src, n_dst, heads, dim, saturate=False):
    """q, z on a grid of 1/16 in [-1, 1] and a cotangent w.  The scores
    (z . q) / sqrt(D) are then exact in f32 at D = 64 (isd = 1/8), so both
    sides clip the same edges.  ``saturate`` makes z positive and sets
    every eighth row of q to +c or -c in every column, with c such that
    about half of those rows' scores lie past +40 or -40; the other
    scores stay a few units wide."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-16, 17, (n_dst, heads, dim)) / 16
    z = rng.integers(-16, 17, (n_src, heads, dim)) / 16
    if saturate:
        z = np.abs(z) + 1 / 16                  # mean 0.5625
        c = round(40 / (0.5625 * math.sqrt(dim)) * 16) / 16
        q[::16], q[8::16] = c, -c
    w = rng.normal(size=(n_dst, heads, dim))
    return (q.astype(np.float32), z.astype(np.float32),
            w.astype(np.float32))


def _port(row, col, n_src, n_dst, q, z, w):
    """(out, l, dq, dz) of the loss sum(out * w) through the port on the
    CPU (the plain versions, through the wrappers and ``_BitDot``)."""
    bf = tbm.build_bit_format(row, col, n_src, n_dst, device="cpu")
    qt, zt = (torch.from_numpy(a).requires_grad_() for a in (q, z))
    out = tbd.bitdot_attention_aggregate(bf, qt, zt)
    (out * torch.from_numpy(w)).sum().backward()
    l = tbd.bitdot_fwd_plain(bf.packed, qt.detach(), zt.detach(),
                             1 / math.sqrt(q.shape[2]))[1]
    return out.detach().numpy(), l.numpy(), qt.grad.numpy(), zt.grad.numpy()


def _oracle(row, col, n_dst, q, z, w, clip_grad=True):
    """(out, l, dq, dz) in float64 over the COO by autograd; the clip's
    gradient is 0 at |e| >= 40, as in the JAX kernels, or passes
    everywhere without ``clip_grad``."""
    q64, z64 = (torch.from_numpy(a).double().requires_grad_() for a in (q, z))
    src, dst = torch.from_numpy(row), torch.from_numpy(col)
    e = (z64[src] * q64[dst]).sum(-1) / math.sqrt(q.shape[2])
    clipped = e.detach().clamp(-40, 40)
    e = (torch.where(e.abs() < 40, e, clipped) if clip_grad
         else e - e.detach() + clipped)
    p = e.exp()
    l = torch.zeros(n_dst, q.shape[1], dtype=torch.float64).index_add(
        0, dst, p)
    num = torch.zeros(q64.shape, dtype=torch.float64).index_add(
        0, dst, p.unsqueeze(-1) * z64[src])
    out = num / l.clamp(min=1e-20).unsqueeze(-1)
    (out * torch.from_numpy(w).double()).sum().backward()
    return (out.detach().numpy(), l.detach().numpy(), q64.grad.numpy(),
            z64.grad.numpy())


def _assert_close(got, want, tols=(ORACLE,) * 4):
    for name, a, b, tol in zip(("out", "l", "dq", "dz"), got, want, tols):
        np.testing.assert_allclose(a, b, err_msg=name, **tol)


# -- the plain versions against a float64 oracle -----------------------------

@pytest.mark.parametrize("heads,dim", [(2, 64), (3, 8), (1, 128), (2, 5)])
@pytest.mark.parametrize("saturate", [False, True])
def test_plain_matches_oracle_bipartite(heads, dim, saturate):
    """A bipartite graph whose last 40 dst have no in-edge: out 0 there,
    finite gradients, and saturated scores with a gradient of 0."""
    rng = np.random.default_rng(heads * 10 + dim)
    row, col = _simple_graph(rng, N_SRC, N_DST, E, no_in=40)
    q, z, w = _inputs(dim, N_SRC, N_DST, heads, dim, saturate)
    got = _port(row, col, N_SRC, N_DST, q, z, w)
    _assert_close(got, _oracle(row, col, N_DST, q, z, w))
    np.testing.assert_array_equal(got[0][-40:], 0.0)
    np.testing.assert_array_equal(got[2][-40:], 0.0)
    assert all(np.isfinite(a).all() for a in got)


def test_plain_matches_oracle_symmetric_plane31():
    """A symmetric graph whose packing reaches bit plane 31 (the sign bit),
    as one tensor for both directions."""
    rng = np.random.default_rng(4)
    n = 8100
    row, col = _simple_graph(rng, n, n, 12_000)
    row = np.r_[row, rng.integers(7936, n, 40), rng.integers(0, n, 40)]
    col = np.r_[col, rng.integers(0, n, 40), rng.integers(7936, n, 40)]
    key = np.unique(np.r_[col * n + row, row * n + col])
    row, col = key % n, key // n
    bf = tbm.build_bit_format(row, col, n, n, symmetric=True, device="cpu")
    assert bf.packed_rev is bf.packed and (bf.packed < 0).any()
    q, z, w = _inputs(5, n, n, 2, 8)
    _assert_close(_port(row, col, n, n, q, z, w),
                  _oracle(row, col, n, q, z, w))


def test_saturated_dst_has_zero_dq():
    """Every score of dst 0 saturates: its draw is 0 on all its edges, so
    dq[0] is exactly 0, while out[0] is the mean of its z rows (every p
    is exp(40))."""
    rng = np.random.default_rng(6)
    row, col = _simple_graph(rng, N_SRC, N_DST, E)
    q, z, w = _inputs(6, N_SRC, N_DST, 2, 64)
    z[:] = np.abs(z) + 1 / 16
    q[0] = 128.0                 # e = 16 sum(z) >= 16 * 64 / 16 = 64
    got = _port(row, col, N_SRC, N_DST, q, z, w)
    _assert_close(got, _oracle(row, col, N_DST, q, z, w))
    np.testing.assert_array_equal(got[2][0], 0.0)
    src = row[col == 0]
    np.testing.assert_allclose(got[0][0], z[src].mean(0), rtol=1e-5)


def test_plain_versions_chunk_rows(monkeypatch):
    """The plain versions give the same results whatever rows they list
    at a time, and the wrappers take them for CPU tensors."""
    rng = np.random.default_rng(7)
    row, col = _simple_graph(rng, N_SRC, N_DST, 3000)
    bf = tbm.build_bit_format(row, col, N_SRC, N_DST, device="cpu")
    q, z, w = (torch.from_numpy(a) for a in _inputs(7, N_SRC, N_DST, 2, 8))
    linv, rho = torch.rand(N_DST, 2), torch.randn(N_DST, 2)
    isd = 1 / math.sqrt(8)

    def run():
        return (tbd.bitdot_fwd(bf.packed, q, z, isd)
                + (tbd.bitdot_bwd_dz(bf.packed_rev, q, z, w, linv, rho, isd),
                   tbd.bitdot_bwd_dq(bf.packed, q, z, w, linv, rho, isd)))

    ref = run()
    monkeypatch.setattr(tbg, "PLAIN_WORDS", 7)
    for a, b in zip(run(), ref):
        torch.testing.assert_close(a, b, **ORACLE)
    assert (tbd.bitdot_fwd.launches, tbd.bitdot_bwd_dz.launches,
            tbd.bitdot_bwd_dq.launches) == (0, 0, 0)


def test_wrapper_checks():
    rng = np.random.default_rng(8)
    row, col = _simple_graph(rng, 40, 30, 200)
    bf = tbm.build_bit_format(row, col, 40, 30, device="cpu")
    q, z = torch.zeros(30, 2, 8), torch.zeros(40, 2, 8)
    g, s = torch.zeros(30, 2, 8), torch.zeros(30, 2)
    with pytest.raises(ValueError, match="H \\* D"):
        tbd.bitdot_fwd(bf.packed, torch.zeros(30, 3, 43),
                       torch.zeros(40, 3, 43), 0.1)
    with pytest.raises(ValueError, match="same H and D"):
        tbd.bitdot_fwd(bf.packed, q, torch.zeros(40, 2, 4), 0.1)
    with pytest.raises(ValueError, match="do not match"):
        tbd.bitdot_bwd_dq(bf.packed, q, z, g[:-1], s, s, 0.1)
    with pytest.raises(ValueError, match="too small"):
        tbd.bitdot_bwd_dz(bf.packed_rev, torch.zeros(9000, 2, 8), z,
                          torch.zeros(9000, 2, 8), torch.zeros(9000, 2),
                          torch.zeros(9000, 2), 0.1)
    with pytest.raises(ValueError, match="bit format"):
        tbd.bitdot_attention_aggregate(bf, z, q)


def test_rejects_multigraph():
    row = np.array([0, 0, 1], np.int64)
    col = np.array([1, 1, 2], np.int64)       # the edge (0, 1) twice
    bf = tbm.build_bit_format(row, col, 8, 8, device="cpu")
    assert bf.rem_src.numel() > 0
    with pytest.raises(ValueError, match="simple"):
        tbd.bitdot_attention_aggregate(bf, torch.zeros(8, 1, 4),
                                       torch.zeros(8, 1, 4))


# -- against JAX's K7, interpreted ---------------------------------------------

JAX_CASES = {"h2d64": (2, 64, False), "h3d8": (3, 8, False),
             "h2d64_saturated": (2, 64, True)}


@pytest.fixture(scope="module")
def jax_k7():
    """{case: (graph, inputs, (out, l, dq, dz))} of JAX's K7 (its three
    pallas_calls ``_fwd_call``, ``_bwdA_call`` and ``_bwdB_call``), each
    shape interpreted once: ``bitdot_attention_aggregate`` under
    ``jax.vjp``, and l from the custom VJP's forward rule."""
    rng = np.random.default_rng(11)
    row, col = _simple_graph(rng, N_SRC, N_DST, E, no_in=20)
    bj = jbm.build_bit_format(row, col, N_SRC, N_DST)
    results = {}
    for name, (heads, dim, saturate) in JAX_CASES.items():
        q, z, w = _inputs(heads + dim, N_SRC, N_DST, heads, dim, saturate)
        isd = 1.0 / math.sqrt(dim)
        l = jbd._bitdot_fwd(bj, jnp.asarray(q), jnp.asarray(z), isd)[1][3]
        out, vjp = jax.vjp(lambda q, z: jbd.bitdot_attention_aggregate(
            bj, q, z), jnp.asarray(q), jnp.asarray(z))
        dq, dz = vjp(jnp.asarray(w))
        results[name] = ((row, col, bj), (q, z, w),
                         tuple(np.asarray(a) for a in (out, l, dq, dz)))
    return results


def test_bit_formats_equal_jax(jax_k7):
    (row, col, bj), _, _ = jax_k7["h2d64"]
    bt = tbm.build_bit_format(row, col, N_SRC, N_DST, device="cpu")
    np.testing.assert_array_equal(bt.packed.numpy(), np.asarray(bj.packed))
    np.testing.assert_array_equal(bt.packed_rev.numpy(),
                                  np.asarray(bj.packed_rev))


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_aggregate_matches_jax(jax_k7, case):
    """``bitdot_attention_aggregate`` (the plain versions behind the
    wrappers) against interpreted JAX K7: out, l and both gradients."""
    (row, col, _), (q, z, w), want = jax_k7[case]
    got = _port(row, col, N_SRC, N_DST, q, z, w)
    _assert_close(got, want, (FWD, FWD, BWD, BWD))
    if JAX_CASES[case][2]:
        # the clip's gradient shows: the saturated case differs from the
        # same inputs with an unclipped gradient
        unclipped = _oracle(row, col, N_DST, q, z, w, clip_grad=False)[2]
        assert np.abs(unclipped - want[2]).max() > 1e-3


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_plain_functions_match_jax_calls(jax_k7, case):
    """Each plain version alone against the JAX kernel it stands for:
    the forward's out and l, dz (``_bwdA_call``) and dq (``_bwdB_call``),
    with linv and rho formed as the JAX backward forms them."""
    (row, col, _), (q, z, w), want = jax_k7[case]
    bf = tbm.build_bit_format(row, col, N_SRC, N_DST, device="cpu")
    qt, zt, wt = (torch.from_numpy(a) for a in (q, z, w))
    isd = 1.0 / math.sqrt(q.shape[2])
    out, l = tbd.bitdot_fwd_plain(bf.packed, qt, zt, isd)
    linv, rho = tbg.backward_scales(wt, out, l, None)
    dz = tbd.bitdot_bwd_dz_plain(bf.packed_rev, qt, zt, wt, linv, rho, isd)
    dq = tbd.bitdot_bwd_dq_plain(bf.packed, qt, zt, wt, linv, rho, isd)
    _assert_close((out.numpy(), l.numpy(), dq.numpy(), dz.numpy()), want,
                  (FWD, FWD, BWD, BWD))


def test_zero_scores_sum_exactly():
    """With q = 0 every p is 1, so l is each dst's in-degree exactly: a sum
    of ones is exact in any order."""
    rng = np.random.default_rng(12)
    row, col = _simple_graph(rng, N_SRC, N_DST, E, no_in=10)
    bf = tbm.build_bit_format(row, col, N_SRC, N_DST, device="cpu")
    z = torch.from_numpy(_inputs(12, N_SRC, N_DST, 2, 64)[1])
    out, l = tbd.bitdot_fwd_plain(bf.packed, torch.zeros(N_DST, 2, 64), z,
                                  0.125)
    deg = np.bincount(col, minlength=N_DST).astype(np.float32)
    np.testing.assert_array_equal(l.numpy(), np.repeat(deg[:, None], 2, 1))


# -- DotGatConv --------------------------------------------------------------

def _square_simple(seed, n=260, e=3200):
    """A simple square graph in which every node has an in-edge."""
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n, e), rng.integers(0, n, e)
    key = np.unique(np.r_[col * n + row,
                          np.arange(n) * n + (np.arange(n) + 1) % n])
    return key % n, key // n, n


@pytest.fixture
def min_edges_1(monkeypatch):
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    monkeypatch.setitem(jconfig._FLAGS, "pallas_spmm_min_edges", 1)


def _jax_layer(fin, dout, heads, gj, x):
    mod = jnn.DotGatConv(fin, dout, heads)
    params = mod.init(jax.random.PRNGKey(0), gj, jnp.asarray(x))["params"]
    return mod, params


def _port_layer(fin, dout, heads, params):
    conv = dgt.nn.DotGatConv(fin, dout, heads, device="cpu")
    conv.load_state_dict(dotgatconv_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return conv


def _graphs(row, col, n):
    gj = dgl.graph((jnp.asarray(row, jnp.int32), jnp.asarray(col, jnp.int32)),
                   num_nodes=n)
    gj.unit().create_bitmask_format()
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    gt.unit().create_bitmask_format()
    return gj, gt


def test_dotgatconv_on_k7_matches_jax(min_edges_1):
    """DotGatConv(12, 64, 2) on a simple bitmask graph: both packages take
    K7; outputs and both weight gradients agree."""
    row, col, n = _square_simple(13)
    gj, gt = _graphs(row, col, n)
    rng = np.random.default_rng(14)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    cot = rng.normal(size=(n, 2, 64)).astype(np.float32)
    mod, params = _jax_layer(12, 64, 2, gj, x)

    def jloss(p):
        out = mod.apply({"params": p}, gj, jnp.asarray(x))
        return (out * cot).sum(), out

    with mock.patch.object(jbd, "_bitdot_core",
                           wraps=jbd._bitdot_core) as spy:
        (_, out_j), gp_j = jax.value_and_grad(jloss, has_aux=True)(params)
    assert spy.call_count == 1
    conv = _port_layer(12, 64, 2, params)
    with mock.patch.object(tbd, "bitdot_attention_aggregate",
                           wraps=tbd.bitdot_attention_aggregate) as spy_t:
        out_t = conv(gt, torch.from_numpy(x))
        (out_t * torch.from_numpy(cot)).sum().backward()
    assert spy_t.call_count == 1
    assert not gt.ndata and not gt.edata
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **MODULE)
    for name in ("fc_src", "fc_dst"):
        np.testing.assert_allclose(
            getattr(conv, name).weight.grad.numpy().T,
            np.asarray(gp_j[name]["kernel"]), **MODULE)


def test_dotgatconv_adam_steps_match_optax(min_edges_1):
    """Three Adam steps (lr 1e-3) of DotGatConv(12, 64, 2) on K7 with the
    loss (out^2).mean(), against optax on the JAX layer."""
    row, col, n = _square_simple(15)
    gj, gt = _graphs(row, col, n)
    x = np.random.default_rng(16).normal(size=(n, 12)).astype(np.float32)
    mod, params = _jax_layer(12, 64, 2, gj, x)
    conv = _port_layer(12, 64, 2, params)
    lr, steps = 1e-3, 3
    tx = optax.adam(lr)
    state = tx.init(params)
    grad_fn = jax.value_and_grad(
        lambda p: jnp.square(mod.apply({"params": p}, gj,
                                       jnp.asarray(x))).mean())
    losses_j = []
    for _ in range(steps):
        loss, grads = grad_fn(params)
        up, state = tx.update(grads, state)
        params = optax.apply_updates(params, up)
        losses_j.append(float(loss))
    opt = torch.optim.Adam(conv.parameters(), lr=lr)
    xt = torch.from_numpy(x)
    losses_t = []
    for _ in range(steps):
        opt.zero_grad()
        loss = conv(gt, xt).square().mean()
        loss.backward()
        opt.step()
        losses_t.append(loss.item())
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert losses_t[-1] < losses_t[0]
    for name in ("fc_src", "fc_dst"):
        np.testing.assert_allclose(
            getattr(conv, name).weight.detach().numpy().T,
            np.asarray(params[name]["kernel"]), **MODULE)


@pytest.mark.parametrize("case,heads,dim,want", [
    ("bits", 2, 64, "k7"), ("bits_tiled", 2, 64, "k7"),
    ("bits", 1, 128, "k7"), ("bits", 2, 32, "gather"),
    ("bits_tiled", 4, 32, "k8"), ("multi", 2, 64, "gather"),
    ("multi_tiled", 2, 64, "k8"), ("bits", 3, 64, "gather"),
    ("bits_few_edges", 2, 64, "gather"), ("bits_no_kernels", 2, 64,
                                          "gather")])
def test_dotgatconv_route(case, heads, dim, want, monkeypatch):
    """K7 under the JAX gates (a simple bit format, H * D <= 128, D >= 64,
    at least ``kernel_spmm_min_edges`` edges, kernels on), else K8 on a
    tiled graph, else the gather path."""
    rng = np.random.default_rng(21)
    n = 200
    row, col = rng.integers(0, n, 1500), rng.integers(0, n, 1500)
    if not case.startswith("multi"):
        key = np.unique(col * n + row)
        row, col = key % n, key // n
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    g.unit().create_bitmask_format()
    assert (g.unit()._bits.rem_src.numel() > 0) == case.startswith("multi")
    if case.endswith("tiled"):
        g.create_tiled_format(tile=128, cap=128)
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges",
                        10_000 if case == "bits_few_edges" else 1)
    if case == "bits_no_kernels":
        monkeypatch.setitem(config._FLAGS, "use_kernels", False)
    conv = dgt.nn.DotGatConv(6, dim, heads, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    calls = _routes(conv, g, torch.randn(n, 6))
    assert {name: calls[name] for name in ("k7", "k8", "gather")} == {
        name: int(name == want) for name in ("k7", "k8", "gather")}
