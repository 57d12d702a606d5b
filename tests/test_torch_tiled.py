"""Parity of the port's tiled format and K3 route with the JAX package on
the CPU.

The format builders must emit the JAX builder's arrays exactly.  K3's
plain version is held to ``tiled_spmm`` of the JAX package, whose Pallas
kernel runs in interpret mode with f32 operands off the TPU
(``_op_dtype``), at rtol 1e-5 / atol 1e-5: both sides sum in f32, in
another order.  The three autograd functions are held to the JAX custom
VJPs, called directly, at the same tolerance.  The JAX package never takes
the tiled route on the CPU (``ops/pallas/dispatch.py:28``), so GraphConv
on the port's tiled route is held to JAX GraphConv on its XLA path at
rtol 1e-4 / atol 1e-5.
"""
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

import dgl_tpu as dgl
import dgl_tpu.ops.pallas.tiled_spmm as jts
import dgl_tpu_torch as dgt
import dgl_tpu_torch.ops.kernels.spmm as tsp
import dgl_tpu_torch.ops.kernels.tiled_spmm as tts
from dgl_tpu import function as jfn
from dgl_tpu import nn as jnn
from dgl_tpu.graph.unitgraph import _auto_cap as j_auto_cap
from dgl_tpu.ops.pallas.spmm import (_spmm_tiled_mul, _spmm_tiled_static,
                                     _spmm_tiled_vjp)
from dgl_tpu_torch import function as tfn
from dgl_tpu_torch.graph.unitgraph import _auto_cap as t_auto_cap
from dgl_tpu_torch.params import graphconv_state_dict
from dgl_tpu_torch.utils import config

KERNEL = dict(rtol=1e-5, atol=1e-5)
SUMS = dict(rtol=1e-4, atol=1e-5)
FIELDS = ("src_local", "dst_local", "eid", "valid", "src_tile", "dst_tile",
          "src_order")


@pytest.fixture
def interpret():
    """Run the JAX package's Pallas kernels in interpret mode off-TPU."""
    if jax.default_backend() == "tpu":
        yield
        return
    orig = pl.pallas_call
    with mock.patch.object(jts.pl, "pallas_call",
                           lambda *a, **k: orig(*a, **{**k,
                                                       "interpret": True})):
        yield


def _coo(kind):
    """(row, col, num_src, num_dst, tile, cap) of a small case."""
    rng = np.random.default_rng({"square": 1, "uneven": 2, "dense": 3,
                                 "empty": 4}[kind])
    if kind == "square":
        n_src = n_dst = 700
        row, col = rng.integers(0, 700, 5000), rng.integers(0, 700, 5000)
        tile, cap = 256, 256
    elif kind == "uneven":      # uneven last tiles, an empty dst tile
        n_src, n_dst = 300, 1000
        row = rng.integers(0, n_src, 3000)
        col = rng.integers(0, n_dst - 256, 3000)
        col[col >= 512] += 256          # dst tile 2 has no edge
        tile, cap = 256, 128
    elif kind == "dense":       # pairs split over several buckets
        n_src, n_dst = 1200, 1500
        row = np.r_[rng.integers(0, 60, 1500), rng.integers(0, n_src, 800)]
        col = np.r_[rng.integers(0, 50, 1500), rng.integers(0, n_dst, 800)]
        tile, cap = 256, 128
    else:
        n_src, n_dst = 500, 400
        row = col = np.zeros(0, np.int64)
        tile, cap = 256, 128
    if len(row):
        row[:100], col[:100] = row[100:200], col[100:200]   # multi-edges
    return row, col, n_src, n_dst, tile, cap


def _formats(kind, device_builder=False):
    row, col, n_src, n_dst, tile, cap = _coo(kind)
    build = (tts.build_tiled_format_device if device_builder
             else tts.build_tiled_format)
    t = build(row, col, n_src, n_dst, tile, cap, device="cpu")
    j = jts.build_tiled_format(row, col, n_src, n_dst, tile, cap)
    return t, j


@pytest.mark.parametrize("kind", ["square", "uneven", "dense", "empty"])
@pytest.mark.parametrize("device_builder", [False, True])
def test_format_equals_jax(kind, device_builder):
    t, j = _formats(kind, device_builder)
    t, j = t.with_src_first(), j.with_src_first()
    for name in FIELDS:
        got, want = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    if j.covered_mask is None:
        assert t.covered_mask is None
    else:
        np.testing.assert_array_equal(t.covered_mask.numpy(),
                                      np.asarray(j.covered_mask))
    assert (kind in ("uneven", "empty")) == (t.covered_mask is not None)
    ptr = t.dst_ptr.numpy()
    for tile in range(t.num_dst_tiles):   # a dst tile's buckets, in order
        assert (t.dst_tile.numpy()[ptr[tile]:ptr[tile + 1]] == tile).all()


def test_edge_slot_and_cap_check():
    row, col, n_src, n_dst, tile, cap = _coo("dense")
    t = tts.build_tiled_format(row, col, n_src, n_dst, tile, cap,
                               device="cpu")
    slot = t.edge_slot().long()
    np.testing.assert_array_equal(t.eid[slot].numpy(), np.arange(len(row)))
    with pytest.raises(ValueError):
        tts.build_tiled_format(row, col, n_src, n_dst, tile, 200,
                               device="cpu")


@pytest.mark.parametrize("num_edges,tiles2", [
    (0, 1), (5000, 9), (60_000, 100), (114_848_857, 51_984),
    (100_000_000, 5_494_336), (3_000_000, 400), (250_000, 200_000)])
def test_auto_cap_matches(num_edges, tiles2):
    assert t_auto_cap(num_edges, tiles2, tts.DEFAULT_CAP) == \
        j_auto_cap(num_edges, tiles2, jts.DEFAULT_CAP)


def test_unit_tiled_format_matches():
    """``UnitGraph.tiled_format`` with the auto cap against the JAX
    unit's."""
    row, col, n_src, _, _, _ = _coo("square")
    uj = dgl.graph((row, col), num_nodes=n_src).unit()
    fj, rj = uj.tiled_format(tile=256)
    ut = dgt.graph((row, col), num_nodes=n_src, device="cpu").unit()
    ft, rt = ut.tiled_format(tile=256)
    assert ft.cap == fj.cap and rt.cap == rj.cap
    for a, b in ((ft, fj), (rt, rj)):
        assert a.with_src_first() is a     # src_order and src_ptr built
        ptr, order = a.src_ptr.numpy(), a.src_order.numpy()
        for tile in range(a.num_src_tiles):   # a src tile's buckets
            assert (a.src_tile.numpy()[order[ptr[tile]:ptr[tile + 1]]]
                    == tile).all()
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(a, name).numpy(),
                                          np.asarray(getattr(b, name)))
    assert ut.tiled_format() == (ft, rt)      # built once


def test_auto_build_tiled(monkeypatch):
    """The port never builds the tiled format on its own (the JAX
    package's ``pallas_auto_build_tiled`` has no counterpart): a weighted
    SpMM takes the gather path until ``create_tiled_format``, then K3's
    route with the default tile, and both agree."""
    row, col, n = _gcn_graphs(19)
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    h, w = torch.randn(n, 3), torch.rand(len(row))
    with mock.patch.object(tsp, "spmm_tiled_mul",
                           wraps=tsp.spmm_tiled_mul) as spy:
        want = dgt.ops.gspmm(g, "mul", "sum", h, w)
        assert g.unit()._tiled is None and spy.call_count == 0
        g.create_tiled_format()
        got = dgt.ops.gspmm(g, "mul", "sum", h, w)
        assert spy.call_count == 1
    fwd, rev = g.unit()._tiled, g.unit()._tiled_rev
    assert fwd.tile == tts.DEFAULT_TILE and rev.num_src == fwd.num_dst
    torch.testing.assert_close(got, want, **SUMS)


@pytest.mark.parametrize("kind", ["square", "uneven", "dense"])
@pytest.mark.parametrize("weights", ["none", "edge", "slot"])
def test_tiled_spmm_plain_matches_jax(kind, weights, interpret):
    t, j = _formats(kind)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(t.num_src, 20)).astype(np.float32)
    w = rng.uniform(0.2, 2.0, size=len(_coo(kind)[0])).astype(np.float32)
    xt = torch.from_numpy(x)
    if weights == "none":
        got = tts.tiled_spmm(t, xt)
        want = jts.tiled_spmm(j, jnp.asarray(x))
    elif weights == "edge":
        got = tts.tiled_spmm(t, xt, torch.from_numpy(w))
        want = jts.tiled_spmm(j, jnp.asarray(x), jnp.asarray(w))
    else:
        ws = tts.slot_edge_weights(t, torch.from_numpy(w))
        wj = jts.slot_edge_weights(j, jnp.asarray(w))
        np.testing.assert_array_equal(ws.numpy(), np.asarray(wj))
        got = tts.tiled_spmm(t, xt, slot_weights=ws)
        want = jts.tiled_spmm(j, jnp.asarray(x), slot_weights=wj)
    assert got.dtype == torch.float32 and got.shape == (t.num_dst, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL)
    # against a dense float64 oracle too
    ref = np.zeros((t.num_dst, 20))
    row, col = _coo(kind)[:2]
    np.add.at(ref, col, x[row] * (1.0 if weights == "none" else
                                  w[:, None]))
    np.testing.assert_allclose(got.numpy(), ref, **KERNEL)


def test_tiled_spmm_checks():
    t, _ = _formats("square")
    with pytest.raises(ValueError):
        tts.tiled_spmm(t, torch.zeros(t.num_src - 1, 4))
    with pytest.raises(ValueError):
        tts.tiled_spmm(t, torch.zeros(t.num_src, 4),
                       slot_weights=torch.zeros(3, 4))


@pytest.mark.parametrize("route", ["copy", "mul", "static"])
def test_autograd_functions_match_jax_vjps(route, interpret):
    """Values, dX and dEw of the three autograd functions against the JAX
    package's custom VJPs."""
    row, col, n_src, n_dst, tile, cap = _coo("dense")
    rng = np.random.default_rng(6)
    x = rng.normal(size=(n_src, 16)).astype(np.float32)
    ew = rng.uniform(0.5, 1.5, size=len(row)).astype(np.float32)
    cot = rng.normal(size=(n_dst, 16)).astype(np.float32)
    tj = jts.build_tiled_format(row, col, n_src, n_dst, tile, cap)
    rj = jts.build_tiled_format(col, row, n_dst, n_src, tile, cap)
    tt = tts.build_tiled_format(row, col, n_src, n_dst, tile, cap,
                                device="cpu")
    rt = tts.build_tiled_format(col, row, n_dst, n_src, tile, cap,
                                device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    ewt = torch.from_numpy(ew).requires_grad_()
    if route == "copy":
        out_j, vjp = jax.vjp(lambda x: _spmm_tiled_vjp(tj, rj, x, None),
                             jnp.asarray(x))
        out_t = tsp.spmm_tiled_copy(tt, rt, xt)
    elif route == "mul":
        rj32, cj32 = (jnp.asarray(a.astype(np.int32)) for a in (row, col))
        out_j, vjp = jax.vjp(
            lambda x, w: _spmm_tiled_mul(tj, rj, rj32, cj32, x, w),
            jnp.asarray(x), jnp.asarray(ew))
        out_t = tsp.spmm_tiled_mul(tt, rt, torch.from_numpy(row),
                                   torch.from_numpy(col), xt, ewt)
    else:
        wsf = jts.slot_edge_weights(tj, jnp.asarray(ew))
        wsr = jts.slot_edge_weights(rj, jnp.asarray(ew))
        out_j, vjp = jax.vjp(
            lambda x: _spmm_tiled_static(tj, rj, wsf, wsr, x),
            jnp.asarray(x))
        out_t = tsp.spmm_tiled_static(
            tt, rt, tts.slot_edge_weights(tt, ewt.detach()),
            tts.slot_edge_weights(rt, ewt.detach()), xt)
    grads_j = vjp(jnp.asarray(cot))
    out_t.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **KERNEL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grads_j[0]),
                               **KERNEL)
    if route == "mul":
        np.testing.assert_allclose(ewt.grad.numpy(), np.asarray(grads_j[1]),
                                   **KERNEL)
    else:
        assert ewt.grad is None


def test_sddmm_dot_chunked(monkeypatch):
    """dEw in chunks (the last one short) equals dEw in one gather."""
    rng = np.random.default_rng(7)
    x, dz = torch.randn(50, 3), torch.randn(40, 3)
    row = torch.from_numpy(rng.integers(0, 50, 1000))
    col = torch.from_numpy(rng.integers(0, 40, 1000))
    whole = (x[row] * dz[col]).sum(-1)
    torch.testing.assert_close(tsp._sddmm_dot(x, dz, row, col), whole)
    monkeypatch.setattr(tsp, "SDDMM_CHUNK", 128)
    torch.testing.assert_close(tsp._sddmm_dot(x, dz, row, col), whole)


def _gcn_graphs(seed=8, n=300, e=3000):
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n, e), rng.integers(0, n - 20, e)
    return row, col, n


@pytest.mark.parametrize("norm,fin,fout,weights", [
    ("both", 9, 4, "none"), ("both", 4, 9, "none"), ("left", 9, 4, "none"),
    ("both", 9, 4, "tensor"), ("right", 4, 9, "tensor"),
    ("none", 9, 4, "field"), ("both", 4, 9, "field")])
def test_graphconv_tiled_matches_jax(norm, fin, fout, weights, monkeypatch):
    """GraphConv on the port's tiled route (K3's plain version) against
    JAX GraphConv on its XLA path: values and gradients."""
    row, col, n = _gcn_graphs()
    rng = np.random.default_rng(9)
    p = {"weight": rng.normal(size=(fin, fout)).astype(np.float32) * 0.3,
         "bias": rng.normal(size=(fout,)).astype(np.float32) * 0.1}
    x = rng.normal(size=(n, fin)).astype(np.float32)
    ew = rng.uniform(0.1, 2.0, size=len(row)).astype(np.float32)
    cot = rng.normal(size=(n, fout)).astype(np.float32)
    mod = jnn.GraphConv(fin, fout, norm=norm, activation=jax.nn.relu)

    def jloss(params, x):
        g = dgl.graph((row, col), num_nodes=n)
        arg = None
        if weights == "tensor":
            arg = jnp.asarray(ew)
        elif weights == "field":
            g.edata["w"] = jnp.asarray(ew)
            arg = "w"
        out = mod.apply({"params": params}, g, x, edge_weight=arg)
        return (out * cot).sum(), out

    (_, out_j), (gp_j, gx_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))

    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    g.create_tiled_format(tile=128)
    arg = None
    if weights == "tensor":
        arg = torch.from_numpy(ew)
    elif weights == "field":
        g.edata["w"] = torch.from_numpy(ew)
        g.cache_edge_weights("w")
        arg = "w"
    conv = dgt.nn.GraphConv(fin, fout, norm=norm, activation=torch.relu,
                            device="cpu")
    conv.load_state_dict(graphconv_state_dict(p))
    xt = torch.from_numpy(x).requires_grad_()
    route = {"none": "spmm_tiled_copy", "tensor": "spmm_tiled_mul",
             "field": "spmm_tiled_static"}[weights]
    with mock.patch.object(tsp, route, wraps=getattr(tsp, route)) as spy:
        out = conv(g, xt, edge_weight=arg)
        (out * torch.from_numpy(cot)).sum().backward()
    assert spy.call_count == 1
    assert set(g.edata) == ({"w"} if weights == "field" else set())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **SUMS)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **SUMS)
    np.testing.assert_allclose(conv.weight.grad.numpy(),
                               np.asarray(gp_j["weight"]), **SUMS)
    np.testing.assert_allclose(conv.bias.grad.numpy(),
                               np.asarray(gp_j["bias"]), **SUMS)


@pytest.mark.parametrize("norm,eps", [("both", 0.0), ("right", 0.0),
                                      ("both", 0.5)])
def test_edge_weight_norm_matches_jax(norm, eps):
    row, col, n = _gcn_graphs(10)
    ew = np.random.default_rng(11).uniform(0.1, 2.0, len(row)).astype(
        np.float32)
    gj = dgl.graph((row, col), num_nodes=n)
    want, vjp = jax.vjp(
        lambda w: jnn.EdgeWeightNorm(norm, eps).apply({}, gj, w),
        jnp.asarray(ew))
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    wt = torch.from_numpy(ew).requires_grad_()
    got = dgt.nn.EdgeWeightNorm(norm, eps)(gt, wt)
    cot = np.random.default_rng(12).normal(size=len(row)).astype(np.float32)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **SUMS)
    np.testing.assert_allclose(wt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(cot))[0]), **SUMS)
    with pytest.raises(ValueError):
        dgt.nn.EdgeWeightNorm("left")


def test_weight_norm_on_ones_is_both_norm(monkeypatch):
    """GraphConv(norm='none') with EdgeWeightNorm('both') of ones, cached,
    equals GraphConv(norm='both'), as the chip run checks at full size."""
    row, col, n = _gcn_graphs(13)
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    g = dgt.add_self_loop(dgt.graph((row, col), num_nodes=n, device="cpu"))
    g.create_tiled_format(tile=128)
    g.edata["w"] = dgt.nn.EdgeWeightNorm("both")(g, torch.ones(g.num_edges()))
    g.cache_edge_weights("w")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n, 7, generator=gen)
    plain = dgt.nn.GraphConv(7, 3, device="cpu", generator=gen)
    weighted = dgt.nn.GraphConv(7, 3, norm="none", device="cpu")
    weighted.load_state_dict(plain.state_dict())
    torch.testing.assert_close(weighted(g, x, edge_weight="w"), plain(g, x),
                               **SUMS)


@pytest.mark.parametrize("op,reduce", [("mul", "sum"), ("div", "sum"),
                                       ("mul", "mean")])
def test_static_route_and_staleness_guard(op, reduce, monkeypatch):
    """update_all(u_{mul,div}_e) takes the cached slot weights while edata
    still holds the cached tensor, unedited, and the general route once
    the field is replaced or edited in place; all give the gather path's
    answer."""
    row, col, n = _gcn_graphs(14)
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    rng = np.random.default_rng(15)
    h = torch.from_numpy(rng.normal(size=(n, 5)).astype(np.float32))
    w1, w2 = (torch.from_numpy(rng.uniform(0.5, 2, len(row)).astype(
        np.float32)) for _ in range(2))
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    g.create_tiled_format(tile=128)
    g.ndata["h"] = h
    mfunc = getattr(tfn, f"u_{op}_e")("h", "w", "m")
    rfunc = getattr(tfn, reduce)("m", "o")

    def reference(w):
        gr = dgt.graph((row, col), num_nodes=n, device="cpu")
        gr.ndata["h"], gr.edata["w"] = h, w
        return dgt.update_all(gr, mfunc, rfunc)["o"]

    g.edata["w"] = w1
    g.cache_edge_weights("w")
    with mock.patch.object(tsp, "spmm_tiled_static",
                           wraps=tsp.spmm_tiled_static) as spy:
        torch.testing.assert_close(dgt.update_all(g, mfunc, rfunc)["o"],
                                   reference(w1), **SUMS)
        assert spy.call_count == 1
        g.edata["w"] = w2                  # replaced: the cache is stale
        torch.testing.assert_close(dgt.update_all(g, mfunc, rfunc)["o"],
                                   reference(w2), **SUMS)
        assert spy.call_count == 1
        g.edata["w"] = w1
        g.edata["w"].mul_(2.0)             # edited in place: stale too
        torch.testing.assert_close(dgt.update_all(g, mfunc, rfunc)["o"],
                                   reference(w1), **SUMS)
        g.edata["w"][:5] = 0.5
        torch.testing.assert_close(dgt.update_all(g, mfunc, rfunc)["o"],
                                   reference(w1), **SUMS)
        assert spy.call_count == 1
        g.cache_edge_weights("w")          # cached again: served again
        torch.testing.assert_close(dgt.update_all(g, mfunc, rfunc)["o"],
                                   reference(w1), **SUMS)
        assert spy.call_count == 2
        g.unit().uncache_edge_weights("w")
        dgt.update_all(g, mfunc, rfunc)
        assert spy.call_count == 2


def test_gcn_training_slice_on_tiled_matches(monkeypatch):
    """2-layer GCN (feat -> 4 -> classes, norm both), 3 Adam steps: the
    port on its tiled route against the JAX package with optax.adam."""
    rng = np.random.default_rng(16)
    n, e, feat, classes = 500, 6000, 20, 6
    row, col = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.normal(size=(n, feat)).astype(np.float32)
    y = rng.integers(0, classes, n)
    params = {}
    for name, (fi, fo) in (("c1", (feat, 4)), ("c2", (4, classes))):
        params[name] = {
            "weight": rng.normal(size=(fi, fo)).astype(np.float32) * 0.3,
            "bias": rng.normal(size=(fo,)).astype(np.float32) * 0.1}
    lr, steps = 1e-2, 3
    c1 = jnn.GraphConv(feat, 4, activation=jax.nn.relu)
    c2 = jnn.GraphConv(4, classes)
    gj = dgl.add_self_loop(dgl.graph((row, col), num_nodes=n))

    def jloss(p):
        logits = c2.apply({"params": p["c2"]}, gj,
                          c1.apply({"params": p["c1"]}, gj, jnp.asarray(x)))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    pj = jax.tree_util.tree_map(jnp.asarray, params)
    tx = optax.adam(lr)
    opt = tx.init(pj)
    losses_j = []
    for _ in range(steps):
        loss, grads = jax.value_and_grad(jloss)(pj)
        up, opt = tx.update(grads, opt)
        pj = optax.apply_updates(pj, up)
        losses_j.append(float(loss))

    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    g = dgt.add_self_loop(dgt.graph((row, col), num_nodes=n, device="cpu"))
    g.create_tiled_format(tile=128)
    t1 = dgt.nn.GraphConv(feat, 4, activation=torch.relu, device="cpu")
    t2 = dgt.nn.GraphConv(4, classes, device="cpu")
    t1.load_state_dict(graphconv_state_dict(params["c1"]))
    t2.load_state_dict(graphconv_state_dict(params["c2"]))
    opt_t = torch.optim.Adam(list(t1.parameters()) + list(t2.parameters()),
                             lr=lr)
    losses_t = []
    with mock.patch.object(tsp, "spmm_tiled_copy",
                           wraps=tsp.spmm_tiled_copy) as spy:
        for _ in range(steps):
            opt_t.zero_grad()
            loss = torch.nn.functional.cross_entropy(
                t2(g, t1(g, torch.from_numpy(x))), torch.from_numpy(y))
            loss.backward()
            opt_t.step()
            losses_t.append(loss.item())
    assert spy.call_count == 2 * steps
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert losses_t[-1] < losses_t[0]
    for name, mod in (("c1", t1), ("c2", t2)):
        for k in ("weight", "bias"):
            np.testing.assert_allclose(getattr(mod, k).detach().numpy(),
                                       np.asarray(pj[name][k]), rtol=1e-4,
                                       atol=1e-6)


def test_tiled_format_on_the_card_by_default():
    """Format builders default to device='cuda': without a GPU they
    raise instead of running on the CPU."""
    row, col, n_src, n_dst, tile, cap = _coo("square")
    for build in (tts.build_tiled_format, tts.build_tiled_format_device):
        if torch.cuda.is_available():
            assert build(row, col, n_src, n_dst).device.type == "cuda"
            continue
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(row, col, n_src, n_dst)


def test_builtins_unchanged_off_the_route():
    """copy_e and the e-u pairs never reach the tiled route."""
    row, col, n = _gcn_graphs(17)
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    g.create_tiled_format(tile=128)
    gj = dgl.graph((row, col), num_nodes=n)
    w = np.random.default_rng(18).normal(size=(len(row), 2)).astype(
        np.float32)
    g.edata["w"], gj.edata["w"] = torch.from_numpy(w), jnp.asarray(w)
    want = dgl.core.update_all(gj, jfn.copy_e("w", "m"), jfn.sum("m", "o"))
    got = dgt.update_all(g, tfn.copy_e("w", "m"), tfn.sum("m", "o"))
    np.testing.assert_allclose(got["o"].numpy(), np.asarray(want["o"]),
                               **SUMS)
