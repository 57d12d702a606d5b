"""Parity of the port's EdgeGAT attention (K10 v2) and ``EdgeGATConv`` with
the JAX package on the CPU: the plain versions against a float64 oracle,
the autograd function against the interpreted JAX kernels and an f32 XLA
composition, ``EdgeGATConv`` on each of its three routes against the JAX
module, and which route each gate takes.

Tolerances:
* the plain versions against a float64 numpy oracle of the K10 v2
  contract (logits clipped to +-40, no max subtraction, the gradients of
  the JAX kernels, which ignore the clip): rtol 1e-5 / atol 1e-5, the atol
  scaled by the largest magnitude for dWe and d(attn_e) (sums over every
  edge) and for every gradient with saturated logits, and rtol 1e-4 with
  saturated logits (a logit of magnitude 40 summed in f32 carries an
  absolute error of about 1e-5, which exp turns into a relative one);
* against the JAX function, whose Pallas kernels cast el, er, the edge
  features, We, fe, p, x, zn and ds to bf16 even when interpreted
  (``gat_fused.py:1550-1555, 1558-1685``; the inputs that form the logits
  are exact in bf16, so lrelu's kink falls at the same slots): rtol 5e-2 /
  atol 6e-2 for out and dx, and for the gradients that sum bf16 products
  over many edges (del, der, d(ef), dWe, d(attn_e)) the rule of
  ``tests/test_pallas.py:226-235``: at most 0.5% of elements outside 2e-1
  + 8e-2 |ref|;
* against the JAX package's f32 XLA routes (an edge composition, the flat
  route, the edge chain), with logits inside +-40: rtol 1e-4 / atol 1e-5,
  sums over edges taken in another order.

The test graph keeps a dst tile and a src tile with no bucket: the JAX
kernels never write the rows of such a tile (interpreted, they come back
NaN), the port writes 0 (a standing divergence).
"""
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import dgl_tpu as dgl
import dgl_tpu.ops.pallas.gat_fused as jgf
import dgl_tpu.ops.pallas.tiled_spmm as jts
import dgl_tpu_torch as dgt
import dgl_tpu_torch.ops.kernels.gat_fused as tgf
from dgl_tpu import nn as jnn
from dgl_tpu.ops import edge_softmax_unit as j_edge_softmax_unit
from dgl_tpu.utils import config as jconfig
from dgl_tpu_torch.params import edgegatconv_state_dict
from dgl_tpu_torch.utils import config
from test_torch_gat_fused import (BF16, DST_COVERED, E, N, ORACLE,
                                  SRC_COVERED, SUMS, _coo, _formats,
                                  _kink_close, _params, _square)

SLOPE = 0.2
FE = 5
H, FH = 2, 8          # the interpreted shape


def _edge_rows(t, slot_tensor):
    """(E, ...) in canonical edge order from a (B, C, ...) slot tensor."""
    a = np.asarray(slot_tensor)
    flat = a.reshape((-1,) + a.shape[2:])
    eid = t.eid.numpy()
    return flat[eid >= 0][np.argsort(eid[eid >= 0])]


def _edge_heads(t, slot_tensor):
    """(E, H) in canonical edge order from a (B, H, C) slot tensor."""
    return _edge_rows(t, np.asarray(slot_tensor).transpose(0, 2, 1))


def _inputs(seed, heads, fh, scale=1.0):
    """el, er, ef (E, FE), We (FE, H * Fh), attn_e, x, dz; ``scale``
    widens el and er, which saturates the logits."""
    rng = np.random.default_rng(seed)

    def normal(*shape, s=1.0):
        return (s * rng.normal(size=shape)).astype(np.float32)

    return (normal(N, heads, s=scale), normal(N, heads, s=scale),
            normal(E, FE), normal(FE, heads * fh, s=0.3),
            normal(heads, fh, s=0.5), normal(N, heads, fh),
            normal(N, heads, fh))


# -- the plain versions against a float64 oracle -----------------------------

def _oracle(row, col, el, er, ef, We, attn, x, dz, slope):
    """The K10 v2 contract in float64 numpy over the edge list: (out, p,
    del, der, dx, d_ef, dWe, d_attn), the gradients as the JAX kernels
    compute them (ds with g = p lrelu'(raw), the clip ignored)."""
    el, er, ef, We, attn, x, dz = (a.astype(np.float64) for a in (
        el, er, ef, We, attn, x, dz))
    heads, fh = attn.shape
    e = len(row)
    fe = (ef @ We).reshape(e, heads, fh)
    raw = el[row] + er[col] + (fe * attn).sum(-1)
    p = np.exp(np.clip(np.where(raw >= 0, raw, slope * raw), -40, 40))
    g = p * np.where(raw >= 0, 1.0, slope)
    den = np.zeros((N, heads))
    np.add.at(den, col, p)
    den = np.maximum(den, 1e-20)
    msg = x[row] + fe
    num = np.zeros(x.shape)
    np.add.at(num, col, p[:, :, None] * msg)
    out = num / den[:, :, None]
    zn = dz / den[:, :, None]
    rp = (out * dz).sum(-1) / den
    ds = ((msg * zn[col]).sum(-1) - rp[col]) * g
    d_el, d_er, dx = np.zeros(el.shape), np.zeros(er.shape), np.zeros(x.shape)
    np.add.at(d_el, row, ds)
    np.add.at(d_er, col, ds)
    np.add.at(dx, row, p[:, :, None] * zn[col])
    dfe = (p[:, :, None] * zn[col] + ds[:, :, None] * attn).reshape(e, -1)
    d_attn = (ds[:, :, None] * fe).sum(0)
    return out, p, d_el, d_er, dx, dfe @ We.T, ef.T @ dfe, d_attn


@pytest.mark.parametrize("heads,fh", [(2, 8), (1, 41), (3, 5)])
@pytest.mark.parametrize("saturate", [False, True])
def test_plain_versions_match_oracle(heads, fh, saturate):
    """The plain versions, chained as the autograd function chains the
    kernels, against float64; ``saturate`` scales the logits far beyond
    the clip (saturated edges get e^40 or e^-40, not a softmax)."""
    row, col = _coo(61)
    t, _ = _formats(row, col)
    ins = _inputs(62, heads, fh, 30.0 if saturate else 1.0)
    want = _oracle(row, col, *ins, SLOPE)
    if saturate:
        assert (np.abs(np.log(want[1])) >= 40 - 1e-9).mean() > 0.1
    el, er, ef, We, attn, x, dz = (torch.from_numpy(a) for a in ins)
    ef_slot = tgf.slot_edge_tensor(t, ef)
    tol = dict(rtol=1e-4, atol=1e-5) if saturate else ORACLE
    out, p, g, den, s = tgf.edgegat_v2_forward(t, el, er, ef_slot, We, attn,
                                               x, heads, fh, SLOPE)
    valid = t.valid.reshape(t.num_buckets, 1, t.cap) > 0
    assert (p.masked_select(~valid) == 0).all()
    np.testing.assert_allclose(_edge_heads(t, p), want[1], **tol)
    np.testing.assert_allclose(out.numpy(), want[0], **tol)
    got = tgf.edgegat_v2_backward(t, ef_slot, We, attn, x, p, g, den, s,
                                  out, dz, heads, fh)
    names = ("del", "der", "dx", "d_ef", "dWe", "d_attn")
    for name, a, ref in zip(names, got, want[2:]):
        a = a.numpy()
        if name == "d_ef":
            assert (a.reshape(-1, FE)[t.eid.numpy() < 0] == 0).all()
            a = _edge_rows(t, a)
        scale = (np.abs(ref).max() if saturate or name in ("dWe", "d_attn")
                 else 1.0)
        np.testing.assert_allclose(a, ref, rtol=tol["rtol"],
                                   atol=1e-5 * scale, err_msg=name)
    # rows of the uncovered tiles: exactly 0
    assert (out[~torch.from_numpy(DST_COVERED)] == 0).all()
    assert (got[2][~torch.from_numpy(SRC_COVERED)] == 0).all()


def test_backward_skips_def_when_not_needed():
    """``need_def=False`` gives no d(ef) and the same other gradients."""
    row, col = _coo(63)
    t, _ = _formats(row, col)
    el, er, ef, We, attn, x, dz = (torch.from_numpy(a)
                                   for a in _inputs(64, 2, 4))
    ef_slot = tgf.slot_edge_tensor(t, ef)
    out, p, g, den, s = tgf.edgegat_v2_forward(t, el, er, ef_slot, We, attn,
                                               x, 2, 4, SLOPE)
    full = tgf.edgegat_v2_backward(t, ef_slot, We, attn, x, p, g, den, s,
                                   out, dz, 2, 4)
    part = tgf.edgegat_v2_backward(t, ef_slot, We, attn, x, p, g, den, s,
                                   out, dz, 2, 4, need_def=False)
    assert part[3] is None and full[3] is not None
    for a, b in zip(part[:3] + part[4:], full[:3] + full[4:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_checks():
    row, col = _coo(65)
    t, _ = _formats(row, col)
    el, er, ef, We, attn, x, _ = (torch.from_numpy(a)
                                  for a in _inputs(66, 2, 4))
    ef_slot = tgf.slot_edge_tensor(t, ef)
    m = torch.zeros(FE, 2)
    with pytest.raises(ValueError, match="ef_slot"):
        tgf.edgegat_scores(t, el, er, ef_slot[:, :-1], m, SLOPE)
    with pytest.raises(ValueError, match="m has shape"):
        tgf.edgegat_scores(t, el, er, ef_slot, m[:, :1], SLOPE)
    with pytest.raises(ValueError, match="zp"):
        tgf.edgegat_ds(t, x, x, el, torch.zeros(t.num_buckets, 2, t.cap),
                       ef_slot, torch.zeros(N, 2, FE + 1))
    with pytest.raises(ValueError, match="both p and m"):
        tgf.edgegat_ds(t, x, x, el, torch.zeros(t.num_buckets, 2, t.cap),
                       ef_slot, torch.zeros(N, 2, FE), p=torch.zeros(
                           t.num_buckets, 2, t.cap))
    with pytest.raises(ValueError, match="We"):
        tgf.edgegat_attention_aggregate_v2(t, el, er, ef_slot, We[:, :3],
                                           attn, x, 2, 4, SLOPE)
    bare = dgt.ops.kernels.tiled_spmm.build_tiled_format(
        row, col, N, N, 256, 128, device="cpu")
    with pytest.raises(ValueError, match="src_order"):
        tgf.edgegat_attention_aggregate_v2(bare, el, er, ef_slot, We, attn,
                                           x, 2, 4, SLOPE)
    assert tgf.edgegat_fits(4, 16) and not tgf.edgegat_fits(64, 1000)


# -- against the JAX function in Pallas interpret mode -----------------------

def _exact(rng, shape, top=8):
    """Multiples of 1/16 in [-top/16, top/16]: bf16 holds them, and the
    sums the kernels form of them, exactly."""
    return (rng.integers(-top, top + 1, shape) / 16).astype(np.float32)


@pytest.fixture(scope="module")
def jax_k10():
    """The JAX package's ``edgegat_attention_aggregate_v2``, value and vjp,
    computed once with its Pallas kernels interpreted, on the transposed
    bf16 edge features of ``slot_edge_tensor_t`` and the lane-padded
    ``pad_We_heads``.  el, er, We and attn_e are multiples of 1/16 and the
    edge features in {-1, 0, 1}, so the logits, which the TPU kernels form
    from bf16 operands, are exact on both sides and lrelu's kink falls at
    the same slots."""
    row, col = _coo(67)
    t, j = _formats(row, col)
    rng = np.random.default_rng(68)
    el, er = _exact(rng, (N, H), 16), _exact(rng, (N, H), 16)
    ef = rng.integers(-1, 2, (E, FE)).astype(np.float32)
    We, attn = _exact(rng, (FE, H * FH)), _exact(rng, (H, FH))
    x, dz = (rng.normal(size=(N, H, FH)).astype(np.float32)
             for _ in range(2))
    ef_t = jgf.slot_edge_tensor_t(j, ef)
    We_p = jgf.pad_We_heads(jnp.asarray(We), H, FH, ef_t.shape[1])
    orig = pl.pallas_call

    def interpreted(*a, **kw):
        return orig(*a, **{**kw, "interpret": True})

    with mock.patch.object(jgf.pl, "pallas_call", interpreted), \
            mock.patch.object(jts.pl, "pallas_call", interpreted):
        out, vjp = jax.vjp(
            lambda *a: jgf.edgegat_attention_aggregate_v2(j, *a, H, FH,
                                                          SLOPE),
            *(jnp.asarray(a) for a in (el, er)), ef_t, We_p,
            *(jnp.asarray(a) for a in (attn, x)))
        grads = vjp(jnp.asarray(dz))
    d_el, d_er, def_t, dwe_p, d_attn, dx = (np.asarray(a, np.float32)
                                            for a in grads)
    fh_pad = dwe_p.shape[1] // H
    res = dict(out=np.asarray(out), d_el=d_el, d_er=d_er, dx=dx,
               d_attn=d_attn,
               # back from JAX's layouts: (B, Fe_pad, C) and (Fe_pad, H *
               # Fh_pad)
               d_ef=def_t[:, :FE, :].transpose(0, 2, 1),
               dWe=dwe_p.reshape(-1, H, fh_pad)[:FE, :, :FH].reshape(FE, -1))
    ins = dict(el=el, er=er, ef=ef, We=We, attn=attn, x=x, dz=dz)
    return t, ins, res


def test_jax_interpret_leaves_uncovered_rows_unwritten(jax_k10):
    """The JAX forward writes no row of a dst tile without a bucket (NaN
    when interpreted), nor its backward a src tile's; the port writes 0."""
    t, ins, res = jax_k10
    assert np.isnan(res["out"][~DST_COVERED]).all()
    assert np.isnan(res["d_er"][~DST_COVERED]).all()
    assert np.isnan(res["d_el"][~SRC_COVERED]).all()
    assert np.isnan(res["dx"][~SRC_COVERED]).all()
    assert np.isfinite(res["out"][DST_COVERED]).all()
    ef_slot = tgf.slot_edge_tensor(t, torch.from_numpy(ins["ef"]))
    got = tgf.edgegat_attention_aggregate_v2(
        t, torch.from_numpy(ins["el"]), torch.from_numpy(ins["er"]),
        ef_slot, *(torch.from_numpy(ins[n]) for n in ("We", "attn", "x")),
        H, FH, SLOPE)
    assert (got[~torch.from_numpy(DST_COVERED)] == 0).all()


def test_edgegat_attention_matches_jax(jax_k10):
    """The attention and all six gradients (el, er, ef, We, attn_e, x)
    against the interpreted JAX kernels, on the covered rows."""
    t, ins, res = jax_k10
    el, er, We, attn, x = (torch.from_numpy(ins[n]).requires_grad_()
                           for n in ("el", "er", "We", "attn", "x"))
    ef_slot = tgf.slot_edge_tensor(t, torch.from_numpy(ins["ef"]))
    ef_slot.requires_grad_()
    out = tgf.edgegat_attention_aggregate_v2(t, el, er, ef_slot, We, attn, x,
                                             H, FH, SLOPE)
    out.backward(torch.from_numpy(ins["dz"]))
    np.testing.assert_allclose(out.detach().numpy()[DST_COVERED],
                               res["out"][DST_COVERED], **BF16)
    np.testing.assert_allclose(x.grad.numpy()[SRC_COVERED],
                               res["dx"][SRC_COVERED], **BF16)
    _kink_close(el.grad.numpy()[SRC_COVERED], res["d_el"][SRC_COVERED],
                "del")
    _kink_close(er.grad.numpy()[DST_COVERED], res["d_er"][DST_COVERED],
                "der")
    valid = t.valid.numpy().reshape(t.num_buckets, t.cap) > 0
    _kink_close(ef_slot.grad.numpy()[valid], res["d_ef"][valid], "d_ef")
    assert (ef_slot.grad.numpy()[~valid] == 0).all()
    _kink_close(We.grad.numpy(), res["dWe"], "dWe")
    _kink_close(attn.grad.numpy(), res["d_attn"], "d_attn")


def test_edgegat_attention_matches_f32_composition():
    """With logits inside +-40 the clip changes nothing: the port's K10 v2
    equals an f32 XLA composition of the same function with the JAX
    package's ``edge_softmax_unit``, values and the gradients of all six
    inputs (the edge features' through the slot tensor), uncovered rows
    included."""
    row, col = _coo(69)
    t, _ = _formats(row, col)
    unit = dgl.graph((row, col), num_nodes=N).unit()
    heads, fh = 3, 5
    ins = _inputs(70, heads, fh)
    r, c = jnp.asarray(row), jnp.asarray(col)

    def ref(el, er, ef, We, attn, x):
        fe = (ef @ We).reshape(-1, heads, fh)
        e = el[r] + er[c] + (fe * attn).sum(-1)
        a = j_edge_softmax_unit(unit, jnp.where(e >= 0, e, SLOPE * e))
        return jax.ops.segment_sum(a[:, :, None] * (x[r] + fe), c, N)

    want, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in ins[:6]))
    gwant = vjp(jnp.asarray(ins[6]))
    el, er, ef, We, attn, x = (torch.from_numpy(a).requires_grad_()
                               for a in ins[:6])
    got = tgf.edgegat_attention_aggregate_v2(
        t, el, er, tgf.slot_edge_tensor(t, ef), We, attn, x, heads, fh,
        SLOPE)
    got.backward(torch.from_numpy(ins[6]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **SUMS)
    for name, a, gw in zip(("el", "er", "ef", "We", "attn", "x"),
                           (el, er, ef, We, attn, x), gwant):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(gw), **SUMS,
                                   err_msg=name)


# -- the module ---------------------------------------------------------------

FIN, DOUT, HEADS = 6, 4, 2
NAMES = ["fc", "fc_edge", "attn_l", "attn_r", "attn_edge"]


def _jax_edgegat(residual, bias, seed=0):
    hd = HEADS * DOUT
    shapes = {"fc/kernel": (FIN, hd), "fc_edge/kernel": (FE, hd),
              "attn_l": (1, HEADS, DOUT), "attn_r": (1, HEADS, DOUT),
              "attn_edge": (1, HEADS, DOUT)}
    if residual:
        shapes["res_fc/kernel"] = (FIN, hd)
    if bias:
        shapes["bias"] = (1, HEADS, DOUT)
    return (jnn.EdgeGATConv(FIN, FE, DOUT, HEADS, residual=residual,
                            bias=bias), _params(seed, shapes))


def _graph_data(seed):
    row, col, n = _square(seed)
    rng = np.random.default_rng(seed + 1)
    return (row, col, n, rng.normal(size=(n, FIN)).astype(np.float32),
            rng.normal(size=(len(row), FE)).astype(np.float32),
            rng.normal(size=(n, HEADS, DOUT)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_modules():
    """The JAX EdgeGATConv (jitted) on its flat route (residual and bias,
    and neither) and on its edge chain (residual and bias): output and the
    gradients of the params, x and the edge features of one cotangent.  On
    the CPU the JAX module never takes its fused route (it needs a TPU)."""
    row, col, n, x, ef, cot = _graph_data(71)
    gj = dgl.graph((row, col), num_nodes=n)
    out = {}
    saved = jconfig._FLAGS["pallas_spmm_min_edges"]
    try:
        for route, residual, bias in (("flat", True, True),
                                      ("flat", False, False),
                                      ("chain", True, True)):
            jconfig._FLAGS["pallas_spmm_min_edges"] = (
                1 if route == "flat" else 10**9)
            mod, params = _jax_edgegat(residual, bias)

            def jloss(p, x, ef, mod=mod):
                h = mod.apply({"params": p}, gj, x, ef)
                return (h * cot).sum(), h

            (_, h), grads = jax.jit(jax.value_and_grad(
                jloss, argnums=(0, 1, 2), has_aux=True))(
                params, jnp.asarray(x), jnp.asarray(ef))
            out[route, residual, bias] = (params, np.asarray(h),
                                          jax.tree_util.tree_map(
                                              np.asarray, grads))
    finally:
        jconfig._FLAGS["pallas_spmm_min_edges"] = saved
    return (row, col, n, x, ef, cot), out


@pytest.fixture
def min_edges_1(monkeypatch):
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)


def _spies():
    return {
        "fused": mock.patch.object(
            tgf, "edgegat_attention_aggregate_v2",
            wraps=tgf.edgegat_attention_aggregate_v2),
        "flat": mock.patch("dgl_tpu_torch.nn.conv.extra.edge_term_sum_flat",
                           wraps=dgt.ops.edgeflat.edge_term_sum_flat),
        "chain": mock.patch("dgl_tpu_torch.nn.conv.extra.update_all",
                            wraps=dgt.update_all)}


def _run(conv, g, x, ef, cot=None, **kw):
    """One forward and backward under the route spies: (output, {route:
    calls})."""
    patches = _spies()
    active = {name: p.start() for name, p in patches.items()}
    try:
        out = conv(g, x, ef, **kw)
        h = out[0] if isinstance(out, tuple) else out
        (h.square().sum() if cot is None else (h * cot).sum()).backward()
    finally:
        for p in patches.values():
            p.stop()
    return out, {k: s.call_count for k, s in active.items()}


@pytest.mark.parametrize("route,residual,bias", [
    ("fused", True, True), ("flat", True, True), ("chain", True, True),
    ("fused", False, False)])
def test_edgegatconv_matches_jax(jax_modules, route, residual, bias,
                                 min_edges_1, monkeypatch):
    """EdgeGATConv on its fused route (K10 v2's plain versions), its flat
    route (the edges split over several chunks) and its edge chain against
    the jitted JAX module on its flat route (the first two) or its edge
    chain, weights by ``edgegatconv_state_dict``: output and the gradients
    of every parameter, x and the edge features."""
    (row, col, n, x, ef, cot), jres = jax_modules
    params, h_j, (gp_j, gx_j, gef_j) = jres[
        "chain" if route == "chain" else "flat", residual, bias]
    conv = dgt.nn.EdgeGATConv(FIN, FE, DOUT, HEADS, residual=residual,
                              bias=bias, device="cpu")
    conv.load_state_dict(edgegatconv_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    if route == "chain":
        monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 10**9)
    else:
        g.create_tiled_format(tile=128, cap=128)
    monkeypatch.setattr("dgl_tpu_torch.nn.conv.extra.EDGEGAT_CHUNK", 1000)
    xt = torch.from_numpy(x).requires_grad_()
    eft = torch.from_numpy(ef).requires_grad_()
    kw = ({"efeats_slot": dgt.nn.EdgeGATConv.slot_edge_feats(g, eft)}
          if route == "fused" else {})
    h, calls = _run(conv, g, xt, eft, torch.from_numpy(cot), **kw)
    assert calls == {k: int(k == route) for k in calls}
    assert not g.ndata and not g.edata
    for got, want in ((h, h_j), (xt.grad, gx_j), (eft.grad, gef_j)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **SUMS)
    names = NAMES + (["res_fc"] if residual else []) + (
        ["bias"] if bias else [])
    for name in names:
        mod = getattr(conv, name)
        got = mod.grad if isinstance(mod, torch.nn.Parameter) else \
            mod.weight.grad.T
        want = gp_j[name] if isinstance(mod, torch.nn.Parameter) else \
            gp_j[name]["kernel"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUMS,
                                   err_msg=name)
    assert conv.fc_dst.weight.grad is None


def test_edgegatconv_state_dict_layout():
    _, params = _jax_edgegat(True, True)
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = edgegatconv_state_dict({"params": params})
    assert set(sd) == {"attn_l", "attn_r", "attn_edge", "bias", "fc.weight",
                       "fc_dst.weight", "fc_edge.weight", "res_fc.weight"}
    assert sd["fc_edge.weight"].shape == (HEADS * DOUT, FE)
    np.testing.assert_array_equal(sd["fc.weight"].numpy(),
                                  params["fc"]["kernel"].T)
    # without flax's fc_dst (never called on a pair), the port's gets fc's
    np.testing.assert_array_equal(sd["fc_dst.weight"].numpy(),
                                  params["fc"]["kernel"].T)
    pair = dict(params, fc_dst={"kernel": 2 * params["fc"]["kernel"]})
    np.testing.assert_array_equal(
        edgegatconv_state_dict(pair)["fc_dst.weight"].numpy(),
        pair["fc_dst"]["kernel"].T)


# -- route selection ---------------------------------------------------------

@pytest.mark.parametrize("case", [
    "fused", "eval_dropout", "no_slot_feats", "untiled", "no_kernels",
    "feat_dropout", "m_too_wide", "attn_dropout", "attention", "few_edges"])
def test_edgegatconv_route(case, min_edges_1, monkeypatch):
    """The fused route needs a tiled format, ``efeats_slot``, enough edges,
    the kernels on, no ``get_attention`` and no dropout active (eval mode
    turns dropout off); without the slot features, the tiled format or the
    kernels, under feature dropout, or when M (Fe x H) does not fit the
    scores kernel's shared memory (``edgegat_fits``), the flat route runs;
    attention
    dropout in training, ``get_attention`` or too few edges take the edge
    chain.  K10 v2's three kernel wrappers run once, twice and once a
    step on the fused route only; nothing leaks into the graph."""
    row, col, n, x, ef, _ = _graph_data(72)
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    if case != "untiled":
        g.create_tiled_format(tile=128, cap=128)
    if case == "no_kernels":
        monkeypatch.setitem(config._FLAGS, "use_kernels", False)
    if case == "few_edges":
        monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 10**9)
    if case == "m_too_wide":
        monkeypatch.setattr(tgf, "edgegat_fits", lambda heads, fe: False)
    drop = {"feat_dropout": dict(feat_drop=0.5),
            "attn_dropout": dict(attn_drop=0.5),
            "eval_dropout": dict(feat_drop=0.5, attn_drop=0.5)}.get(case, {})
    conv = dgt.nn.EdgeGATConv(FIN, FE, DOUT, HEADS, device="cpu",
                              generator=torch.Generator().manual_seed(0),
                              **drop)
    conv.train(case != "eval_dropout")
    eft = torch.from_numpy(ef)
    slot = (None if case in ("no_slot_feats", "untiled")
            else dgt.nn.EdgeGATConv.slot_edge_feats(g, eft))
    wrappers = ("edgegat_scores", "slot_feat_reduce", "edgegat_ds")
    spies = [mock.patch.object(tgf, w, wraps=getattr(tgf, w))
             for w in wrappers]
    counted = [s.start() for s in spies]
    try:
        out, calls = _run(conv, g, torch.from_numpy(x), eft,
                          get_attention=case == "attention",
                          efeats_slot=slot)
    finally:
        for s in spies:
            s.stop()
    route = {"fused": "fused", "eval_dropout": "fused",
             "attention": "chain", "attn_dropout": "chain",
             "few_edges": "chain"}.get(case, "flat")
    assert calls == {k: int(k == route) for k in calls}
    assert [c.call_count for c in counted] == (
        [1, 2, 1] if route == "fused" else [0, 0, 0])
    assert not g.ndata and not g.edata
    if case == "attention":
        assert out[1].shape == (len(row), HEADS, 1)


def test_edgegatconv_fused_route_checks_slot_feats(min_edges_1):
    """The fused route refuses slot features of another width and edge
    features without one row per edge."""
    row, col, n, x, ef, _ = _graph_data(73)
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    g.create_tiled_format(tile=128, cap=128)
    conv = dgt.nn.EdgeGATConv(FIN, FE, DOUT, HEADS, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    eft = torch.from_numpy(ef)
    slot = dgt.nn.EdgeGATConv.slot_edge_feats(g, eft)
    with pytest.raises(ValueError):
        conv(g, torch.from_numpy(x), eft, efeats_slot=slot[..., :-1])
    with pytest.raises(ValueError):
        conv(g, torch.from_numpy(x), eft[:-1], efeats_slot=slot)


def test_edge_softmax_reexport():
    from dgl_tpu_torch.nn.softmax import edge_softmax
    assert edge_softmax is dgt.ops.edge_softmax
