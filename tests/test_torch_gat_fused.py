"""Parity of the port's slot-space GAT and DotGat attention (K6, K8) with
the JAX package on the CPU: the plain version of each kernel, the three
autograd functions, ``GATConv`` on its slot route, ``DotGatConv``, a
2-layer GAT trained on K6, and which route each module takes.

Tolerances:
* the plain versions against a float64 numpy oracle of the K6 contract
  (logits clipped to +-40, no max subtraction, the gradients of the JAX
  kernels): rtol 1e-5 / atol 1e-5;
* against the JAX functions, whose Pallas kernels cast el, er, x, p, zn
  and ds to bf16 even when interpreted (``gat_fused.py:38-47, 66-73,
  115, 131, 153, 178``): the JAX tests' own rtol 5e-2 / atol 6e-2, and
  for del, der and d(ee_slot), which go through lrelu's kink, the rule of
  ``tests/test_pallas.py:226-235``: at most 0.5% of elements outside
  2e-1 + 8e-2 |ref|;
* against the JAX package's f32 XLA routes (the edge composition,
  edgeflat, the gather path), with logits inside +-40: rtol 1e-4 /
  atol 1e-5, sums over edges taken in another order.

The test graph keeps a dst tile and a src tile with no bucket.  The JAX
forward never writes the rows of such a tile (interpreted, they come back
NaN); the port writes 0, so rows of uncovered tiles are compared with 0
and the rest with JAX.
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
import dgl_tpu.ops.edgeflat as jef
import dgl_tpu.ops.pallas.gat_fused as jgf
import dgl_tpu.ops.pallas.tiled_spmm as jts
import dgl_tpu_torch as dgt
import dgl_tpu_torch.ops.edgeflat as tef
import dgl_tpu_torch.ops.kernels.bitdot as tbd
import dgl_tpu_torch.ops.kernels.gat_fused as tgf
import dgl_tpu_torch.ops.kernels.tiled_spmm as tts
from dgl_tpu import nn as jnn
from dgl_tpu.ops import edge_softmax_unit as j_edge_softmax_unit
from dgl_tpu.ops import gspmm as j_gspmm
from dgl_tpu.ops import gsddmm as j_gsddmm
from dgl_tpu.utils import config as jconfig
from dgl_tpu_torch.params import dotgatconv_state_dict
from dgl_tpu_torch.utils import config
from test_torch_gat import _torch_gat

ORACLE = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=6e-2)
SUMS = dict(rtol=1e-4, atol=1e-5)
SLOPE = 0.2
N, E, TILE, CAP = 600, 3000, 256, 128
# rows of the tiles with no bucket: dst tile 2 and src tile 1
DST_COVERED = np.arange(N) < 512
SRC_COVERED = (np.arange(N) < 256) | (np.arange(N) >= 512)


def _coo(seed=0, n=N, e=E):
    """A multigraph whose dst tile 2 (rows 512-599) has no in-edge and
    whose src tile 1 (rows 256-511) has no out-edge; nodes 512-599 are
    sources only."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n - 256, e)
    row[row >= 256] += 256
    col = rng.integers(0, 512, e)
    row[:100], col[:100] = row[100:200], col[100:200]        # multi-edges
    return row, col


def _formats(row, col):
    t = tts.build_tiled_format(row, col, N, N, TILE, CAP,
                               device="cpu").with_src_first()
    j = jts.build_tiled_format(row, col, N, N, TILE, CAP).with_src_first()
    return t, j


def _inputs(seed, heads, fh, scale=1.0):
    rng = np.random.default_rng(seed)
    el = (scale * rng.normal(size=(N, heads))).astype(np.float32)
    er = (scale * rng.normal(size=(N, heads))).astype(np.float32)
    x = rng.normal(size=(N, heads, fh)).astype(np.float32)
    dz = rng.normal(size=(N, heads, fh)).astype(np.float32)
    return el, er, x, dz


def _edge_order(t, slot_tensor):
    """(E, H) in canonical edge order from a (B, H, C) slot tensor."""
    heads = slot_tensor.shape[1]
    flat = np.asarray(slot_tensor).transpose(0, 2, 1).reshape(-1, heads)
    eid = t.eid.numpy()
    return flat[eid >= 0][np.argsort(eid[eid >= 0])]


def _kink_close(got, want, what):
    d = np.abs(np.asarray(got) - np.asarray(want))
    assert (d > 2e-1 + 8e-2 * np.abs(np.asarray(want))).mean() < 0.005, what


# -- the plain versions against a float64 oracle -----------------------------

def _oracle(row, col, el, er, x, dz, slope, ee=None):
    """The K6 contract in float64 numpy over the edge list: out, p, g, and
    the gradients (del, der, dx, ds) as the JAX kernels compute them."""
    el, er, x, dz = (a.astype(np.float64) for a in (el, er, x, dz))
    raw = el[row] + er[col] + (0.0 if ee is None else ee)
    p = np.exp(np.clip(np.where(raw >= 0, raw, slope * raw), -40, 40))
    g = p * np.where(raw >= 0, 1.0, slope)
    den = np.zeros(el.shape)
    np.add.at(den, col, p)
    den = np.maximum(den, 1e-20)
    num = np.zeros(x.shape)
    np.add.at(num, col, p[:, :, None] * x[row])
    out = num / den[:, :, None]
    zn = dz / den[:, :, None]
    rp = (out * dz).sum(-1) / den
    ds = ((x[row] * zn[col]).sum(-1) - rp[col]) * g
    d_el, d_er, dx = np.zeros(el.shape), np.zeros(el.shape), np.zeros(x.shape)
    np.add.at(d_el, row, ds)
    np.add.at(d_er, col, ds)
    np.add.at(dx, row, p[:, :, None] * zn[col])
    return out, p, g, d_el, d_er, dx, ds


@pytest.mark.parametrize("heads,fh", [(4, 8), (1, 41), (3, 5)])
@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_plain_versions_match_oracle(heads, fh, saturate, bias):
    """Each plain version, chained as the autograd function chains the
    kernels, against float64; ``saturate`` scales the logits far beyond
    the clip (saturated edges get e^40 or e^-40, not a softmax)."""
    row, col = _coo(1)
    t, _ = _formats(row, col)
    el, er, x, dz = _inputs(2, heads, fh, 30.0 if saturate else 1.0)
    ee_e = None
    ee_slot = None
    if bias:
        ee_e = np.random.default_rng(3).normal(size=(E, heads)).astype(
            np.float32)
        ee_slot = tef._w_slot_from_flat(t, torch.from_numpy(ee_e.reshape(-1)),
                                        heads)
    want = _oracle(row, col, el, er, x, dz, SLOPE, ee_e)
    if saturate:
        assert (np.abs(np.log(want[1])) >= 40 - 1e-9).mean() > 0.1
    tel, ter, tx = (torch.from_numpy(a) for a in (el, er, x))
    p, g = tgf.gat_scores(t, tel, ter, SLOPE, ee_slot)
    valid = t.valid.reshape(t.num_buckets, 1, t.cap) > 0
    assert (p.masked_select(~valid) == 0).all()
    assert (g.masked_select(~valid) == 0).all()
    np.testing.assert_allclose(_edge_order(t, p), want[1], **ORACLE)
    np.testing.assert_allclose(_edge_order(t, g), want[2], **ORACLE)
    out, p2, g2, den = tgf.gat_forward(t, tel, ter, tx, heads, fh, SLOPE,
                                       ee_slot)
    np.testing.assert_allclose(out.numpy(), want[0], **ORACLE)
    d_el, d_er, dx, ds = tgf.gat_backward(t, tx, p2, g2, den, out,
                                          torch.from_numpy(dz), heads, fh)
    for got, ref in ((d_el, want[3]), (d_er, want[4]), (dx, want[5])):
        np.testing.assert_allclose(got.numpy(), ref, **ORACLE)
    np.testing.assert_allclose(_edge_order(t, ds), want[6], **ORACLE)
    assert (ds.masked_select(~valid) == 0).all()
    # rows of the uncovered tiles: exactly 0
    assert (out[~torch.from_numpy(DST_COVERED)] == 0).all()
    assert (d_er[~torch.from_numpy(DST_COVERED)] == 0).all()
    assert (d_el[~torch.from_numpy(SRC_COVERED)] == 0).all()
    assert (dx[~torch.from_numpy(SRC_COVERED)] == 0).all()


@pytest.mark.parametrize("heads,d,fh", [(2, 8, 8), (1, 16, 5)])
@pytest.mark.parametrize("saturate", [False, True])
def test_dot_plain_matches_oracle(heads, d, fh, saturate):
    """K8's chain (K4's SDDMM, then K6's plain versions) against float64.
    Saturated, the softmax is nearly one-hot and ds = (<x, zn> - rp) p
    cancels terms of the size of the inputs, so the gradients' atol is
    1e-5 of their largest magnitude."""
    row, col = _coo(4)
    t, _ = _formats(row, col)
    rng = np.random.default_rng(5)
    q = ((30.0 if saturate else 1.0)
         * rng.normal(size=(N, heads, d))).astype(np.float32)
    k = rng.normal(size=(N, heads, d)).astype(np.float32)
    x = rng.normal(size=(N, heads, fh)).astype(np.float32)
    dz = rng.normal(size=(N, heads, fh)).astype(np.float32)
    q64, k64, x64 = (a.astype(np.float64) for a in (q, k, x))
    e = (k64[row] * q64[col]).sum(-1) / np.sqrt(d)
    if saturate:
        assert (np.abs(e) > 40).mean() > 0.1
    p = np.exp(np.clip(e, -40, 40))
    den = np.zeros((N, heads))
    np.add.at(den, col, p)
    den = np.maximum(den, 1e-20)
    num = np.zeros(x.shape)
    np.add.at(num, col, p[:, :, None] * x64[row])
    out = num / den[:, :, None]
    zn = dz / den[:, :, None]
    rp = (out * dz).sum(-1) / den
    ds = ((x64[row] * zn[col]).sum(-1) - rp[col]) * p / np.sqrt(d)
    dq, dk, dx = np.zeros(q.shape), np.zeros(k.shape), np.zeros(x.shape)
    np.add.at(dq, col, ds[:, :, None] * k64[row])
    np.add.at(dk, row, ds[:, :, None] * q64[col])
    np.add.at(dx, row, p[:, :, None] * zn[col])
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, x)]
    got = tgf.dot_gat_attention_aggregate(t, *ins, heads, d, fh)
    got.backward(torch.from_numpy(dz))
    np.testing.assert_allclose(got.detach().numpy(), out, **ORACLE)
    for a, ref in zip(ins, (dq, dk, dx)):
        scale = np.abs(ref).max() if saturate else 1.0
        np.testing.assert_allclose(a.grad.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * scale)


def test_wrapper_checks():
    row, col = _coo(6)
    t, _ = _formats(row, col)
    el, er, x, _ = (torch.from_numpy(a) for a in _inputs(7, 2, 4))
    with pytest.raises(ValueError):
        tgf.gat_scores(t, el[:10], er, SLOPE)
    with pytest.raises(ValueError):
        tgf.slot_reduce(t, torch.zeros(1, 2, t.cap))
    with pytest.raises(ValueError):
        tgf.slot_reduce(t, torch.zeros(t.num_buckets, 2, t.cap), "both")
    bare = tts.build_tiled_format(row, col, N, N, TILE, CAP, device="cpu")
    with pytest.raises(ValueError, match="src_order"):
        tgf.gat_attention_aggregate(bare, el, er, x, 2, 4, SLOPE)
    with pytest.raises(ValueError, match="src_order"):
        tgf.src_aggregate(bare, x, torch.zeros(t.num_buckets, 2, t.cap))


# -- against the JAX functions in Pallas interpret mode ----------------------

J_HEADS, J_FH = 4, 8


@pytest.fixture(scope="module")
def jax_k6():
    """The JAX package's gat / egat / dot_gat attention, values and
    vjps, each computed once with its Pallas kernels interpreted."""
    row, col = _coo(8)
    t, j = _formats(row, col)
    el, er, x, dz = _inputs(9, J_HEADS, J_FH)
    rng = np.random.default_rng(10)
    ee_e = rng.normal(size=(E * J_HEADS,)).astype(np.float32)
    q = rng.normal(size=(N, J_HEADS, J_FH)).astype(np.float32)
    k = rng.normal(size=(N, J_HEADS, J_FH)).astype(np.float32)
    ee_j = jef._w_slot_from_flat(j, jnp.asarray(ee_e), J_HEADS)
    ins = dict(el=el, er=er, x=x, dz=dz, q=q, k=k,
               ee=tef._w_slot_from_flat(t, torch.from_numpy(ee_e), J_HEADS)
               .numpy())
    np.testing.assert_array_equal(ins["ee"], np.asarray(ee_j))
    orig = pl.pallas_call

    def interpreted(*a, **kw):
        return orig(*a, **{**kw, "interpret": True})

    res = {}
    with mock.patch.object(jgf.pl, "pallas_call", interpreted), \
            mock.patch.object(jts.pl, "pallas_call", interpreted):
        cot = jnp.asarray(dz)
        for name, fn, args in (
                ("gat", lambda a, b, c: jgf.gat_attention_aggregate(
                    j, a, b, c, J_HEADS, J_FH, SLOPE), (el, er, x)),
                ("egat", lambda a, b, e, c: jgf.egat_attention_aggregate(
                    j, a, b, e, c, J_HEADS, J_FH, SLOPE), (el, er, ee_j, x)),
                ("dot", lambda a, b, c: jgf.dot_gat_attention_aggregate(
                    j, a, b, c, J_HEADS, J_FH, J_FH), (q, k, x))):
            out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
            res[name] = (np.asarray(out),) + tuple(
                np.asarray(gr) for gr in vjp(cot))
    return t, ins, res


def test_jax_interpret_leaves_uncovered_rows_unwritten(jax_k6):
    """The JAX forward writes no row of a dst tile without a bucket (NaN
    when interpreted), nor its backward a src tile's; the port writes 0."""
    t, ins, res = jax_k6
    out, d_el, _, dx = res["gat"]
    assert np.isnan(out[~DST_COVERED]).all()
    assert np.isnan(d_el[~SRC_COVERED]).all()
    assert np.isnan(dx[~SRC_COVERED]).all()
    assert np.isfinite(out[DST_COVERED]).all()
    got = tgf.gat_attention_aggregate(
        t, torch.from_numpy(ins["el"]), torch.from_numpy(ins["er"]),
        torch.from_numpy(ins["x"]), J_HEADS, J_FH, SLOPE)
    assert (got[~torch.from_numpy(DST_COVERED)] == 0).all()


@pytest.mark.parametrize("kind", ["gat", "egat"])
def test_gat_attention_matches_jax(jax_k6, kind):
    """gat / egat attention and every gradient against the interpreted
    JAX kernels, on the covered rows."""
    t, ins, res = jax_k6
    want = res[kind]
    names = ["el", "er"] + (["ee"] if kind == "egat" else []) + ["x"]
    args = [torch.from_numpy(ins[n]).requires_grad_() for n in names]
    if kind == "gat":
        out = tgf.gat_attention_aggregate(t, *args, J_HEADS, J_FH, SLOPE)
    else:
        out = tgf.egat_attention_aggregate(t, *args, J_HEADS, J_FH, SLOPE)
    out.backward(torch.from_numpy(ins["dz"]))
    np.testing.assert_allclose(out.detach().numpy()[DST_COVERED],
                               want[0][DST_COVERED], **BF16)
    grads = dict(zip(names, (a.grad.numpy() for a in args)))
    ref = dict(zip(names, want[1:]))
    _kink_close(grads["el"][SRC_COVERED], ref["el"][SRC_COVERED], "del")
    _kink_close(grads["er"][DST_COVERED], ref["er"][DST_COVERED], "der")
    np.testing.assert_allclose(grads["x"][SRC_COVERED], ref["x"][SRC_COVERED],
                               **BF16)
    if kind == "egat":
        _kink_close(grads["ee"], ref["ee"], "d_ee")
        valid = t.valid.numpy().reshape(t.num_buckets, 1, t.cap) > 0
        assert (grads["ee"][~np.broadcast_to(valid, grads["ee"].shape)]
                == 0).all()


def test_dot_gat_attention_matches_jax(jax_k6):
    t, ins, res = jax_k6
    out_j, dq_j, dk_j, dx_j = res["dot"]
    args = [torch.from_numpy(ins[n]).requires_grad_() for n in ("q", "k", "x")]
    out = tgf.dot_gat_attention_aggregate(t, *args, J_HEADS, J_FH, J_FH)
    out.backward(torch.from_numpy(ins["dz"]))
    np.testing.assert_allclose(out.detach().numpy()[DST_COVERED],
                               out_j[DST_COVERED], **BF16)
    np.testing.assert_allclose(args[0].grad.numpy()[DST_COVERED],
                               dq_j[DST_COVERED], **BF16)
    for a, want in ((args[1], dk_j), (args[2], dx_j)):
        np.testing.assert_allclose(a.grad.numpy()[SRC_COVERED],
                                   want[SRC_COVERED], **BF16)


# -- against the JAX package's f32 compositions -----------------------------

@pytest.mark.parametrize("kind", ["gat", "dot"])
def test_attention_matches_f32_composition(kind):
    """With logits inside +-40 the clip changes nothing: the port's K6 /
    K8 equals the JAX package's unfused f32 composition (gsddmm, lrelu,
    edge_softmax_unit, gspmm; ``tests/test_pallas.py:207-211, 255-258``),
    values and gradients, uncovered rows included."""
    row, col = _coo(11)
    t, _ = _formats(row, col)
    unit = dgl.graph((row, col), num_nodes=N).unit()
    heads, fh = 3, 6
    el, er, x, dz = _inputs(12, heads, fh)
    q = np.random.default_rng(13).normal(size=(N, heads, fh)).astype(
        np.float32)

    if kind == "gat":
        def ref(a, b, c):
            e = j_gsddmm(unit, "add", a[:, :, None], b[:, :, None], "u", "v")
            e = jnp.where(e >= 0, e, SLOPE * e)
            return j_gspmm(unit, "mul", "sum", c, j_edge_softmax_unit(unit, e))
        args = (el, er, x)
    else:
        def ref(a, b, c):
            e = j_gsddmm(unit, "dot", b, a, "u", "v") / np.sqrt(fh)
            return j_gspmm(unit, "mul", "sum", c, j_edge_softmax_unit(unit, e))
        args = (q, el[:, :, None] * x, x)        # q, k, x
    want, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in args))
    gwant = vjp(jnp.asarray(dz))
    ins = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
           for a in args]
    if kind == "gat":
        got = tgf.gat_attention_aggregate(t, *ins, heads, fh, SLOPE)
    else:
        got = tgf.dot_gat_attention_aggregate(t, *ins, heads, fh, fh)
    got.backward(torch.from_numpy(dz))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **SUMS)
    for a, gw in zip(ins, gwant):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(gw), **SUMS)


# -- the modules --------------------------------------------------------------

@pytest.fixture
def min_edges_1(monkeypatch):
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    monkeypatch.setitem(jconfig._FLAGS, "pallas_spmm_min_edges", 1)


def _square(seed, n=300, e=2500):
    """A square multigraph with some zero-in-degree nodes."""
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n, e), rng.integers(0, n - 30, e)
    row[:50], col[:50] = row[50:100], col[50:100]
    return row, col, n


def _params(seed, shapes):
    """Random flax params of the given {name: shape} (nested by '/'), as
    ``mod.init`` would lay them out, made with numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        node = out
        *path, leaf = name.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(0.3 * rng.normal(size=shape)
                                 .astype(np.float32))
    return out


def _jax_gat(fin, dout, heads, residual, bias, seed=0):
    hd = heads * dout
    shapes = {"fc/kernel": (fin, hd), "attn_l": (1, heads, dout),
              "attn_r": (1, heads, dout)}
    if residual:
        shapes["res_fc/kernel"] = (fin, hd)
    if bias:
        shapes["bias"] = (1, heads, dout)
    return (jnn.GATConv(fin, dout, num_heads=heads, residual=residual,
                        bias=bias), _params(seed, shapes))


@pytest.mark.parametrize("heads,dout,residual,bias", [
    (3, 5, False, True), (2, 8, True, True), (1, 41, False, False)])
def test_gatconv_slot_route_matches_jax(heads, dout, residual, bias,
                                        min_edges_1):
    """GATConv on K6's route (a tiled graph, no attention dropout) against
    JAX GATConv on its f32 edgeflat route (no tiled format), with weights
    carried by ``gatconv_state_dict``: values and all gradients."""
    row, col, n = _square(14)
    fin = 7
    rng = np.random.default_rng(15)
    x = rng.normal(size=(n, fin)).astype(np.float32)
    cot = rng.normal(size=(n, heads, dout)).astype(np.float32)
    mod, params = _jax_gat(fin, dout, heads, residual, bias)
    gj = dgl.graph((row, col), num_nodes=n)

    def jloss(p, x):
        out = mod.apply({"params": p}, gj, x)
        return (out * cot).sum(), out

    (_, out_j), (gp_j, gx_j) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    conv = _torch_gat(params, fin, dout, heads, residual, bias)
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    gt.create_tiled_format(tile=128, cap=128)
    xt = torch.from_numpy(x).requires_grad_()
    with mock.patch.object(tgf, "gat_attention_aggregate",
                           wraps=tgf.gat_attention_aggregate) as spy:
        out_t = conv(gt, xt)
        (out_t * torch.from_numpy(cot)).sum().backward()
    assert spy.call_count == 1
    assert not gt.ndata and not gt.edata
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **SUMS)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **SUMS)
    pairs = [(conv.fc.weight.grad.T, gp_j["fc"]["kernel"]),
             (conv.attn_l.grad, gp_j["attn_l"]),
             (conv.attn_r.grad, gp_j["attn_r"])]
    if residual:
        pairs.append((conv.res_fc.weight.grad.T, gp_j["res_fc"]["kernel"]))
    if bias:
        pairs.append((conv.bias.grad, gp_j["bias"]))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUMS)


def _jax_dotgat(fin, dout, heads, seed=0):
    hd = heads * dout
    return (jnn.DotGatConv(fin, dout, heads),
            _params(seed, {"fc_src/kernel": (fin, hd),
                           "fc_dst/kernel": (fin, hd)}))


@pytest.mark.parametrize("heads,dout", [(4, 8), (1, 16)])
@pytest.mark.parametrize("kernels", [True, False])
def test_dotgatconv_matches_jax(heads, dout, kernels, min_edges_1,
                                monkeypatch):
    """DotGatConv on K8's route (a tiled graph) and on the gather path
    (``use_kernels(False)``) against JAX DotGatConv on its gather path,
    weights by ``dotgatconv_state_dict``: values and all gradients."""
    row, col, n = _square(16)
    fin = 6
    rng = np.random.default_rng(17)
    x = rng.normal(size=(n, fin)).astype(np.float32)
    cot = rng.normal(size=(n, heads, dout)).astype(np.float32)
    mod, params = _jax_dotgat(fin, dout, heads)
    gj = dgl.graph((row, col), num_nodes=n)

    def jloss(p, x):
        out = mod.apply({"params": p}, gj, x)
        return (out * cot).sum(), out

    (_, out_j), (gp_j, gx_j) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    conv = dgt.nn.DotGatConv(fin, dout, heads, device="cpu")
    conv.load_state_dict(dotgatconv_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    gt.create_tiled_format(tile=128, cap=128)
    monkeypatch.setitem(config._FLAGS, "use_kernels", kernels)
    xt = torch.from_numpy(x).requires_grad_()
    with mock.patch.object(tgf, "dot_gat_attention_aggregate",
                           wraps=tgf.dot_gat_attention_aggregate) as spy:
        out_t = conv(gt, xt)
        (out_t * torch.from_numpy(cot)).sum().backward()
    assert spy.call_count == int(kernels)
    assert not gt.ndata and not gt.edata
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **SUMS)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **SUMS)
    for name in ("fc_src", "fc_dst"):
        np.testing.assert_allclose(
            getattr(conv, name).weight.grad.numpy().T,
            np.asarray(gp_j[name]["kernel"]), **SUMS)


def test_dotgatconv_state_dict_layout():
    _, params = _jax_dotgat(5, 3, 2)
    sd = dotgatconv_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, params)})
    assert set(sd) == {"fc_src.weight", "fc_dst.weight"}
    assert sd["fc_src.weight"].shape == (6, 5)
    np.testing.assert_array_equal(sd["fc_dst.weight"].numpy(),
                                  np.asarray(params["fc_dst"]["kernel"]).T)


def test_gat_training_on_k6_matches_jax(min_edges_1):
    """2-layer GAT without attention dropout (feat -> 4 heads x 4 -> elu ->
    1 head x classes), 3 Adam steps: the port through K6's plain versions
    on a tiled graph with an uncovered tile against the JAX package on its
    edgeflat route."""
    rng = np.random.default_rng(18)
    n, feat, classes = 300, 9, 5
    row, col, _ = _square(19, n=n)
    x = rng.normal(size=(n, feat)).astype(np.float32)
    y = rng.integers(0, classes, n)
    lr, steps = 1e-2, 3
    m1, p1 = _jax_gat(feat, 4, 4, False, True, seed=1)
    m2, p2 = _jax_gat(16, classes, 1, False, True, seed=2)
    gj = dgl.graph((row, col), num_nodes=n)
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    def jloss(params):
        h = jax.nn.elu(m1.apply({"params": params["c1"]}, gj, xj)
                       .reshape(n, -1))
        logits = m2.apply({"params": params["c2"]}, gj, h).reshape(n, -1)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, yj).mean()

    params = {"c1": p1, "c2": p2}
    tx = optax.adam(lr)
    opt = tx.init(params)
    losses_j = []
    grad_fn = jax.jit(jax.value_and_grad(jloss))
    for _ in range(steps):
        loss, grads = grad_fn(params)
        up, opt = tx.update(grads, opt)
        params = optax.apply_updates(params, up)
        losses_j.append(float(loss))

    t1 = _torch_gat(p1, feat, 4, 4, False, True)
    t2 = _torch_gat(p2, 16, classes, 1, False, True)
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    gt.create_tiled_format(tile=256, cap=128)     # rows 256-299: tile 1
    opt_t = torch.optim.Adam(list(t1.parameters()) + list(t2.parameters()),
                             lr=lr)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses_t = []
    with mock.patch.object(tgf, "gat_ds", wraps=tgf.gat_ds) as spy:
        for _ in range(steps):
            opt_t.zero_grad()
            h = torch.nn.functional.elu(t1(gt, xt).reshape(n, -1))
            loss = torch.nn.functional.cross_entropy(
                t2(gt, h).reshape(n, -1), yt)
            loss.backward()
            opt_t.step()
            losses_t.append(loss.item())
    assert spy.call_count == 2 * steps
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert losses_t[-1] < losses_t[0]
    for name, mod in (("c1", t1), ("c2", t2)):
        np.testing.assert_allclose(mod.fc.weight.detach().numpy().T,
                                   np.asarray(params[name]["fc"]["kernel"]),
                                   rtol=1e-4, atol=1e-5)


# -- route selection ---------------------------------------------------------

def _routes(conv, g, x):
    """{route: calls} of one forward and backward of ``conv``."""
    spies = {
        "k7": mock.patch.object(tbd, "bitdot_attention_aggregate",
                                wraps=tbd.bitdot_attention_aggregate),
        "k6": mock.patch.object(tgf, "gat_attention_aggregate",
                                wraps=tgf.gat_attention_aggregate),
        "k8": mock.patch.object(tgf, "dot_gat_attention_aggregate",
                                wraps=tgf.dot_gat_attention_aggregate),
        "edgeflat": mock.patch(
            "dgl_tpu_torch.nn.conv.gatconv.edge_softmax_flat",
            wraps=tef.edge_softmax_flat),
        "k4": mock.patch.object(tts, "tiled_spmm_multihead",
                                wraps=tts.tiled_spmm_multihead),
        "gather": mock.patch("dgl_tpu_torch.nn.conv.gatconv.update_all",
                             wraps=dgt.update_all),
    }
    active = {name: p.start() for name, p in spies.items()}
    try:
        conv(g, x).square().sum().backward()
    finally:
        for p in spies.values():
            p.stop()
    assert not g.ndata and not g.edata          # nothing leaks
    return {name: spy.call_count for name, spy in active.items()}


@pytest.mark.parametrize("case", ["train_dropout", "eval", "no_dropout",
                                  "untiled", "no_kernels"])
def test_gatconv_route(case, min_edges_1, monkeypatch):
    """Attention dropout in training takes edgeflat (K4); eval mode or
    ``attn_drop=0`` takes K6; a graph without a tiled format takes
    edgeflat's gather path, and so does ``use_kernels(False)``."""
    row, col, n = _square(20)
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    if case != "untiled":
        g.create_tiled_format(tile=128, cap=128)
    if case == "no_kernels":
        monkeypatch.setitem(config._FLAGS, "use_kernels", False)
    conv = dgt.nn.GATConv(5, 4, 2, attn_drop=0.0 if case == "no_dropout"
                          else 0.6, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    conv.train(case != "eval")
    calls = _routes(conv, g, torch.randn(n, 5))
    k6 = case in ("eval", "no_dropout")
    assert calls["k6"] == int(k6)
    assert calls["edgeflat"] == int(not k6)
    assert calls["k4"] == (1 if k6 else 2 if case == "train_dropout" else 0)
    assert calls["gather"] == 0


@pytest.mark.parametrize("bits,tiled", [(True, True), (True, False),
                                        (False, True), (False, False)])
def test_dotgatconv_route(bits, tiled, min_edges_1):
    """DotGatConv takes K7 on a simple bit format at D >= 64 and H * D <=
    128, as the JAX package does, whether or not the graph is also tiled;
    otherwise K8 on a tiled graph and the gather path without one."""
    rng = np.random.default_rng(21)
    n = 200
    key = np.unique(rng.integers(0, n * n, 1500))
    g = dgt.graph((key % n, key // n), num_nodes=n, device="cpu")
    if bits:
        g.unit().create_bitmask_format()
    if tiled:
        g.create_tiled_format(tile=128, cap=128)
    conv = dgt.nn.DotGatConv(6, 64, 2, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    calls = _routes(conv, g, torch.randn(n, 6))
    assert calls["k7"] == int(bits)
    assert calls["k8"] == int(tiled and not bits)
    assert calls["gather"] == int(not tiled and not bits)
    assert calls["k4"] == 2 * int(tiled and not bits)   # num and dq
