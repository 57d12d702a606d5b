"""Parity of the port's stored-edge-term attention functions, EGATConv v1
(K11 v1, ``egatconv_attention_aggregate``) and EdgeGATConv v1 (K10 v1,
``edgegat_attention_aggregate``), with the JAX package on the CPU: the
plain versions against a float64 oracle, the autograd functions against
the interpreted JAX kernels, the bf16 slot tensors against the f32 ones,
each v1 function against its v2 counterpart on the same leaves, and
``unslot_edge_tensor``.

Layouts: the port's stored slot tensors are (B, C, H * D) without the
TPU's lane padding (``_lane_pad``, ``gat_fused.py:243``); the JAX ones are
(B, C, H * D_pad), so the tests pad the port's inputs for JAX and unpad
its gradients.

Tolerances:
* the plain versions against a float64 numpy oracle of the contract
  (logits clipped to +-40, no max subtraction, the gradients of the JAX
  kernels, which ignore the clip): rtol 1e-5 / atol 1e-5, the atol scaled
  by the largest magnitude for dattn (a sum over every edge);
* against the JAX functions, whose Pallas kernels cast the node operands,
  attn, p, W, zn and ds to bf16 even when interpreted and store dFE and
  dfe in bf16 (``gat_fused.py:959-1054, 1276-1340``; the inputs that form
  the logits are multiples of 1/16, exact in bf16, so lrelu's kink falls
  at the same slots): rtol 5e-2 / atol 6e-2 for out and dx, and for the
  other gradients, sums of bf16 products over many edges, the rule of
  ``tests/test_pallas.py:226-235``: at most 0.5% of elements outside 2e-1
  + 8e-2 |ref|;
* bf16 slot tensors holding the f32 ones' values exactly: out and every
  node gradient equal to 1e-6, the slot gradient equal to the f32 one
  rounded to bf16, and (K11 v1) dFNI, dFNJ equal to 1e-6 to the sums of
  that rounded dFE;
* v1 against v2 on the same leaves, f32, logits inside +-40: rtol 1e-5,
  atol 1e-6 of each result's largest magnitude (sums in another order).

The uncovered-tile graph keeps a dst tile and a src tile with no bucket:
the JAX kernels never write the rows of such a tile (interpreted, they
come back NaN), the port writes 0 (a standing divergence).
"""
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import dgl_tpu.ops.pallas.gat_fused as jgf
import dgl_tpu.ops.pallas.tiled_spmm as jts
import dgl_tpu_torch.ops.kernels.gat_fused as tgf
import dgl_tpu_torch.ops.kernels.tiled_spmm as tts
from test_torch_gat_fused import (BF16, DST_COVERED, ORACLE, SRC_COVERED,
                                  _coo, _formats, _kink_close)

SLOPE = 0.2
# tests/test_pallas.py's graph and sizes (:541-550, :699-708)
P_N, P_E, P_TILE, P_CAP = 260, 1600, 256, 256
# the JAX comparisons: (graph, H, D); "uncovered" is the N = 600 graph of
# test_torch_gat_fused.py with a dst tile and a src tile with no bucket
CASES = [("pallas", 2, 8), ("pallas", 4, 32), ("uncovered", 2, 8)]


def _pallas_graph():
    rng = np.random.default_rng(3)
    row = rng.integers(0, P_N, P_E)
    col = rng.integers(0, P_N, P_E)
    t = tts.build_tiled_format(row, col, P_N, P_N, P_TILE, P_CAP,
                               device="cpu").with_src_first()
    j = jts.build_tiled_format(row, col, P_N, P_N, tile=P_TILE,
                               cap=P_CAP).with_src_first()
    return row, col, P_N, t, j


def _graph(kind):
    if kind == "pallas":
        return _pallas_graph()
    row, col = _coo(81)
    t, j = _formats(row, col)
    return row, col, 600, t, j


def _exact(rng, shape, top=8):
    """Multiples of 1/16 in [-top/16, top/16]: bf16 holds them, and the
    sums the kernels form of them, exactly."""
    return (rng.integers(-top, top + 1, shape) / 16).astype(np.float32)


def _pad_heads(a, heads, dim, dim_pad):
    """(..., H * D) -> (..., H * D_pad), each head's columns zero-padded."""
    lead = a.shape[:-1]
    out = np.zeros(lead + (heads, dim_pad), np.float32)
    out[..., :dim] = np.asarray(a, np.float32).reshape(lead + (heads, dim))
    return out.reshape(lead + (heads * dim_pad,))


def _unpad_heads(a, heads, dim):
    a = np.asarray(a, np.float32)
    lead = a.shape[:-1]
    return a.reshape(lead + (heads, -1))[..., :dim].reshape(
        lead + (heads * dim,))


def _slot(t, a):
    """Canonical (E, F) numpy rows in the port's (B, C, F) slot order."""
    return tgf.slot_edge_tensor(t, torch.from_numpy(np.ascontiguousarray(a)))


def _edge_rows(t, slot_tensor):
    """(E, ...) canonical edge order from a (B, C, ...) slot tensor."""
    return tgf.unslot_edge_tensor(t, torch.as_tensor(slot_tensor)).numpy()


def _lrelu(a, slope):
    return np.where(a >= 0, a, slope * a)


# -- the plain versions against a float64 oracle -----------------------------

def _egatc_oracle(row, col, n, fni, fnj, fe, attn, x, dz, slope):
    """K11 v1 in float64 over the edge list: (out, dfni, dfnj, dfe (E, H *
    D), dattn, dx), the gradients as the JAX kernels compute them (the
    clip ignored)."""
    fni, fnj, fe, attn, x, dz = (a.astype(np.float64) for a in (
        fni, fnj, fe, attn, x, dz))
    heads, dim = attn.shape
    raw = fni[row] + fnj[col] + fe.reshape(-1, heads, dim)
    p = np.exp(np.clip((_lrelu(raw, slope) * attn).sum(-1), -40, 40))
    den = np.zeros((n, heads))
    np.add.at(den, col, p)
    den = np.maximum(den, 1e-20)
    num = np.zeros((n,) + x.shape[1:])
    np.add.at(num, col, p[:, :, None] * x[row])
    out = num / den[:, :, None]
    zn = dz / den[:, :, None]
    rp = (out * dz).sum(-1) / den
    ds = ((x[row] * zn[col]).sum(-1) - rp[col]) * p
    dw = ds[:, :, None] * attn * np.where(raw >= 0, 1.0, slope)
    dfni, dfnj, dx = np.zeros(fni.shape), np.zeros(fnj.shape), np.zeros(
        x.shape)
    np.add.at(dfni, row, dw)
    np.add.at(dfnj, col, dw)
    np.add.at(dx, row, p[:, :, None] * zn[col])
    dattn = (ds[:, :, None] * _lrelu(raw, slope)).sum(0)
    return out, dfni, dfnj, dw.reshape(len(row), -1), dattn, dx


def _edgegat_oracle(row, col, n, el, er, ee, fe, x, dz, slope):
    """K10 v1 in float64 over the edge list: (out, del, der, dee (E, H),
    dfe (E, H * Fh), dx)."""
    el, er, ee, fe, x, dz = (a.astype(np.float64) for a in (
        el, er, ee, fe, x, dz))
    heads = el.shape[1]
    raw = el[row] + er[col] + ee
    p = np.exp(np.clip(_lrelu(raw, slope), -40, 40))
    g = p * np.where(raw >= 0, 1.0, slope)
    den = np.zeros((n, heads))
    np.add.at(den, col, p)
    den = np.maximum(den, 1e-20)
    msg = x[row] + fe.reshape(-1, heads, x.shape[2])
    num = np.zeros((n,) + x.shape[1:])
    np.add.at(num, col, p[:, :, None] * msg)
    out = num / den[:, :, None]
    zn = dz / den[:, :, None]
    rp = (out * dz).sum(-1) / den
    ds = ((msg * zn[col]).sum(-1) - rp[col]) * g
    d_el, d_er, dx = np.zeros(el.shape), np.zeros(er.shape), np.zeros(
        x.shape)
    np.add.at(d_el, row, ds)
    np.add.at(d_er, col, ds)
    dfe = p[:, :, None] * zn[col]
    np.add.at(dx, row, dfe)
    return out, d_el, d_er, ds, dfe.reshape(len(row), -1), dx


@pytest.mark.parametrize("heads,dim", [(2, 8), (1, 41), (3, 5)])
def test_egatc_plain_matches_oracle(heads, dim):
    """K11 v1's forward and backward on the plain versions, chained as the
    autograd function chains the kernels, against float64; rows of the
    uncovered tiles are 0."""
    row, col, n, t, _ = _graph("uncovered")
    rng = np.random.default_rng(82)
    fni, fnj = (0.5 * rng.normal(size=(n, heads, dim)).astype(np.float32)
                for _ in range(2))
    fe = 0.5 * rng.normal(size=(len(row), heads * dim)).astype(np.float32)
    attn = rng.normal(size=(heads, dim)).astype(np.float32)
    x, dz = (rng.normal(size=(n, heads, dim)).astype(np.float32)
             for _ in range(2))
    want = _egatc_oracle(row, col, n, fni, fnj, fe, attn, x, dz, SLOPE)
    ins = [torch.from_numpy(a).requires_grad_() for a in (fni, fnj)]
    fe_slot = _slot(t, fe).requires_grad_()
    a_t, x_t = (torch.from_numpy(a).requires_grad_() for a in (attn, x))
    out = tgf.egatconv_attention_aggregate(t, *ins, fe_slot, a_t, x_t, heads,
                                           dim, dim, SLOPE)
    out.backward(torch.from_numpy(dz))
    np.testing.assert_allclose(out.detach().numpy(), want[0], **ORACLE)
    got = (ins[0].grad, ins[1].grad, _edge_rows(t, fe_slot.grad),
           a_t.grad, x_t.grad)
    for name, a, ref in zip(("dfni", "dfnj", "dfe", "dattn", "dx"), got,
                            want[1:]):
        scale = np.abs(ref).max() if name == "dattn" else 1.0
        np.testing.assert_allclose(np.asarray(a), ref, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)
    valid = t.valid.reshape(t.num_buckets, t.cap) > 0
    assert (fe_slot.grad[~valid] == 0).all()
    assert (out[~torch.from_numpy(DST_COVERED)] == 0).all()
    assert (ins[0].grad[~torch.from_numpy(SRC_COVERED)] == 0).all()


@pytest.mark.parametrize("heads,fh", [(2, 8), (1, 41), (3, 5)])
def test_edgegat_plain_matches_oracle(heads, fh):
    """K10 v1's forward and backward on the plain versions against
    float64; rows of the uncovered tiles are 0."""
    row, col, n, t, _ = _graph("uncovered")
    rng = np.random.default_rng(83)
    el, er = (rng.normal(size=(n, heads)).astype(np.float32)
              for _ in range(2))
    ee = rng.normal(size=(len(row), heads)).astype(np.float32)
    fe = rng.normal(size=(len(row), heads * fh)).astype(np.float32)
    x, dz = (rng.normal(size=(n, heads, fh)).astype(np.float32)
             for _ in range(2))
    want = _edgegat_oracle(row, col, n, el, er, ee, fe, x, dz, SLOPE)
    el_t, er_t, x_t = (torch.from_numpy(a).requires_grad_()
                       for a in (el, er, x))
    ee_slot = _slot(t, ee).permute(0, 2, 1).contiguous().requires_grad_()
    fe_slot = _slot(t, fe).requires_grad_()
    out = tgf.edgegat_attention_aggregate(t, el_t, er_t, ee_slot, fe_slot,
                                          x_t, heads, fh, SLOPE)
    out.backward(torch.from_numpy(dz))
    np.testing.assert_allclose(out.detach().numpy(), want[0], **ORACLE)
    got = (el_t.grad, er_t.grad,
           _edge_rows(t, ee_slot.grad.permute(0, 2, 1)),
           _edge_rows(t, fe_slot.grad), x_t.grad)
    for name, a, ref in zip(("del", "der", "dee", "dfe", "dx"), got,
                            want[1:]):
        np.testing.assert_allclose(np.asarray(a), ref, **ORACLE,
                                   err_msg=name)
    valid = t.valid.reshape(t.num_buckets, t.cap) > 0
    assert (fe_slot.grad[~valid] == 0).all()
    assert (ee_slot.grad.permute(0, 2, 1)[~valid] == 0).all()
    assert (out[~torch.from_numpy(DST_COVERED)] == 0).all()
    assert (x_t.grad[~torch.from_numpy(SRC_COVERED)] == 0).all()


# -- against the JAX functions in Pallas interpret mode ----------------------

def _interpreted():
    orig = pl.pallas_call

    def interpreted(*a, **kw):
        return orig(*a, **{**kw, "interpret": True})

    return (mock.patch.object(jgf.pl, "pallas_call", interpreted),
            mock.patch.object(jts.pl, "pallas_call", interpreted))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{g}-H{h}-D{d}" for g, h, d in CASES])
def jax_v1(request):
    """Both JAX v1 functions, value and vjp, computed once a case with
    their Pallas kernels interpreted, on the lane-padded slot tensors of
    the JAX package's own ``slot_edge_tensor`` (K10 v1's fe in bf16, as
    ``tests/test_pallas.py:718-720`` builds it)."""
    kind, heads, dim = request.param
    row, col, n, t, j = _graph(kind)
    e = len(row)
    rng = np.random.default_rng(84 + heads)
    ins = dict(fni=_exact(rng, (n, heads, dim)),
               fnj=_exact(rng, (n, heads, dim)),
               fe=_exact(rng, (e, heads * dim)),
               attn=_exact(rng, (heads, dim)),
               el=_exact(rng, (n, heads), 16), er=_exact(rng, (n, heads), 16),
               ee=_exact(rng, (e, heads), 16),
               x=rng.normal(size=(n, heads, dim)).astype(np.float32),
               dz=rng.normal(size=(n, heads, dim)).astype(np.float32))
    d_pad = jgf._lane_pad(heads, dim)
    fe_j = jgf.slot_edge_tensor(j, _pad_heads(ins["fe"], heads, dim, d_pad),
                                heads * d_pad)
    ee_j = jnp.transpose(jgf.slot_edge_tensor(j, ins["ee"], heads),
                         (0, 2, 1))
    jx = {k: jnp.asarray(v) for k, v in ins.items()}
    p1, p2 = _interpreted()
    with p1, p2:
        out_c, vjp = jax.vjp(
            lambda fni, fnj, fe, attn, x: jgf.egatconv_attention_aggregate(
                j, fni, fnj, fe, attn, x, heads, dim, dim, SLOPE),
            jx["fni"], jx["fnj"], fe_j, jx["attn"], jx["x"])
        g_c = vjp(jx["dz"])
        out_e, vjp = jax.vjp(
            lambda el, er, ee, fe, x: jgf.edgegat_attention_aggregate(
                j, el, er, ee, fe, x, heads, dim, SLOPE),
            jx["el"], jx["er"], ee_j, fe_j.astype(jnp.bfloat16), jx["x"])
        g_e = vjp(jx["dz"])
    res = dict(egatc=(np.asarray(out_c),) + tuple(
                   np.asarray(a, np.float32) for a in g_c),
               edgegat=(np.asarray(out_e),) + tuple(
                   np.asarray(a, np.float32) for a in g_e))
    return kind, heads, dim, n, t, ins, res


def _covered(kind, n):
    if kind == "uncovered":
        return DST_COVERED, SRC_COVERED
    return np.ones(n, bool), np.ones(n, bool)


def test_egatc_matches_jax(jax_v1):
    """K11 v1's attention and all five gradients (fni, fnj, the slot
    tensor, attn, x) against the interpreted JAX kernels, on the covered
    rows."""
    kind, heads, dim, n, t, ins, res = jax_v1
    want = res["egatc"]
    dst_ok, src_ok = _covered(kind, n)
    fni, fnj, attn, x = (torch.from_numpy(ins[k]).requires_grad_()
                         for k in ("fni", "fnj", "attn", "x"))
    fe_slot = _slot(t, ins["fe"]).requires_grad_()
    out = tgf.egatconv_attention_aggregate(t, fni, fnj, fe_slot, attn, x,
                                           heads, dim, dim, SLOPE)
    out.backward(torch.from_numpy(ins["dz"]))
    np.testing.assert_allclose(out.detach().numpy()[dst_ok],
                               want[0][dst_ok], **BF16)
    np.testing.assert_allclose(x.grad.numpy()[src_ok], want[5][src_ok],
                               **BF16)
    _kink_close(fni.grad.numpy()[src_ok], want[1][src_ok], "dfni")
    _kink_close(fnj.grad.numpy()[dst_ok], want[2][dst_ok], "dfnj")
    valid = t.valid.numpy().reshape(t.num_buckets, t.cap) > 0
    dfe_j = _unpad_heads(want[3], heads, dim)
    _kink_close(fe_slot.grad.numpy()[valid], dfe_j[valid], "dfe")
    assert (fe_slot.grad.numpy()[~valid] == 0).all()
    _kink_close(attn.grad.numpy(), want[4], "dattn")


def test_edgegat_matches_jax(jax_v1):
    """K10 v1's attention and all five gradients (el, er, the two slot
    tensors, x) against the interpreted JAX kernels, on the covered
    rows."""
    kind, heads, fh, n, t, ins, res = jax_v1
    want = res["edgegat"]
    dst_ok, src_ok = _covered(kind, n)
    el, er, x = (torch.from_numpy(ins[k]).requires_grad_()
                 for k in ("el", "er", "x"))
    ee_slot = _slot(t, ins["ee"]).permute(0, 2, 1).contiguous()
    ee_slot.requires_grad_()
    fe_slot = _slot(t, ins["fe"]).requires_grad_()
    out = tgf.edgegat_attention_aggregate(t, el, er, ee_slot, fe_slot, x,
                                          heads, fh, SLOPE)
    out.backward(torch.from_numpy(ins["dz"]))
    np.testing.assert_allclose(out.detach().numpy()[dst_ok],
                               want[0][dst_ok], **BF16)
    np.testing.assert_allclose(x.grad.numpy()[src_ok], want[5][src_ok],
                               **BF16)
    _kink_close(el.grad.numpy()[src_ok], want[1][src_ok], "del")
    _kink_close(er.grad.numpy()[dst_ok], want[2][dst_ok], "der")
    valid = t.valid.numpy().reshape(t.num_buckets, t.cap) > 0
    _kink_close(ee_slot.grad.numpy().transpose(0, 2, 1)[valid],
                want[3].transpose(0, 2, 1)[valid], "dee")
    dfe_j = _unpad_heads(want[4], heads, fh)
    _kink_close(fe_slot.grad.numpy()[valid], dfe_j[valid], "dfe")
    assert (fe_slot.grad.numpy()[~valid] == 0).all()


def test_jax_interpret_leaves_uncovered_rows_unwritten(jax_v1):
    """The JAX v1 forwards write no row of a dst tile without a bucket
    (NaN when interpreted), nor the backwards a row of such a src tile;
    the port writes 0 there.  Where every tile has a bucket, every JAX row
    is written."""
    kind, heads, dim, n, t, ins, res = jax_v1
    dst_ok, src_ok = _covered(kind, n)
    for name in ("egatc", "edgegat"):
        out, g_src = res[name][0], res[name][1]
        assert np.isnan(out[~dst_ok]).all(), name
        assert np.isnan(g_src[~src_ok]).all(), name
        assert np.isfinite(out[dst_ok]).all(), name
        assert np.isfinite(g_src[src_ok]).all(), name
    if kind != "uncovered":
        return
    tin = {k: torch.from_numpy(v) for k, v in ins.items()}
    out = tgf.egatconv_attention_aggregate(
        t, tin["fni"], tin["fnj"], _slot(t, ins["fe"]), tin["attn"],
        tin["x"], heads, dim, dim, SLOPE)
    assert (out[~torch.from_numpy(DST_COVERED)] == 0).all()
    out = tgf.edgegat_attention_aggregate(
        t, tin["el"], tin["er"], _slot(t, ins["ee"]).permute(0, 2, 1),
        _slot(t, ins["fe"]), tin["x"], heads, dim, SLOPE)
    assert (out[~torch.from_numpy(DST_COVERED)] == 0).all()


# -- bf16 slot tensors, and v1 against v2 -------------------------------------

def _bf16_pair(t, a):
    """The slot tensor of ``a`` in f32 and in bf16, equal values."""
    f32 = _slot(t, a)
    return f32.requires_grad_(), f32.detach().to(torch.bfloat16)\
        .requires_grad_()


def test_egatc_bf16_slot_tensor():
    """A bf16 FE that holds the f32 one's values gives the same forward
    and dattn, dFE in bf16 equal to the f32 dFE rounded, and dFNI, dFNJ
    the sums of the rounded dFE."""
    row, col, n, t, _ = _graph("uncovered")
    heads, dim = 2, 8
    rng = np.random.default_rng(85)
    fni, fnj = (_exact(rng, (n, heads, dim)) for _ in range(2))
    fe, attn = _exact(rng, (len(row), heads * dim)), _exact(rng, (heads, dim))
    x, dz = (torch.from_numpy(rng.normal(size=(n, heads, dim)).astype(
        np.float32)) for _ in range(2))
    res = []
    for fe_slot in _bf16_pair(t, fe):
        u, v, a = (torch.from_numpy(b).requires_grad_()
                   for b in (fni, fnj, attn))
        out = tgf.egatconv_attention_aggregate(t, u, v, fe_slot, a, x, heads,
                                               dim, dim, SLOPE)
        out.backward(dz)
        res.append((out.detach(), u.grad, v.grad, fe_slot.grad, a.grad))
    (o32, u32, v32, f32, a32), (o16, u16, v16, f16, a16) = res
    assert f16.dtype == torch.bfloat16 and f32.dtype == torch.float32
    torch.testing.assert_close(o16, o32, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(a16, a32, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(f16, f32.to(torch.bfloat16), rtol=0, atol=0)
    for g16, side in ((u16, "src"), (v16, "dst")):
        want = tgf.slot_vec_reduce_plain(t, f16.float(), side)
        torch.testing.assert_close(g16, want.view(g16.shape), rtol=1e-6,
                                   atol=1e-6)


def test_edgegat_bf16_slot_tensor():
    """A bf16 fe that holds the f32 one's values gives the same forward
    and node gradients, and dfe in bf16 equal to the f32 dfe rounded."""
    row, col, n, t, _ = _graph("uncovered")
    heads, fh = 2, 8
    rng = np.random.default_rng(86)
    el, er = (torch.from_numpy(_exact(rng, (n, heads), 16)) for _ in range(2))
    ee_slot = _slot(t, _exact(rng, (len(row), heads), 16)).permute(0, 2, 1)
    fe = _exact(rng, (len(row), heads * fh))
    x, dz = (torch.from_numpy(rng.normal(size=(n, heads, fh)).astype(
        np.float32)) for _ in range(2))
    res = []
    for fe_slot in _bf16_pair(t, fe):
        l, r, xx = (a.clone().requires_grad_() for a in (el, er, x))
        out = tgf.edgegat_attention_aggregate(t, l, r, ee_slot, fe_slot, xx,
                                              heads, fh, SLOPE)
        out.backward(dz)
        res.append((out.detach(), l.grad, r.grad, xx.grad, fe_slot.grad))
    for name, a16, a32 in zip(("out", "del", "der", "dx"), res[1], res[0]):
        torch.testing.assert_close(a16, a32, rtol=1e-6, atol=1e-6,
                                   msg=lambda m, name=name: f"{name}: {m}")
    assert res[1][4].dtype == torch.bfloat16
    torch.testing.assert_close(res[1][4], res[0][4].to(torch.bfloat16),
                               rtol=0, atol=0)


def _close_scaled(got, want, what):
    """rtol 1e-5, atol 1e-6 of the larger result's largest magnitude."""
    scale = max(float(want.abs().max()), 1.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale,
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("heads,dim", [(2, 8), (4, 32)])
def test_egatc_v1_matches_v2(heads, dim):
    """``egatconv_attention_aggregate`` on FE = ef_slot @ Wf equals
    ``egatconv_attention_aggregate_v2`` on ef_slot and Wf: the value and
    the gradients of fni, fnj, ef_slot, Wf, attn and x."""
    row, col, n, t, _ = _graph("pallas")
    fe_in = 5
    rng = np.random.default_rng(87 + heads)
    leaves = [torch.from_numpy(a) for a in (
        0.5 * rng.normal(size=(n, heads, dim)),
        0.5 * rng.normal(size=(n, heads, dim)),
        rng.normal(size=(len(row), fe_in)),
        0.3 * rng.normal(size=(fe_in, heads * dim)),
        0.5 * rng.normal(size=(heads, dim)),
        rng.normal(size=(n, heads, dim)))]
    leaves = [a.float() for a in leaves]
    leaves[2] = _slot(t, leaves[2].numpy())
    dz = torch.from_numpy(rng.normal(size=(n, heads, dim)).astype(
        np.float32))
    res = []
    for v1 in (True, False):
        fni, fnj, ef_slot, wf, attn, x = (a.clone().requires_grad_()
                                          for a in leaves)
        if v1:
            out = tgf.egatconv_attention_aggregate(
                t, fni, fnj, ef_slot @ wf, attn, x, heads, dim, dim, SLOPE)
        else:
            out = tgf.egatconv_attention_aggregate_v2(
                t, fni, fnj, ef_slot, wf, attn, x, heads, dim, dim, SLOPE)
        out.backward(dz)
        res.append([out.detach()] + [a.grad for a in (
            fni, fnj, ef_slot, wf, attn, x)])
    for name, a1, a2 in zip(("out", "dfni", "dfnj", "def", "dWf", "dattn",
                             "dx"), *res):
        _close_scaled(a1, a2, name)


@pytest.mark.parametrize("heads,fh", [(2, 8), (4, 32)])
def test_edgegat_v1_matches_v2(heads, fh):
    """``edgegat_attention_aggregate`` on fe_slot = ef_slot @ We and
    ee_slot = <fe_slot, attn_e> per head equals
    ``edgegat_attention_aggregate_v2`` on ef_slot, We and attn_e: the value
    and the gradients of el, er, ef_slot, We, attn_e and x."""
    row, col, n, t, _ = _graph("pallas")
    fe_in = 5
    rng = np.random.default_rng(88 + heads)
    leaves = [torch.from_numpy(a).float() for a in (
        rng.normal(size=(n, heads)), rng.normal(size=(n, heads)),
        rng.normal(size=(len(row), fe_in)),
        0.3 * rng.normal(size=(fe_in, heads * fh)),
        0.5 * rng.normal(size=(heads, fh)),
        rng.normal(size=(n, heads, fh)))]
    leaves[2] = _slot(t, leaves[2].numpy())
    dz = torch.from_numpy(rng.normal(size=(n, heads, fh)).astype(np.float32))
    b, cap = t.num_buckets, t.cap
    res = []
    for v1 in (True, False):
        el, er, ef_slot, We, attn_e, x = (a.clone().requires_grad_()
                                          for a in leaves)
        if v1:
            fe_slot = ef_slot @ We
            ee_slot = (fe_slot.view(b, cap, heads, fh) * attn_e).sum(-1)
            out = tgf.edgegat_attention_aggregate(
                t, el, er, ee_slot.permute(0, 2, 1).contiguous(), fe_slot, x,
                heads, fh, SLOPE)
        else:
            out = tgf.edgegat_attention_aggregate_v2(
                t, el, er, ef_slot, We, attn_e, x, heads, fh, SLOPE)
        out.backward(dz)
        res.append([out.detach()] + [a.grad for a in (
            el, er, ef_slot, We, attn_e, x)])
    for name, a1, a2 in zip(("out", "del", "der", "def", "dWe", "dattn_e",
                             "dx"), *res):
        _close_scaled(a1, a2, name)


# -- the slot helpers and the wrappers' checks --------------------------------

def test_unslot_edge_tensor_matches_jax():
    """``unslot_edge_tensor`` inverts ``slot_edge_tensor`` and equals the
    JAX package's."""
    row, col, n, t, j = _graph("uncovered")
    a = np.random.default_rng(89).normal(size=(len(row), 6)).astype(
        np.float32)
    slot = _slot(t, a)
    np.testing.assert_array_equal(tgf.unslot_edge_tensor(t, slot).numpy(), a)
    want = jgf.unslot_edge_tensor(j, jgf.slot_edge_tensor(j, a, 6))
    np.testing.assert_array_equal(
        tgf.unslot_edge_tensor(t, slot).numpy(), np.asarray(want))
    np.testing.assert_array_equal(slot.numpy(),
                                  np.asarray(jgf.slot_edge_tensor(j, a, 6)))


def test_v1_wrapper_checks():
    row, col, n, t, _ = _graph("uncovered")
    heads, dim = 2, 4
    u = torch.zeros(n, heads, dim)
    attn = torch.zeros(heads, dim)
    fe_slot = torch.zeros(t.num_buckets, t.cap, heads * dim)
    ee_slot = torch.zeros(t.num_buckets, heads, t.cap)
    with pytest.raises(ValueError, match="fe_slot"):
        tgf.egatc_scores(t, u, u, attn, fe_slot[..., 1:], SLOPE)
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        tgf.egatc_scores(t, u, u, attn, fe_slot.double(), SLOPE)
    with pytest.raises(ValueError, match="side"):
        tgf.slot_vec_reduce(t, fe_slot, "both")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tgf.dx_dfe(t, u, ee_slot, torch.float16)
    with pytest.raises(ValueError, match="ee_slot"):
        tgf.edgegat_attention_aggregate(t, u[..., 0], u[..., 0],
                                        ee_slot[:, :1], fe_slot, u, heads,
                                        dim, SLOPE)
    bare = tts.build_tiled_format(row, col, n, n, 256, 128, device="cpu")
    with pytest.raises(ValueError, match="src_order"):
        tgf.egatconv_attention_aggregate(bare, u, u, fe_slot, attn, u, heads,
                                         dim, dim, SLOPE)
    with pytest.raises(ValueError, match="src_order"):
        tgf.slot_vec_reduce(bare, fe_slot, "src")
