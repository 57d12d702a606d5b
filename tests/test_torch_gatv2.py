"""Parity of the port's vector attention (K9: GATv2, K11 v2: EGATConv)
with the JAX package on the CPU: the plain version of each kernel against
a float64 oracle, the two autograd functions against the interpreted JAX
kernels and the f32 XLA composition, ``GATv2Conv`` and ``EGATConv`` on
each of their routes, a 2-layer GATv2 trained on K9, and which route each
module takes.

Tolerances:
* the plain versions against a float64 numpy oracle of the K9 contract
  (logits clipped to +-40, no max subtraction, the gradients of the JAX
  kernels, which ignore the clip): rtol 1e-5 / atol 1e-5, the atol scaled
  by the largest magnitude for da and dWf (sums over every edge) and for
  every gradient with saturated logits, and rtol 1e-4 with saturated
  logits (a logit of magnitude 40, a dot product summed in f32, carries an
  absolute error of about 1e-5, which exp turns into a relative one);
* against the JAX functions, whose Pallas kernels cast U, V, x, ef, Wf,
  attn, lrelu(raw), ds and dW to bf16 even when interpreted (the inputs
  that form raw are chosen exact in bf16, so the kink falls at the same
  slots) (``gat_fused.py:674-685,
  715-727, 1550-1555, 2014-2021``): rtol 5e-2 / atol 6e-2 for out and dx,
  and for the gradients that go through lrelu's kink (dU, dV, da, d(ef),
  dWf) the rule of ``tests/test_pallas.py:226-235``: at most 0.5% of
  elements outside 2e-1 + 8e-2 |ref|;
* against the JAX package's f32 XLA routes (the edge composition, the
  edge chain, the flat route), with logits inside +-40: rtol 1e-4 / atol
  1e-5, sums over edges taken in another order.

The test graph keeps a dst tile and a src tile with no bucket: the JAX
kernels never write the rows of such a tile (interpreted, they come back
NaN), the port writes 0.
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
import dgl_tpu.ops.pallas.gat_fused as jgf
import dgl_tpu.ops.pallas.tiled_spmm as jts
import dgl_tpu_torch as dgt
import dgl_tpu_torch.ops.kernels.gat_fused as tgf
from dgl_tpu import nn as jnn
from dgl_tpu.ops import edge_softmax_unit as j_edge_softmax_unit
from dgl_tpu.ops import gspmm as j_gspmm
from dgl_tpu.ops import gsddmm as j_gsddmm
from dgl_tpu.utils import config as jconfig
from dgl_tpu_torch.params import egatconv_state_dict, gatv2conv_state_dict
from dgl_tpu_torch.utils import config
from test_torch_gat_fused import (BF16, DST_COVERED, E, N, ORACLE,
                                  SRC_COVERED, SUMS, _coo, _formats,
                                  _kink_close, _params, _square)

SLOPE = 0.2
EGAT_SLOPE = 0.01
FE = 5


def _edge_rows(t, slot_tensor):
    """(E, ...) in canonical edge order from a (B, C, ...) slot tensor."""
    a = np.asarray(slot_tensor)
    flat = a.reshape((-1,) + a.shape[2:])
    eid = t.eid.numpy()
    return flat[eid >= 0][np.argsort(eid[eid >= 0])]


def _edge_heads(t, slot_tensor):
    """(E, H) in canonical edge order from a (B, H, C) slot tensor."""
    return _edge_rows(t, np.asarray(slot_tensor).transpose(0, 2, 1))


def _inputs(seed, heads, dim, scale=1.0, edge=None):
    """U, V, x, attn, dz and, with ``edge`` ("fe" or "bias"), canonical
    edge features (E, FE) and wf (FE or FE + 1, H * D)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, s=1.0):
        return (s * rng.normal(size=shape)).astype(np.float32)

    U, V = normal(N, heads, dim, s=scale), normal(N, heads, dim, s=scale)
    x, dz = normal(N, heads, dim), normal(N, heads, dim)
    attn = normal(heads, dim, s=0.5)
    ef = wf = None
    if edge is not None:
        ef = normal(E, FE)
        wf = normal(FE + (edge == "bias"), heads * dim, s=0.3 * scale)
    return U, V, x, attn, dz, ef, wf


# -- the plain versions against a float64 oracle -----------------------------

def _oracle(row, col, U, V, x, attn, dz, slope, ef=None, wf=None):
    """The K9 / K11 v2 contract in float64 numpy over the edge list: (out,
    p, dU, dV, dx, da, d_ef, dwf); p and the gradients as the JAX kernels
    compute them (ds with g = p, dW = ds attn lrelu'(raw))."""
    U, V, x, attn, dz = (a.astype(np.float64) for a in (U, V, x, attn, dz))
    heads, dim = attn.shape
    raw = U[row] + V[col]
    if ef is not None:
        ef, wf = ef.astype(np.float64), wf.astype(np.float64)
        term = ef @ wf[:FE] + (wf[FE] if wf.shape[0] > FE else 0.0)
        raw = raw + term.reshape(-1, heads, dim)
    lr = np.where(raw >= 0, raw, slope * raw)
    p = np.exp(np.clip((lr * attn).sum(-1), -40, 40))
    den = np.zeros((N, heads))
    np.add.at(den, col, p)
    den = np.maximum(den, 1e-20)
    num = np.zeros(x.shape)
    np.add.at(num, col, p[:, :, None] * x[row])
    out = num / den[:, :, None]
    zn = dz / den[:, :, None]
    rp = (out * dz).sum(-1) / den
    ds = ((x[row] * zn[col]).sum(-1) - rp[col]) * p
    dw = ds[:, :, None] * attn * np.where(raw >= 0, 1.0, slope)
    dU, dV, dx = np.zeros(U.shape), np.zeros(V.shape), np.zeros(x.shape)
    np.add.at(dU, row, dw)
    np.add.at(dV, col, dw)
    np.add.at(dx, row, p[:, :, None] * zn[col])
    da = (ds[:, :, None] * lr).sum(0)
    d_ef = dwf = None
    if ef is not None:
        dw2 = dw.reshape(len(row), -1)
        d_ef = dw2 @ wf[:FE].T
        ones = np.ones((len(row), wf.shape[0] - FE))
        dwf = np.concatenate([ef, ones], 1).T @ dw2
    return out, p, dU, dV, dx, da, d_ef, dwf


@pytest.mark.parametrize("heads,dim", [(2, 8), (1, 41)])
@pytest.mark.parametrize("edge", [None, "fe", "bias"])
@pytest.mark.parametrize("saturate", [False, True])
def test_plain_versions_match_oracle(heads, dim, edge, saturate):
    """Each plain version, chained as the autograd function chains the
    kernels, against float64; ``saturate`` scales the logits far beyond
    the clip (saturated edges get e^40 or e^-40, not a softmax)."""
    row, col = _coo(31)
    t, _ = _formats(row, col)
    U, V, x, attn, dz, ef, wf = _inputs(32, heads, dim,
                                        30.0 if saturate else 1.0, edge)
    want = _oracle(row, col, U, V, x, attn, dz, SLOPE, ef, wf)
    if saturate:
        assert (np.abs(np.log(want[1])) >= 40 - 1e-9).mean() > 0.1
    tU, tV, tx, ta, tdz = (torch.from_numpy(a) for a in (U, V, x, attn, dz))
    ef_slot = twf = None
    if edge is not None:
        ef_slot = tgf.slot_edge_tensor(t, torch.from_numpy(ef))
        twf = torch.from_numpy(wf)
    p = tgf.vattn_scores(t, tU, tV, ta, SLOPE, ef_slot, twf)
    valid = t.valid.reshape(t.num_buckets, 1, t.cap) > 0
    assert (p.masked_select(~valid) == 0).all()
    # saturated, logits of magnitude 40 are dot products summed in f32
    # with an absolute error of about 1e-5, which exp makes relative
    tol = dict(rtol=1e-4, atol=1e-5) if saturate else ORACLE
    np.testing.assert_allclose(_edge_heads(t, p), want[1], **tol)
    out, p2, den = tgf.vattn_forward(t, tU, tV, tx, ta, heads, dim, SLOPE,
                                     ef_slot, twf)
    np.testing.assert_allclose(out.numpy(), want[0], **tol)
    dU, dV, dx, da, d_ef, dwf = tgf.vattn_backward(
        t, tU, tV, tx, ta, p2, den, out, tdz, SLOPE, ef_slot, twf)
    got = [dU, dV, dx, da] + ([d_ef, dwf] if edge else [])
    refs = list(want[2:6]) + ([want[6], want[7]] if edge else [])
    for name, a, ref in zip(("dU", "dV", "dx", "da", "d_ef", "dwf"), got,
                            refs):
        a = a.numpy()
        if name == "d_ef":
            assert (a.reshape(-1, FE)[t.eid.numpy() < 0] == 0).all()
            a = _edge_rows(t, a)
        # da and dwf sum over every edge: atol of their largest magnitude
        scale = (np.abs(ref).max() if saturate or name in ("da", "dwf")
                 else 1.0)
        np.testing.assert_allclose(a, ref, rtol=tol["rtol"],
                                   atol=1e-5 * scale, err_msg=name)
    # rows of the uncovered tiles: exactly 0
    assert (out[~torch.from_numpy(DST_COVERED)] == 0).all()
    assert (dV[~torch.from_numpy(DST_COVERED)] == 0).all()
    assert (dU[~torch.from_numpy(SRC_COVERED)] == 0).all()
    assert (dx[~torch.from_numpy(SRC_COVERED)] == 0).all()


def test_slot_grad_skips_def_when_not_needed():
    """``need_def=False`` gives no d(ef) and the same da and dwf."""
    row, col = _coo(33)
    t, _ = _formats(row, col)
    U, V, _, attn, _, ef, wf = (None if a is None else torch.from_numpy(a)
                                for a in _inputs(34, 2, 8, edge="bias"))
    ef_slot = tgf.slot_edge_tensor(t, ef)
    ds = torch.randn(t.num_buckets, 2, t.cap) * t.valid.view(
        t.num_buckets, 1, t.cap)
    full = tgf.vattn_slot_grad(t, U, V, attn, ds, SLOPE, ef_slot, wf)
    part = tgf.vattn_slot_grad(t, U, V, attn, ds, SLOPE, ef_slot, wf,
                               need_def=False)
    assert part[1] is None and full[1] is not None
    torch.testing.assert_close(part[0], full[0], rtol=0, atol=0)
    torch.testing.assert_close(part[2], full[2], rtol=0, atol=0)


def test_wrapper_checks():
    row, col = _coo(35)
    t, _ = _formats(row, col)
    U, V, x, attn, _, ef, wf = (None if a is None else torch.from_numpy(a)
                                for a in _inputs(36, 2, 8, edge="fe"))
    ef_slot = tgf.slot_edge_tensor(t, ef)
    with pytest.raises(ValueError):
        tgf.vattn_scores(t, U[:10], V, attn, SLOPE)
    with pytest.raises(ValueError):
        tgf.vattn_scores(t, U, V, attn[:1], SLOPE)
    with pytest.raises(ValueError, match="both"):
        tgf.vattn_scores(t, U, V, attn, SLOPE, ef_slot)
    with pytest.raises(ValueError, match="wf"):
        tgf.vattn_scores(t, U, V, attn, SLOPE, ef_slot, wf[:, :3])
    with pytest.raises(ValueError, match="side"):
        tgf.vattn_node_grad(t, U, V, attn,
                            torch.zeros(t.num_buckets, 2, t.cap), SLOPE,
                            "both")
    bare = dgt.ops.kernels.tiled_spmm.build_tiled_format(
        row, col, N, N, 256, 128, device="cpu")
    with pytest.raises(ValueError, match="src_order"):
        tgf.gatv2_attention_aggregate(bare, U, V, x, attn, 2, 8, 8, SLOPE)
    with pytest.raises(ValueError, match="at most"):
        tgf._fe_cap(tgf.MAX_FE_ROWS + 1)


# -- against the JAX functions in Pallas interpret mode ----------------------

J_HEADS, J_DIM, J_FIN = 2, 8, 7


def _ef_t(j, ef, bias: bool):
    """The JAX fused route's slot-transposed edge features (``gatconv.py:
    403-416``): (B, Fe_pad, C) bf16 with the bias's ones row."""
    rows = FE + int(bias)
    fe_pad = max(16, -(-rows // 16) * 16)
    slot = np.asarray(jgf.slot_edge_tensor(j, ef, FE))
    ef_t = np.zeros((j.num_buckets, fe_pad, j.cap), np.float32)
    ef_t[:, :FE, :] = slot.transpose(0, 2, 1)
    if bias:
        ef_t[:, FE, :] = 1.0
    return jnp.asarray(ef_t, jnp.bfloat16), fe_pad


def _exact(rng, shape, top=8):
    """Multiples of 1/16 in [-top/16, top/16]: bf16 holds them, and the
    sums the kernels form of them, exactly."""
    return (rng.integers(-top, top + 1, shape) / 16).astype(np.float32)


@pytest.fixture(scope="module")
def jax_k9():
    """The JAX package's gatv2 and egatconv v2 attention, values and vjps,
    each computed once with its Pallas kernels interpreted.  The inputs
    that form raw are multiples of 1/16 (``_exact``) and the egat node
    features and edge features are in {-1, 0, 1}, so that raw, which the
    TPU kernels form from bf16 operands, is exact on both sides and
    lrelu's kink falls at the same slots.  The egat inputs come from node
    features X and flax-style weights, so that the fused EGATConv route is
    held to them too."""
    row, col = _coo(37)
    t, j = _formats(row, col)
    rng = np.random.default_rng(38)
    hd = J_HEADS * J_DIM
    U, V = (_exact(rng, (N, J_HEADS, J_DIM), 16) for _ in range(2))
    x, dz = (rng.normal(size=(N, J_HEADS, J_DIM)).astype(np.float32)
             for _ in range(2))
    attn = _exact(rng, (J_HEADS, J_DIM))
    X = rng.integers(-1, 2, (N, J_FIN)).astype(np.float32)
    ef = rng.integers(-1, 2, (E, FE)).astype(np.float32)
    eparams = {"fc_node_src": {"kernel": _exact(rng, (J_FIN, hd))},
               "fc_ni": {"kernel": _exact(rng, (J_FIN, hd))},
               "fc_fij": {"kernel": _exact(rng, (FE, hd))},
               "fc_nj": {"kernel": _exact(rng, (J_FIN, hd))},
               "attn": _exact(rng, (1, J_HEADS, J_DIM)),
               "bias": _exact(rng, (hd,))}
    ef_t, fe_pad = _ef_t(j, ef, True)
    wfull = np.concatenate([eparams["fc_fij"]["kernel"],
                            eparams["bias"][None]])
    wf_p = jgf.pad_We_heads(jnp.asarray(wfull), J_HEADS, J_DIM, fe_pad)
    proj = {n: (X @ eparams[n]["kernel"]).reshape(N, J_HEADS, J_DIM)
            for n in ("fc_node_src", "fc_ni", "fc_nj")}
    orig = pl.pallas_call

    def interpreted(*a, **kw):
        return orig(*a, **{**kw, "interpret": True})

    res = {}
    with mock.patch.object(jgf.pl, "pallas_call", interpreted), \
            mock.patch.object(jts.pl, "pallas_call", interpreted):
        cot = jnp.asarray(dz)
        for name, fn, args in (
                ("gatv2", lambda u, v, z, a: jgf.gatv2_attention_aggregate(
                    j, u, v, z, a, J_HEADS, J_DIM, J_DIM, SLOPE),
                 (U, V, x, attn)),
                ("egat", lambda u, v, e, w, a, z:
                    jgf.egatconv_attention_aggregate_v2(
                        j, u, v, e, w, a, z, J_HEADS, J_DIM, J_DIM,
                        EGAT_SLOPE),
                 (proj["fc_ni"], proj["fc_nj"], ef_t, wf_p,
                  eparams["attn"][0], proj["fc_node_src"]))):
            out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
            res[name] = (np.asarray(out),) + tuple(
                np.asarray(g, np.float32) for g in vjp(cot))
    ins = dict(U=U, V=V, x=x, attn=attn, dz=dz, ef=ef, X=X, row=row,
               col=col, eparams=eparams, proj=proj, fe_pad=fe_pad)
    return t, ins, res


def _unpad_wf(dwf_p, rows):
    """JAX's (Fe_pad, H * D_pad) dWf back to (rows, H * D)."""
    d_pad = dwf_p.shape[1] // J_HEADS
    return dwf_p.reshape(-1, J_HEADS, d_pad)[:rows, :, :J_DIM].reshape(
        rows, -1)


@pytest.mark.parametrize("kind", ["gatv2", "egat"])
def test_jax_interpret_leaves_uncovered_rows_unwritten(jax_k9, kind):
    """The JAX forward writes no row of a dst tile without a bucket (NaN
    when interpreted), nor its backward a src tile's; the port writes 0."""
    t, ins, res = jax_k9
    out, d_u, d_v = res[kind][:3]
    dx = res[kind][-1] if kind == "egat" else res[kind][3]
    assert np.isnan(out[~DST_COVERED]).all()
    assert np.isnan(d_v[~DST_COVERED]).all()
    assert np.isnan(d_u[~SRC_COVERED]).all()
    assert np.isnan(dx[~SRC_COVERED]).all()
    assert np.isfinite(out[DST_COVERED]).all()
    got = tgf.gatv2_attention_aggregate(
        t, *(torch.from_numpy(ins[n]) for n in ("U", "V", "x", "attn")),
        J_HEADS, J_DIM, J_DIM, SLOPE)
    assert (got[~torch.from_numpy(DST_COVERED)] == 0).all()


def test_gatv2_attention_matches_jax(jax_k9):
    """gatv2 attention and every gradient against the interpreted JAX
    kernels, on the covered rows."""
    t, ins, res = jax_k9
    want = res["gatv2"]
    args = [torch.from_numpy(ins[n]).requires_grad_()
            for n in ("U", "V", "x", "attn")]
    out = tgf.gatv2_attention_aggregate(t, *args, J_HEADS, J_DIM, J_DIM,
                                        SLOPE)
    out.backward(torch.from_numpy(ins["dz"]))
    np.testing.assert_allclose(out.detach().numpy()[DST_COVERED],
                               want[0][DST_COVERED], **BF16)
    dU, dV, dx, da = (a.grad.numpy() for a in args)
    _kink_close(dU[SRC_COVERED], want[1][SRC_COVERED], "dU")
    _kink_close(dV[DST_COVERED], want[2][DST_COVERED], "dV")
    np.testing.assert_allclose(dx[SRC_COVERED], want[3][SRC_COVERED], **BF16)
    _kink_close(da, want[4], "da")


def test_egat_attention_matches_jax(jax_k9):
    """egatconv v2 attention and every gradient (fni, fnj, ef, Wf with the
    bias row, attn, x) against the interpreted JAX kernels."""
    t, ins, res = jax_k9
    want = res["egat"]
    ep, proj = ins["eparams"], ins["proj"]
    wfull = np.concatenate([ep["fc_fij"]["kernel"], ep["bias"][None]])
    args = [torch.from_numpy(a).requires_grad_() for a in (
        proj["fc_ni"], proj["fc_nj"])]
    ef_slot = tgf.slot_edge_tensor(t, torch.from_numpy(ins["ef"]))
    ef_slot.requires_grad_()
    wf = torch.from_numpy(wfull).requires_grad_()
    attn = torch.from_numpy(ep["attn"][0]).requires_grad_()
    x3 = torch.from_numpy(proj["fc_node_src"]).requires_grad_()
    out = tgf.egatconv_attention_aggregate_v2(
        t, args[0], args[1], ef_slot, wf, attn, x3, J_HEADS, J_DIM, J_DIM,
        EGAT_SLOPE)
    out.backward(torch.from_numpy(ins["dz"]))
    np.testing.assert_allclose(out.detach().numpy()[DST_COVERED],
                               want[0][DST_COVERED], **BF16)
    _kink_close(args[0].grad.numpy()[SRC_COVERED], want[1][SRC_COVERED],
                "d_fni")
    _kink_close(args[1].grad.numpy()[DST_COVERED], want[2][DST_COVERED],
                "d_fnj")
    d_ef_j = want[3][:, :FE, :].transpose(0, 2, 1)        # (B, C, Fe)
    _kink_close(ef_slot.grad.numpy(), d_ef_j, "d_ef")
    valid = t.valid.numpy().reshape(-1) > 0
    assert (ef_slot.grad.numpy().reshape(-1, FE)[~valid] == 0).all()
    _kink_close(wf.grad.numpy(), _unpad_wf(want[4], FE + 1), "dWf")
    _kink_close(attn.grad.numpy(), want[5], "da")
    np.testing.assert_allclose(x3.grad.numpy()[SRC_COVERED],
                               want[6][SRC_COVERED], **BF16)


# -- against the JAX package's f32 compositions -----------------------------

@pytest.mark.parametrize("edge", [None, "fe", "bias"])
def test_attention_matches_f32_composition(edge):
    """With logits inside +-40 the clip changes nothing: the port's K9 /
    K11 v2 equals the JAX package's unfused f32 composition (gsddmm, the
    edge term, lrelu, the dot with attn, edge_softmax_unit, gspmm), values
    and gradients, uncovered rows included."""
    row, col = _coo(41)
    t, _ = _formats(row, col)
    unit = dgl.graph((row, col), num_nodes=N).unit()
    heads, dim = 3, 5
    U, V, x, attn, dz, ef, wf = _inputs(42, heads, dim, edge=edge)
    slope = SLOPE if edge is None else EGAT_SLOPE

    def ref(u, v, z, a, *edge_args):
        e = j_gsddmm(unit, "add", u, v, "u", "v")          # (E, H, D)
        if edge_args:
            ef_, wf_ = edge_args
            term = ef_ @ wf_[:FE]
            if wf_.shape[0] > FE:
                term = term + wf_[FE]
            e = e + term.reshape(-1, heads, dim)
        e = jnp.where(e >= 0, e, slope * e)
        e = (e * a).sum(-1, keepdims=True)
        return j_gspmm(unit, "mul", "sum", z, j_edge_softmax_unit(unit, e))

    args = (U, V, x, attn) + (() if edge is None else (ef, wf))
    want, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in args))
    gwant = vjp(jnp.asarray(dz))
    ins = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
           for a in args]
    if edge is None:
        got = tgf.gatv2_attention_aggregate(t, *ins, heads, dim, dim, slope)
    else:
        ef_slot = tgf.slot_edge_tensor(t, ins[4])       # differentiable
        got = tgf.egatconv_attention_aggregate_v2(
            t, ins[0], ins[1], ef_slot, ins[5], ins[3], ins[2], heads, dim,
            dim, slope)
    got.backward(torch.from_numpy(dz))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **SUMS)
    for name, a, gw in zip(("U", "V", "x", "attn", "ef", "wf"), ins, gwant):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(gw), **SUMS,
                                   err_msg=name)


# -- the modules --------------------------------------------------------------

@pytest.fixture
def min_edges_1(monkeypatch):
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    monkeypatch.setitem(jconfig._FLAGS, "pallas_spmm_min_edges", 1)


def _jax_gatv2(fin, dout, heads, share, residual, bias, seed=0):
    hd = heads * dout
    shapes = {"fc_src/kernel": (fin, hd), "attn": (1, heads, dout)}
    if bias:
        shapes["fc_src/bias"] = (hd,)
    if not share:
        shapes["fc_dst/kernel"] = (fin, hd)
        if bias:
            shapes["fc_dst/bias"] = (hd,)
    if residual:
        shapes["res_fc/kernel"] = (fin, hd)
    return (jnn.GATv2Conv(fin, dout, num_heads=heads, residual=residual,
                          bias=bias, share_weights=share),
            _params(seed, shapes))


def _torch_gatv2(params, fin, dout, heads, share, residual, bias):
    conv = dgt.nn.GATv2Conv(fin, dout, heads, residual=residual, bias=bias,
                            share_weights=share, device="cpu")
    conv.load_state_dict(gatv2conv_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return conv


def _grad_pairs(conv, gp, names):
    """(port gradient, JAX gradient) of each Dense and array parameter."""
    pairs = []
    for name in names:
        if name in ("attn", "bias"):
            pairs.append((getattr(conv, name).grad, gp[name]))
            continue
        lin = getattr(conv, name)
        pairs.append((lin.weight.grad.T, gp[name]["kernel"]))
        if "bias" in gp[name]:
            pairs.append((lin.bias.grad, gp[name]["bias"]))
    return pairs


@pytest.mark.parametrize("share,residual,bias", [
    (False, False, True), (True, True, True), (False, True, False)])
@pytest.mark.parametrize("route", ["k9", "chain"])
def test_gatv2conv_matches_jax(share, residual, bias, route, min_edges_1,
                               monkeypatch):
    """GATv2Conv on K9's route (a tiled graph) and on the edge chain
    (``use_kernels(False)``) against JAX GATv2Conv on its f32 edge chain
    (no tiled format), with weights carried by ``gatv2conv_state_dict``:
    values and all gradients."""
    row, col, n = _square(43)
    fin, heads, dout = 6, 2, 4
    rng = np.random.default_rng(44)
    x = rng.normal(size=(n, fin)).astype(np.float32)
    cot = rng.normal(size=(n, heads, dout)).astype(np.float32)
    mod, params = _jax_gatv2(fin, dout, heads, share, residual, bias)
    gj = dgl.graph((row, col), num_nodes=n)

    def jloss(p, x):
        out = mod.apply({"params": p}, gj, x)
        return (out * cot).sum(), out

    (_, out_j), (gp_j, gx_j) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    conv = _torch_gatv2(params, fin, dout, heads, share, residual, bias)
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    gt.create_tiled_format(tile=128, cap=128)
    monkeypatch.setitem(config._FLAGS, "use_kernels", route == "k9")
    xt = torch.from_numpy(x).requires_grad_()
    with mock.patch.object(tgf, "gatv2_attention_aggregate",
                           wraps=tgf.gatv2_attention_aggregate) as spy:
        out_t = conv(gt, xt)
        (out_t * torch.from_numpy(cot)).sum().backward()
    assert spy.call_count == int(route == "k9")
    assert not gt.ndata and not gt.edata
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **SUMS)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **SUMS)
    names = ["fc_src", "attn"] + ([] if share else ["fc_dst"]) + (
        ["res_fc"] if residual else [])
    for got, want in _grad_pairs(conv, gp_j, names):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUMS)


def test_gatv2conv_state_dict_layout():
    _, params = _jax_gatv2(5, 3, 2, True, True, True)
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = gatv2conv_state_dict({"params": params})
    assert set(sd) == {"attn", "fc_src.weight", "fc_src.bias",
                       "fc_dst.weight", "fc_dst.bias", "res_fc.weight"}
    assert sd["fc_src.weight"].shape == (6, 5)
    np.testing.assert_array_equal(sd["fc_dst.weight"].numpy(),
                                  params["fc_src"]["kernel"].T)
    conv = dgt.nn.GATv2Conv(5, 3, 2, residual=True, share_weights=True,
                            device="cpu")
    conv.load_state_dict(sd)
    assert conv.fc_dst is conv.fc_src


def _egat_graph(seed, n=300, e=2500):
    row, col, n = _square(seed, n, e)
    rng = np.random.default_rng(seed + 1)
    return row, col, n, rng.normal(size=(len(row), FE)).astype(np.float32)


def _jax_egat(fin, dn, de, heads, bias, seed=0):
    shapes = {"fc_node_src/kernel": (fin, heads * dn),
              "fc_ni/kernel": (fin, heads * de),
              "fc_fij/kernel": (FE, heads * de),
              "fc_nj/kernel": (fin, heads * de), "attn": (1, heads, de)}
    if bias:
        shapes["bias"] = (heads * de,)
    return (jnn.EGATConv(fin, FE, dn, de, heads, bias=bias),
            _params(seed, shapes))


def _torch_egat(params, fin, dn, de, heads, bias):
    conv = dgt.nn.EGATConv(fin, FE, dn, de, heads, bias=bias, device="cpu")
    conv.load_state_dict(egatconv_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return conv


EGAT_NAMES = ["fc_node_src", "fc_ni", "fc_fij", "fc_nj", "attn"]


@pytest.mark.parametrize("route", ["flat", "chain"])
@pytest.mark.parametrize("bias", [True, False])
def test_egatconv_matches_jax(route, bias, min_edges_1, monkeypatch):
    """EGATConv on its flat route (chunked logits, edgeflat; the graph's
    edges split over several chunks) and on the edge chain against the
    JAX module on the same route, weights by ``egatconv_state_dict``:
    node and edge features and every gradient."""
    row, col, n, ef = _egat_graph(45)
    fin, dn, de, heads = 6, 3, 4, 2
    rng = np.random.default_rng(46)
    x = rng.normal(size=(n, fin)).astype(np.float32)
    cot = rng.normal(size=(n, heads, dn)).astype(np.float32)
    cot_e = rng.normal(size=(len(row), heads, de)).astype(np.float32)
    mod, params = _jax_egat(fin, dn, de, heads, bias)
    gj = dgl.graph((row, col), num_nodes=n)
    if route == "chain":
        monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 10**9)
        monkeypatch.setitem(jconfig._FLAGS, "pallas_spmm_min_edges", 10**9)
    else:
        monkeypatch.setattr("dgl_tpu_torch.nn.conv.gatconv.EGAT_CHUNK", 1000)

    def jloss(p, x, ef):
        h, f = mod.apply({"params": p}, gj, x, ef)
        return (h * cot).sum() + (f * cot_e).sum(), (h, f)

    (_, (h_j, f_j)), (gp_j, gx_j, gef_j) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(params, jnp.asarray(x),
                                                  jnp.asarray(ef))
    conv = _torch_egat(params, fin, dn, de, heads, bias)
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    eft = torch.from_numpy(ef).requires_grad_()
    with mock.patch("dgl_tpu_torch.nn.conv.gatconv.edge_softmax_flat",
                    wraps=dgt.ops.edgeflat.edge_softmax_flat) as spy:
        h, f = conv(gt, xt, eft)
        ((h * torch.from_numpy(cot)).sum()
         + (f * torch.from_numpy(cot_e)).sum()).backward()
    assert spy.call_count == int(route == "flat")
    assert not gt.ndata and not gt.edata
    for got, want in ((h, h_j), (f, f_j), (xt.grad, gx_j), (eft.grad, gef_j)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **SUMS)
    for got, want in _grad_pairs(conv, gp_j,
                                 EGAT_NAMES + (["bias"] if bias else [])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUMS)


def test_egatconv_fused_route_matches_jax(jax_k9, min_edges_1):
    """EGATConv's fused route (K11 v2) on the fixture's graph against JAX's
    ``egatconv_attention_aggregate_v2`` called directly with the same
    weights (JAX's own fused route needs a TPU): h on the covered rows,
    and each weight's gradient by the chain rule from the JAX function's
    gradients, with the rows JAX leaves unwritten taken as the port's 0."""
    t, ins, res = jax_k9
    want = [np.nan_to_num(a) for a in res["egat"]]
    ep, X = ins["eparams"], ins["X"]
    conv = _torch_egat(ep, J_FIN, J_DIM, J_DIM, J_HEADS, True)
    g = dgt.graph((ins["row"], ins["col"]), num_nodes=N, device="cpu")
    g.create_tiled_format(tile=256, cap=128)
    ef_slot = dgt.nn.EGATConv.slot_edge_feats(g, torch.from_numpy(ins["ef"]))
    with mock.patch.object(tgf, "egatconv_attention_aggregate_v2",
                           wraps=tgf.egatconv_attention_aggregate_v2) as spy:
        h, f = conv(g, torch.from_numpy(X), torch.from_numpy(ins["ef"]),
                    compute_edge_feats=False, efeats_slot=ef_slot)
        h.backward(torch.from_numpy(ins["dz"]))
    assert spy.call_count == 1 and f is None
    np.testing.assert_allclose(h.detach().numpy()[DST_COVERED],
                               want[0][DST_COVERED], **BF16)
    hd = J_HEADS * J_DIM
    dwf = _unpad_wf(want[4], FE + 1)
    refs = {"fc_ni": X.T @ want[1].reshape(N, hd),
            "fc_nj": X.T @ want[2].reshape(N, hd),
            "fc_node_src": X.T @ want[6].reshape(N, hd),
            "fc_fij": dwf[:FE], "bias": dwf[FE], "attn": want[5][None]}
    for name, ref in refs.items():
        got = getattr(conv, name)
        got = (got.grad if name in ("attn", "bias") else got.weight.grad.T)
        if name == "fc_node_src":
            np.testing.assert_allclose(got.numpy(), ref, **BF16)
        else:
            _kink_close(got.numpy(), ref, name)


def test_egatconv_state_dict_layout():
    _, params = _jax_egat(5, 3, 4, 2, True)
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = egatconv_state_dict({"params": params})
    assert set(sd) == {"attn", "bias", "fc_node_src.weight", "fc_ni.weight",
                       "fc_fij.weight", "fc_nj.weight"}
    assert sd["fc_fij.weight"].shape == (8, FE)
    np.testing.assert_array_equal(sd["fc_ni.weight"].numpy(),
                                  params["fc_ni"]["kernel"].T)


def test_gatv2_training_on_k9_matches_jax(min_edges_1):
    """2-layer GATv2 (feat -> 4 heads x 4 -> elu -> 1 head x classes), 3
    Adam steps: the port through K9's plain versions on a tiled graph with
    an uncovered tile against the JAX package on its edge chain."""
    rng = np.random.default_rng(47)
    n, feat, classes = 300, 9, 5
    row, col, _ = _square(48, n=n)
    x = rng.normal(size=(n, feat)).astype(np.float32)
    y = rng.integers(0, classes, n)
    lr, steps = 1e-2, 3
    m1, p1 = _jax_gatv2(feat, 4, 4, False, False, True, seed=1)
    m2, p2 = _jax_gatv2(16, classes, 1, False, False, True, seed=2)
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

    t1 = _torch_gatv2(p1, feat, 4, 4, False, False, True)
    t2 = _torch_gatv2(p2, 16, classes, 1, False, False, True)
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    gt.create_tiled_format(tile=256, cap=128)     # rows 256-299: tile 1
    opt_t = torch.optim.Adam(list(t1.parameters()) + list(t2.parameters()),
                             lr=lr)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses_t = []
    with mock.patch.object(tgf, "vattn_slot_grad",
                           wraps=tgf.vattn_slot_grad) as spy:
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
        np.testing.assert_allclose(
            mod.fc_src.weight.detach().numpy().T,
            np.asarray(params[name]["fc_src"]["kernel"]), rtol=1e-4,
            atol=1e-5)


# -- route selection ---------------------------------------------------------

@pytest.mark.parametrize("case", ["train_dropout", "eval", "no_dropout",
                                  "untiled", "no_kernels", "attention"])
def test_gatv2conv_route(case, min_edges_1, monkeypatch):
    """Attention dropout in training, a graph without a tiled format,
    ``use_kernels(False)`` or ``get_attention`` take the edge chain; eval
    mode or ``attn_drop=0`` take K9."""
    row, col, n = _square(49)
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    if case != "untiled":
        g.create_tiled_format(tile=128, cap=128)
    if case == "no_kernels":
        monkeypatch.setitem(config._FLAGS, "use_kernels", False)
    conv = dgt.nn.GATv2Conv(5, 4, 2, attn_drop=0.0 if case == "no_dropout"
                            else 0.6, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    conv.train(case not in ("eval", "attention"))
    with mock.patch.object(tgf, "gatv2_attention_aggregate",
                           wraps=tgf.gatv2_attention_aggregate) as k9, \
            mock.patch("dgl_tpu_torch.nn.conv.gatconv.update_all",
                       wraps=dgt.update_all) as chain:
        out = conv(g, torch.randn(n, 5), get_attention=case == "attention")
        if case == "attention":
            out, a = out
            assert a.shape == (len(row), 2, 1)
        out.square().sum().backward()
    assert not g.ndata and not g.edata
    k9_route = case in ("eval", "no_dropout")
    assert (k9.call_count, chain.call_count) == (int(k9_route),
                                                 int(not k9_route))


@pytest.mark.parametrize("case", ["fused", "no_slot_feats", "edge_feats",
                                  "untiled", "attention"])
def test_egatconv_route(case, min_edges_1):
    """The fused route needs a tiled format, ``efeats_slot`` and
    ``compute_edge_feats=False``; without them the flat route runs, and
    ``get_attention`` takes the edge chain."""
    row, col, n, ef = _egat_graph(50)
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    if case != "untiled":
        g.create_tiled_format(tile=128, cap=128)
    conv = dgt.nn.EGATConv(5, FE, 3, 4, 2, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    eft = torch.from_numpy(ef)
    slot = (None if case in ("no_slot_feats", "untiled")
            else dgt.nn.EGATConv.slot_edge_feats(g, eft))
    spies = {
        "k11": mock.patch.object(tgf, "egatconv_attention_aggregate_v2",
                                 wraps=tgf.egatconv_attention_aggregate_v2),
        "flat": mock.patch("dgl_tpu_torch.nn.conv.gatconv.edge_softmax_flat",
                           wraps=dgt.ops.edgeflat.edge_softmax_flat),
        "chain": mock.patch("dgl_tpu_torch.nn.conv.gatconv.update_all",
                            wraps=dgt.update_all)}
    active = {name: p.start() for name, p in spies.items()}
    try:
        out = conv(g, torch.randn(n, 5), eft,
                   get_attention=case == "attention",
                   compute_edge_feats=case == "edge_feats",
                   efeats_slot=slot)
        out[0].square().sum().backward()
    finally:
        for p in spies.values():
            p.stop()
    assert not g.ndata and not g.edata
    route = {"fused": "k11", "attention": "chain"}.get(case, "flat")
    assert {k: s.call_count for k, s in active.items()} == {
        k: int(k == route) for k in spies}
    assert (out[1] is None) == (case in ("fused", "no_slot_feats", "untiled"))


@pytest.mark.parametrize("case", ["feature_width", "edge_count",
                                  "stale_slot_grad", "slot_from_efeats"])
def test_egatconv_fused_route_checks_slot_feats(case, min_edges_1):
    """The fused route reads the edge features only through
    ``efeats_slot``: it refuses one of another width, ``efeats`` without
    one row per edge, and an ``efeats`` that asks for a gradient the slot
    tensor cannot carry; a slot tensor built from ``efeats`` in the step
    carries that gradient to it, as the flat route does."""
    row, col, n, ef = _egat_graph(51)
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    g.create_tiled_format(tile=128, cap=128)
    conv = dgt.nn.EGATConv(5, FE, 3, 4, 2, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    x = torch.randn(n, 5, generator=torch.Generator().manual_seed(1))
    eft = torch.from_numpy(ef)
    if case == "slot_from_efeats":
        eft.requires_grad_()
        h, _ = conv(g, x, eft, compute_edge_feats=False,
                    efeats_slot=dgt.nn.EGATConv.slot_edge_feats(g, eft))
        h.square().sum().backward()
        got = eft.grad.clone()
        eft.grad = None
        h, _ = conv(g, x, eft, compute_edge_feats=False)    # the flat route
        h.square().sum().backward()
        np.testing.assert_allclose(got.numpy(), eft.grad.numpy(), **SUMS)
        return
    slot = dgt.nn.EGATConv.slot_edge_feats(g, eft)
    if case == "feature_width":
        slot = slot[..., :-1]
    elif case == "edge_count":
        eft = eft[:-1]
    else:
        eft = eft.clone().requires_grad_()
    with pytest.raises(ValueError):
        conv(g, x, eft, compute_edge_feats=False, efeats_slot=slot)


@pytest.mark.parametrize("fe,bias,rows", [(31, False, 31), (31, True, 32),
                                          (32, True, 33)])
def test_egatconv_fused_route_edge_row_cap(fe, bias, rows, min_edges_1):
    """The K11 v2 kernels take at most MAX_FE_ROWS edge rows, the bias row
    counted: the gate routes a layer with more to the flat route, which
    computes the same function (the JAX package pads the rows and stays
    fused).  The plain versions have no cap, so the CPU shows the route
    taken, not the fault."""
    assert tgf.MAX_FE_ROWS == 32
    assert tgf.fe_rows_fit(rows) == (rows <= 32)
    row, col, n = _square(52)
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    g.create_tiled_format(tile=128, cap=128)
    ef = torch.randn(len(row), fe, generator=torch.Generator().manual_seed(1))
    conv = dgt.nn.EGATConv(5, fe, 3, 4, 2, bias=bias, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    with mock.patch.object(tgf, "egatconv_attention_aggregate_v2",
                           wraps=tgf.egatconv_attention_aggregate_v2) as k11, \
            mock.patch("dgl_tpu_torch.nn.conv.gatconv.edge_softmax_flat",
                       wraps=dgt.ops.edgeflat.edge_softmax_flat) as flat:
        h, _ = conv(g, torch.randn(n, 5), ef, compute_edge_feats=False,
                    efeats_slot=dgt.nn.EGATConv.slot_edge_feats(g, ef))
        h.square().sum().backward()
    assert (k11.call_count, flat.call_count) == ((1, 0) if rows <= 32
                                                 else (0, 1))
