"""Parity of the port's edgeflat route and K4 with the JAX package on the
CPU: ``sddmm_flat``, ``edge_softmax_flat``, ``spmm_mul_flat`` and its
gradients, K4's plain versions, and ``GATConv`` on the edgeflat route.

Tolerances: rtol 1e-5 / atol 1e-6 for gathers and elementwise ops; K4's
plain versions against a float64 numpy oracle at rtol 1e-5 / atol 1e-5;
against the JAX multihead kernels, which cast their operands to bf16 even
when interpreted (``tiled_spmm.py:439-451, 503-513``), at the JAX tests'
own rtol 5e-2 / atol 6e-2 (``tests/test_pallas.py:137,152``); modules at
rtol 1e-4 / atol 1e-5, where sums over edges are taken in another order.
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
import dgl_tpu.ops.pallas.tiled_spmm as jts
import dgl_tpu_torch as dgt
import dgl_tpu_torch.ops.edgeflat as tef
import dgl_tpu_torch.ops.kernels.gat_fused as tgf
import dgl_tpu_torch.ops.kernels.tiled_spmm as tts
from dgl_tpu.utils import config as jconfig
from dgl_tpu_torch.utils import config
from test_torch_gat import _jax_gat, _torch_gat

EXACT = dict(rtol=1e-5, atol=1e-6)
ORACLE = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=6e-2)
SUMS = dict(rtol=1e-4, atol=1e-5)


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


def _coo(seed, n=40, e=200, no_in=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n - no_in, e), n


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "copy_lhs",
                                "copy_rhs"])
@pytest.mark.parametrize("targets", [("u", "v"), ("v", "u"), ("u", "e")])
def test_sddmm_flat_matches(op, targets):
    row, col, n = _coo(1)
    rng = np.random.default_rng(2)
    heads = 3
    lhs = rng.normal(size=(n, heads)).astype(np.float32)
    rhs = (rng.normal(size=(len(row) * heads,)) if targets[1] == "e" else
           rng.normal(size=(n, heads))).astype(np.float32)
    if op == "div":
        rhs = np.abs(rhs) + 0.5
    uj = dgl.graph((row, col), num_nodes=n).unit()
    ut = dgt.graph((row, col), num_nodes=n, device="cpu").unit()
    want = jef.sddmm_flat(uj, op, jnp.asarray(lhs), jnp.asarray(rhs),
                          *targets)
    got = tef.sddmm_flat(ut, op, torch.from_numpy(lhs), torch.from_numpy(rhs),
                         *targets)
    assert got.shape == (len(row) * heads,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)
    with pytest.raises(ValueError):
        tef.sddmm_flat(ut, "pow", torch.from_numpy(lhs), None)


@pytest.mark.parametrize("norm_by", ["dst", "src"])
def test_edge_softmax_flat_matches(norm_by):
    row, col, n = _coo(3, no_in=4)
    rng = np.random.default_rng(4)
    heads = 4
    s = (3 * rng.normal(size=(len(row) * heads,))).astype(np.float32)
    cot = rng.normal(size=s.shape).astype(np.float32)
    uj = dgl.graph((row, col), num_nodes=n).unit()
    want, vjp = jax.vjp(lambda s: jef.edge_softmax_flat(uj, s, heads,
                                                        norm_by),
                        jnp.asarray(s))
    ut = dgt.graph((row, col), num_nodes=n, device="cpu").unit()
    st = torch.from_numpy(s).requires_grad_()
    got = tef.edge_softmax_flat(ut, st, heads, norm_by)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **SUMS)
    np.testing.assert_allclose(st.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(cot))[0]), **SUMS)


def test_spmm_mul_flat_gather_matches():
    """Without a tiled format both packages take one g-SpMM per head."""
    row, col, n = _coo(5, no_in=3)
    rng = np.random.default_rng(6)
    heads, f = 3, 5
    x = rng.normal(size=(n, heads, f)).astype(np.float32)
    w = rng.random(len(row) * heads).astype(np.float32)
    cot = rng.normal(size=(n, heads, f)).astype(np.float32)
    uj = dgl.graph((row, col), num_nodes=n).unit()
    want, vjp = jax.vjp(lambda x, w: jef.spmm_mul_flat(uj, x, w, heads),
                        jnp.asarray(x), jnp.asarray(w))
    ut = dgt.graph((row, col), num_nodes=n, device="cpu").unit()
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    got = tef.spmm_mul_flat(ut, xt, wt, heads)
    got.backward(torch.from_numpy(cot))
    gx, gw = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **SUMS)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **SUMS)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), **SUMS)


def _tiled_case(seed, heads, fh, n=300, e=2000, tile=256, cap=128):
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n, e), rng.integers(0, n - 40, e)
    row[:50], col[:50] = row[50:100], col[50:100]          # multi-edges
    x = rng.normal(size=(n, heads, fh)).astype(np.float32)
    z = rng.normal(size=(n, heads, fh)).astype(np.float32)
    w = rng.random((e, heads)).astype(np.float32)
    t = tts.build_tiled_format(row, col, n, n, tile, cap, device="cpu")
    j = jts.build_tiled_format(row, col, n, n, tile, cap)
    return row, col, x, z, w, t, j


@pytest.mark.parametrize("heads,fh", [(4, 8), (1, 41), (3, 5), (8, 16)])
def test_multihead_plain_matches_oracle(heads, fh):
    """K4's plain versions against float64 numpy."""
    row, col, x, z, w, t, _ = _tiled_case(7, heads, fh)
    w_slot = tef._w_slot_from_flat(t, torch.from_numpy(w.reshape(-1)), heads)
    got = tts.tiled_spmm_multihead(t, torch.from_numpy(x), w_slot, heads, fh)
    want = np.zeros(x.shape)
    np.add.at(want, col, w[:, :, None].astype(np.float64) * x[row])
    np.testing.assert_allclose(got.numpy(), want, **ORACLE)
    e_slot = tts.tiled_sddmm_dot_multihead(t, torch.from_numpy(x),
                                           torch.from_numpy(z), heads, fh)
    eid = t.eid.numpy()
    got_e = e_slot.numpy().transpose(0, 2, 1).reshape(-1, heads)
    want_e = np.einsum("ehf,ehf->eh", x[row].astype(np.float64), z[col])
    np.testing.assert_allclose(got_e[eid >= 0][np.argsort(eid[eid >= 0])],
                               want_e, **ORACLE)
    assert (got_e[eid < 0] == 0).all()          # padded slots hold 0


@pytest.mark.parametrize("heads,fh", [(4, 8), (1, 41), (3, 5)])
def test_multihead_plain_matches_jax(heads, fh, interpret):
    """K4's plain versions against the JAX kernels (bf16 operands), the
    SDDMM on valid slots only: the TPU kernel leaves the product of row 0
    of each tile at padded slots, the port 0."""
    row, col, x, z, w, t, j = _tiled_case(8, heads, fh)
    w_flat = w.reshape(-1)
    w_slot_t = tef._w_slot_from_flat(t, torch.from_numpy(w_flat), heads)
    w_slot_j = jef._w_slot_from_flat(j, jnp.asarray(w_flat), heads)
    np.testing.assert_array_equal(w_slot_t.numpy(), np.asarray(w_slot_j))
    got = tts.tiled_spmm_multihead(t, torch.from_numpy(x), w_slot_t, heads,
                                   fh)
    want = jts.tiled_spmm_multihead(j, jnp.asarray(x), w_slot_j, heads, fh)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), **BF16)
    got_e = tts.tiled_sddmm_dot_multihead(t, torch.from_numpy(x),
                                          torch.from_numpy(z), heads, fh)
    want_e = jts.tiled_sddmm_dot_multihead(j, jnp.asarray(x), jnp.asarray(z),
                                           heads, fh)
    valid = t.valid.numpy().reshape(t.num_buckets, 1, t.cap) > 0
    valid = np.broadcast_to(valid, got_e.shape)
    np.testing.assert_allclose(np.asarray(want_e)[valid],
                               got_e.numpy()[valid], **BF16)


def test_multihead_checks():
    _, _, x, z, _, t, _ = _tiled_case(9, 2, 4)
    with pytest.raises(ValueError):
        tts.tiled_spmm_multihead(t, torch.from_numpy(x),
                                 torch.zeros(1, 2, t.cap), 2, 4)
    with pytest.raises(ValueError):
        tts.tiled_sddmm_dot_multihead(t, torch.from_numpy(x),
                                      torch.from_numpy(z)[:10], 2, 4)


@pytest.mark.parametrize("heads,fh", [(2, 4), (1, 6)])
def test_spmm_mul_flat_tiled_matches_jax(heads, fh, interpret, monkeypatch):
    """spmm_mul_flat and its gradients over a tiled format, both packages
    on their kernel route (min edges set low on both sides)."""
    row, col, x, _, w, t, j = _tiled_case(10, heads, fh, n=120, e=900)
    n = 120
    cot = np.random.default_rng(11).normal(size=x.shape).astype(np.float32)
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    monkeypatch.setitem(jconfig._FLAGS, "pallas_spmm_min_edges", 1)
    gj = dgl.graph((row, col), num_nodes=n)
    gj.unit().tiled_format(tile=256, cap=128)
    with mock.patch.object(jef, "_spmm_mh_vjp",
                           wraps=jef._spmm_mh_vjp) as jspy:
        want, vjp = jax.vjp(
            lambda x, w: jef.spmm_mul_flat(gj.unit(), x, w, heads),
            jnp.asarray(x), jnp.asarray(w.reshape(-1)))
        gx, gw = vjp(jnp.asarray(cot))
    assert jspy.call_count == 1
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    gt.unit().tiled_format(tile=256, cap=128)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w.reshape(-1)).requires_grad_()
    with mock.patch.object(tts, "tiled_sddmm_dot_multihead",
                           wraps=tts.tiled_sddmm_dot_multihead) as tspy:
        got = tef.spmm_mul_flat(gt.unit(), xt, wt, heads)
        got.backward(torch.from_numpy(cot))
    assert tspy.call_count == 1
    np.testing.assert_allclose(np.asarray(want), got.detach().numpy(), **BF16)
    np.testing.assert_allclose(np.asarray(gx), xt.grad.numpy(), **BF16)
    np.testing.assert_allclose(np.asarray(gw), wt.grad.numpy(), **BF16)
    # and the port's tiled route against its own gather route, in f32
    gp = dgt.graph((row, col), num_nodes=n, device="cpu")
    xs, ws = xt.detach().requires_grad_(), wt.detach().requires_grad_()
    ref = tef.spmm_mul_flat(gp.unit(), xs, ws, heads)
    ref.backward(torch.from_numpy(cot))
    for a, b in ((got.detach(), ref.detach()), (xt.grad, xs.grad),
                 (wt.grad, ws.grad)):
        torch.testing.assert_close(a, b, **SUMS)


@pytest.mark.parametrize("heads,dout,residual,bias", [
    (3, 5, False, True), (2, 8, True, True), (1, 41, False, False)])
def test_gatconv_edgeflat_matches_jax(heads, dout, residual, bias,
                                      monkeypatch):
    """GATConv on the edgeflat route without a tiled format, in both
    packages (min edges 1 forces it): values and all gradients."""
    row, col, n = _coo(12, n=70, e=600)
    fin = 6
    rng = np.random.default_rng(13)
    x = rng.normal(size=(n, fin)).astype(np.float32)
    cot = rng.normal(size=(n, heads, dout)).astype(np.float32)
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    monkeypatch.setitem(jconfig._FLAGS, "pallas_spmm_min_edges", 1)
    mod, params = _jax_gat(fin, dout, heads, residual, bias)
    gj = dgl.graph((row, col), num_nodes=n)

    def jloss(p, x):
        out = mod.apply({"params": p}, gj, x)
        return (out * cot).sum(), out

    with mock.patch.object(jef, "edge_softmax_flat",
                           wraps=jef.edge_softmax_flat) as jspy:
        (_, out_j), (gp_j, gx_j) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    assert jspy.call_count == 1
    conv = _torch_gat(params, fin, dout, heads, residual, bias)
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    with mock.patch("dgl_tpu_torch.nn.conv.gatconv.edge_softmax_flat",
                    wraps=tef.edge_softmax_flat) as tspy:
        out_t = conv(gt, xt)
        (out_t * torch.from_numpy(cot)).sum().backward()
    assert tspy.call_count == 1
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


def test_gatconv_tiled_dropout_matches_untiled(monkeypatch):
    """In training with attention dropout 0.6, GATConv on a tiled graph
    (edgeflat on K4's plain versions) equals the same module and generator
    seed on the same graph without the tiled format (the per-head gather
    path): the dropout masks are the same draws.  In eval mode the tiled
    graph takes the slot-space route (K6's plain versions), which equals
    the gather path while the logits stay inside its clip."""
    row, col, n = _coo(14, n=90, e=900)
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    x = torch.randn(n, 6, generator=torch.Generator().manual_seed(0))

    def run(tiled, train=True):
        conv = dgt.nn.GATConv(6, 4, 2, attn_drop=0.6, residual=True,
                              device="cpu",
                              generator=torch.Generator().manual_seed(3))
        conv.train(train)
        g = dgt.graph((row, col), num_nodes=n, device="cpu")
        if tiled:
            g.create_tiled_format(tile=256, cap=128)
        xs = x.clone().requires_grad_()
        with mock.patch.object(tts, "tiled_spmm_multihead",
                               wraps=tts.tiled_spmm_multihead) as spy, \
                mock.patch.object(tgf, "gat_ds", wraps=tgf.gat_ds) as k6:
            out = conv(g, xs)
            out.square().sum().backward()
        # K6 takes K4's SpMM for its numerator, and its own kernels back
        assert (spy.call_count, k6.call_count) == (
            ((2, 0) if train else (1, 1)) if tiled else (0, 0))
        return [out.detach(), xs.grad] + [p.grad for p in conv.parameters()]

    tiled, plain = run(True), run(False)
    for a, b in zip(tiled, plain):
        torch.testing.assert_close(a, b, **SUMS)
    # eval mode drops nothing: the two graphs agree there too
    evals = run(True, train=False), run(False, train=False)
    for a, b in zip(*evals):
        torch.testing.assert_close(a, b, **SUMS)
    assert not torch.allclose(evals[0][0], tiled[0])


def test_gat_training_slice_on_tiled_matches(monkeypatch):
    """2-layer GAT (feat -> 2 heads x 4 -> elu -> 1 head x classes),
    attn_drop 0, 3 Adam steps: the port over a tiled format, which takes
    the slot-space route without attention dropout (K6's plain versions,
    as the JAX package on a TPU), against the JAX package on its edgeflat
    route without one (its gather fallback)."""
    rng = np.random.default_rng(15)
    n, e, feat, classes = 150, 1400, 10, 5
    row = np.r_[rng.integers(0, n, e), np.arange(n)]
    col = np.r_[rng.integers(0, n, e), np.arange(n)]
    x = rng.normal(size=(n, feat)).astype(np.float32)
    y = rng.integers(0, classes, n)
    lr, steps = 1e-2, 3
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    monkeypatch.setitem(jconfig._FLAGS, "pallas_spmm_min_edges", 1)
    m1, p1 = _jax_gat(feat, 4, 2, False, True, seed=1)
    m2, p2 = _jax_gat(8, classes, 1, False, True, seed=2)
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
    for _ in range(steps):
        loss, grads = jax.value_and_grad(jloss)(params)
        up, opt = tx.update(grads, opt)
        params = optax.apply_updates(params, up)
        losses_j.append(float(loss))

    t1 = _torch_gat(p1, feat, 4, 2, False, True)
    t2 = _torch_gat(p2, 8, classes, 1, False, True)
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    gt.create_tiled_format(tile=128, cap=128)
    opt_t = torch.optim.Adam(list(t1.parameters()) + list(t2.parameters()),
                             lr=lr)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses_t = []
    with mock.patch.object(tgf, "gat_scores", wraps=tgf.gat_scores) as spy:
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


@pytest.mark.parametrize("shape", [(30,), (30, 1), (30, 4), (30, 2),
                                   (30, 3, 1), (30, 2, 2), (30, 2, 5)])
def test_gather_rows(shape):
    """``gather_rows`` equals ``v[ids]`` (16-byte, 8-byte and other rows),
    and its gradient equals advanced indexing's."""
    from dgl_tpu_torch.utils import gather_rows
    gen = torch.Generator().manual_seed(len(shape))
    v = torch.randn(shape, generator=gen, requires_grad=True)
    ids = torch.randint(0, shape[0], (100,), generator=gen)
    got = gather_rows(v, ids)
    torch.testing.assert_close(got, v[ids])
    cot = torch.randn(got.shape, generator=gen)
    (gv,) = torch.autograd.grad(got, v, cot)
    (want,) = torch.autograd.grad(v[ids], v, cot)
    torch.testing.assert_close(gv, want)
