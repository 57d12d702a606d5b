"""Parity of the port's GAT path with the JAX package, on the CPU:
``gsddmm``, ``edge_softmax``, ``apply_edges``, ``GATConv`` on the edge
chain and on the bitmask route, and a 2-layer GAT trained with Adam.

Tolerances: rtol 1e-5 / atol 1e-6 for gathers and elementwise ops (the
same f32 arithmetic); rtol 1e-4 / atol 1e-5 where sums over edges are
taken in another order (softmax sums, aggregation, weight gradients).
"""
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dgl_tpu as dgl
import dgl_tpu.ops.pallas.bitgat as jbg
import dgl_tpu_torch as dgt
import dgl_tpu_torch.ops.kernels.bitgat as tbg
from dgl_tpu import function as jfn
from dgl_tpu import nn as jnn
from dgl_tpu.ops import edge_softmax as j_edge_softmax
from dgl_tpu.ops import gsddmm as j_gsddmm
from dgl_tpu.utils import config as jconfig
from dgl_tpu_torch import function as tfn
from dgl_tpu_torch.params import gatconv_state_dict
from dgl_tpu_torch.utils import config

EXACT = dict(rtol=1e-5, atol=1e-6)
SUMS = dict(rtol=1e-4, atol=1e-5)


def _coo(seed, n=60, e=500, no_in=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n - no_in, e), n


def _simple(seed, n=150, e=1500):
    """A simple graph in which every node has an in-edge."""
    rng = np.random.default_rng(seed)
    row = np.r_[rng.integers(0, n, e), np.arange(n)]
    col = np.r_[rng.integers(0, n, e), (np.arange(n) + 1) % n]
    key = np.unique(col * n + row)
    return key % n, key // n, n


def _data(rng, target, n, e, shape):
    return rng.normal(size=((e if target == "e" else n),) + shape).astype(
        np.float32)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "dot",
                                "copy_lhs", "copy_rhs"])
@pytest.mark.parametrize("lhs,rhs", [("u", "v"), ("u", "e"), ("e", "v"),
                                     ("v", "u"), ("e", "u")])
def test_gsddmm_matches(op, lhs, rhs):
    row, col, n = _coo(1)
    rng = np.random.default_rng(2)
    x = _data(rng, lhs, n, len(row), (3, 4))
    # the rhs broadcasts over the trailing head axis, except for dot
    y = _data(rng, rhs, n, len(row), (3, 4) if op == "dot" else (3, 1))
    if op == "div":
        y = np.abs(y) + 0.5
    cot_shape = (len(row), 3, 1) if op == "dot" else (len(row), 3, 4)
    cot = rng.normal(size=cot_shape).astype(np.float32)
    if op == "copy_rhs":
        cot = cot[:, :, :1]
    gj = dgl.graph((row, col), num_nodes=n)

    def jf(x, y):
        out = j_gsddmm(gj, op, x, y, lhs, rhs)
        return (out * cot).sum(), out

    (_, out_j), (gx_j, gy_j) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(y))
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    xt, yt = (torch.from_numpy(a).requires_grad_() for a in (x, y))
    out_t = dgt.ops.gsddmm(gt, op, xt, yt, lhs, rhs)
    (out_t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **EXACT)
    for got, want in ((xt.grad, gx_j), (yt.grad, gy_j)):
        if got is None:       # the operand a copy ignores
            assert not np.asarray(want).any()
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUMS)


def test_gsddmm_invalid():
    row, col, n = _coo(1)
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    x = torch.zeros(n, 2)
    with pytest.raises(ValueError):
        dgt.ops.gsddmm(gt, "pow", x, x)
    with pytest.raises(ValueError):
        dgt.ops.gsddmm(gt, "add", x, x, "u", "w")


@pytest.mark.parametrize("norm_by", ["dst", "src"])
@pytest.mark.parametrize("shape", [(), (4, 1)])
def test_edge_softmax_matches(norm_by, shape):
    row, col, n = _coo(3)
    rng = np.random.default_rng(4)
    score = (3 * rng.normal(size=(len(row),) + shape)).astype(np.float32)
    cot = rng.normal(size=score.shape).astype(np.float32)
    gj = dgl.graph((row, col), num_nodes=n)
    out_j, vjp = jax.vjp(lambda s: j_edge_softmax(gj, s, norm_by=norm_by),
                         jnp.asarray(score))
    (ds_j,) = vjp(jnp.asarray(cot))
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    st = torch.from_numpy(score).requires_grad_()
    out_t = dgt.ops.edge_softmax(gt, st, norm_by=norm_by)
    out_t.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **SUMS)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(ds_j), **SUMS)
    # each node's incident edges sum to 1
    ids = torch.from_numpy(col if norm_by == "dst" else row)
    sums = torch.zeros((n,) + shape).index_add_(0, ids, out_t.detach())
    torch.testing.assert_close(sums[torch.unique(ids)],
                               torch.ones((len(torch.unique(ids)),) + shape))
    with pytest.raises(NotImplementedError):
        dgt.ops.edge_softmax(gt, st, eids=torch.arange(3))


def test_apply_edges():
    row, col, n = _coo(5)
    rng = np.random.default_rng(6)
    hu = rng.normal(size=(n, 2, 3)).astype(np.float32)
    hv = rng.normal(size=(n, 2, 1)).astype(np.float32)
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    gt.ndata["hu"] = torch.from_numpy(hu)
    gt.ndata["hv"] = torch.from_numpy(hv)
    out = dgt.apply_edges(gt, tfn.u_add_v("hu", "hv", "e"))
    assert "e" not in gt.edata                # the functional form
    np.testing.assert_allclose(out.numpy(), hu[row] + hv[col], **EXACT)
    gt.apply_edges(tfn.v_dot_u("hu", "hu", "d"))
    np.testing.assert_allclose(gt.edata["d"].numpy(),
                               (hu[col] * hu[row]).sum(-1, keepdims=True),
                               **EXACT)
    gt.apply_edges(tfn.copy_u("hu", "c"))
    np.testing.assert_allclose(gt.edata["c"].numpy(), hu[row], **EXACT)
    # against the JAX package's apply_edges, for a v-e builtin
    gt.edata["w"] = torch.from_numpy(
        rng.normal(size=(len(row), 2, 1)).astype(np.float32))
    gj = dgl.graph((row, col), num_nodes=n)
    gj.ndata["hu"] = jnp.asarray(hu)
    gj.edata["w"] = jnp.asarray(gt.edata["w"].numpy())
    want = dgl.apply_edges(gj, jfn.v_sub_e("hu", "w", "m"))
    np.testing.assert_allclose(
        dgt.apply_edges(gt, tfn.v_sub_e("hu", "w", "m")).numpy(),
        np.asarray(want), **EXACT)
    with pytest.raises(NotImplementedError):
        dgt.apply_edges(gt, lambda edges: {}, None)


def test_builtin_surface_matches():
    """The port generates the JAX package's builtin message names."""
    names = [f"{lhs}_{op}_{rhs}" for op in ("add", "sub", "mul", "div",
                                            "dot")
             for lhs in "uve" for rhs in "uve" if lhs != rhs]
    for name in names:
        assert tuple(getattr(tfn, name)("a", "b", "c")) == \
            tuple(getattr(jfn, name)("a", "b", "c"))
    for name in ("copy_u", "copy_e"):
        assert tuple(getattr(tfn, name)("a", "c")) == \
            tuple(getattr(jfn, name)("a", "c"))


@pytest.mark.parametrize("mfunc", ["v_mul_e", "e_add_u", "e_sub_u",
                                   "u_dot_v", "copy_e"])
def test_update_all_builtins_match(mfunc):
    """update_all with the new builtins (v targets, e-u pairs, dot, copy_e)
    against the JAX package."""
    row, col, n = _coo(7)
    rng = np.random.default_rng(8)
    h = rng.normal(size=(n, 3)).astype(np.float32)
    w = rng.normal(size=(len(row), 3)).astype(np.float32)
    gj = dgl.graph((row, col), num_nodes=n)
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    gj.ndata["h"], gj.edata["w"] = jnp.asarray(h), jnp.asarray(w)
    gt.ndata["h"], gt.edata["w"] = torch.from_numpy(h), torch.from_numpy(w)
    args = {"v_mul_e": ("h", "w"), "e_add_u": ("w", "h"),
            "e_sub_u": ("w", "h"), "u_dot_v": ("h", "h"), "copy_e": ("w",)}
    for reduce in ("sum", "max"):
        want = dgl.core.update_all(gj, getattr(jfn, mfunc)(*args[mfunc], "m"),
                                   getattr(jfn, reduce)("m", "o"))["o"]
        got = dgt.update_all(gt, getattr(tfn, mfunc)(*args[mfunc], "m"),
                             getattr(tfn, reduce)("m", "o"))["o"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUMS)


def _jax_gat(fin, dout, heads, residual, bias, seed=0):
    mod = jnn.GATConv(fin, dout, num_heads=heads, residual=residual,
                      bias=bias)
    gi = dgl.graph((np.arange(4), np.roll(np.arange(4), 1)), num_nodes=4)
    params = mod.init(jax.random.PRNGKey(seed), gi,
                      jnp.zeros((4, fin), jnp.float32))["params"]
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)
                              * 0.3), params)
    return mod, params


def _torch_gat(params, fin, dout, heads, residual, bias, **kw):
    conv = dgt.nn.GATConv(fin, dout, heads, residual=residual, bias=bias,
                          device="cpu", **kw)
    conv.load_state_dict(gatconv_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return conv


def _grads_match(conv, gp_j, residual, bias, tol):
    pairs = [(conv.fc.weight.grad.T, gp_j["fc"]["kernel"]),
             (conv.attn_l.grad, gp_j["attn_l"]),
             (conv.attn_r.grad, gp_j["attn_r"])]
    if residual:
        pairs.append((conv.res_fc.weight.grad.T, gp_j["res_fc"]["kernel"]))
    if bias:
        pairs.append((conv.bias.grad, gp_j["bias"]))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _gat_case(row, col, n, fin, dout, heads, residual, bias, bits):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(n, fin)).astype(np.float32)
    cot = rng.normal(size=(n, heads, dout)).astype(np.float32)
    mod, params = _jax_gat(fin, dout, heads, residual, bias)
    gj = dgl.graph((row, col), num_nodes=n)
    if bits:
        gj.unit().create_bitmask_format()

    def jloss(p, x):
        out = mod.apply({"params": p}, gj, x)
        return (out * cot).sum(), out

    (_, out_j), (gp_j, gx_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    conv = _torch_gat(params, fin, dout, heads, residual, bias)
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    if bits:
        gt.unit().create_bitmask_format()
    xt = torch.from_numpy(x).requires_grad_()
    out_t = conv(gt, xt)
    (out_t * torch.from_numpy(cot)).sum().backward()
    assert not gt.ndata and not gt.edata     # no field leaks out of forward
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **SUMS)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **SUMS)
    _grads_match(conv, gp_j, residual, bias, SUMS)


@pytest.mark.parametrize("residual,bias", [(False, True), (True, True),
                                           (True, False), (False, False)])
def test_gatconv_edge_chain_matches(residual, bias):
    row, col, n = _coo(10, n=70, e=600, no_in=0)
    _gat_case(row, col, n, 6, 5, 3, residual, bias, bits=False)


@pytest.mark.parametrize("heads,dout,residual", [(2, 8, False),
                                                 (1, 41, True)])
def test_gatconv_bits_route_matches(heads, dout, residual, monkeypatch):
    """Both packages on their bitmask route (min edges 1): the JAX Pallas
    kernels in interpret mode, the port's kernels' plain versions."""
    row, col, n = _simple(11)
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    monkeypatch.setitem(jconfig._FLAGS, "pallas_spmm_min_edges", 1)
    with mock.patch.object(jbg, "_bitgat_core",
                           wraps=jbg._bitgat_core) as jspy, \
            mock.patch.object(tbg, "_BitGAT", wraps=tbg._BitGAT) as tspy:
        _gat_case(row, col, n, 7, dout, heads, residual, True, bits=True)
    assert jspy.call_count >= 1 and tspy.apply.call_count == 1


def test_gatconv_routes_and_dropout(monkeypatch):
    """The route gates; attention dropout in training rides the kernels
    with a seed from the module's generator, so two modules with equal
    generators give equal outputs, and eval mode drops nothing."""
    row, col, n = _simple(12)
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    g.unit().create_bitmask_format()
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    x = torch.randn(n, 5, generator=torch.Generator().manual_seed(0))

    def make():
        return dgt.nn.GATConv(5, 4, 2, attn_drop=0.6, device="cpu",
                              generator=torch.Generator().manual_seed(3))

    a, b = make(), make()
    torch.testing.assert_close(a.fc.weight, b.fc.weight)
    with mock.patch.object(tbg, "bitgat_attention_aggregate",
                           wraps=tbg.bitgat_attention_aggregate) as spy:
        out_a, out_b = a(g, x), b(g, x)
        assert spy.call_count == 2
        assert spy.call_args.kwargs["attn_drop"] == 0.6
    torch.testing.assert_close(out_a, out_b)
    a.eval()
    torch.testing.assert_close(a(g, x), b.eval()(g, x))
    assert not torch.allclose(out_a, a(g, x))
    # the edge chain: edge weights and attention ask for it
    with mock.patch.object(tbg, "bitgat_attention_aggregate") as spy:
        out, att = a(g, x, get_attention=True)
        a(g, x, edge_weight=torch.ones(g.num_edges()))
        monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 10**9)
        torch.testing.assert_close(a(g, x), out, **SUMS)
        assert spy.call_count == 0
    assert att.shape == (g.num_edges(), 2, 1)
    assert not g.ndata and not g.edata


def _train_data(seed=13, n=200, e=1600, feat=10, classes=5):
    row, col, n = _simple(seed, n, e)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, feat)).astype(np.float32)
    y = rng.integers(0, classes, n)
    return row, col, n, x, y


def test_gat_training_slice_matches(monkeypatch):
    """2-layer GAT (feat -> 2 heads x 4 -> elu -> 1 head x classes),
    attn_drop 0, 3 Adam steps, both packages on their bitmask route."""
    row, col, n, x, y = _train_data()
    lr, steps, classes = 1e-2, 3, int(y.max()) + 1
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    monkeypatch.setitem(jconfig._FLAGS, "pallas_spmm_min_edges", 1)
    m1, p1 = _jax_gat(x.shape[1], 4, 2, False, True, seed=1)
    m2, p2 = _jax_gat(8, classes, 1, False, True, seed=2)
    gj = dgl.graph((row, col), num_nodes=n)
    gj.unit().create_bitmask_format()
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    def jloss(params):
        h = m1.apply({"params": params["c1"]}, gj, xj)
        h = jax.nn.elu(h.reshape(n, -1))
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

    t1 = _torch_gat(p1, x.shape[1], 4, 2, False, True)
    t2 = _torch_gat(p2, 8, classes, 1, False, True)
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    gt.unit().create_bitmask_format()
    model = torch.nn.ModuleList([t1, t2])
    opt_t = torch.optim.Adam(model.parameters(), lr=lr)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses_t = []
    for _ in range(steps):
        opt_t.zero_grad()
        h = torch.nn.functional.elu(t1(gt, xt).reshape(n, -1))
        logits = t2(gt, h).reshape(n, -1)
        loss = torch.nn.functional.cross_entropy(logits, yt)
        loss.backward()
        opt_t.step()
        losses_t.append(loss.item())

    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert losses_t[-1] < losses_t[0]
    for name, mod in (("c1", t1), ("c2", t2)):
        np.testing.assert_allclose(mod.fc.weight.detach().numpy().T,
                                   np.asarray(params[name]["fc"]["kernel"]),
                                   rtol=1e-4, atol=1e-5)
        for k in ("attn_l", "attn_r", "bias"):
            np.testing.assert_allclose(getattr(mod, k).detach().numpy(),
                                       np.asarray(params[name][k]),
                                       rtol=1e-4, atol=1e-5)


def test_gatconv_state_dict_layout():
    _, params = _jax_gat(6, 3, 2, True, True)
    sd = gatconv_state_dict({"params": jax.tree_util.tree_map(np.asarray,
                                                              params)})
    assert set(sd) == {"fc.weight", "res_fc.weight", "attn_l", "attn_r",
                       "bias"}
    assert sd["fc.weight"].shape == (6, 6) and sd["attn_l"].shape == (1, 2, 3)
    np.testing.assert_array_equal(sd["fc.weight"].numpy(),
                                  np.asarray(params["fc"]["kernel"]).T)
    conv = dgt.nn.GATConv(6, 3, 2, residual=True, device="cpu")
    assert set(conv.state_dict()) == set(sd)
