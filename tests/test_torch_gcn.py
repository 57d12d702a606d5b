"""Parity of the port's GraphConv and of the whole slice (a 2-layer GCN
trained with Adam) with the JAX package, on the CPU; the port's import
purity and its default device."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dgl_tpu as dgl
import dgl_tpu_torch as dgt
import dgl_tpu_torch.ops.kernels.bitmm as tbm
from dgl_tpu import nn as jnn
from dgl_tpu_torch.params import graphconv_state_dict
from dgl_tpu_torch.utils import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _coo(seed, n=80, e=700):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, e)
    col = rng.integers(0, n - 4, e)      # 4 nodes with no in-edge
    return row, col, n


def _params(rng, fin, fout):
    return {"weight": rng.normal(size=(fin, fout)).astype(np.float32) * 0.3,
            "bias": rng.normal(size=(fout,)).astype(np.float32) * 0.1}


@pytest.mark.parametrize("norm,fin,fout,weighted", [
    (norm, fin, fout, False) for norm in ("none", "both", "left", "right")
    for fin, fout in ((7, 3), (3, 7))] + [
    ("both", 7, 3, True), ("both", 3, 7, True)])
def test_graphconv_matches(norm, fin, fout, weighted):
    row, col, n = _coo(fin * 10 + fout)
    rng = np.random.default_rng(5)
    p = _params(rng, fin, fout)
    x = rng.normal(size=(n, fin)).astype(np.float32)
    ew = rng.uniform(0.1, 2.0, size=len(row)).astype(np.float32)
    cot = rng.normal(size=(n, fout)).astype(np.float32)

    mod = jnn.GraphConv(fin, fout, norm=norm, activation=jax.nn.relu)

    def jloss(params, x):
        g = dgl.graph((row, col), num_nodes=n)
        out = mod.apply({"params": params}, g, x,
                        edge_weight=jnp.asarray(ew) if weighted else None)
        return (out * cot).sum(), out

    (_, out_j), (gp_j, gx_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))

    conv = dgt.nn.GraphConv(fin, fout, norm=norm, activation=torch.relu,
                            device="cpu")
    conv.load_state_dict(graphconv_state_dict({"params": p}))
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    out = conv(g, xt, edge_weight=torch.from_numpy(ew) if weighted else None)
    (out * torch.from_numpy(cot)).sum().backward()
    assert not g.ndata and not g.edata       # no field leaks out of forward
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **tol)
    np.testing.assert_allclose(conv.weight.grad.numpy(),
                               np.asarray(gp_j["weight"]), **tol)
    np.testing.assert_allclose(conv.bias.grad.numpy(),
                               np.asarray(gp_j["bias"]), **tol)


def test_graphconv_options():
    row, col, n = _coo(9)
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    with pytest.raises(ValueError):
        dgt.nn.GraphConv(3, 4, norm="sym", device="cpu")
    bare = dgt.nn.GraphConv(3, 4, weight=False, bias=False, device="cpu")
    assert list(bare.state_dict()) == []
    w = torch.randn(3, 4)
    x = torch.randn(n, 3)
    full = dgt.nn.GraphConv(3, 4, bias=False, device="cpu")
    full.load_state_dict({"weight": w})
    torch.testing.assert_close(bare(g, x, weight=w), full(g, x))
    a = dgt.nn.GraphConv(5, 2, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    b = dgt.nn.GraphConv(5, 2, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a.weight, b.weight)


def _slice_data(seed=11, n=500, e=6000, feat=20, classes=6):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, e)
    col = rng.integers(0, n, e)
    x = rng.normal(size=(n, feat)).astype(np.float32)
    y = rng.integers(0, classes, n)
    train = np.sort(rng.permutation(n)[: n // 2])
    p1 = _params(rng, feat, 4)
    p2 = _params(rng, 4, classes)
    return row, col, n, x, y, train, p1, p2


def test_gcn_training_slice_matches(monkeypatch):
    """2-layer GCN (feat -> 4 -> classes, norm both), 3 Adam steps: the port
    on its bit route (the kernels' plain versions on the CPU) against the
    JAX package with optax.adam at the same lr."""
    row, col, n, x, y, train, p1, p2 = _slice_data()
    lr, steps = 1e-2, 3

    # JAX
    c1 = jnn.GraphConv(x.shape[1], 4, activation=jax.nn.relu)
    c2 = jnn.GraphConv(4, p2["weight"].shape[1])
    gj = dgl.add_self_loop(dgl.graph((row, col), num_nodes=n))
    xj, yj, tj = jnp.asarray(x), jnp.asarray(y), jnp.asarray(train)

    def jloss(params):
        h = c1.apply({"params": params["c1"]}, gj, xj)
        logits = c2.apply({"params": params["c2"]}, gj, h)
        ls = optax.softmax_cross_entropy_with_integer_labels(logits[tj],
                                                             yj[tj])
        return ls.mean()

    params = {"c1": {k: jnp.asarray(v) for k, v in p1.items()},
              "c2": {k: jnp.asarray(v) for k, v in p2.items()}}
    tx = optax.adam(lr)
    opt = tx.init(params)
    losses_j = []
    for _ in range(steps):
        loss, grads = jax.value_and_grad(jloss)(params)
        up, opt = tx.update(grads, opt)
        params = optax.apply_updates(params, up)
        losses_j.append(float(loss))

    # the port
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    g = dgt.add_self_loop(dgt.graph((row, col), num_nodes=n, device="cpu"))
    g.unit().create_bitmask_format(on_device=True)
    t1 = dgt.nn.GraphConv(x.shape[1], 4, activation=torch.relu,
                          device="cpu")
    t2 = dgt.nn.GraphConv(4, p2["weight"].shape[1], device="cpu")
    t1.load_state_dict(graphconv_state_dict(p1))
    t2.load_state_dict(graphconv_state_dict(p2))
    model = torch.nn.ModuleList([t1, t2])
    opt_t = torch.optim.Adam(model.parameters(), lr=lr)
    xt, yt, tt = (torch.from_numpy(a) for a in (x, y, train))
    losses_t = []
    for _ in range(steps):
        opt_t.zero_grad()
        logits = t2(g, t1(g, xt))
        loss = torch.nn.functional.cross_entropy(logits[tt], yt[tt])
        loss.backward()
        opt_t.step()
        losses_t.append(loss.item())

    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert losses_t[-1] < losses_t[0]
    for name, mod in (("c1", t1), ("c2", t2)):
        for k in ("weight", "bias"):
            np.testing.assert_allclose(getattr(mod, k).detach().numpy(),
                                       np.asarray(params[name][k]),
                                       rtol=1e-4, atol=1e-6)


def test_graphconv_state_dict_layout():
    rng = np.random.default_rng(0)
    p = _params(rng, 6, 2)
    sd = graphconv_state_dict({"params": p})
    assert set(sd) == {"weight", "bias"}
    assert sd["weight"].shape == (6, 2) and sd["weight"].dtype == torch.float32
    np.testing.assert_array_equal(sd["weight"].numpy(), p["weight"])
    assert graphconv_state_dict({"weight": p["weight"]}).keys() == {"weight"}


def test_port_imports_no_jax():
    """The port imports neither jax nor the JAX package (a subprocess: this
    test process has jax loaded by tests/conftest.py)."""
    code = """
import sys
before = set(sys.modules)
import numpy as np
import torch
import dgl_tpu_torch as dgt
from dgl_tpu_torch.utils import config
config.set("kernel_spmm_min_edges", 1)
rng = np.random.default_rng(0)
g = dgt.graph((rng.integers(0, 50, 400), rng.integers(0, 50, 400)),
              num_nodes=50, device="cpu")
g.unit().create_bitmask_format(on_device=True)
conv = dgt.nn.GraphConv(5, 3, device="cpu")
conv(g, torch.randn(50, 5)).sum().backward()
import dgl_tpu_torch.params, dgl_tpu_torch.ops.kernels.bitgat
gs = dgt.graph((rng.integers(0, 50, 400), rng.integers(0, 50, 400)),
               num_nodes=50, device="cpu")
gs.unit().create_bitmask_format()
bits_gat = dgt.nn.GATConv(5, 4, 2, device="cpu")
bits_gat(gs, torch.randn(50, 5)).sum().backward()   # multi-edges: chain
row, col = gs.unit().coo()
key = torch.unique(col * 50 + row)
gs = dgt.graph((key % 50, key // 50), num_nodes=50, device="cpu")
gs.unit().create_bitmask_format()
bits_gat(gs, torch.randn(50, 5)).sum().backward()   # simple: the kernels
import dgl_tpu_torch.ops.kernels.bitdot
dgt.nn.DotGatConv(5, 64, 2, device="cpu")(
    gs, torch.randn(50, 5)).sum().backward()                    # K7
dgt.ops.edge_softmax(gs, dgt.ops.gsddmm(gs, "add", torch.randn(50, 2),
                                        torch.randn(50, 2)))
import dgl_tpu_torch.ops.edgeflat, dgl_tpu_torch.ops.kernels.tiled_spmm
gt = dgt.graph((rng.integers(0, 50, 400), rng.integers(0, 50, 400)),
               num_nodes=50, device="cpu")
gt.create_tiled_format(tile=128, cap=128)
gt.edata["w"] = dgt.nn.EdgeWeightNorm()(gt, torch.ones(400))
gt.cache_edge_weights("w")
dgt.nn.GraphConv(5, 3, norm="none", device="cpu")(
    gt, torch.randn(50, 5), edge_weight="w").sum().backward()   # K3 static
conv(gt, torch.randn(50, 5), edge_weight=torch.rand(400)).sum().backward()
gat = dgt.nn.GATConv(5, 4, 2, attn_drop=0.5, device="cpu")
gat(gt, torch.randn(50, 5)).sum().backward()                    # K4
import dgl_tpu_torch.ops.kernels.gat_fused
gat.eval()
gat(gt, torch.randn(50, 5)).sum().backward()                    # K6
dgt.nn.DotGatConv(5, 4, 2, device="cpu")(
    gt, torch.randn(50, 5)).sum().backward()                    # K8
ef = torch.randn(400, 3)
dgt.nn.EdgeGATConv(5, 3, 4, 2, device="cpu")(
    gt, torch.randn(50, 5), ef,
    efeats_slot=dgt.nn.EdgeGATConv.slot_edge_feats(gt, ef)).sum().backward()
import dgl_tpu_torch.nn.softmax                                 # K10 v2
gh = dgt.graph((rng.integers(0, 50, 400), rng.integers(0, 5, 400)),
               num_nodes=50, device="cpu")
gh.unit().create_hybrid_format(k_dense=8, min_degree=20, tile=128, cap=128)
conv(gh, torch.randn(50, 5)).sum().backward()                   # K12
assert gh.auto_format() == {gh.canonical_etypes[0]: "tiled"}
tgf = dgl_tpu_torch.ops.kernels.gat_fused
tf = gt.unit().tiled_format()[0]
fe = tgf.slot_edge_tensor(tf, torch.randn(400, 8)).requires_grad_()
tgf.egatconv_attention_aggregate(
    tf, torch.randn(50, 2, 4), torch.randn(50, 2, 4), fe, torch.randn(2, 4),
    torch.randn(50, 2, 4), 2, 4, 4, 0.2).sum().backward()       # K11 v1
tgf.edgegat_attention_aggregate(
    tf, torch.randn(50, 2), torch.randn(50, 2),
    tgf.slot_edge_tensor(tf, torch.randn(400, 2)).permute(0, 2, 1), fe,
    torch.randn(50, 2, 4), 2, 4, 0.2).sum().backward()           # K10 v1
from dgl_tpu_torch.tools import perf_bitgat_probe, perf_bitmm_variants
perf_bitgat_probe.tiny_check("cpu")                              # P2
perf_bitmm_variants.tiny_check("cpu")                            # P1
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "dgl_tpu"))
assert not bad, bad
print("clean")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("clean")


def test_default_device_is_the_card():
    """Entry points default to device="cuda"; with no GPU they raise
    instead of running on the CPU."""
    row, col, n = _coo(1)
    entries = [
        lambda: dgt.graph((row, col), num_nodes=n),
        lambda: dgt.nn.GraphConv(3, 4),
        lambda: dgt.nn.GATConv(3, 4, 2),
        lambda: dgt.nn.DotGatConv(3, 4, 2),
        lambda: tbm.build_bit_format(row, col, n, n),
        lambda: tbm.build_bit_format_device(row, col, n, n),
    ]
    if torch.cuda.is_available():
        assert entries[0]().device.type == "cuda"
        return
    for make in entries:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
