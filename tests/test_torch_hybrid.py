"""Parity of the port's hybrid format, ``auto_format`` and K12's plain
versions with the JAX package on the CPU.

The builders must emit the JAX builder's arrays exactly: the hub ids, the
wire block (int8, or f16 above 127, widened to bf16 on the device) and
each remainder level's tiled fields.  An npz written by either package
loads in the other.  K12's plain versions are held to the JAX
``int8_matmul``, its Pallas kernels interpreted at small ``BK``/``BN``
(set through ``monkeypatch``): exactly with x on a bf16-exact grid, and
with normal x, which the JAX kernel rounds to bf16 and the port does not,
within 2^-8 of the sum of |a| |x| (bf16 rounding is within 2^-9).  ``hybrid_spmm`` is held to the JAX ``hybrid_spmm``
(its tiled levels interpreted; off the TPU it takes XLA's bf16 dot for the
block) and to a dense float64 oracle, forward and gradient: with inputs on
a grid every sum is exact, so they agree exactly.  The GCN on the hybrid
format is held to the JAX GCN on its XLA path at rtol 1e-4 / atol 1e-5.
"""
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import dgl_tpu as dgl
import dgl_tpu.ops.pallas.hybrid as jhb
import dgl_tpu.ops.pallas.int8mm as ji8
import dgl_tpu_torch as dgt
import dgl_tpu_torch.ops.kernels.hybrid as thb
import dgl_tpu_torch.ops.kernels.int8mm as ti8
import dgl_tpu_torch.ops.kernels.spmm as tsp
from dgl_tpu import nn as jnn
from dgl_tpu_torch import function as tfn
from dgl_tpu_torch.params import graphconv_state_dict
from dgl_tpu_torch.utils import config

FIELDS = ("src_local", "dst_local", "eid", "valid", "src_tile", "dst_tile",
          "src_order")
PALLAS_CALL = pl.pallas_call          # as the JAX package left it
JAX_BLOCKS = (ji8.BK, ji8.BN)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode off the TPU,
    undone after the test."""
    if jax.default_backend() != "tpu":
        monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: PALLAS_CALL(
            *a, **{**k, "interpret": True}))


def _case(kind):
    """(row, col, num_src, num_dst, build kwargs) of a small case."""
    rng = np.random.default_rng({"asym": 31, "sym": 32, "multires": 33,
                                 "weighted": 34, "f16": 35, "star": 36,
                                 "hubs_only": 37}[kind])
    kw = dict(k_dense=16, min_degree=40, tile=256, cap=128)
    if kind in ("sym", "star"):
        n = 600
        if kind == "sym":
            r = np.r_[rng.integers(0, n, 1500), rng.integers(0, n, 1200)]
            c = np.r_[rng.integers(0, n, 1500), rng.integers(0, 20, 1200)]
        else:                       # every edge has a hub endpoint
            r = rng.integers(20, n, 1500)
            c = rng.integers(0, 12, 1500)
        r[:60], c[:60] = r[60:120], c[60:120]        # multi-edges
        return np.r_[r, c], np.r_[c, r], n, n, dict(kw, symmetric=True)
    n_src, n_dst = 700, 530         # multiples of no block size
    if kind == "hubs_only":         # every edge into a hub dst
        row = rng.integers(0, n_src, 2000)
        col = rng.integers(0, 10, 2000)
        return row, col, n_src, n_dst, kw
    row = np.r_[rng.integers(0, n_src, 2500), rng.integers(0, n_src, 2500)]
    col = np.r_[rng.integers(0, n_dst, 2500), rng.integers(0, 24, 2500)]
    row[:200], col[:200] = row[200:400], col[200:400]    # multi-edges
    if kind == "multires":          # a dense tile pair for the small level
        row = np.r_[row, rng.integers(300, 400, 1500)]
        col = np.r_[col, rng.integers(260, 380, 1500)]
        kw = dict(kw, multires=((128, 128), (256, 128)))
    elif kind == "weighted":
        kw = dict(kw, weights=rng.uniform(0.1, 2.0, len(row)).astype(
            np.float32))
    elif kind == "f16":             # one multiplicity over 127
        row = np.r_[row, np.full(150, 5)]
        col = np.r_[col, np.full(150, 3)]
    return row, col, n_src, n_dst, kw


CASES = ["asym", "sym", "multires", "weighted", "f16", "star", "hubs_only"]


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _same_level(t, j):
    assert (t.num_src, t.num_dst, t.tile, t.cap) == (
        j.num_src, j.num_dst, j.tile, j.cap)
    for name in FIELDS:
        got, want = _np(getattr(t, name)), _np(getattr(j, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _same_format(t, j):
    """The port's HybridFormat against the JAX one: every array equal
    (the JAX int8 block carries its TPU padding, which must be zero)."""
    assert (t.k, t.num_src, t.num_dst, t.symmetric) == (
        j.k, j.num_src, j.num_dst, j.symmetric)
    np.testing.assert_array_equal(_np(t.dense_ids),
                                  _np(j.dense_ids).astype(np.int64))
    a, aj = _np(t.a_dense), _np(j.a_dense)
    assert a.dtype == aj.dtype
    np.testing.assert_array_equal(a, aj[: a.shape[0], : a.shape[1]])
    assert not aj[a.shape[0]:].any() and not aj[:, a.shape[1]:].any()
    for side in ("tf_fwd", "tf_rev"):
        lt = thb._levels(getattr(t, side))
        lj = jhb._levels(getattr(j, side))
        assert len(lt) == len(lj)
        for a, b in zip(lt, lj):
            _same_level(a, b)
    if t.symmetric:
        assert t.tf_rev is t.tf_fwd


def _both(kind, **extra):
    row, col, n_src, n_dst, kw = _case(kind)
    kw = dict(kw, **extra)
    t = thb.build_hybrid_format(row, col, n_src, n_dst, device="cpu", **kw)
    j = jhb.build_hybrid_format(row, col, n_src, n_dst, **kw)
    return t, j


@pytest.mark.parametrize("kind", CASES)
def test_builder_equals_jax(kind):
    t, j = _both(kind)
    _same_format(t, j)
    want_dtype = {"weighted": torch.bfloat16, "f16": torch.bfloat16}
    assert t.a_dense.dtype == want_dtype.get(kind, torch.int8)
    assert t.a_dense.shape == (t.k, -(-t.num_src // 128) * 128)
    n_levels = {"multires": 2, "star": 0, "hubs_only": 0}.get(kind, 1)
    assert len(thb._levels(t.tf_fwd)) == n_levels


def test_builder_raises_without_hubs():
    row, col, n_src, n_dst, kw = _case("asym")
    kw = dict(kw, min_degree=10_000)
    with pytest.raises(ValueError):
        jhb.build_hybrid_format(row, col, n_src, n_dst, **kw)
    with pytest.raises(ValueError):
        thb.build_hybrid_format(row, col, n_src, n_dst, device="cpu", **kw)


@pytest.mark.parametrize("kind", ["asym", "sym", "multires", "f16"])
def test_cache_crosses_packages(kind, tmp_path):
    """An npz that the JAX package writes loads in the port, and the
    reverse; both packages write the same arrays under the same names."""
    row, col, n_src, n_dst, kw = _case(kind)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j = jhb.build_hybrid_format(row, col, n_src, n_dst, cache_path=pj, **kw)
    t = thb.build_hybrid_format(row, col, n_src, n_dst, cache_path=pt,
                                device="cpu", **kw)
    with np.load(pj) as zj, np.load(pt) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for name in zj.files:
            assert zj[name].dtype == zt[name].dtype, name
            np.testing.assert_array_equal(zj[name].reshape(-1),
                                          zt[name].reshape(-1), name)
    _same_format(thb.load_hybrid_format(pj, device="cpu"), j)
    _same_format(t, jhb.load_hybrid_format(pt))
    # a build with the path loads the file instead of building
    with mock.patch.object(thb, "unique_counts") as spy:
        _same_format(thb.build_hybrid_format(row, col, n_src, n_dst,
                                             cache_path=pj, device="cpu",
                                             **kw), j)
    assert spy.call_count == 0
    assert thb.load_hybrid_format(str(tmp_path / "none.npz"), "cpu") is None


def test_unique_counts_not_np_unique(monkeypatch):
    """The host builder counts with the sort-based ``unique_counts``
    (numpy 2.3's hash ``np.unique`` is slow at scale)."""
    row, col, n_src, n_dst, kw = _case("asym")
    monkeypatch.setattr(np, "unique", None)
    hf = thb.build_hybrid_format(row, col, n_src, n_dst, device="cpu", **kw)
    assert hf.k > 0


# -- K12's plain versions ------------------------------------------------------

def _jax_int8(a, x, contract_rows, monkeypatch):
    """JAX ``int8_matmul`` at BK = 64, BN = 128, interpreted, unjitted (a
    jitted trace would keep the patched block sizes for later callers)."""
    monkeypatch.setattr(ji8, "BK", 64)
    monkeypatch.setattr(ji8, "BN", 128)
    ap = jnp.asarray(ji8.pad_int8_block(a, bk=64, bn=128))
    out = ji8.int8_matmul.__wrapped__(ap, jnp.asarray(x),
                                      contract_rows=contract_rows)
    return np.asarray(out)


@pytest.mark.parametrize("contract_rows", [False, True])
@pytest.mark.parametrize("f,grid", [(1, True), (16, True), (41, True),
                                    (16, False)])
def test_int8_plain_matches_jax(contract_rows, f, grid, interpret,
                                monkeypatch):
    rng = np.random.default_rng(40 + f)
    k, n, n_pad = 70, 300, 384           # k and n on no block boundary
    a = np.zeros((k, n_pad), np.int8)
    a[:, :n] = rng.integers(0, 128, (k, n)) * (rng.random((k, n)) < 0.3)
    rows = k if contract_rows else n
    if grid:       # multiples of 1/8 in [-4, 4]: bf16-exact, sums exact
        x = rng.integers(-32, 33, (rows, f)).astype(np.float32) / 8
    else:
        x = rng.normal(size=(rows, f)).astype(np.float32)
    want = _jax_int8(a, x, contract_rows, monkeypatch)
    fn = ti8.int8_matmul_cols_plain if contract_rows else \
        ti8.int8_matmul_rows_plain
    got = fn(torch.from_numpy(a), torch.from_numpy(x)).numpy()
    want = want[: got.shape[0]]
    assert got.shape == ((n_pad, f) if contract_rows else (k, f))
    exact = (a.astype(np.float64).T if contract_rows else
             a[:, :n].astype(np.float64)) @ x.astype(np.float64)
    if grid:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, exact)
    else:
        # JAX rounds x to bf16 (relative error up to 2^-9) and the port
        # keeps f32: each sum may move by 2^-9 of the sum of |a| |x|
        mag = (np.abs(a.astype(np.float64).T) if contract_rows else
               np.abs(a[:, :n].astype(np.float64))) @ np.abs(x)
        assert (np.abs(got - want) <= 2.0 ** -8 * mag).all()
        # and an f32 sum of `terms` products is within terms * 2^-24 of it
        terms = k if contract_rows else n
        assert (np.abs(got - exact) <= terms * 2.0 ** -24 * mag).all()
    # the wrapper takes the plain version on the CPU, and counts nothing
    launches = ti8.int8_matmul_rows.launches + ti8.int8_matmul_cols.launches
    np.testing.assert_array_equal(
        ti8.int8_matmul(torch.from_numpy(a), torch.from_numpy(x),
                        contract_rows=contract_rows).numpy(), got)
    assert launches == (ti8.int8_matmul_rows.launches
                        + ti8.int8_matmul_cols.launches)


def test_int8_wrapper_checks():
    a = torch.zeros(8, 128, dtype=torch.int8)
    x = torch.zeros(128, 4)
    for bad_a, bad_x in ((a.float(), x), (a, x.double()), (a, x.half()),
                         (torch.zeros(8, 120, dtype=torch.int8), x[:120]),
                         (a, x.t().contiguous().t()),
                         (a.t().contiguous().t(), x), (a, x[None]),
                         (a, torch.zeros(129, 4))):
        with pytest.raises(ValueError):
            ti8.int8_matmul_rows(bad_a, bad_x)
    with pytest.raises(ValueError):
        ti8.int8_matmul_cols(a, torch.zeros(9, 4))
    with pytest.raises(ValueError):
        ti8.int8_matmul_cols(a, torch.zeros(8, 4, dtype=torch.bfloat16))


# -- hybrid_spmm ------------------------------------------------------------

def _oracle(row, col, n_src, n_dst, w=None):
    a = np.zeros((n_dst, n_src), np.float64)
    np.add.at(a, (col, row), 1.0 if w is None else w)
    return a


@pytest.mark.parametrize("kind", CASES)
def test_hybrid_spmm_matches_jax_and_oracle(kind, interpret):
    row, col, n_src, n_dst, kw = _case(kind)
    t, j = _both(kind)
    rng = np.random.default_rng(50)
    f = 12
    x = rng.integers(-16, 17, (n_src, f)).astype(np.float32) / 8
    cot = rng.integers(-16, 17, (n_dst, f)).astype(np.float32) / 8
    out_j, vjp = jax.vjp(lambda v: jhb.hybrid_spmm(j, v), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    out = thb.hybrid_spmm(t, xt)
    out.backward(torch.from_numpy(cot))
    assert out.dtype == torch.float32 and out.shape == (n_dst, f)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(dx_j))
    a = _oracle(row, col, n_src, n_dst)
    if "weights" in kw:
        # the weights reach the hub rows only, summed into the bf16 block;
        # the remainder's edges count 1, as in the JAX package
        a[np.asarray(t.dense_ids)] = _np(t.a_dense)[:, :n_src]
    np.testing.assert_array_equal(out.detach().numpy(), a @ x)
    np.testing.assert_array_equal(xt.grad.numpy(), a.T @ cot)


# -- dispatch, auto_format, the GCN -------------------------------------------

def _routes():
    return (mock.patch.object(thb, "hybrid_spmm", wraps=thb.hybrid_spmm),
            mock.patch.object(thb, "int8_matmul", wraps=thb.int8_matmul))


def test_dispatch_copy_takes_hybrid_mul_takes_gather(monkeypatch):
    row, col, n, _, kw = _case("sym")
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    g.unit().create_hybrid_format(**kw)
    assert g.unit()._tiled is None and g.unit()._hybrid.symmetric
    rng = np.random.default_rng(60)
    h = torch.from_numpy(rng.integers(-8, 9, (n, 5)).astype(np.float32) / 4)
    w = torch.from_numpy(rng.integers(1, 5, len(row)).astype(np.float32))
    ref = _oracle(row, col, n, n)
    hyb, mm = _routes()
    with hyb as spy, mm as spy_mm, mock.patch.object(
            tsp, "spmm_tiled_mul", wraps=tsp.spmm_tiled_mul) as spy_mul:
        g.ndata["h"] = h
        g.update_all(tfn.copy_u("h", "m"), tfn.sum("m", "out"))
        assert spy.call_count == 1
        assert spy_mm.call_count == 2          # rows and cols (symmetric)
        np.testing.assert_array_equal(g.ndata["out"].numpy(), ref @ h.numpy())
        g.edata["w"] = w
        g.update_all(tfn.u_mul_e("h", "w", "m"), tfn.sum("m", "out"))
        assert spy.call_count == 1 and spy_mul.call_count == 0
        np.testing.assert_allclose(
            g.ndata["out"].numpy(),
            _oracle(row, col, n, n, w.numpy()) @ h.numpy(), rtol=1e-6)
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", len(row) + 1)
    with _routes()[0] as spy:                  # below the edge gate
        g.update_all(tfn.copy_u("h", "m"), tfn.sum("m", "out"))
        assert spy.call_count == 0


def _auto_graphs():
    """The three graphs of tests/test_pallas.py's auto_format test, and a
    symmetric graph under 50M edges with no bitmask budget."""
    rng = np.random.default_rng(7)
    n, e = 2000, 1_200_000
    r0, c0 = rng.integers(0, n, e // 2), rng.integers(0, n, e // 2)
    hub = rng.integers(0, 64, e)
    src = rng.integers(0, 30000, e)
    out = [((np.r_[r0, c0], np.r_[c0, r0]), n, {}),
           ((src, hub), 30000, dict(hbm_budget_bytes=1 << 20)),
           ((rng.integers(0, 5000, 20000), rng.integers(0, 5000, 20000)),
            5000, {})]
    r1 = rng.integers(0, 30000, 600_000)
    c1 = rng.integers(0, 64, 600_000)
    out.append(((np.r_[r1, c1], np.r_[c1, r1]), 30000,
                dict(hbm_budget_bytes=1 << 20)))
    return out


def _hub_graph():
    """1.2M edges over 30,000 nodes, 1M of them into 64 hubs and the rest
    at random: auto_format takes the hybrid at a 1 MiB budget, with a
    remainder."""
    rng = np.random.default_rng(8)
    src = rng.integers(0, 30000, 1_200_000)
    dst = np.r_[rng.integers(0, 64, 1_000_000),
                rng.integers(0, 30000, 200_000)]
    return src, dst, 30000


@pytest.mark.parametrize("case", range(4))
def test_auto_format_matches_jax(case):
    (row, col), n, kw = _auto_graphs()[case]
    uj = dgl.graph((row, col), num_nodes=n).unit()
    ut = dgt.graph((row, col), num_nodes=n, device="cpu").unit()
    choice = ut._auto_format_choice(**kw)
    fam_j, fam_t = uj.auto_format(**kw), ut.auto_format(**kw)
    assert fam_t == fam_j == choice["family"] == \
        ("bitmask", "hybrid", "tiled", "hybrid")[case]
    if fam_t == "bitmask":
        assert ut._bits is not None and ut._bits.symmetric
        np.testing.assert_array_equal(_np(ut._bits.packed),
                                      _np(uj._bits.packed))
    elif fam_t == "hybrid":
        assert ut._hybrid.symmetric == (case == 3) == choice["symmetric"]
        _same_format(ut._hybrid, uj._hybrid)
    else:
        assert ut._tiled is not None and ut._hybrid is None
        _same_level(ut._tiled, uj._tiled)


def test_graph_auto_format_and_cache(tmp_path):
    row, col, n = _hub_graph()
    kw = dict(hbm_budget_bytes=1 << 20)
    gj = dgl.graph((row, col), num_nodes=n)
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    want = gj.auto_format(cache_path=pj, **kw)
    assert gt.auto_format(cache_path=pt, **kw) == want == {
        gt.canonical_etypes[0]: "hybrid"}
    # one relation: the path is used as it is, and it loads in both
    _same_format(thb.load_hybrid_format(pj, "cpu"), gj.unit()._hybrid)
    _same_format(gt.unit()._hybrid, jhb.load_hybrid_format(pt))
    gh = dgt.graph((row, col), num_nodes=n, device="cpu")
    assert gh.create_hybrid_format(k_dense=32, min_degree=100) is gh
    assert gh.unit()._hybrid.k == 32 and not gh.unit()._hybrid.symmetric


def test_create_hybrid_format_defaults_match_jax():
    """UnitGraph.create_hybrid_format's defaults: k_dense 8192, min_degree
    256, tile 1024, cap 512 (not the auto cap)."""
    row, col, n = _hub_graph()
    uj = dgl.graph((row, col), num_nodes=n).unit()
    ut = dgt.graph((row, col), num_nodes=n, device="cpu").unit()
    uj.create_hybrid_format()
    ut.create_hybrid_format()
    assert ut._hybrid.tf_fwd.tile == 1024 and ut._hybrid.tf_fwd.cap == 512
    _same_format(ut._hybrid, uj._hybrid)


def test_graphconv_gcn_on_hybrid_matches_jax(monkeypatch):
    """A 2-layer GraphConv GCN (norm both) on the symmetric hybrid format
    against the JAX GCN with the same weights: logits and gradients."""
    row, col, n, _, kw = _case("sym")
    rng = np.random.default_rng(70)
    feat, hid, classes = 10, 6, 4
    params = {}
    for name, (fi, fo) in (("c1", (feat, hid)), ("c2", (hid, classes))):
        params[name] = {
            "weight": rng.normal(size=(fi, fo)).astype(np.float32) * 0.3,
            "bias": rng.normal(size=(fo,)).astype(np.float32) * 0.1}
    x = rng.normal(size=(n, feat)).astype(np.float32)
    cot = rng.normal(size=(n, classes)).astype(np.float32)
    c1 = jnn.GraphConv(feat, hid, activation=jax.nn.relu)
    c2 = jnn.GraphConv(hid, classes)
    gj = dgl.graph((row, col), num_nodes=n)

    def jloss(p, x):
        out = c2.apply({"params": p["c2"]}, gj,
                       c1.apply({"params": p["c1"]}, gj, x))
        return (out * cot).sum(), out

    (_, out_j), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))

    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    g = dgt.graph((row, col), num_nodes=n, device="cpu")
    g.unit().create_hybrid_format(k_dense=16, min_degree=40, tile=256,
                                  cap=128, symmetric=True)
    t1 = dgt.nn.GraphConv(feat, hid, activation=torch.relu, device="cpu")
    t2 = dgt.nn.GraphConv(hid, classes, device="cpu")
    t1.load_state_dict(graphconv_state_dict(params["c1"]))
    t2.load_state_dict(graphconv_state_dict(params["c2"]))
    xt = torch.from_numpy(x).requires_grad_()
    with _routes()[0] as spy:
        out = t2(g, t1(g, xt))
        (out * torch.from_numpy(cot)).sum().backward()
    assert spy.call_count == 2
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol)
    for name, mod in (("c1", t1), ("c2", t2)):
        for k in ("weight", "bias"):
            np.testing.assert_allclose(getattr(mod, k).grad.numpy(),
                                       np.asarray(gp[name][k]), **tol)


def test_hybrid_format_on_the_card_by_default():
    """The builder and the loader default to device='cuda': without a GPU
    they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    row, col, n_src, n_dst, kw = _case("asym")
    with pytest.raises(RuntimeError):
        thb.build_hybrid_format(row, col, n_src, n_dst, **kw)
    with pytest.raises(RuntimeError):
        thb.load_hybrid_format("absent.npz")


def test_jax_module_state_unchanged():
    """The tests above leave the JAX package's globals as they found
    them (``--dist loadfile`` runs several files in one process)."""
    assert (ji8.BK, ji8.BN) == JAX_BLOCKS == (1024, 2048)
    assert pl.pallas_call is PALLAS_CALL
