"""Parity of the port's bit-masked GAT attention
(dgl_tpu_torch/ops/kernels/bitgat.py, K5) with the JAX package on
identical inputs.

The dropout threshold and keep mask must equal the JAX package's bit for
bit.  ``bitgat_attention_aggregate`` is held to the JAX one, whose Pallas
kernels run in interpret mode with f32 operands off the TPU; the port on
the CPU runs the kernels' plain PyTorch versions.  Tolerance rtol 1e-4 /
atol 1e-5: f32 on both sides, with the sums over each node's edges taken
in another order (the TPU kernels sum plane by plane, the plain versions
edge by edge).
"""
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import dgl_tpu.ops.pallas.bitgat as jbg
import dgl_tpu.ops.pallas.bitmm as jbm
import dgl_tpu_torch.ops.kernels.bitgat as tbg
import dgl_tpu_torch.ops.kernels.bitmm as tbm

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture
def interpret():
    """Run the JAX package's Pallas kernels in interpret mode off-TPU."""
    if jax.default_backend() == "tpu":
        yield
        return
    orig = pl.pallas_call
    with mock.patch.object(jbg.pl, "pallas_call",
                           lambda *a, **k: orig(*a, **{**k,
                                                       "interpret": True})):
        yield


def _simple_graph(rng, n_src, n_dst, e, no_in=0):
    """Deduplicated random edges; the last ``no_in`` dst have none."""
    row = rng.integers(0, n_src, e)
    col = rng.integers(0, n_dst - no_in, e)
    key = np.unique(col.astype(np.int64) * n_src + row)
    return key % n_src, key // n_src


def _inputs(seed, n_src, n_dst, heads, dim):
    rng = np.random.default_rng(seed)
    el = rng.normal(size=(n_src, heads)).astype(np.float32)
    er = rng.normal(size=(n_dst, heads)).astype(np.float32)
    z = rng.normal(size=(n_src, heads, dim)).astype(np.float32)
    w = rng.normal(size=(n_dst, heads, dim)).astype(np.float32)
    return el, er, z, w


def _both(row, col, n_src, n_dst, heads, dim, drop, seed, slope=0.2,
          bound=False):
    """(out, d_el, d_er, d_z) of the loss sum(out * w) on both sides; with
    ``bound``, some el and er lie exactly on the +-20 clip and some past
    it."""
    el, er, z, w = _inputs(heads * 100 + dim, n_src, n_dst, heads, dim)
    if bound:
        el[::7], el[3::7], el[5::11] = 20.0, -20.0, 25.0
        er[::5], er[2::5], er[4::13] = -20.0, 20.0, -30.0
    bj = jbm.build_bit_format(row, col, n_src, n_dst)
    bt = tbm.build_bit_format(row, col, n_src, n_dst, device="cpu")

    def jloss(el, er, z):
        out = jbg.bitgat_attention_aggregate(
            bj, el, er, z, slope, attn_drop=drop,
            dropout_seed=seed if drop else None)
        return (out * w).sum(), out

    (_, out_j), grads_j = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(el), jnp.asarray(er), jnp.asarray(z))
    ts = [torch.from_numpy(a).requires_grad_() for a in (el, er, z)]
    out_t = tbg.bitgat_attention_aggregate(
        bt, *ts, slope, attn_drop=drop, dropout_seed=seed if drop else None)
    (out_t * torch.from_numpy(w)).sum().backward()
    return ((out_t.detach().numpy(),) + tuple(t.grad.numpy() for t in ts),
            (np.asarray(out_j),) + tuple(np.asarray(g) for g in grads_j))


def _assert_close(got, want):
    for name, a, b in zip(("out", "d_el", "d_er", "d_z"), got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("attn_drop", [0.0, 1e-6, 0.1, 0.6, 0.99, 0.99999])
def test_drop_thresh_matches(attn_drop):
    assert tbg.drop_thresh(attn_drop) == jbg.drop_thresh(attn_drop)


def test_drop_thresh_range():
    assert tbg.drop_thresh(0.6) == 13107       # round(0.4 * 2^15)
    for bad in (1.0, 1.5):
        with pytest.raises(ValueError):
            tbg.drop_thresh(bad)


@pytest.mark.parametrize("seed", [0, 1234, -1, -2**31, 2**31 - 1])
@pytest.mark.parametrize("attn_drop", [0.6, 0.3])
def test_dropout_keep_reference_bit_exact(seed, attn_drop):
    """The keep mask on ids up to 2^24 and on negative seeds equals the
    JAX package's bit for bit, for all 8 heads."""
    rng = np.random.default_rng(abs(seed) % 1000)
    src = np.r_[0, 2**24 - 1, rng.integers(0, 2**24, 4000)]
    dst = np.r_[2**24 - 1, 0, rng.integers(0, 2**24, 4000)]
    want = np.asarray(jbg.dropout_keep_reference(
        jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32), 8, seed,
        attn_drop))
    got = tbg.dropout_keep_reference(torch.from_numpy(src),
                                     torch.from_numpy(dst), 8, seed,
                                     attn_drop).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.2 < 1 - got.mean() < 0.7


def test_dropout_keep_reference_no_dropout():
    keep = tbg.dropout_keep_reference(torch.arange(5), torch.arange(5), 3,
                                      7, 0.0)
    assert keep.shape == (5, 3) and keep.all()


@pytest.mark.parametrize("heads,dim,drop", [
    (2, 16, 0.0), (2, 16, 0.6), (4, 32, 0.6), (1, 41, 0.6), (8, 16, 0.6),
    (3, 5, 0.0)])
def test_bitgat_matches_jax(interpret, heads, dim, drop):
    rng = np.random.default_rng(1)
    row, col = _simple_graph(rng, 300, 220, 4000)
    got, want = _both(row, col, 300, 220, heads, dim, drop, seed=77)
    _assert_close(got, want)


def test_bitgat_slope_and_seed(interpret):
    """Another LeakyReLU slope; the mask follows the seed."""
    rng = np.random.default_rng(2)
    row, col = _simple_graph(rng, 180, 180, 2500)
    got, want = _both(row, col, 180, 180, 3, 8, 0.5, seed=-5, slope=0.4)
    _assert_close(got, want)
    other, _ = _both(row, col, 180, 180, 3, 8, 0.5, seed=-4, slope=0.4)
    assert np.abs(other[0] - got[0]).max() > 1e-4


def test_bitgat_zero_in_degree_rows(interpret):
    """dst nodes with no in-edge give exactly 0 and finite gradients."""
    rng = np.random.default_rng(3)
    row, col = _simple_graph(rng, 200, 150, 2000, no_in=50)
    got, want = _both(row, col, 200, 150, 2, 8, 0.6, seed=9)
    _assert_close(got, want)
    np.testing.assert_array_equal(got[0][100:], 0.0)
    np.testing.assert_array_equal(got[2][100:], 0.0)
    assert all(np.isfinite(g).all() for g in got[1:])


def test_bitgat_plane31_matches_jax(interpret):
    """A graph whose two packings reach bit plane 31 (the sign bit)."""
    rng = np.random.default_rng(4)
    n_src, n_dst = 8100, 8050
    row, col = _simple_graph(rng, n_src, n_dst, 20_000)
    row = np.r_[row, rng.integers(7936, n_src, 40)]
    col = np.r_[col, rng.integers(7936, n_dst, 40)]
    key = np.unique(col * n_src + row)
    row, col = key % n_src, key // n_src
    bt = tbm.build_bit_format(row, col, n_src, n_dst, device="cpu")
    assert (bt.packed < 0).any() and (bt.packed_rev < 0).any()
    got, want = _both(row, col, n_src, n_dst, 2, 8, 0.6, seed=31)
    _assert_close(got, want)


def test_bitgat_clip_bound_matches_jax(interpret):
    """el and er exactly on the +-20 clip: its gradient there is 1/2, as
    jnp.clip's is (torch.clamp's would be 1, twice JAX's d_el), and 0 past
    the bound."""
    rng = np.random.default_rng(5)
    row, col = _simple_graph(rng, 64, 64, 700)
    got, want = _both(row, col, 64, 64, 2, 8, 0.0, seed=0, bound=True)
    _assert_close(got, want)
    assert np.abs(got[1][::7]).max() > 1e-3      # the bound's gradient
    np.testing.assert_array_equal(got[1][5::11], 0.0)


def test_bitgat_guards():
    row = np.array([0, 0, 1], np.int64)
    col = np.array([1, 1, 2], np.int64)     # the edge (0, 1) twice
    multi = tbm.build_bit_format(row, col, 8, 8, device="cpu")
    assert multi.rem_src.numel() > 0
    el, er = torch.zeros(8, 1), torch.zeros(8, 1)
    with pytest.raises(ValueError, match="simple"):
        tbg.bitgat_attention_aggregate(multi, el, er, torch.zeros(8, 1, 4))
    bf = tbm.build_bit_format(row[1:], col[1:], 8, 8, device="cpu")
    with pytest.raises(ValueError, match="8 heads"):
        tbg.bitgat_attention_aggregate(bf, torch.zeros(8, 9),
                                       torch.zeros(8, 9),
                                       torch.zeros(8, 9, 2), attn_drop=0.5,
                                       dropout_seed=1)
    with pytest.raises(ValueError, match="dropout_seed"):
        tbg.bitgat_attention_aggregate(bf, el, er, torch.zeros(8, 1, 4),
                                       attn_drop=0.5)
    with pytest.raises(ValueError, match="H \\* D"):
        tbg.bitgat_attention_aggregate(bf, torch.zeros(8, 2),
                                       torch.zeros(8, 2),
                                       torch.zeros(8, 2, 65))
    # without dropout H may pass 8, as in the JAX package
    out = tbg.bitgat_attention_aggregate(bf, torch.zeros(8, 16),
                                         torch.zeros(8, 16),
                                         torch.ones(8, 16, 2))
    assert out.shape == (8, 16, 2)


def test_plain_versions_chunk_rows(monkeypatch):
    """The plain versions give the same results whatever rows they list
    at a time, and the wrappers take them for CPU tensors."""
    rng = np.random.default_rng(5)
    n_src, n_dst, heads, dim = 300, 220, 2, 8
    row, col = _simple_graph(rng, n_src, n_dst, 3000)
    bt = tbm.build_bit_format(row, col, n_src, n_dst, device="cpu")
    el, er, z, w = (torch.from_numpy(a) for a in
                    _inputs(6, n_src, n_dst, heads, dim))
    linv, rho = torch.rand(n_dst, heads), torch.randn(n_dst, heads)
    args = (0.2, tbg.drop_thresh(0.6), 3)

    def run():
        fwd = tbg.bitgat_fwd(bt.packed, el, er, z, n_dst, *args)
        bwd = tbg.bitgat_bwd(bt.packed_rev, el, er, z, w, linv, rho, n_dst,
                             *args)
        return fwd + bwd

    ref = run()
    monkeypatch.setattr(tbg, "PLAIN_WORDS", 7)
    for a, b in zip(run(), ref):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    assert tbg.bitgat_fwd.launches == 0 and tbg.bitgat_bwd.launches == 0
    # the edges the plain versions list are the graph's
    listed = torch.cat([d * n_src + s for d, s in
                        tbg.bit_edges(bt.packed, n_dst)])
    np.testing.assert_array_equal(np.sort(listed.numpy()),
                                  np.sort(col * n_src + row))
    with pytest.raises(ValueError):
        tbg.bitgat_fwd(bt.packed, el, er[:-1], z, n_dst, *args)
    with pytest.raises(ValueError):
        tbg.bitgat_bwd(bt.packed_rev, el, er, z, w[:-1], linv, rho, n_dst,
                       *args)


def test_bitgat_input_gradients_optional():
    """z without a gradient (a layer's input) is fine: the backward gives
    the gradients of el and er alone."""
    rng = np.random.default_rng(7)
    row, col = _simple_graph(rng, 120, 120, 900)
    bt = tbm.build_bit_format(row, col, 120, 120, device="cpu")
    el, er, z, w = (torch.from_numpy(a) for a in _inputs(8, 120, 120, 2, 4))
    el.requires_grad_()
    out = tbg.bitgat_attention_aggregate(bt, el, er, z)
    (out * w).sum().backward()
    assert el.grad is not None and torch.isfinite(el.grad).all()
