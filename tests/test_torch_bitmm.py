"""Parity of the port's bitmask SpMM (dgl_tpu_torch/ops/kernels/bitmm.py)
with the JAX package on identical inputs.

Format builders must emit the same arrays exactly.  ``bit_spmm`` is held to
the JAX ``bit_spmm``, whose Pallas kernels run in interpret mode with f32
operands off the TPU (as tests/test_pallas.py runs them); the port on the
CPU runs the kernels' plain PyTorch versions.  Tolerance rtol 1e-5 /
atol 1e-4: both sides sum in f32, in another order.
"""
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import dgl_tpu.ops.pallas.bitmm as jbm
import dgl_tpu_torch.ops.kernels.bitmm as tbm

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def interpret():
    """Run the JAX package's Pallas kernels in interpret mode off-TPU."""
    if jax.default_backend() == "tpu":
        yield
        return
    orig = pl.pallas_call
    with mock.patch.object(jbm.pl, "pallas_call",
                           lambda *a, **k: orig(*a, **{**k,
                                                       "interpret": True})):
        yield


def _graph(kind):
    """(row, col, num_src, num_dst, symmetric) with multi-edges."""
    rng = np.random.default_rng({"asym": 21, "sym": 22, "plane31": 23}[kind])
    if kind == "asym":
        n_src, n_dst, e = 300, 220, 4000
    elif kind == "sym":
        n_src = n_dst = 256
        e = 2000
    else:                       # bit plane 31 on both packings
        n_src, n_dst, e = 8100, 8050, 30000
    row = rng.integers(0, n_src, e)
    col = rng.integers(0, n_dst, e)
    row[:50], col[:50] = row[50:100], col[50:100]
    if kind == "plane31":
        row[100:140] = rng.integers(7936, n_src, 40)
        col[140:180] = rng.integers(7936, n_dst, 40)
    if kind == "sym":
        row, col = np.concatenate([row, col]), np.concatenate([col, row])
    return row, col, n_src, n_dst, kind == "sym"


def _dense_rem(rs, rd, rw, n_src, n_dst):
    out = np.zeros((n_dst, n_src), np.float64)
    np.add.at(out, (np.asarray(rd), np.asarray(rs)), np.asarray(rw))
    return out


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same_format(bj, bt):
    np.testing.assert_array_equal(_np(bj.packed), _np(bt.packed))
    np.testing.assert_array_equal(_np(bj.packed_rev), _np(bt.packed_rev))
    np.testing.assert_array_equal(
        _dense_rem(bj.rem_src, bj.rem_dst, bj.rem_w, bj.num_src, bj.num_dst),
        _dense_rem(bt.rem_src, bt.rem_dst, bt.rem_w, bt.num_src, bt.num_dst))
    assert bt.symmetric == bj.symmetric and bt.num_dst == bj.num_dst


@pytest.mark.parametrize("kind", ["asym", "sym", "plane31"])
def test_pack_bits_matches(kind):
    row, col, n_src, n_dst, _ = _graph(kind)
    pj, rdj, rsj, rwj = jbm.pack_bits(row, col, n_src, n_dst)
    pt, rdt, rst, rwt = tbm.pack_bits(row, col, n_src, n_dst)
    np.testing.assert_array_equal(pj, pt)
    np.testing.assert_array_equal(_dense_rem(rsj, rdj, rwj, n_src, n_dst),
                                  _dense_rem(rst, rdt, rwt, n_src, n_dst))
    assert (rwt > 0).all() and len(rwt) > 0
    if kind == "plane31":
        assert (pt < 0).any()          # the sign bit is plane 31


@pytest.mark.parametrize("kind", ["asym", "sym", "plane31"])
def test_build_bit_format_matches(kind):
    row, col, n_src, n_dst, sym = _graph(kind)
    bj = jbm.build_bit_format(row, col, n_src, n_dst, symmetric=sym)
    bt = tbm.build_bit_format(row, col, n_src, n_dst, symmetric=sym,
                              device="cpu")
    _same_format(bj, bt)
    assert (bt.packed_rev is bt.packed) == sym
    if kind == "plane31":
        assert (_np(bt.packed) < 0).any() and (_np(bt.packed_rev) < 0).any()


@pytest.mark.parametrize("kind", ["asym", "sym", "plane31"])
def test_build_bit_format_device_matches(kind):
    row, col, n_src, n_dst, sym = _graph(kind)
    bj = jbm.build_bit_format_device(row, col, n_src, n_dst, symmetric=sym)
    bt = tbm.build_bit_format_device(torch.from_numpy(row),
                                     torch.from_numpy(col), n_src, n_dst,
                                     symmetric=sym, device="cpu")
    _same_format(bj, bt)
    # the host builder gives the same format
    _same_format(bt, tbm.build_bit_format(row, col, n_src, n_dst,
                                          symmetric=sym, device="cpu"))


def test_build_bit_format_device_assume_simple():
    row, col, n_src, n_dst, _ = _graph("plane31")
    key = np.unique(col * n_src + row)
    row, col = key % n_src, key // n_src
    bj = jbm.build_bit_format_device(row, col, n_src, n_dst,
                                     assume_simple=True)
    bt = tbm.build_bit_format_device(row, col, n_src, n_dst,
                                     assume_simple=True, device="cpu")
    _same_format(bj, bt)
    assert bt.rem_src.numel() == 0


@pytest.mark.parametrize("kind", ["asym", "sym"])
@pytest.mark.parametrize("f", [8, 96, 97, 136])
def test_bit_spmm_matches_jax(interpret, kind, f):
    row, col, n_src, n_dst, sym = _graph(kind)
    _check_spmm(row, col, n_src, n_dst, sym, f)


@pytest.mark.parametrize("f", [8, 97])
def test_bit_spmm_plane31_matches_jax(interpret, f):
    row, col, n_src, n_dst, sym = _graph("plane31")
    _check_spmm(row, col, n_src, n_dst, sym, f)


def _check_spmm(row, col, n_src, n_dst, sym, f):
    rng = np.random.default_rng(f)
    x = rng.normal(size=(n_src, f)).astype(np.float32)
    dz = rng.normal(size=(n_dst, f)).astype(np.float32)
    bj = jbm.build_bit_format(row, col, n_src, n_dst, symmetric=sym)
    bt = tbm.build_bit_format(row, col, n_src, n_dst, symmetric=sym,
                              device="cpu")
    out_j, vjp = jax.vjp(lambda v: jbm.bit_spmm(bj, v), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(dz))
    xt = torch.from_numpy(x).requires_grad_()
    out_t = tbm.bit_spmm(bt, xt)
    out_t.backward(torch.from_numpy(dz))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j),
                               rtol=RTOL, atol=ATOL)
    # and the product itself, against a dense oracle
    dense = np.zeros((n_dst, n_src))
    np.add.at(dense, (col, row), 1.0)
    np.testing.assert_allclose(out_t.detach().numpy(), dense @ x,
                               rtol=RTOL, atol=ATOL)


def test_plain_versions_chunk_rows(monkeypatch):
    """The plain versions give the same product whatever rows they unpack
    at a time, and the wrappers take them for CPU tensors."""
    row, col, n_src, n_dst, _ = _graph("asym")
    bt = tbm.build_bit_format(row, col, n_src, n_dst, device="cpu")
    x = torch.randn(n_src, 5, generator=torch.Generator().manual_seed(0))
    ref_t = tbm.bit_matmul_t(bt.packed_rev, x, n_dst)
    ref = tbm.bit_matmul(bt.packed, x, n_dst)
    torch.testing.assert_close(ref, ref_t, rtol=RTOL, atol=ATOL)
    monkeypatch.setattr(tbm, "PLAIN_ROWS", 7)
    torch.testing.assert_close(tbm.bit_matmul_t_plain(bt.packed_rev, x,
                                                      n_dst), ref_t)
    torch.testing.assert_close(tbm.bit_matmul_plain(bt.packed, x, n_dst),
                               ref)
    assert tbm.bit_matmul_t.launches == 0 and tbm.bit_matmul.launches == 0
    with pytest.raises(ValueError):
        tbm.bit_matmul_t(bt.packed_rev, torch.zeros(n_src, 97), n_dst)
    with pytest.raises(ValueError):
        tbm.bit_matmul(bt.packed, x, bt.packed.shape[0] + 1)


def test_remainder_chunks(monkeypatch):
    """A remainder longer than REM_CHUNK is added in chunks, with the same
    values and gradients."""
    row, col, n_src, n_dst, _ = _graph("asym")
    row[200:400], col[200:400] = row[:200], col[:200]
    bt = tbm.build_bit_format(row, col, n_src, n_dst, device="cpu")
    x = torch.randn(n_src, 4, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    out = tbm.bit_spmm(bt, x)
    (g,) = torch.autograd.grad(out.square().sum(), x)
    monkeypatch.setattr(tbm, "REM_CHUNK", 16)
    assert bt.rem_src.numel() > 16
    out2 = tbm.bit_spmm(bt, x)
    (g2,) = torch.autograd.grad(out2.square().sum(), x)
    torch.testing.assert_close(out2, out)
    torch.testing.assert_close(g2, g)
