"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  These tests need a GPU and skip without one; they import
neither JAX nor the JAX package, so they run on a machine that has only
PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance rtol 1e-4 / atol 1e-3: f32 sums in another order, and K1's
atomics (and K5's, for the gradient of er) add in an order that changes
from run to run."""
import numpy as np
import pytest
import torch

import dgl_tpu_torch as dgt
import dgl_tpu_torch.ops.kernels.bitgat as tbg
import dgl_tpu_torch.ops.kernels.bitmm as tbm
from dgl_tpu_torch.utils import config

pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-4, 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _coo(n_src=8100, n_dst=8050, e=60_000, seed=23):
    """COO with multi-edges whose packings both reach bit plane 31."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n_src, e)
    col = rng.integers(0, n_dst, e)
    row[:500], col[:500] = row[500:1000], col[500:1000]
    row[1000:1100] = rng.integers(7936, n_src, 100)
    col[1100:1200] = rng.integers(7936, n_dst, 100)
    return row, col, n_src, n_dst


@pytest.mark.parametrize("f", [16, 41, 96, 97, 128])
def test_kernels_match_plain(card, f):
    """Forward and backward of ``bit_spmm`` through a kernel against the
    kernel's plain version plus the remainder."""
    row, col, n_src, n_dst = _coo()
    bf = tbm.build_bit_format_device(row, col, n_src, n_dst, device=card)
    assert (bf.packed < 0).any() and (bf.packed_rev < 0).any()
    gen = torch.Generator(device=card).manual_seed(f)
    x = torch.randn(n_src, f, device=card, generator=gen, requires_grad=True)
    dz = torch.randn(n_dst, f, device=card, generator=gen)
    counter = tbm.bit_matmul_t if f <= tbm.T_MAX_F else tbm.bit_matmul
    before = counter.launches
    out = tbm.bit_spmm(bf, x)
    out.backward(dz)
    assert counter.launches == before + 2
    plain = (tbm.bit_matmul_t_plain if f <= tbm.T_MAX_F
             else tbm.bit_matmul_plain)
    fwd, bwd = ((bf.packed_rev, bf.packed) if f <= tbm.T_MAX_F
                else (bf.packed, bf.packed_rev))
    ref = tbm.add_remainder(plain(fwd, x.detach(), n_dst), x.detach(),
                            bf.rem_src, bf.rem_dst, bf.rem_w)
    dref = tbm.add_remainder(plain(bwd, dz, n_src), dz, bf.rem_dst,
                             bf.rem_src, bf.rem_w)
    torch.testing.assert_close(out.detach(), ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(x.grad, dref, rtol=RTOL, atol=ATOL)


def test_device_packing_matches_host(card):
    row, col, n_src, n_dst = _coo()
    dev = tbm.build_bit_format_device(row, col, n_src, n_dst, device=card)
    host = tbm.build_bit_format(row, col, n_src, n_dst, device="cpu")
    np.testing.assert_array_equal(dev.packed.cpu().numpy(),
                                  host.packed.numpy())
    np.testing.assert_array_equal(dev.packed_rev.cpu().numpy(),
                                  host.packed_rev.numpy())


@pytest.mark.parametrize("fin,fout", [(30, 8), (120, 130)])
def test_graphconv_kernels_match_gather_path(card, fin, fout, monkeypatch):
    """A GraphConv step through the kernels (K1 at F = 8, K2 at F = 120)
    equals the gather + ``index_add_`` path on the card, and the graph
    lives on the card by default."""
    row, col, n, _ = _coo(n_src=8100, n_dst=8100)
    g = dgt.add_self_loop(dgt.graph((row, col), num_nodes=n))
    assert g.device.type == "cuda"
    g.unit().create_bitmask_format(on_device=True)
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    conv = dgt.nn.GraphConv(fin, fout,
                            generator=torch.Generator(device=card)
                            .manual_seed(0))
    x = torch.randn(n, fin, device=card,
                    generator=torch.Generator(device=card).manual_seed(1),
                    requires_grad=True)

    def step():
        conv.zero_grad()
        x.grad = None
        out = conv(g, x)
        out.square().mean().backward()
        return out.detach(), conv.weight.grad.clone(), x.grad.clone()

    launches = tbm.bit_matmul_t.launches + tbm.bit_matmul.launches
    out_k, dw_k, dx_k = step()
    assert tbm.bit_matmul_t.launches + tbm.bit_matmul.launches == \
        launches + 2
    monkeypatch.setitem(config._FLAGS, "use_kernels", False)
    out_g, dw_g, dx_g = step()
    torch.testing.assert_close(out_k, out_g, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(dw_k, dw_g, rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(dx_k, dx_g, rtol=1e-3, atol=1e-5)


def _simple_coo():
    """The COO above made simple: both packings still reach plane 31."""
    row, col, n_src, n_dst = _coo()
    key = np.unique(col * n_src + row)
    return key % n_src, key // n_src, n_src, n_dst


@pytest.mark.parametrize("heads,dim,drop", [
    (4, 32, 0.0), (4, 32, 0.6), (1, 41, 0.0), (1, 41, 0.6), (8, 16, 0.6),
    (3, 5, 0.0), (2, 64, 0.0)])
def test_bitgat_kernels_match_plain(card, heads, dim, drop):
    """K5 forward and backward through ``bitgat_attention_aggregate``
    against the plain versions chained the same way."""
    row, col, n_src, n_dst = _simple_coo()
    bf = tbm.build_bit_format_device(row, col, n_src, n_dst, device=card)
    assert (bf.packed < 0).any() and (bf.packed_rev < 0).any()
    gen = torch.Generator(device=card).manual_seed(heads * 100 + dim)
    el = torch.randn(n_src, heads, device=card, generator=gen)
    er = torch.randn(n_dst, heads, device=card, generator=gen)
    z = torch.randn(n_src, heads, dim, device=card, generator=gen)
    g = torch.randn(n_dst, heads, dim, device=card, generator=gen)
    thresh = tbg.drop_thresh(drop)
    seed = torch.tensor([-7], device=card) if thresh else None
    ins = [t.clone().requires_grad_() for t in (el, er, z)]
    before = (tbg.bitgat_fwd.launches, tbg.bitgat_bwd.launches)
    out = tbg.bitgat_attention_aggregate(bf, *ins, 0.2, drop, seed)
    out.backward(g)
    assert (tbg.bitgat_fwd.launches, tbg.bitgat_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    ref, l = tbg.bitgat_fwd_plain(bf.packed, el, er, z, n_dst, 0.2, thresh,
                                  seed)
    linv, rho = tbg.backward_scales(g, ref, l, thresh)
    grads = tbg.bitgat_bwd_plain(bf.packed_rev, el, er, z, g, linv, rho,
                                 n_dst, 0.2, thresh, seed)
    torch.testing.assert_close(out.detach(), ref, rtol=RTOL, atol=ATOL)
    for got, want in zip((t.grad for t in ins), grads):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_bitgat_kernel_zero_in_degree(card):
    """dst rows with no in-edge: exactly 0 and finite gradients."""
    row, col, n_src, n_dst = _simple_coo()
    keep = col < n_dst - 100
    bf = tbm.build_bit_format_device(row[keep], col[keep], n_src, n_dst,
                                     device=card)
    z = torch.randn(n_src, 2, 8, device=card, requires_grad=True)
    el = torch.randn(n_src, 2, device=card, requires_grad=True)
    er = torch.randn(n_dst, 2, device=card, requires_grad=True)
    out = tbg.bitgat_attention_aggregate(bf, el, er, z, 0.2, 0.6, 5)
    out.sum().backward()
    assert (out[n_dst - 100:] == 0).all()
    assert all(torch.isfinite(t.grad).all() for t in (el, er, z))


def test_gatconv_kernels_match_edge_chain(card, monkeypatch):
    """A GATConv step through K5 equals the edge chain on the card."""
    row, col, n, _ = _simple_coo()
    g = dgt.graph((row, col), num_nodes=n)
    g.unit().create_bitmask_format(on_device=True)
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    conv = dgt.nn.GATConv(24, 32, 4, residual=True,
                          generator=torch.Generator(device=card)
                          .manual_seed(0))
    x = torch.randn(n, 24, device=card,
                    generator=torch.Generator(device=card).manual_seed(1),
                    requires_grad=True)

    def step():
        conv.zero_grad()
        x.grad = None
        out = conv(g, x)
        out.square().mean().backward()
        return [out.detach(), x.grad.clone()] + [
            p.grad.clone() for p in conv.parameters()]

    before = tbg.bitgat_fwd.launches
    kern = step()
    assert tbg.bitgat_fwd.launches == before + 1
    monkeypatch.setitem(config._FLAGS, "use_kernels", False)
    chain = step()
    torch.testing.assert_close(kern[0], chain[0], rtol=RTOL, atol=ATOL)
    for a, b in zip(kern[1:], chain[1:]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)
