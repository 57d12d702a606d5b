"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  These tests need a GPU and skip without one; they import
neither JAX nor the JAX package, so they run on a machine that has only
PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance rtol 1e-4 / atol 1e-3: f32 sums in another order, and K1's
atomics (K5's, for the gradient of er, and K3's and K6's reduce's
shared-memory adds) add in an order that changes from run to run.  The
row walk (K4's SpMM, K6's dx) sums each row in slot order, the SDDMM walk
forms each dot in one lane order and K2 sums a row's bits in one list
order; their checks take dyadic inputs and ask for equality."""
import math

import numpy as np
import pytest
import torch

import dgl_tpu_torch as dgt
import dgl_tpu_torch.ops.kernels.bitdot as tbd
import dgl_tpu_torch.ops.kernels.bitgat as tbg
import dgl_tpu_torch.ops.kernels.bitmm as tbm
import dgl_tpu_torch.ops.kernels.gat_fused as tgf
import dgl_tpu_torch.ops.kernels.int8mm as tgi8
import dgl_tpu_torch.ops.kernels.spmm as tsp
import dgl_tpu_torch.ops.kernels.tiled_spmm as tts
from dgl_tpu_torch.ops import edgeflat
from dgl_tpu_torch.parallel import bitgat_spmd as tgs
from dgl_tpu_torch.parallel import bitspmd as tbs
from dgl_tpu_torch.parallel import comm
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


def _tiled(card, tile=256, cap=128):
    """The multigraph above in the tiled format (uneven tiles, an empty
    dst tile), built on the card; the same arrays as the host builder."""
    row, col, n_src, n_dst = _coo()
    keep = (col < 2048) | (col >= 2304)         # dst tile 8 has no edge
    row, col = row[keep], col[keep]
    fwd = tts.build_tiled_format_device(row, col, n_src, n_dst, tile, cap,
                                        device=card)
    rev = tts.build_tiled_format_device(col, row, n_dst, n_src, tile, cap,
                                        device=card)
    host = tts.build_tiled_format(row, col, n_src, n_dst, tile, cap,
                                  device="cpu")
    for name in ("src_local", "dst_local", "eid", "valid", "src_tile",
                 "dst_tile", "dst_ptr", "covered_mask"):
        torch.testing.assert_close(getattr(fwd, name).cpu(),
                                   getattr(host, name), rtol=0, atol=0)
    assert fwd.covered_mask is not None
    return fwd, rev, torch.as_tensor(row, device=card), \
        torch.as_tensor(col, device=card)


@pytest.mark.parametrize("f", [16, 41, 128])
@pytest.mark.parametrize("weights", ["none", "edge", "slot"])
def test_tiled_spmm_kernel_matches_plain(card, f, weights):
    """K3 forward and backward (the three autograd functions) against the
    plain version on the same formats."""
    fwd, rev, row, col = _tiled(card)
    gen = torch.Generator(device=card).manual_seed(f)
    x = torch.randn(fwd.num_src, f, device=card, generator=gen,
                    requires_grad=True)
    ew = torch.rand(row.shape[0], device=card, generator=gen) + 0.5
    ew.requires_grad_(weights == "edge")
    dz = torch.randn(fwd.num_dst, f, device=card, generator=gen)
    before = tts.tiled_spmm.launches
    if weights == "none":
        out = tsp.spmm_tiled_copy(fwd, rev, x)
        w_f = w_r = None
    elif weights == "edge":
        out = tsp.spmm_tiled_mul(fwd, rev, row, col, x, ew)
        w_f = tts.slot_edge_weights(fwd, ew.detach())
        w_r = tts.slot_edge_weights(rev, ew.detach())
    else:
        w_f = tts.slot_edge_weights(fwd, ew.detach())
        w_r = tts.slot_edge_weights(rev, ew.detach())
        out = tsp.spmm_tiled_static(fwd, rev, w_f, w_r, x)
    out.backward(dz)
    torch.cuda.synchronize()
    assert tts.tiled_spmm.launches == before + 2
    torch.testing.assert_close(out.detach(),
                               tts.tiled_spmm_plain(fwd, x.detach(), w_f),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(x.grad, tts.tiled_spmm_plain(rev, dz, w_r),
                               rtol=RTOL, atol=ATOL)
    if weights == "edge":
        want = (x.detach()[row] * dz[col]).sum(-1)
        torch.testing.assert_close(ew.grad, want, rtol=RTOL, atol=ATOL)


ROW_WALK_SHAPES = [(4, 32), (1, 41), (8, 8), (2, 64)]


def _row_walk_case(card, heads, fh, seed):
    """A format with a dst hub and a src hub of degree 12,000, rows with no
    slot on both sides and a dst tile with no bucket; x (or z) and w on
    dyadic grids, on which every f32 sum is exact in any order (degree
    12,000 times 1 at a step of 2^-8 stays under 2^24)."""
    row, col, n_src, n_dst = _coo()
    # dst tile 8 and src rows 4,000-4,049 have no edge
    keep = ((col < 2048) | (col >= 2304)) & ((row < 4000) | (row >= 4050))
    row = np.r_[row[keep], np.full(12_000, 17), np.arange(12_000) % 4000]
    col = np.r_[col[keep], np.arange(12_000) % 2048, np.full(12_000, 5)]
    fwd = tts.build_tiled_format_device(row, col, n_src, n_dst, 256, 128,
                                        device=card).with_src_first()
    gen = torch.Generator(device=card).manual_seed(seed)

    def grid(*shape, low):
        return torch.randint(low, 17, shape, device=card,
                             generator=gen).float() / 16

    y = {"dst": grid(n_src, heads, fh, low=-16),
         "src": grid(n_dst, heads, fh, low=-16)}
    w = edgeflat._w_slot_from_flat(fwd, grid(len(row) * heads, low=0), heads)
    return fwd, y, w


@pytest.mark.parametrize("heads,fh", ROW_WALK_SHAPES)
def test_row_walk_matches_plain(card, heads, fh):
    """The row walk (K4's SpMM by dst, K6's dx by src) equals the plain
    versions exactly, hub rows, rows with no slot and the dst tile with no
    bucket included."""
    fwd, y, w = _row_walk_case(card, heads, fh, heads * 100 + fh)
    for side in ("dst", "src"):
        v = fwd.row_view(side)
        deg = (v.ptr[1:] - v.ptr[:-1])
        assert int(deg.max()) >= 12_000 and int(deg.min()) == 0
    before = (tts.tiled_spmm_multihead.launches, tgf.src_aggregate.launches)
    num = tts.tiled_spmm_multihead(fwd, y["dst"], w, heads, fh)
    dx = tgf.src_aggregate(fwd, y["src"], w)
    torch.cuda.synchronize()
    assert (tts.tiled_spmm_multihead.launches,
            tgf.src_aggregate.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(num, tts.tiled_spmm_multihead_plain(fwd, y["dst"], w))
    assert torch.equal(dx, tgf.src_aggregate_plain(fwd, y["src"], w))
    assert (num[2048:2304] == 0).all()


def test_row_walk_is_deterministic(card):
    """No row is split, so two launches on inputs off any grid give the
    same bits at every row."""
    fwd, _, w = _row_walk_case(card, 4, 32, 1)
    gen = torch.Generator(device=card).manual_seed(2)
    x = torch.randn(fwd.num_src, 4, 32, device=card, generator=gen)
    z = torch.randn(fwd.num_dst, 4, 32, device=card, generator=gen)
    w = w * torch.rand(w.shape, device=card, generator=gen)
    runs = [(tts.tiled_spmm_multihead(fwd, x, w, 4, 32),
             tgf.src_aggregate(fwd, z, w)) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("heads,fh", ROW_WALK_SHAPES)
def test_row_walk_reads_weights_through_strides(card, heads, fh):
    """The kernel reads the (B, H, C) weights through their strides: in
    place, as a (B, H, C) view of slot-major memory (what the wrappers
    hand it) and as a view of a wider tensor, it gives the plain
    version's bits."""
    fwd, y, w = _row_walk_case(card, heads, fh, heads * 100 + fh + 7)
    slot_major = torch.empty(w.shape[0], w.shape[2], w.shape[1],
                             device=card).transpose(1, 2)
    slot_major.copy_(w)
    wide = torch.zeros(w.shape[0], w.shape[1] + 1, w.shape[2] * 2,
                       device=card)[:, 1:, ::2]
    wide.copy_(w)
    assert len({w.stride(), slot_major.stride(), wide.stride()}) == 3
    want = {"dst": tts.tiled_spmm_multihead_plain(fwd, y["dst"], w),
            "src": tgf.src_aggregate_plain(fwd, y["src"], w)}
    for side in ("dst", "src"):
        for wv in (w, slot_major, wide):
            out = torch.empty_like(want[side])
            tts.row_walk(fwd.row_view(side), fwd.cap, y[side], wv, out)
            assert torch.equal(out, want[side])


def test_row_walk_wrappers_never_take_plain_on_cuda(card, monkeypatch):
    """On CUDA tensors K4's SpMM and the src-side aggregation launch the
    row walk: a plain version that is reached raises."""
    fwd, y, w = _row_walk_case(card, 1, 41, 3)
    for module, name in ((tts, "tiled_spmm_multihead_plain"),
                         (tgf, "src_aggregate_plain")):
        def refuse(*args, _name=name, **kwargs):
            raise AssertionError(f"{_name} reached with CUDA tensors")
        monkeypatch.setattr(module, name, refuse)
    before = (tts.tiled_spmm_multihead.launches, tgf.src_aggregate.launches)
    tts.tiled_spmm_multihead(fwd, y["dst"], w, 1, 41)
    tgf.src_aggregate(fwd, y["src"], w)
    torch.cuda.synchronize()
    assert (tts.tiled_spmm_multihead.launches,
            tgf.src_aggregate.launches) == (before[0] + 1, before[1] + 1)


# the main path's widths, and rows wider than one launch of the walk
# holds (two groups of 4 heads; groups of 2 and 1; two column chunks)
SDDMM_SHAPES = [(4, 32), (1, 41), (8, 8), (2, 64), (8, 256), (3, 300),
                (1, 2048)]


@pytest.mark.parametrize("heads,fh", SDDMM_SHAPES)
def test_sddmm_walk_matches_plain(card, heads, fh):
    """K4's SDDMM, the dot-product walk by dst, equals its plain version
    exactly on dyadic inputs (each dot at most 2,048 products of multiples
    of 1/16, exact in f32), the dst hub of degree 12,000, rows with no
    slot and the dst tile with no bucket included, every padded slot 0."""
    fwd, y, _ = _row_walk_case(card, heads, fh, heads * 100 + fh + 11)
    x, z = y["dst"], y["src"]         # (num_src, H, Fh), (num_dst, H, Fh)
    deg = fwd.row_view("dst").ptr.diff()
    assert int(deg.max()) >= 12_000 and int(deg.min()) == 0
    before = tts.tiled_sddmm_dot_multihead.launches
    e = tts.tiled_sddmm_dot_multihead(fwd, x, z, heads, fh)
    torch.cuda.synchronize()
    assert tts.tiled_sddmm_dot_multihead.launches == before + 1
    want = tts.tiled_sddmm_dot_multihead_plain(fwd, x, z)
    assert torch.equal(e, want)
    pad = fwd.valid.reshape(fwd.num_buckets, 1, fwd.cap) == 0
    assert pad.any() and (e.masked_select(pad) == 0).all()


@pytest.mark.parametrize("heads,fh", [(4, 32), (1, 2048)])
def test_sddmm_walk_is_deterministic(card, heads, fh):
    """No row is split, each dot is reduced in one lane order and the
    column chunks' parts are added in one order, so two calls on inputs
    off any grid give the same bits."""
    fwd, _, _ = _row_walk_case(card, heads, fh, 5)
    gen = torch.Generator(device=card).manual_seed(6)
    x = torch.randn(fwd.num_src, heads, fh, device=card, generator=gen)
    z = torch.randn(fwd.num_dst, heads, fh, device=card, generator=gen)
    a = tts.tiled_sddmm_dot_multihead(fwd, x, z, heads, fh)
    b = tts.tiled_sddmm_dot_multihead(fwd, x, z, heads, fh)
    assert torch.equal(a, b)
    torch.testing.assert_close(
        a, tts.tiled_sddmm_dot_multihead_plain(fwd, x, z), rtol=RTOL,
        atol=ATOL * fh / 32)


def test_sddmm_probe_layouts_on_card(card):
    """The SDDMM probe's write layouts (its edits of ``csrc/row_agg.cu``,
    the bucket-order walk and the passes of ``tools/sddmm_probe.cu``)
    give the plain version's bits, and its CPU check holds."""
    from dgl_tpu_torch.tools import perf_sddmm_walk as tsw
    assert tsw.tiny_check() == tsw.LAYOUTS
    walks, own = tsw.build_probe()
    for heads, fh in ((4, 32), (1, 41)):
        fwd, y, _ = _row_walk_case(card, heads, fh, 9)
        hp = -(-fh // 4) * 4
        calls = tsw.layout_calls(fwd, tts._vec4_rows(y["dst"], hp),
                                 tts._vec4_rows(y["src"], hp), walks, own)
        want = tts.tiled_sddmm_dot_multihead_plain(fwd, y["dst"], y["src"])
        for layout in (*tsw.LAYOUTS, "direct_memset"):
            assert torch.equal(calls[layout](), want), layout


def test_sddmm_and_k2_never_take_plain_on_cuda(card, monkeypatch):
    """On CUDA tensors K4's SDDMM and K2 launch their kernels: a plain
    version that is reached raises."""
    fwd, y, _ = _row_walk_case(card, 1, 41, 3)
    bf, x = _k2_case(card, 128)
    for module, name in ((tts, "tiled_sddmm_dot_multihead_plain"),
                         (tbm, "bit_matmul_plain")):
        def refuse(*args, _name=name, **kwargs):
            raise AssertionError(f"{_name} reached with CUDA tensors")
        monkeypatch.setattr(module, name, refuse)
    before = (tts.tiled_sddmm_dot_multihead.launches, tbm.bit_matmul.launches)
    tts.tiled_sddmm_dot_multihead(fwd, y["dst"], y["src"], 1, 41)
    tbm.bit_matmul(bf.packed, x, bf.num_dst)
    torch.cuda.synchronize()
    assert (tts.tiled_sddmm_dot_multihead.launches,
            tbm.bit_matmul.launches) == (before[0] + 1, before[1] + 1)


K2_HUB, K2_EMPTY = 5, 7


def _k2_case(card, f):
    """The bits of a 16,000-src x 4,000-dst graph (n32 = 512, two steps a
    row; srcs in bit plane 31), a dst hub with an edge from each of 12,500
    srcs and a dst with no edge; x on a grid of 1/16 in [-1, 1], on which
    every f32 sum of the hub's 12,500 rows is exact."""
    rng = np.random.default_rng(f)
    n_src, n_dst = 16_000, 4_000
    row = np.r_[rng.integers(0, n_src, 80_000), np.arange(12_500),
                rng.integers(31 * 512, n_src, 500)]
    col = np.r_[rng.integers(0, n_dst, 80_000), np.full(12_500, K2_HUB),
                rng.integers(0, n_dst, 500)]
    keep = col != K2_EMPTY
    bf = tbm.build_bit_format_device(row[keep], col[keep], n_src, n_dst,
                                     device=card)
    gen = torch.Generator(device=card).manual_seed(f)
    x = torch.randint(-16, 17, (n_src, f), device=card,
                      generator=gen).float() / 16
    return bf, x


@pytest.mark.parametrize("f", [97, 128, 256])
def test_k2_matches_plain(card, f):
    """K2, the bit-list walk, equals its plain version exactly: the hub
    row of 12,500 bits, the row with none (0) and bit 31 included."""
    bf, x = _k2_case(card, f)
    assert (bf.packed < 0).any()
    before = tbm.bit_matmul.launches
    got = tbm.bit_matmul(bf.packed, x, bf.num_dst)
    torch.cuda.synchronize()
    assert tbm.bit_matmul.launches == before + 1
    assert torch.equal(got, tbm.bit_matmul_plain(bf.packed, x, bf.num_dst))
    assert (got[K2_EMPTY] == 0).all() and (got[K2_HUB] != 0).any()


def test_k2_is_deterministic(card):
    """A row's bits are summed by one warp in one list order: two launches
    on inputs off any grid give the same bits."""
    bf, _ = _k2_case(card, 160)
    gen = torch.Generator(device=card).manual_seed(7)
    x = torch.randn(bf.num_src, 160, device=card, generator=gen)
    a = tbm.bit_matmul(bf.packed, x, bf.num_dst)
    assert torch.equal(a, tbm.bit_matmul(bf.packed, x, bf.num_dst))
    torch.testing.assert_close(
        a, tbm.bit_matmul_plain(bf.packed, x, bf.num_dst), rtol=RTOL,
        atol=ATOL)


@pytest.mark.parametrize("heads,fh", [(4, 32), (1, 41), (8, 16), (3, 5)])
def test_tiled_multihead_kernels_match_plain(card, heads, fh):
    """K4's SpMM and SDDMM against their plain versions; the SDDMM writes
    0 at every padded slot."""
    fwd, rev, row, col = _tiled(card)
    gen = torch.Generator(device=card).manual_seed(heads * 100 + fh)
    x = torch.randn(fwd.num_src, heads, fh, device=card, generator=gen)
    z = torch.randn(fwd.num_dst, heads, fh, device=card, generator=gen)
    w = torch.rand(row.shape[0] * heads, device=card, generator=gen)
    w_slot = edgeflat._w_slot_from_flat(fwd, w, heads)
    before = (tts.tiled_spmm_multihead.launches,
              tts.tiled_sddmm_dot_multihead.launches)
    out = tts.tiled_spmm_multihead(fwd, x, w_slot, heads, fh)
    e = tts.tiled_sddmm_dot_multihead(fwd, x, z, heads, fh)
    torch.cuda.synchronize()
    assert (tts.tiled_spmm_multihead.launches,
            tts.tiled_sddmm_dot_multihead.launches) == \
        (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(
        out, tts.tiled_spmm_multihead_plain(fwd, x, w_slot), rtol=RTOL,
        atol=ATOL)
    torch.testing.assert_close(
        e, tts.tiled_sddmm_dot_multihead_plain(fwd, x, z), rtol=RTOL,
        atol=ATOL)
    pad = fwd.valid.reshape(fwd.num_buckets, 1, fwd.cap) == 0
    assert (e.masked_select(pad) == 0).all()


def test_spmm_mul_flat_kernels_match_gather(card, monkeypatch):
    """spmm_mul_flat and its gradients through K4 against the per-head
    gather path on the card."""
    fwd, rev, row, col = _tiled(card)
    g = dgt.graph((row, col), num_nodes=max(fwd.num_src, fwd.num_dst))
    unit = g.unit()
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    gen = torch.Generator(device=card).manual_seed(5)
    x = torch.randn(unit.num_src, 4, 8, device=card, generator=gen)
    w = torch.rand(unit.num_edges * 4, device=card, generator=gen)
    dz = torch.randn(unit.num_dst, 4, 8, device=card, generator=gen)

    def run():
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = edgeflat.spmm_mul_flat(unit, xs, ws, 4)
        out.backward(dz)
        return out.detach(), xs.grad, ws.grad

    want = run()
    unit.tiled_format(256, 128)
    before = tts.tiled_spmm_multihead.launches
    got = run()
    assert tts.tiled_spmm_multihead.launches == before + 2
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_graphconv_tiled_matches_gather_path(card, monkeypatch):
    """GraphConv steps through K3, plain and with a learnable edge weight,
    equal the gather path on the card."""
    row, col, n, _ = _coo(n_src=8100, n_dst=8100)
    g = dgt.add_self_loop(dgt.graph((row, col), num_nodes=n))
    g.create_tiled_format(tile=1024)
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    conv = dgt.nn.GraphConv(30, 8, generator=torch.Generator(device=card)
                            .manual_seed(0))
    x = torch.randn(n, 30, device=card,
                    generator=torch.Generator(device=card).manual_seed(1))
    ew = torch.rand(g.num_edges(), device=card) + 0.5

    def step(weighted):
        conv.zero_grad()
        xs = x.clone().requires_grad_()
        ws = ew.clone().requires_grad_()
        out = conv(g, xs, edge_weight=ws if weighted else None)
        out.square().mean().backward()
        return [out.detach(), conv.weight.grad.clone(), xs.grad] + (
            [ws.grad] if weighted else [])

    for weighted in (False, True):
        before = tts.tiled_spmm.launches
        kern = step(weighted)
        assert tts.tiled_spmm.launches == before + 2
        monkeypatch.setitem(config._FLAGS, "use_kernels", False)
        ref = step(weighted)
        monkeypatch.setitem(config._FLAGS, "use_kernels", True)
        torch.testing.assert_close(kern[0], ref[0], rtol=RTOL, atol=ATOL)
        for a, b in zip(kern[1:], ref[1:]):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)


def _k6_plain(fwd, el, er, x, dz, ee=None):
    """K6 forward and backward chained from the plain versions, as the
    autograd function chains the kernels: (out, del, der, dx, ds)."""
    heads, fh = x.shape[1], x.shape[2]
    p, g = tgf.gat_scores_plain(fwd, el, er, 0.2, ee)
    den = tgf.slot_reduce_plain(fwd, p, "dst").clamp_(min=tgf.DEN_EPS)
    out = tts.tiled_spmm_multihead_plain(fwd, x, p) / den.unsqueeze(-1)
    zn, rp = tgf._scales(out, dz, den)
    ds = tgf.gat_ds_plain(fwd, x, zn, rp, g)
    return (out, tgf.slot_reduce_plain(fwd, ds, "src"),
            tgf.slot_reduce_plain(fwd, ds, "dst"),
            tgf.src_aggregate_plain(fwd, zn, p), ds)


@pytest.mark.parametrize("heads,fh", [(4, 32), (1, 41), (8, 16), (3, 5)])
@pytest.mark.parametrize("bias", [False, True])
def test_gat_fused_kernels_match_plain(card, heads, fh, bias):
    """Each K6 kernel against its plain version (both sides of the slot
    reduce), then the forward and backward of ``egat_attention_aggregate``
    / ``gat_attention_aggregate`` against the plain chain; rows of the dst
    tile without a bucket are 0."""
    fwd, _, row, _ = _tiled(card)
    fwd = fwd.with_src_first()
    gen = torch.Generator(device=card).manual_seed(heads * 100 + fh)

    def randn(*shape):
        return torch.randn(*shape, device=card, generator=gen)

    el, er = randn(fwd.num_src, heads), randn(fwd.num_dst, heads)
    x, dz = randn(fwd.num_src, heads, fh), randn(fwd.num_dst, heads, fh)
    zn, rp = randn(fwd.num_dst, heads, fh), randn(fwd.num_dst, heads)
    ee = (edgeflat._w_slot_from_flat(fwd, randn(row.shape[0] * heads), heads)
          if bias else None)
    before = [k.launches for k in (tgf.gat_scores, tgf.slot_reduce,
                                   tgf.gat_ds, tgf.src_aggregate)]
    p, g = tgf.gat_scores(fwd, el, er, 0.2, ee)
    got = [p, g, tgf.slot_reduce(fwd, p, "dst"),
           tgf.slot_reduce(fwd, g, "src"), tgf.gat_ds(fwd, x, zn, rp, g),
           tgf.src_aggregate(fwd, zn, p)]
    torch.cuda.synchronize()
    assert [k.launches for k in (tgf.gat_scores, tgf.slot_reduce,
                                 tgf.gat_ds, tgf.src_aggregate)] == [
        before[0] + 1, before[1] + 2, before[2] + 1, before[3] + 1]
    want = list(tgf.gat_scores_plain(fwd, el, er, 0.2, ee)) + [
        tgf.slot_reduce_plain(fwd, p, "dst"),
        tgf.slot_reduce_plain(fwd, g, "src"),
        tgf.gat_ds_plain(fwd, x, zn, rp, g),
        tgf.src_aggregate_plain(fwd, zn, p)]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)

    ins = [t.clone().requires_grad_() for t in (el, er, x)]
    if bias:
        ee_in = ee.clone().requires_grad_()
        out = tgf.egat_attention_aggregate(fwd, ins[0], ins[1], ee_in, ins[2],
                                           heads, fh, 0.2)
    else:
        out = tgf.gat_attention_aggregate(fwd, *ins, heads, fh, 0.2)
    out.backward(dz)
    ref = _k6_plain(fwd, el, er, x, dz, ee)
    torch.testing.assert_close(out.detach(), ref[0], rtol=RTOL, atol=ATOL)
    for a, b in zip([t.grad for t in ins], ref[1:4]):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    if bias:
        torch.testing.assert_close(ee_in.grad, ref[4], rtol=RTOL, atol=ATOL)
    assert fwd.covered_mask is not None
    assert (out.detach()[fwd.covered_mask[:fwd.num_dst] == 0] == 0).all()


@pytest.mark.parametrize("heads,d", [(4, 32), (1, 41), (8, 16)])
def test_dot_gat_kernels_match_plain(card, heads, d):
    """K8 forward and backward (K4's SDDMM and SpMM, K6's kernels)
    against the same chain of plain versions."""
    fwd, _, _, _ = _tiled(card)
    fwd = fwd.with_src_first()
    gen = torch.Generator(device=card).manual_seed(heads * 10 + d)
    q = torch.randn(fwd.num_dst, heads, d, device=card, generator=gen)
    k, x = (torch.randn(fwd.num_src, heads, d, device=card, generator=gen)
            for _ in range(2))
    dz = torch.randn(fwd.num_dst, heads, d, device=card, generator=gen)
    ins = [t.clone().requires_grad_() for t in (q, k, x)]
    before = tts.tiled_sddmm_dot_multihead.launches
    out = tgf.dot_gat_attention_aggregate(fwd, *ins, heads, d, d)
    out.backward(dz)
    assert tts.tiled_sddmm_dot_multihead.launches == before + 1
    scale = d ** -0.5
    p = tts.tiled_sddmm_dot_multihead_plain(fwd, k, q) * scale
    p = torch.exp(p.clamp(-tgf.CLIP, tgf.CLIP)) * fwd.valid.view(
        fwd.num_buckets, 1, fwd.cap)
    den = tgf.slot_reduce_plain(fwd, p, "dst").clamp_(min=tgf.DEN_EPS)
    ref = tts.tiled_spmm_multihead_plain(fwd, x, p) / den.unsqueeze(-1)
    zn, rp = tgf._scales(ref, dz, den)
    ds = tgf.gat_ds_plain(fwd, x, zn, rp, p) * scale
    want = (tts.tiled_spmm_multihead_plain(fwd, k, ds),
            tgf.src_aggregate_plain(fwd, q, ds),
            tgf.src_aggregate_plain(fwd, zn, p))
    torch.testing.assert_close(out.detach(), ref, rtol=RTOL, atol=ATOL)
    for a, b in zip([t.grad for t in ins], want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_attention_convs_kernels_match_gather(card, monkeypatch):
    """A GATConv step on K6 (no attention dropout) equals edgeflat's gather
    path, and a DotGatConv step on K8 equals its gather path, on the
    card."""
    row, col, n, _ = _coo(n_src=8100, n_dst=8100)
    g = dgt.graph((row, col), num_nodes=n)
    g.create_tiled_format(tile=1024)
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    x = torch.randn(n, 24, device=card,
                    generator=torch.Generator(device=card).manual_seed(1))
    gen = torch.Generator(device=card).manual_seed(0)
    for conv, counter in (
            (dgt.nn.GATConv(24, 32, 4, residual=True, generator=gen),
             tgf.gat_scores),
            (dgt.nn.DotGatConv(24, 32, 4, generator=gen),
             tts.tiled_sddmm_dot_multihead)):
        def step():
            conv.zero_grad()
            xs = x.clone().requires_grad_()
            out = conv(g, xs)
            out.square().mean().backward()
            return [out.detach(), xs.grad] + [
                p.grad.clone() for p in conv.parameters()]

        before = counter.launches
        kern = step()
        assert counter.launches == before + 1
        monkeypatch.setitem(config._FLAGS, "use_kernels", False)
        ref = step()
        monkeypatch.setitem(config._FLAGS, "use_kernels", True)
        torch.testing.assert_close(kern[0], ref[0], rtol=RTOL, atol=ATOL)
        for a, b in zip(kern[1:], ref[1:]):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)


def _vattn_inputs(card, fwd, heads, dim, fe, bias, seed):
    """U, V, attn, ds and, with fe > 0, slot edge features and wf (the
    bias row last with ``bias``) on the format ``fwd``.  U, V, attn and wf
    are multiples of 1/16 and the edge features in {-1, 0, 1}, so raw is
    exact in f32 in any order and the kernels and the plain versions take
    the same side of lrelu's kink."""
    gen = torch.Generator(device=card).manual_seed(seed)

    def exact(*shape, top=8):
        return torch.randint(-top, top + 1, shape, device=card,
                             generator=gen).float() / 16

    b, cap = fwd.num_buckets, fwd.cap
    U = exact(fwd.num_src, heads, dim, top=16)
    V = exact(fwd.num_dst, heads, dim, top=16)
    attn = exact(heads, dim)
    ds = torch.randn(b, heads, cap, device=card, generator=gen) * \
        fwd.valid.view(b, 1, cap)
    ef = wf = None
    if fe:
        ef = torch.randint(-1, 2, (b, cap, fe), device=card,
                           generator=gen).float() * fwd.valid.view(b, cap, 1)
        wf = exact(fe + int(bias), heads * dim)
    return U, V, attn, ds, ef, wf


VATTN_EDGES = [(0, False), (5, False), (12, True), (16, True)]


@pytest.mark.parametrize("heads,dim", [(8, 8), (1, 41), (4, 32), (3, 5)])
@pytest.mark.parametrize("fe,bias", VATTN_EDGES)
def test_vattn_kernels_match_plain(card, heads, dim, fe, bias):
    """Each K9 / K11 v2 kernel (scores, slot gradient, node gradient on
    both sides) against its plain version, without and with the edge term
    (Fe = 5, and Fe = 12 and 16 plus the bias row); then the forward and
    backward of the autograd function against the plain chain."""
    fwd, _, _, _ = _tiled(card)
    fwd = fwd.with_src_first()
    slope = 0.01 if fe else 0.2
    U, V, attn, ds, ef, wf = _vattn_inputs(card, fwd, heads, dim, fe, bias,
                                           heads * 100 + dim + fe)
    counters = (tgf.vattn_scores, tgf.vattn_slot_grad, tgf.vattn_node_grad)
    before = [k.launches for k in counters]
    got = [tgf.vattn_scores(fwd, U, V, attn, slope, ef, wf)]
    got += [a for a in tgf.vattn_slot_grad(fwd, U, V, attn, ds, slope, ef,
                                           wf) if a is not None]
    got += [tgf.vattn_node_grad(fwd, U, V, attn, ds, slope, side, ef, wf)
            for side in ("dst", "src")]
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [1, 1, 2]
    want = [tgf.vattn_scores_plain(fwd, U, V, attn, slope, ef, wf)]
    want += [a for a in tgf.vattn_slot_grad_plain(fwd, U, V, attn, ds, slope,
                                                  ef, wf) if a is not None]
    want += [tgf.vattn_node_grad_plain(fwd, U, V, attn, ds, slope, side, ef,
                                       wf) for side in ("dst", "src")]
    assert len(got) == len(want) == (6 if fe else 4)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    pad = fwd.valid.reshape(fwd.num_buckets, 1, fwd.cap) == 0
    assert (got[0].masked_select(pad) == 0).all()
    if fe:
        assert (got[2].masked_select(pad.transpose(1, 2)) == 0).all()

    x = torch.randn_like(U)
    dz = torch.randn(fwd.num_dst, heads, dim, device=card)
    ins = [t.clone().requires_grad_() for t in (U, V, attn, x)]
    edge = [t.clone().requires_grad_() for t in (ef, wf)] if fe else []
    if fe:
        out = tgf.egatconv_attention_aggregate_v2(
            fwd, ins[0], ins[1], edge[0], edge[1], ins[2], ins[3], heads,
            dim, dim, slope)
    else:
        out = tgf.gatv2_attention_aggregate(fwd, ins[0], ins[1], ins[3],
                                            ins[2], heads, dim, dim, slope)
    out.backward(dz)
    p = tgf.vattn_scores_plain(fwd, U, V, attn, slope, ef, wf)
    den = tgf.slot_reduce_plain(fwd, p, "dst").clamp_(min=tgf.DEN_EPS)
    ref = tts.tiled_spmm_multihead_plain(fwd, x, p) / den.unsqueeze(-1)
    zn, rp = tgf._scales(ref, dz, den)
    g = tgf.gat_ds_plain(fwd, x, zn, rp, p)
    da, d_ef, dwf = tgf.vattn_slot_grad_plain(fwd, U, V, attn, g, slope, ef,
                                              wf)
    grads = [tgf.vattn_node_grad_plain(fwd, U, V, attn, g, slope, "src", ef,
                                       wf),
             tgf.vattn_node_grad_plain(fwd, U, V, attn, g, slope, "dst", ef,
                                       wf),
             da, tgf.src_aggregate_plain(fwd, zn, p)]
    torch.testing.assert_close(out.detach(), ref, rtol=RTOL, atol=ATOL)
    for a, b in zip([t.grad for t in ins + edge], grads + [d_ef, dwf]):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_vattn_wrappers_never_take_plain_on_cuda(card, monkeypatch):
    """On CUDA tensors each wrapper launches its kernel: a plain version
    that is reached raises."""
    fwd, _, _, _ = _tiled(card)
    fwd = fwd.with_src_first()
    for name in ("vattn_scores_plain", "vattn_slot_grad_plain",
                 "vattn_node_grad_plain"):
        def refuse(*args, _name=name, **kwargs):
            raise AssertionError(f"{_name} reached with CUDA tensors")
        monkeypatch.setattr(tgf, name, refuse)
    for fe, bias in VATTN_EDGES[:2]:
        U, V, attn, ds, ef, wf = _vattn_inputs(card, fwd, 4, 8, fe, bias, 7)
        before = tgf.vattn_scores.launches
        tgf.vattn_scores(fwd, U, V, attn, 0.2, ef, wf)
        tgf.vattn_slot_grad(fwd, U, V, attn, ds, 0.2, ef, wf)
        tgf.vattn_node_grad(fwd, U, V, attn, ds, 0.2, "src", ef, wf)
        torch.cuda.synchronize()
        assert tgf.vattn_scores.launches == before + 1


def test_vector_attention_convs_kernels_match_reference(card, monkeypatch):
    """A GATv2Conv step on K9 equals its edge chain, and an EGATConv step
    on K11 v2 (the fused route) equals its flat route, on the card."""
    row, col, n, _ = _coo(n_src=8100, n_dst=8100)
    g = dgt.graph((row, col), num_nodes=n)
    g.create_tiled_format(tile=1024)
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    x = torch.randn(n, 24, device=card,
                    generator=torch.Generator(device=card).manual_seed(1))
    ef = torch.randn(len(row), 16, device=card,
                     generator=torch.Generator(device=card).manual_seed(2))
    ef_slot = dgt.nn.EGATConv.slot_edge_feats(g, ef)
    gen = torch.Generator(device=card).manual_seed(0)
    gatv2 = dgt.nn.GATv2Conv(24, 8, 8, residual=True, generator=gen)
    egat = dgt.nn.EGATConv(24, 16, 32, 32, 4, generator=gen)

    def step(conv, **kw):
        conv.zero_grad()
        xs = x.clone().requires_grad_()
        out = conv(g, xs, **kw)
        out = out[0] if isinstance(out, tuple) else out
        out.square().mean().backward()
        return [out.detach(), xs.grad] + [
            p.grad.clone() for p in conv.parameters()]

    before = tgf.vattn_scores.launches
    kern = step(gatv2)
    monkeypatch.setitem(config._FLAGS, "use_kernels", False)
    ref = step(gatv2)
    monkeypatch.setitem(config._FLAGS, "use_kernels", True)
    kern_e = step(egat, efeats=ef, compute_edge_feats=False,
                  efeats_slot=ef_slot)
    ref_e = step(egat, efeats=ef, compute_edge_feats=False)
    assert tgf.vattn_scores.launches == before + 2
    for k, r in ((kern, ref), (kern_e, ref_e)):
        torch.testing.assert_close(k[0], r[0], rtol=RTOL, atol=ATOL)
        for a, b in zip(k[1:], r[1:]):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)


def _edgegat_inputs(card, fwd, heads, fh, fe, seed):
    """el, er, ef_slot, We, attn_e, M and x on ``fwd``.  el, er, We and
    attn_e are multiples of 1/16 and the edge features in {-1, 0, 1}, so the
    logit el + er + ef . M is exact in f32 in any order and the kernels and
    the plain versions take the same side of lrelu's kink."""
    gen = torch.Generator(device=card).manual_seed(seed)

    def exact(*shape, top=8):
        return torch.randint(-top, top + 1, shape, device=card,
                             generator=gen).float() / 16

    b, cap = fwd.num_buckets, fwd.cap
    el, er = exact(fwd.num_src, heads, top=16), exact(fwd.num_dst, heads,
                                                       top=16)
    ef = torch.randint(-1, 2, (b, cap, fe), device=card,
                       generator=gen).float() * fwd.valid.view(b, cap, 1)
    We, attn = exact(fe, heads * fh), exact(heads, fh)
    m = torch.einsum("fhd,hd->fh", We.view(fe, heads, fh), attn)
    x = torch.randn(fwd.num_src, heads, fh, device=card, generator=gen)
    return el, er, ef, We, attn, m, x


@pytest.mark.parametrize("heads,fh", [(4, 32), (1, 41), (8, 8), (3, 5)])
@pytest.mark.parametrize("fe", [16, 5])
def test_edgegat_kernels_match_plain(card, heads, fh, fe):
    """Each K10 v2 kernel (the edge scores, the slot-feature reduce with p
    and with ds, the edge ds with and without d(ef)) against its plain
    version; then the forward and backward of the autograd function
    against the plain chain."""
    fwd, _, _, _ = _tiled(card)
    fwd = fwd.with_src_first()
    el, er, ef, We, attn, m, x = _edgegat_inputs(card, fwd, heads, fh, fe,
                                                 heads * 100 + fh + fe)
    counters = (tgf.edgegat_scores, tgf.slot_feat_reduce, tgf.edgegat_ds)
    before = [k.launches for k in counters]
    p, g = tgf.edgegat_scores(fwd, el, er, ef, m, 0.2)
    s = tgf.slot_feat_reduce(fwd, p, ef)
    gen = torch.Generator(device=card).manual_seed(heads * 1000 + fh * 10
                                                   + fe)
    zn = torch.randn(fwd.num_dst, heads, fh, device=card, generator=gen)
    rp = torch.randn(fwd.num_dst, heads, device=card, generator=gen)
    zp = torch.randn(fwd.num_dst, heads, fe, device=card, generator=gen)
    ds, no_def = tgf.edgegat_ds(fwd, x, zn, rp, g, ef, zp)
    ds2, d_ef = tgf.edgegat_ds(fwd, x, zn, rp, g, ef, zp, p, m)
    q = tgf.slot_feat_reduce(fwd, ds, ef)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [1, 2, 2]
    assert no_def is None
    want_p, want_g = tgf.edgegat_scores_plain(fwd, el, er, ef, m, 0.2)
    want_ds, want_def = tgf.edgegat_ds_plain(fwd, x, zn, rp, g, ef, zp, p, m)
    for a, b in ((p, want_p), (g, want_g),
                 (s, tgf.slot_feat_reduce_plain(fwd, p, ef)),
                 (q, tgf.slot_feat_reduce_plain(fwd, ds, ef))):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    # ds is a dot of fh + fe products and rp, times g; d(ef) sums 2 H
    # products over the heads.  Their terms are large at (4, 32, 16) (p and
    # g up to e^clip) and cancel to units at some slots, where two f32
    # orders of the same sums differ by more than ATOL: each is held to
    # twice the f32 rounding of its terms' magnitudes where that exceeds
    # the standard tolerance
    mag_ds, mag_def = tgf.edgegat_ds_plain(
        fwd, x.abs(), zn.abs(), -rp.abs(), g.abs(), ef.abs(), zp.abs(),
        p.abs(), m.abs())
    bound_ds = 2 * (fh + fe + 2) * 2.0 ** -24 * mag_ds
    bound_def = (2 * (2 * heads + 1) * 2.0 ** -24 * mag_def
                 + torch.einsum("bhc,fh->bcf", bound_ds, m.abs()))
    for a, b, bound in ((ds, want_ds, bound_ds), (ds2, want_ds, bound_ds),
                        (d_ef, want_def, bound_def)):
        assert ((a - b).abs()
                <= torch.maximum(ATOL + RTOL * b.abs(), bound)).all()
    pad = fwd.valid.reshape(fwd.num_buckets, fwd.cap, 1) == 0
    assert (d_ef.masked_select(pad) == 0).all()

    dz = torch.randn(fwd.num_dst, heads, fh, device=card, generator=gen)
    ins = [t.clone().requires_grad_() for t in (el, er, ef, We, attn, x)]
    out = tgf.edgegat_attention_aggregate_v2(fwd, *ins, heads, fh, 0.2)
    out.backward(dz)
    # the same chain on the plain versions
    w3 = We.view(fe, heads, fh)
    den = tgf.slot_reduce_plain(fwd, want_p, "dst").clamp_(min=tgf.DEN_EPS)
    s_p = tgf.slot_feat_reduce_plain(fwd, want_p, ef)
    ref = (tts.tiled_spmm_multihead_plain(fwd, x, want_p)
           + torch.einsum("vhf,fhd->vhd", s_p, w3)) / den.unsqueeze(-1)
    zn, rp = tgf._scales(ref, dz, den)
    zp = torch.einsum("vhd,fhd->vhf", zn, w3)
    dsp, defp = tgf.edgegat_ds_plain(fwd, x, zn, rp, want_g, ef, zp, want_p,
                                     m)
    qp = tgf.slot_feat_reduce_plain(fwd, dsp, ef).sum(0)
    grads = [tgf.slot_reduce_plain(fwd, dsp, "src"),
             tgf.slot_reduce_plain(fwd, dsp, "dst"), defp,
             (torch.einsum("vhf,vhd->fhd", s_p, zn)
              + torch.einsum("hf,hd->fhd", qp, attn)).reshape(fe, -1),
             torch.einsum("hf,fhd->hd", qp, w3),
             tgf.src_aggregate_plain(fwd, zn, want_p)]
    torch.testing.assert_close(out.detach(), ref, rtol=RTOL, atol=ATOL)
    for t, b in zip(ins, grads):
        # dWe and d(attn_e) sum over every edge: atol of their magnitude
        torch.testing.assert_close(t.grad, b, rtol=RTOL,
                                   atol=ATOL * max(1.0, float(b.abs().max())))


def test_edgegat_wrappers_never_take_plain_on_cuda(card, monkeypatch):
    """On CUDA tensors each K10 v2 wrapper launches its kernel: a plain
    version that is reached raises."""
    fwd, _, _, _ = _tiled(card)
    fwd = fwd.with_src_first()
    for name in ("edgegat_scores_plain", "slot_feat_reduce_plain",
                 "edgegat_ds_plain"):
        def refuse(*args, _name=name, **kwargs):
            raise AssertionError(f"{_name} reached with CUDA tensors")
        monkeypatch.setattr(tgf, name, refuse)
    el, er, ef, We, attn, m, x = _edgegat_inputs(card, fwd, 4, 8, 16, 7)
    out = tgf.edgegat_attention_aggregate_v2(
        fwd, el.requires_grad_(), er, ef.requires_grad_(), We, attn, x, 4, 8,
        0.2)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert ef.grad is not None and el.grad is not None


def test_slot_reduce_any_head_count(card):
    """The slot reduce at 64 heads and tile 1024, whose (tile, H) f32 sums
    exceed a block's shared memory, walks the heads in groups, one launch
    each, and equals its plain version on both sides."""
    row, col, n_src, n_dst = _coo()
    fwd = tts.build_tiled_format_device(row, col, n_src, n_dst, 1024, 128,
                                        device=card).with_src_first()
    assert 1024 * 64 * 4 > tts._SMEM_PER_BLOCK
    vals = torch.randn(fwd.num_buckets, 64, fwd.cap, device=card) * \
        fwd.valid.view(fwd.num_buckets, 1, fwd.cap)
    for side in ("dst", "src"):
        before = tgf.slot_reduce.launches
        got = tgf.slot_reduce(fwd, vals, side)
        torch.cuda.synchronize()
        assert tgf.slot_reduce.launches - before == 2
        torch.testing.assert_close(got, tgf.slot_reduce_plain(fwd, vals, side),
                                   rtol=RTOL, atol=ATOL)


def test_egatconv_above_the_edge_row_cap(card, monkeypatch):
    """EGATConv with 32 edge features and the bias row (33 rows, above
    MAX_FE_ROWS) and ``efeats_slot`` does not raise: it takes the flat
    route, and equals it (whose atomics add in no fixed order)."""
    row, col, n, _ = _coo(n_src=8100, n_dst=8100)
    g = dgt.graph((row, col), num_nodes=n)
    g.create_tiled_format(tile=1024)
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    gen = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(n, 24, device=card, generator=gen)
    ef = torch.randn(len(row), 32, device=card, generator=gen)
    conv = dgt.nn.EGATConv(24, 32, 16, 16, 4, bias=True, generator=gen)
    before = tgf.vattn_scores.launches
    res = []
    for kw in ({"efeats_slot": dgt.nn.EGATConv.slot_edge_feats(g, ef)}, {}):
        conv.zero_grad()
        h, _ = conv(g, x, ef, compute_edge_feats=False, **kw)
        h.square().mean().backward()
        res.append([h.detach()] + [p.grad.clone() for p in conv.parameters()])
    torch.cuda.synchronize()
    assert tgf.vattn_scores.launches == before
    torch.testing.assert_close(res[0][0], res[1][0], rtol=RTOL, atol=ATOL)
    for a, b in zip(res[0][1:], res[1][1:]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)


def test_edgegatconv_kernels_match_flat_route(card, monkeypatch):
    """An EdgeGATConv step on K10 v2 (the fused route) equals its flat
    route on the card, output and every gradient."""
    row, col, n, _ = _coo(n_src=8100, n_dst=8100)
    g = dgt.graph((row, col), num_nodes=n)
    g.create_tiled_format(tile=1024)
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    gen = torch.Generator(device=card).manual_seed(4)
    x = torch.randn(n, 24, device=card, generator=gen)
    ef = torch.randn(len(row), 16, device=card, generator=gen)
    conv = dgt.nn.EdgeGATConv(24, 16, 32, 4, generator=gen)

    def step(**kw):
        conv.zero_grad()
        xs = x.clone().requires_grad_()
        out = conv(g, xs, ef, **kw)
        out.square().mean().backward()
        return [out.detach(), xs.grad] + [
            p.grad.clone() for p in conv.parameters() if p.grad is not None]

    before = tgf.edgegat_scores.launches
    kern = step(efeats_slot=dgt.nn.EdgeGATConv.slot_edge_feats(g, ef))
    ref = step()
    torch.cuda.synchronize()
    assert tgf.edgegat_scores.launches == before + 1
    assert len(kern) == len(ref)
    torch.testing.assert_close(kern[0], ref[0], rtol=RTOL, atol=ATOL)
    for a, b in zip(kern[1:], ref[1:]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)


# -- K7: bit-masked dot-product attention ----------------------------------

def _bitdot_inputs(card, n_src, n_dst, heads, dim, seed, saturate=False):
    """q, z on a grid of 1/16 in [-1, 1] (the scores are exact in f32 at D
    = 64, so kernel and plain version clip the same edges) and g normal.
    ``saturate``, as in tests/test_torch_bitdot.py: z positive and every
    eighth row of q at +c or -c, with about half of its scores past
    +-40."""
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randint(-16, 17, (n_dst, heads, dim), device=card,
                      generator=gen) / 16
    z = torch.randint(-16, 17, (n_src, heads, dim), device=card,
                      generator=gen) / 16
    if saturate:
        z = z.abs() + 1 / 16
        c = round(40 / (0.5625 * math.sqrt(dim)) * 16) / 16
        q[::16], q[8::16] = c, -c
    g = torch.randn(n_dst, heads, dim, device=card, generator=gen)
    return q, z, g


@pytest.mark.parametrize("heads,dim,saturate", [
    (2, 64, False), (1, 128, False), (4, 32, False), (3, 8, False),
    (2, 64, True)])
def test_bitdot_kernels_match_plain(card, heads, dim, saturate):
    """K7's three kernels through ``bitdot_attention_aggregate`` against
    the plain versions chained the same way, on a bipartite graph whose
    packings reach plane 31; with ``saturate``, scores past +-40."""
    row, col, n_src, n_dst = _simple_coo()
    bf = tbm.build_bit_format_device(row, col, n_src, n_dst, device=card)
    q, z, g = _bitdot_inputs(card, n_src, n_dst, heads, dim, heads + dim,
                             saturate)
    isd = 1 / math.sqrt(dim)
    if saturate:
        e = (z[torch.from_numpy(row).to(card)]
             * q[torch.from_numpy(col).to(card)]).sum(-1) * isd
        assert (e.abs() >= 40).float().mean() > 0.01
    ins = [t.clone().requires_grad_() for t in (q, z)]
    counters = (tbd.bitdot_fwd, tbd.bitdot_bwd_dz, tbd.bitdot_bwd_dq)
    before = [c.launches for c in counters]
    out = tbd.bitdot_attention_aggregate(bf, *ins)
    out.backward(g)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [b + 1 for b in before]
    ref, l_ref = tbd.bitdot_fwd_plain(bf.packed, q, z, isd)
    linv, rho = tbg.backward_scales(g, ref, l_ref, None)
    dz = tbd.bitdot_bwd_dz_plain(bf.packed_rev, q, z, g, linv, rho, isd)
    dq = tbd.bitdot_bwd_dq_plain(bf.packed, q, z, g, linv, rho, isd)
    torch.testing.assert_close(out.detach(), ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(tbd.bitdot_fwd(bf.packed, q, z, isd)[1],
                               l_ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(ins[0].grad, dq, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(ins[1].grad, dz, rtol=RTOL, atol=ATOL)


def test_bitdot_kernels_take_hd_up_to_128(card):
    """H * D = 129 raises in every wrapper before a launch."""
    row, col, n_src, n_dst = _simple_coo()
    bf = tbm.build_bit_format_device(row, col, n_src, n_dst, device=card)
    q, z, g = _bitdot_inputs(card, n_src, n_dst, 3, 43, 1)
    s = torch.zeros(n_dst, 3, device=card)
    before = tbd.bitdot_fwd.launches
    with pytest.raises(ValueError, match="H \\* D"):
        tbd.bitdot_fwd(bf.packed, q, z, 0.1)
    with pytest.raises(ValueError, match="H \\* D"):
        tbd.bitdot_bwd_dz(bf.packed_rev, q, z, g, s, s, 0.1)
    with pytest.raises(ValueError, match="H \\* D"):
        tbd.bitdot_bwd_dq(bf.packed, q, z, g, s, s, 0.1)
    assert tbd.bitdot_fwd.launches == before


def test_bitdot_wrappers_never_take_plain_on_cuda(card, monkeypatch):
    """On CUDA tensors each K7 wrapper launches its kernel: a plain version
    that is reached raises."""
    for name in ("bitdot_fwd_plain", "bitdot_bwd_dz_plain",
                 "bitdot_bwd_dq_plain"):
        def refuse(*args, _name=name, **kwargs):
            raise AssertionError(f"{_name} reached with CUDA tensors")
        monkeypatch.setattr(tbd, name, refuse)
    row, col, n_src, n_dst = _simple_coo()
    bf = tbm.build_bit_format_device(row, col, n_src, n_dst, device=card)
    q, z, g = _bitdot_inputs(card, n_src, n_dst, 2, 64, 2)
    q.requires_grad_()
    z.requires_grad_()
    tbd.bitdot_attention_aggregate(bf, q, z).backward(g)
    torch.cuda.synchronize()
    assert torch.isfinite(q.grad).all() and torch.isfinite(z.grad).all()


def test_dotgatconv_k7_matches_gather_path(card, monkeypatch):
    """A DotGatConv(24, 64, 2) step on K7 equals its gather path on the
    card (scores inside the clip)."""
    row, col, n, _ = _simple_coo()
    g = dgt.graph((row, col), num_nodes=n)
    g.unit().create_bitmask_format(on_device=True)
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    conv = dgt.nn.DotGatConv(24, 64, 2, generator=torch.Generator(
        device=card).manual_seed(0))
    x = torch.randn(n, 24, device=card,
                    generator=torch.Generator(device=card).manual_seed(1))

    def step():
        conv.zero_grad()
        out = conv(g, x)
        out.square().mean().backward()
        return [out.detach()] + [p.grad.clone() for p in conv.parameters()]

    before = tbd.bitdot_fwd.launches
    kern = step()
    assert tbd.bitdot_fwd.launches == before + 1
    monkeypatch.setitem(config._FLAGS, "use_kernels", False)
    chain = step()
    torch.testing.assert_close(kern[0], chain[0], rtol=RTOL, atol=ATOL)
    for a, b in zip(kern[1:], chain[1:]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)


# -- K12, the hybrid format's int8 hub block -----------------------------------

def _int8_block(card, k, n_pad, n, density=0.3, seed=0):
    """A (k, n_pad) int8 block of counts 0..127 at ``density`` over its
    first ``n`` columns, 0 past them."""
    gen = torch.Generator(device=card).manual_seed(seed)
    a = torch.randint(0, 128, (k, n_pad), dtype=torch.int8, device=card,
                      generator=gen)
    keep = torch.rand(k, n_pad, device=card, generator=gen) < density
    a *= keep
    a[:, n:] = 0
    return a


@pytest.mark.parametrize("contract_rows", [False, True])
@pytest.mark.parametrize("f", [1, 16, 41, 128])
def test_int8_kernels_match_plain(card, f, contract_rows):
    """K12 in both orientations at shapes on no block boundary (k = 1003,
    N = 5000, N_pad = 5008) against its plain version: exactly with
    inputs on a grid of 2^-12 in [-1/4, 1/4] (every sum is exact in f32;
    the values carry up to 10 significant bits, which bf16 does not hold,
    so a kernel that rounded its input to bf16 would fail), and with
    normal inputs within the f32 rounding of two sums of up to 5,000
    products of counts up to 127 (RTOL/ATOL do not hold there: sums of
    |terms| near 10^4 cancel to near 0)."""
    k, n, n_pad = 1003, 5000, 5008
    # about 9,500 counted edges a row: the grid's sums stay under
    # 2^24 * 2^-12
    a = _int8_block(card, k, n_pad, n, density=0.03, seed=f)
    counted = max(int(a.sum(dim, dtype=torch.int64).max()) for dim in (0, 1))
    assert counted / 4 < 2 ** 12
    gen = torch.Generator(device=card).manual_seed(100 + f)
    rows = k if contract_rows else n
    grid = torch.randint(-1024, 1025, (rows, f), device=card,
                         generator=gen).float() * 2.0 ** -12
    assert not torch.equal(grid.to(torch.bfloat16).float(), grid)
    normal = torch.randn(rows, f, device=card, generator=gen)
    kernel = tgi8.int8_matmul_cols if contract_rows else \
        tgi8.int8_matmul_rows
    plain = tgi8.int8_matmul_cols_plain if contract_rows else \
        tgi8.int8_matmul_rows_plain
    before = kernel.launches
    got = kernel(a, grid)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.shape == ((n_pad, f) if contract_rows else (k, f))
    assert torch.equal(got, plain(a, grid))
    # two f32 sums of `terms` products, in two orders: each is within
    # terms * 2^-24 of the sum of the products' magnitudes
    err = (kernel(a, normal) - plain(a, normal)).abs()
    terms = k if contract_rows else n
    assert (err <= 2 * terms * 2.0 ** -24 * plain(a, normal.abs())).all()
    zero = torch.zeros_like(a)
    assert not kernel(zero, normal).any()


@pytest.mark.parametrize("f", [1, 8, 16, 41, 128])
@pytest.mark.parametrize("k,n_pad", [(1003, 5008), (77, 23_936)])
def test_int8_cols_tensor_cores_exact_and_repeatable(card, f, k, n_pad):
    """The column kernel (bf16 mma.sync over three parts of z) at ragged
    k (not a multiple of its 32-row stage) and N_pad (not of its 512-row
    pass), on int8 values over -128..127: exactly the plain version on a
    grid of 2^-12 in [-1/4, 1/4] (values bf16 does not hold; every sum
    exact in f32, as the assert on the block's column sums shows), and two
    calls give the same bits on normal inputs."""
    gen = torch.Generator(device=card).manual_seed(f * 1000 + k)
    a = torch.randint(-128, 128, (k, n_pad), dtype=torch.int8, device=card,
                      generator=gen)
    a *= torch.rand(k, n_pad, device=card, generator=gen) < 0.05
    assert (a == -128).any() and (a == 127).any()
    assert int(a.abs().sum(0, dtype=torch.int64).max()) / 4 < 2 ** 12
    z = torch.randint(-1024, 1025, (k, f), device=card,
                      generator=gen).float() * 2.0 ** -12
    before = tgi8.int8_matmul_cols.launches
    got = tgi8.int8_matmul_cols(a, z)
    torch.cuda.synchronize()
    assert tgi8.int8_matmul_cols.launches == before + 1
    assert torch.equal(got, tgi8.int8_matmul_cols_plain(a, z))
    normal = torch.randn(k, f, device=card, generator=gen)
    assert torch.equal(tgi8.int8_matmul_cols(a, normal),
                       tgi8.int8_matmul_cols(a, normal))


def test_int8_kernels_64bit_offsets(card):
    """A block of k * N_pad = 2,160,000,000 bytes, past 2^31: rows and
    columns whose offsets need 64 bits match the plain version."""
    k, n_pad = 4500, 480_000
    assert k * n_pad > 2 ** 31
    a = torch.zeros(k, n_pad, dtype=torch.int8, device=card)
    gen = torch.Generator(device=card).manual_seed(7)
    a[-300:] = torch.randint(0, 4, (300, n_pad), dtype=torch.int8,
                             device=card, generator=gen)
    a[:, -1000:] = 5
    x = torch.randint(-8, 9, (n_pad, 16), device=card,
                      generator=gen).float() / 8
    z = torch.randint(-8, 9, (k, 16), device=card,
                      generator=gen).float() / 8
    rows = tgi8.int8_matmul_rows(a, x)
    assert rows[-300:].abs().sum() > 0
    assert torch.equal(rows, tgi8.int8_matmul_rows_plain(a, x))
    assert torch.equal(tgi8.int8_matmul_cols(a, z),
                       tgi8.int8_matmul_cols_plain(a, z))


def _hub_coo(n=6000, seed=41):
    """A square COO with 40 hub dst nodes and multi-edges."""
    rng = np.random.default_rng(seed)
    row = np.r_[rng.integers(0, n, 40_000), rng.integers(0, n, 30_000)]
    col = np.r_[rng.integers(0, n, 40_000), rng.integers(0, 40, 30_000)]
    row[:300], col[:300] = row[300:600], col[300:600]
    return row, col, n


@pytest.mark.parametrize("symmetric", [False, True])
def test_hybrid_spmm_matches_gather(card, symmetric, monkeypatch):
    """``update_all(copy_u, sum)`` on the hybrid format (K12 rows and
    columns, K3 on the remainder) against the gather path, forward and
    backward, with the launches each takes."""
    row, col, n = _hub_coo()
    if symmetric:
        row, col = np.r_[row, col], np.r_[col, row]
    g = dgt.graph((row, col), num_nodes=n)
    g.unit().create_hybrid_format(k_dense=64, min_degree=100,
                                  symmetric=symmetric)
    hf = g.unit()._hybrid
    assert hf.a_dense.dtype == torch.int8 and hf.k == 40
    monkeypatch.setitem(config._FLAGS, "kernel_spmm_min_edges", 1)
    gen = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(n, 16, device=card, generator=gen)
    dz = torch.randn(n, 16, device=card, generator=gen)

    def run():
        xg = x.clone().requires_grad_()
        out = dgt.ops.gspmm(g, "copy_lhs", "sum", xg, None)
        out.backward(dz)
        return out.detach(), xg.grad

    counts = (tgi8.int8_matmul_rows.launches,
              tgi8.int8_matmul_cols.launches, tts.tiled_spmm.launches)
    out, dx = run()
    torch.cuda.synchronize()
    launched = (tgi8.int8_matmul_rows.launches - counts[0],
                tgi8.int8_matmul_cols.launches - counts[1],
                tts.tiled_spmm.launches - counts[2])
    assert launched == ((2, 2, 2) if symmetric else (1, 1, 2))
    monkeypatch.setitem(config._FLAGS, "use_kernels", False)
    out_g, dx_g = run()
    torch.testing.assert_close(out, out_g, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(dx, dx_g, rtol=RTOL, atol=ATOL)


def test_int8_wrappers_raise_and_never_take_plain(card, monkeypatch):
    """On CUDA tensors the K12 wrappers launch their kernels (a plain
    version that is reached raises), and a wrong dtype, shape or layout
    raises before any launch."""
    for name in ("int8_matmul_rows_plain", "int8_matmul_cols_plain"):
        def refuse(*args, _name=name, **kwargs):
            raise AssertionError(f"{_name} reached with CUDA tensors")
        monkeypatch.setattr(tgi8, name, refuse)
    a = _int8_block(card, 70, 256, 250)
    x = torch.randn(250, 16, device=card)
    z = torch.randn(70, 16, device=card)
    assert torch.isfinite(tgi8.int8_matmul_rows(a, x)).all()
    assert torch.isfinite(tgi8.int8_matmul_cols(a, z)).all()
    before = (tgi8.int8_matmul_rows.launches, tgi8.int8_matmul_cols.launches)
    for bad in (lambda: tgi8.int8_matmul_rows(a.float(), x),
                lambda: tgi8.int8_matmul_rows(a, x.half()),
                lambda: tgi8.int8_matmul_rows(a, x.t().contiguous().t()),
                lambda: tgi8.int8_matmul_rows(a[:, :200], x[:200]),
                lambda: tgi8.int8_matmul_rows(a, x.cpu()),
                lambda: tgi8.int8_matmul_cols(a, z.double()),
                lambda: tgi8.int8_matmul_cols(a, z[:69])):
        with pytest.raises(ValueError):
            bad()
    assert before == (tgi8.int8_matmul_rows.launches,
                      tgi8.int8_matmul_cols.launches)


# -- the mesh-sharded slice: K5's src-major forward, K13, the format --------

SHARD_FIELDS = ("shards", "shards_rev", "rem_src_g", "rem_dst_l", "rem_w",
                "brem_src_g", "brem_dst_l", "brem_w")


def _shard_graph():
    """``_coo``'s edges made simple on 8,100 nodes: at two parts device
    0's shard reaches bit plane 31 (dst 3,968 to 4,095)."""
    row, col, n, _ = _coo()
    key = np.unique(col * n + row)
    return key % n, key // n, n


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_sharded_device_builder_matches_host(card, parts):
    row, col, n, _ = _coo()
    got = tbs.build_bit_sharded_format_device(row, col, n, parts,
                                              device=card)
    want = tbs.build_bit_sharded_format(row, col, n, parts, device="cpu")
    assert got.has_remainder
    for name in SHARD_FIELDS:
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name


@pytest.mark.parametrize("heads,dim", [(4, 32), (1, 41), (8, 16), (3, 8)])
def test_shard_gat_kernels_match_plain(card, heads, dim):
    """``bitgat_fwd_t`` and K13 on each shard of a two-part build against
    their plain versions; each launches once."""
    row, col, n = _shard_graph()
    fmt = tbs.build_bit_sharded_format_device(row, col, n, 2, device=card)
    assert (fmt.shards[0] < 0).any()
    gen = torch.Generator(device=card).manual_seed(heads * 100 + dim)
    kp, npp = fmt.kp, fmt.npp
    for shard in fmt.shards:
        el = torch.randn(kp, heads, device=card, generator=gen)
        er = torch.randn(npp, heads, device=card, generator=gen)
        z = torch.randn(kp, heads, dim, device=card, generator=gen)
        g = torch.randn(npp, heads, dim, device=card, generator=gen)
        f0, b0 = tbg.bitgat_fwd_t.launches, tgs.bit_shard_gat_bwd.launches
        out, l = tbg.bitgat_fwd_t(shard, el, er, z, npp, 0.2)
        w_out, w_l = tbg.bitgat_fwd_t_plain(shard, el, er, z, npp, 0.2)
        torch.testing.assert_close(out, w_out, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(l, w_l, rtol=RTOL, atol=ATOL)
        linv, rho = tbg.backward_scales(g, w_out, w_l, None)
        args = (shard, el, er, z, g, linv, rho, npp, 0.2)
        for a, b in zip(tgs.bit_shard_gat_bwd(*args),
                        tgs.bit_shard_gat_bwd_plain(*args)):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        assert (tbg.bitgat_fwd_t.launches - f0,
                tgs.bit_shard_gat_bwd.launches - b0) == (1, 1)


def test_shard_gat_wrappers_never_take_plain_on_cuda(card, monkeypatch):
    for mod, name in ((tbg, "bitgat_fwd_t_plain"),
                      (tgs, "bit_shard_gat_bwd_plain")):
        def refuse(*args, _name=name, **kwargs):
            raise AssertionError(f"{_name} reached with CUDA tensors")
        monkeypatch.setattr(mod, name, refuse)
    row, col, n = _shard_graph()
    fmt = tbs.build_bit_sharded_format_device(row, col, n, 1, device=card)
    npp = fmt.npp
    el, er = torch.randn(npp, 2, device=card), torch.randn(npp, 2, device=card)
    z = torch.randn(npp, 2, 16, device=card)
    out, l = tbg.bitgat_fwd_t(fmt.shards[0], el, er, z, npp, 0.2)
    linv, rho = tbg.backward_scales(z, out, l, None)
    grads = tgs.bit_shard_gat_bwd(fmt.shards[0], el, er, z, z, linv, rho,
                                  npp, 0.2)
    assert all(torch.isfinite(t).all() for t in (out, l) + grads)


@pytest.fixture
def nccl_group(card, tmp_path):
    """A world-size-1 NCCL group in this process."""
    group = comm.init_group(1, 0, card, str(tmp_path / "rendezvous"))
    yield group
    torch.distributed.destroy_process_group()


def test_sharded_ops_world_size_one(card, nccl_group):
    """``bit_sharded_spmm`` and ``bit_sharded_gat`` on a world-size-1 NCCL
    group against ``bit_spmm`` and ``bitgat_attention_aggregate``."""
    row, col, n = _shard_graph()
    fmt = tbs.build_bit_sharded_format_device(row, col, n, 1, device=card)
    bf = tbm.build_bit_format_device(row, col, n, n, device=card)
    gen = torch.Generator(device=card).manual_seed(5)
    x = torch.randn(n, 16, device=card, generator=gen)
    xp = tbs.pad_nodes(fmt, x).requires_grad_()
    out = tbs.bit_sharded_spmm(fmt, xp, nccl_group)
    out.square().sum().backward()
    xs = x.clone().requires_grad_()
    want = tbm.bit_spmm(bf, xs)
    want.square().sum().backward()
    torch.testing.assert_close(out[:n], want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(xp.grad[:n], xs.grad, rtol=RTOL, atol=ATOL)
    el, er = (torch.randn(n, 4, device=card, generator=gen)
              for _ in range(2))
    z, w = (torch.randn(n, 4, 32, device=card, generator=gen)
            for _ in range(2))
    ins_p = [tbs.pad_nodes(fmt, t).requires_grad_() for t in (el, er, z)]
    out = tgs.bit_sharded_gat(fmt, *ins_p, nccl_group)
    (out * tbs.pad_nodes(fmt, w)).sum().backward()
    ins_s = [t.clone().requires_grad_() for t in (el, er, z)]
    want = tbg.bitgat_attention_aggregate(bf, *ins_s)
    (want * w).sum().backward()
    torch.testing.assert_close(out[:n], want, rtol=RTOL, atol=ATOL)
    for a, b in zip(ins_p, ins_s):
        torch.testing.assert_close(a.grad[:n], b.grad, rtol=RTOL, atol=ATOL)


def test_gloo_refuses_cuda_tensors(card, tmp_path):
    """The card's tensors never go through gloo."""
    comm.init_group(1, 0, "cpu", str(tmp_path / "rendezvous"))
    try:
        with pytest.raises(ValueError, match="gloo"):
            comm.all_gather_rows(torch.zeros(4, 2, device=card))
        with pytest.raises(ValueError, match="gloo"):
            comm.reduce_scatter_rows(torch.zeros(4, 2, device=card))
    finally:
        torch.distributed.destroy_process_group()


def _grid(card, gen, *shape, step, top, low=None):
    low = -top if low is None else low
    return torch.randint(round(low / step), round(top / step) + 1, shape,
                         device=card, generator=gen).float() * step


@pytest.mark.parametrize("heads,dim", [(4, 32), (1, 41), (8, 8), (3, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v1_kernels_match_plain(card, heads, dim, dtype):
    """Each K11 v1 kernel (the scores and the slot gradient over a stored
    FE, the slot vector sum on both sides) and each K10 v1 kernel (the
    numerator with a stored message, its ds, dx with dfe) against its plain
    version, the stored slot tensors in ``dtype``.  Inputs lie on dyadic
    grids, so every per-slot value and every sum over a node's slots is
    exact in any order; da sums over every slot (atol of its magnitude)."""
    fwd, _, _, _ = _tiled(card)
    fwd = fwd.with_src_first()
    b, cap = fwd.num_buckets, fwd.cap
    gen = torch.Generator(device=card).manual_seed(heads * 100 + dim)
    valid_r, valid_h = fwd.valid.view(b, cap, 1), fwd.valid.view(b, 1, cap)
    U = _grid(card, gen, fwd.num_src, heads, dim, step=1 / 16, top=1)
    V = _grid(card, gen, fwd.num_dst, heads, dim, step=1 / 16, top=1)
    attn = _grid(card, gen, heads, dim, step=1 / 16, top=0.5)
    fe = (_grid(card, gen, b, cap, heads * dim, step=1 / 16, top=0.5)
          * valid_r).to(dtype)
    ds = _grid(card, gen, b, heads, cap, step=1 / 8, top=1) * valid_h
    p = _grid(card, gen, b, heads, cap, step=1 / 16, top=4, low=0) * valid_h
    zn = _grid(card, gen, fwd.num_dst, heads, dim, step=1 / 16, top=1)
    g = torch.randn(b, heads, cap, device=card, generator=gen) * valid_h
    rp = torch.randn(fwd.num_dst, heads, device=card, generator=gen)
    counters = [getattr(tgf, n) for n in (
        "egatc_scores", "egatc_slot_grad", "slot_vec_reduce", "fe_aggregate",
        "fe_ds", "dx_dfe")]
    before = [k.launches for k in counters]
    da, dfe = tgf.egatc_slot_grad(fwd, U, V, attn, fe, ds, 0.25)
    want_da, want_dfe = tgf.egatc_slot_grad_plain(fwd, U, V, attn, fe, ds,
                                                  0.25)
    assert dfe.dtype == dtype
    dx, dfe2 = tgf.dx_dfe(fwd, zn, p, dtype)
    want_dx, want_dfe2 = tgf.dx_dfe_plain(fwd, zn, p, dtype)
    pairs = [
        (tgf.egatc_scores(fwd, U, V, attn, fe, 0.25),
         tgf.egatc_scores_plain(fwd, U, V, attn, fe, 0.25)),
        (dfe.float(), want_dfe.float()),
        (tgf.slot_vec_reduce(fwd, dfe, "dst"),
         tgf.slot_vec_reduce_plain(fwd, dfe, "dst")),
        (tgf.slot_vec_reduce(fwd, dfe, "src"),
         tgf.slot_vec_reduce_plain(fwd, dfe, "src")),
        (tgf.fe_aggregate(fwd, U, fe, p), tgf.fe_aggregate_plain(fwd, U, fe,
                                                                 p)),
        (tgf.fe_ds(fwd, U, fe, zn, rp, g),
         tgf.fe_ds_plain(fwd, U, fe, zn, rp, g)),
        (dx, want_dx), (dfe2.float(), want_dfe2.float())]
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(counters, before)] == [
        1, 1, 2, 1, 1, 1]
    for i, (a, w) in enumerate(pairs):
        torch.testing.assert_close(a, w, rtol=RTOL, atol=ATOL,
                                   msg=lambda m, i=i: f"pair {i}: {m}")
    torch.testing.assert_close(
        da, want_da, rtol=RTOL,
        atol=ATOL * max(1.0, float(want_da.abs().max())))
    for t in (dfe, dfe2):
        assert (t.masked_select(valid_r == 0) == 0).all()


def test_v1_attention_matches_v2(card):
    """Both v1 functions through their kernels against the v2 functions on
    the same leaves, (4, 32) with 16 edge features: values and every leaf's
    gradient (sums in another order: rtol 1e-4, atol 1e-3 of each result's
    magnitude)."""
    fwd, _, _, _ = _tiled(card)
    fwd = fwd.with_src_first()
    b, cap, heads, dim, fe_in = fwd.num_buckets, fwd.cap, 4, 32, 16
    gen = torch.Generator(device=card).manual_seed(11)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=card, generator=gen)
                ).requires_grad_()

    ef = (torch.randn(b, cap, fe_in, device=card, generator=gen)
          * fwd.valid.view(b, cap, 1)).requires_grad_()
    u, v, x = (randn(n, heads, dim, scale=s) for n, s in (
        (fwd.num_src, 0.5), (fwd.num_dst, 0.5), (fwd.num_src, 1.0)))
    el, er = randn(fwd.num_src, heads), randn(fwd.num_dst, heads)
    wf, attn = randn(fe_in, heads * dim, scale=0.1), randn(heads, dim)
    dz = torch.randn(fwd.num_dst, heads, dim, device=card, generator=gen)

    def run(fn, leaves):
        for t in leaves:
            t.grad = None
        fn().backward(dz)
        return [t.grad.clone() for t in leaves]

    def egatc_v1():
        return tgf.egatconv_attention_aggregate(fwd, u, v, ef @ wf, attn, x,
                                                heads, dim, dim, 0.01)

    def egatc_v2():
        return tgf.egatconv_attention_aggregate_v2(fwd, u, v, ef, wf, attn,
                                                   x, heads, dim, dim, 0.01)

    def edgegat_v1():
        fe = ef @ wf
        ee = (fe.view(b, cap, heads, dim) * attn).sum(-1)
        return tgf.edgegat_attention_aggregate(
            fwd, el, er, ee.transpose(1, 2).contiguous(), fe, x, heads, dim,
            0.2)

    def edgegat_v2():
        return tgf.edgegat_attention_aggregate_v2(fwd, el, er, ef, wf, attn,
                                                  x, heads, dim, 0.2)

    for v1, v2, leaves in ((egatc_v1, egatc_v2, (u, v, ef, wf, attn, x)),
                           (edgegat_v1, edgegat_v2,
                            (el, er, ef, wf, attn, x))):
        torch.testing.assert_close(v1().detach(), v2().detach(), rtol=RTOL,
                                   atol=ATOL)
        for a, w in zip(run(v1, leaves), run(v2, leaves)):
            torch.testing.assert_close(
                a, w, rtol=RTOL, atol=ATOL * max(1.0, float(w.abs().max())))


def test_v1_wrappers_never_take_plain_on_cuda(card, monkeypatch):
    """On CUDA tensors each K11 v1 and K10 v1 wrapper launches its kernel:
    a plain version that is reached raises."""
    fwd, _, _, _ = _tiled(card)
    fwd = fwd.with_src_first()
    for name in ("egatc_scores_plain", "egatc_slot_grad_plain",
                 "slot_vec_reduce_plain", "fe_aggregate_plain",
                 "fe_ds_plain", "dx_dfe_plain"):
        def refuse(*args, _name=name, **kwargs):
            raise AssertionError(f"{_name} reached with CUDA tensors")
        monkeypatch.setattr(tgf, name, refuse)
    b, cap, heads, dim = fwd.num_buckets, fwd.cap, 2, 8
    gen = torch.Generator(device=card).manual_seed(12)
    u = torch.randn(fwd.num_src, heads, dim, device=card, generator=gen)
    v = torch.randn(fwd.num_dst, heads, dim, device=card, generator=gen)
    fe = torch.randn(b, cap, heads * dim, device=card, dtype=torch.bfloat16,
                     generator=gen).requires_grad_()
    ee = torch.randn(b, heads, cap, device=card, generator=gen)
    attn = torch.randn(heads, dim, device=card, generator=gen)
    el = torch.randn(fwd.num_src, heads, device=card, generator=gen)
    er = torch.randn(fwd.num_dst, heads, device=card, generator=gen)
    out = (tgf.egatconv_attention_aggregate(fwd, u, v, fe, attn, u, heads,
                                            dim, dim, 0.2).sum()
           + tgf.edgegat_attention_aggregate(fwd, el, er, ee, fe, u, heads,
                                             dim, 0.2).sum())
    out.backward()
    torch.cuda.synchronize()
    assert fe.grad is not None and fe.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("w", [8, 16, 32])
def test_bit_matmul_t_slab_widths(card, w):
    """K1 at each slab width of the sweep equals its plain version exactly
    on grid inputs."""
    row, col, n_src, n_dst = _coo()
    bf = tbm.build_bit_format_device(row, col, n_src, n_dst, device=card)
    gen = torch.Generator(device=card).manual_seed(w)
    x = _grid(card, gen, n_src, 16, step=1 / 16, top=1)
    got = tbm.bit_matmul_t(bf.packed_rev, x, n_dst, slab_words=w)
    torch.testing.assert_close(
        got, tbm.bit_matmul_t_plain(bf.packed_rev, x, n_dst), rtol=0, atol=0)


@pytest.mark.parametrize("f", [1, 16, 41, 96])
@pytest.mark.parametrize("density", [3, 1])
def test_k1_walk_matches_plain(card, f, density):
    """K1's walk on random words (2^-3 of the bits set, or half of them:
    lists drained in pieces), plane 31 set, rows ragged against its
    128-row tiles and fewer than the packing's, words ragged against a
    32-word slab (36 a row), num_dst short of 32 n32: exactly the plain
    version on a grid of 1/16, at every slab width; one launch each."""
    gen = torch.Generator(device=card).manual_seed(f * 10 + density)
    rows, n32 = 777, 36
    packed = torch.randint(-2 ** 31, 2 ** 31, (rows + 9, n32),
                           dtype=torch.int32, device=card, generator=gen)
    for _ in range(density - 1):
        packed &= torch.randint(-2 ** 31, 2 ** 31, (rows + 9, n32),
                                dtype=torch.int32, device=card,
                                generator=gen)
    packed[:3] |= -2 ** 31
    x = _grid(card, gen, rows, f, step=1 / 16, top=1)
    num_dst = 32 * n32 - 7
    want = tbm.bit_matmul_t_plain(packed, x, num_dst)
    for w in tbm.SLAB_WORDS:
        before = tbm.bit_matmul_t.launches
        got = tbm.bit_matmul_t(packed, x, num_dst, slab_words=w)
        torch.cuda.synchronize()
        assert tbm.bit_matmul_t.launches == before + 1
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("f", [16, 96])
def test_k1_walk_on_a_four_part_shard(card, f):
    """K1 on each shard of a 4-part sharded build (the sharded GCN's
    launches: rows = all nodes, 128 words a shard's row) equals its plain
    version exactly on a grid."""
    row, col, n = _shard_graph()
    fmt = tbs.build_bit_sharded_format_device(row, col, n, 4, device=card)
    gen = torch.Generator(device=card).manual_seed(f)
    x = _grid(card, gen, fmt.kp, f, step=1 / 16, top=1)
    for p in range(4):
        shard = fmt.shards[p]
        got = tbm.bit_matmul_t(shard, x, fmt.npp)
        torch.testing.assert_close(
            got, tbm.bit_matmul_t_plain(shard, x, fmt.npp), rtol=0, atol=0)


def test_tools_tiny_checks_on_card(card):
    """The tools' tiny checks through the kernels: K1 on random words and
    ``bitgat_fwd_t`` on P2's tiny inputs, against their dense oracles."""
    from dgl_tpu_torch.tools import perf_bitgat_probe, perf_bitmm_variants
    before = (tbm.bit_matmul_t.launches, tbg.bitgat_fwd_t.launches)
    assert perf_bitmm_variants.tiny_check(card)[1] < 1e-3
    assert perf_bitgat_probe.tiny_check(card)[1] < 1e-4
    assert (tbm.bit_matmul_t.launches - before[0],
            tbg.bitgat_fwd_t.launches - before[1]) == (1, 1)
