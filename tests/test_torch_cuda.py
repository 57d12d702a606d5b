"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  These tests need a GPU and skip without one; they import
neither JAX nor the JAX package, so they run on a machine that has only
PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance rtol 1e-4 / atol 1e-3: f32 sums in another order, and K1's
atomics (K5's, for the gradient of er) add in an order that changes from
run to run.  The row walk (K3, K4's SpMM, K6's dx, K9's node gradient)
and the row reduce (K6's den, der and del) and the slot walk (K10's and
K11 v1's sums of stored slot rows) sum each row in slot order, the SDDMM
walk (K4's SDDMM, K6's and K10's ds) forms each dot in one lane order
and K2 sums a row's bits in one list order; their checks take
dyadic inputs and ask for equality.  K5's listed walk by src sums dz and
del in registers in one order (der in L2 in none), its walk by dst out
and l; K9's da, folded into the
node-gradient walk by dst, meets in L2 in no order (atol 1e-3 times its
largest magnitude, as ``chip_smoke.close_sum``).  K7's dz and dq walks
sum a row in registers in one order; K11 v2's slot gradient on the tensor
cores adds its blocks' partials in block order and its node gradient, the
row walk with the edge term, sums each row in slot order (both bit for
bit on dyadic inputs).  K7's forward sums a row in registers in one order
too; K11's scores, the dot-product walk in its scores mode, form each
logit in one lane order (the raw sums bit for bit on dyadic inputs).  K11
v1's slot gradient, the slot walk by dst, sums dFNJ in slot order and da
over static ranges added in range order, and K10 v2's scores form each
logit by FMAs in feature order: bit for bit on dyadic inputs, the scores
also bit for bit against the kernel they replaced and the staged
design."""
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
from dgl_tpu_torch.tools import perf_bwd_walks as tbw
from dgl_tpu_torch.tools import perf_dq_node_grad as tdq
from dgl_tpu_torch.tools import perf_dz_slot_grad as tdz
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


def _listed_graph():
    """Simple edges on 8,100 src and 16,300 dst nodes: the rows of the A^T
    packing hold 512 words (two steps of the listed walk) and reach bit
    plane 31; src 7 is a hub of 5,000 out-edges (a list fills in each of
    its steps), src 100-199 have none."""
    rng = np.random.default_rng(29)
    n_src, n_dst = 8100, 16_300
    src = rng.integers(0, n_src, 80_000)
    src[(src >= 100) & (src < 200)] = 5
    dst = rng.integers(0, n_dst, 80_000)
    src[:5000], dst[:5000] = 7, rng.permutation(n_dst)[:5000]
    dst[5000:5100] = rng.integers(15_872, n_dst, 100)
    key = np.unique(dst * n_src + src)
    return key % n_src, key // n_src, n_src, n_dst


def _listed_case(card, heads, dim, drop):
    """K5 backward's operands on ``_listed_graph`` with linv and rho from
    the plain forward: (bf, args of launch_bwd after the packing)."""
    row, col, n_src, n_dst = _listed_graph()
    bf = tbm.build_bit_format_device(row, col, n_src, n_dst, device=card)
    assert (bf.packed_rev < 0).any() and bf.packed_rev.shape[1] == 512
    gen = torch.Generator(device=card).manual_seed(heads * 100 + dim)
    el = torch.randn(n_src, heads, device=card, generator=gen)
    er = torch.randn(n_dst, heads, device=card, generator=gen)
    z = torch.randn(n_src, heads, dim, device=card, generator=gen)
    g = torch.randn(n_dst, heads, dim, device=card, generator=gen)
    thresh = tbg.drop_thresh(drop)
    seed = torch.tensor([-99], device=card)
    out, l = tbg.bitgat_fwd_plain(bf.packed, el, er, z, n_dst, 0.2, thresh,
                                  seed)
    linv, rho = tbg.backward_scales(g, out, l, thresh)
    return bf, (el, er, z, g, linv, rho, n_dst, 0.2, thresh, seed)


@pytest.mark.parametrize("heads,dim,drop,lanes", [
    (4, 32, 0.0, None), (4, 32, 0.6, None), (4, 32, 0.0, 8),
    (4, 32, 0.6, 32), (1, 41, 0.0, None), (1, 41, 0.6, None),
    (8, 16, 0.6, None), (2, 64, 0.0, None), (3, 5, 0.0, None),
    (1, 8, 0.6, None), (16, 8, 0.0, None), (1, 128, 0.6, 16)])
def test_bwd_listed_walk_matches_plain(card, heads, dim, drop, lanes):
    """K5's backward as the listed walk, at the layouts of ``list_layout``
    (der by vectors at H = 2, 4 and 8, by scalars elsewhere) and, launched
    by ``tools/perf_bwd_walks.py``, at other lanes an entry, against the
    plain version; a hub row and rows of two steps."""
    bf, args = _listed_case(card, heads, dim, drop)
    want = tbg.bitgat_bwd_plain(bf.packed_rev, *args)
    order = tbg.bwd_claim_order(bf)
    got = (tbg.launch_bwd(bf.packed_rev, *args, order=order) if lanes is None
           else tbw.listed_walk(bf.packed_rev, *args, order=order,
                                lanes=lanes))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_bwd_listed_walk_is_deterministic(card):
    """dz and del are summed in registers in one order: the same bits from
    run to run (der meets in L2 in no fixed order)."""
    bf, args = _listed_case(card, 4, 32, 0.6)
    a = tbg.bitgat_bwd(bf.packed_rev, *args, order=tbg.bwd_claim_order(bf))
    b = tbg.bitgat_bwd(bf.packed_rev, *args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    torch.testing.assert_close(a[1], b[1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("heads,dim", [(4, 32), (1, 41), (8, 16)])
def test_bwd_listed_walk_kernel_attrs(card, heads, dim):
    for drop in (False, True):
        regs, warps = tbg.list_kernel_attrs("bwd", heads, dim, drop)
        assert 0 < regs <= 128 and warps >= 16


def _fwd_listed_case(card, heads, dim, drop):
    """K5 forward's operands on ``_listed_graph`` with src and dst swapped:
    the dst-major packing's rows hold 512 words (two steps of the walk)
    and reach bit plane 31, dst 7 is a hub of 5,000 in-edges, dst 100-199
    have none.  (bf, args of bitgat_fwd after the packing)."""
    row, col, n_src, n_dst = _listed_graph()
    bf = tbm.build_bit_format_device(col, row, n_dst, n_src, device=card)
    assert (bf.packed < 0).any() and bf.packed.shape[1] == 512
    gen = torch.Generator(device=card).manual_seed(heads * 100 + dim)
    el = torch.randn(n_dst, heads, device=card, generator=gen)
    er = torch.randn(n_src, heads, device=card, generator=gen)
    z = torch.randn(n_dst, heads, dim, device=card, generator=gen)
    seed = torch.tensor([-99], device=card)
    return bf, (el, er, z, n_src, 0.2, tbg.drop_thresh(drop), seed)


@pytest.mark.parametrize("heads,dim,drop", [
    (4, 32, 0.0), (4, 32, 0.6), (1, 41, 0.0), (1, 41, 0.6), (8, 16, 0.6),
    (2, 16, 0.0), (2, 64, 0.0), (3, 5, 0.0), (1, 8, 0.6), (16, 8, 0.0),
    (1, 128, 0.6)])
def test_fwd_listed_walk_matches_plain(card, heads, dim, drop):
    """K5's forward as the listed walk by dst, at the layouts of
    ``list_layout``, against the plain version; a hub row, rows of two
    steps, rows with no edge (0, and l 0)."""
    bf, args = _fwd_listed_case(card, heads, dim, drop)
    before = tbg.bitgat_fwd.launches
    got = tbg.bitgat_fwd(bf.packed, *args, order=tbg.fwd_claim_order(bf))
    assert tbg.bitgat_fwd.launches == before + 1
    want = tbg.bitgat_fwd_plain(bf.packed, *args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    assert (got[0][100:200] == 0).all() and (got[1][100:200] == 0).all()


def test_fwd_listed_walk_is_deterministic(card):
    """out and l are summed in registers in one order: the same bits from
    run to run, whichever order the rows are claimed in."""
    bf, args = _fwd_listed_case(card, 4, 32, 0.6)
    a = tbg.bitgat_fwd(bf.packed, *args, order=tbg.fwd_claim_order(bf))
    b = tbg.bitgat_fwd(bf.packed, *args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_fwd_listed_walk_skips_bits_past_num_src(card):
    """Set bits at or past num_src (a packing wider than z) are skipped:
    the walk equals the plain version on the packing with them cleared."""
    bf, (el, er, z, n_dst, slope, thresh, seed) = _fwd_listed_case(
        card, 2, 16, 0.6)
    num_src = 16_000
    k32 = bf.packed.shape[1]
    src = (torch.arange(k32, device=card)[None, :]
           + k32 * torch.arange(32, device=card)[:, None])
    past = ((src >= num_src).to(torch.int64)
            << torch.arange(32, device=card)[:, None]).sum(0)
    past = torch.where(past >= 2**31, past - 2**32, past).to(torch.int32)
    assert (bf.packed & past).any()
    args = (el[:num_src], er, z[:num_src], n_dst, slope, thresh, seed)
    got = tbg.bitgat_fwd(bf.packed, *args)
    want = tbg.bitgat_fwd_plain(bf.packed & ~past, *args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("heads,dim", [(4, 32), (1, 41), (8, 16)])
def test_fwd_listed_walk_kernel_attrs(card, heads, dim):
    for drop in (False, True):
        regs, warps = tbg.list_kernel_attrs("fwd", heads, dim, drop)
        assert 0 < regs <= 128 and warps >= 16


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_fwd_t_on_the_shard_view(card, parts):
    """Each shard's dst-major view, built on the card, equals the bit
    transpose of the host builder's shard; ``bitgat_fwd_t`` on it (the walk
    by dst) equals its plain version, and the walk on a view built anew
    for the call.  Symmetric with npp == kp: the view is the shard."""
    row, col, n = _shard_graph()
    fmt = tbs.build_bit_sharded_format_device(row, col, n, parts,
                                              device=card)
    host = tbs.build_bit_sharded_format(row, col, n, parts, device="cpu")
    gen = torch.Generator(device=card).manual_seed(parts)
    kp, npp = fmt.kp, fmt.npp
    for p in range(parts):
        shard = fmt.shards[p]
        view, order = tgs.shard_fwd_view(fmt, shard)
        assert torch.equal(view.cpu(), tbg.transpose_bits(host.shards[p], kp,
                                                          npp))
        el = torch.randn(kp, 4, device=card, generator=gen)
        er = torch.randn(npp, 4, device=card, generator=gen)
        z = torch.randn(kp, 4, 32, device=card, generator=gen)
        got = tbg.bitgat_fwd_t(shard, el, er, z, npp, 0.2, view, order)
        anew = tbg.bitgat_fwd_t(shard, el, er, z, npp, 0.2)
        want = tbg.bitgat_fwd_t_plain(shard, el, er, z, npp, 0.2)
        for a, b, c in zip(got, anew, want):
            assert torch.equal(a, b)
            torch.testing.assert_close(a, c, rtol=RTOL, atol=ATOL)
    if parts == 1:
        m = 4000                   # npp == kp == 4,096 at one part
        keep = (row < m) & (col < m)
        key = np.unique(np.r_[col[keep] * m + row[keep],
                              row[keep] * m + col[keep]])
        sym = tbs.build_bit_sharded_format_device(
            key % m, key // m, m, 1, symmetric=True, device=card)
        view, _ = tgs.shard_fwd_view(sym, sym.shards[0])
        assert sym.npp == sym.kp
        assert view.data_ptr() == sym.shards[0].data_ptr()


def test_fwd_walks_probe_retired_kernels(card):
    """The probe's retired kernels (the warp walk by dst, the scatter walk
    over A^T) and its edit of the walk, against the plain versions."""
    from dgl_tpu_torch.tools import perf_fwd_walks as tfw
    bf, args = _fwd_listed_case(card, 4, 32, 0.6)
    want = tbg.bitgat_fwd_plain(bf.packed, *args)
    for got in (tfw.warp_walk(bf.packed, *args),
                tfw.listed_walk(bf.packed, *args, variant="u2x")):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    row, col, n = _shard_graph()
    fmt = tbs.build_bit_sharded_format_device(row, col, n, 2, device=card)
    el, er, z, _, slope, _, _ = args
    kp, npp = fmt.kp, fmt.npp
    for shard in fmt.shards:
        ins = (el[:kp], er[:npp], z[:kp], npp, slope)
        for a, b in zip(tfw.scatter_walk(shard, *ins),
                        tbg.bitgat_fwd_t_plain(shard, *ins)):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


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
    """K3 forward and backward (the three autograd functions), the row
    walk by dst on each format, against the plain version on the same
    formats."""
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
    # through the row walk by dst: both formats' dst views were built
    assert fwd._rows_dst is not None and rev._rows_dst is not None
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
    counters = (tgf.vattn_scores, tgf.vattn_slot_grad, tgf.vattn_node_grad,
                tgf.vattn_node_grad_da)
    before = [k.launches for k in counters]
    got = [tgf.vattn_scores(fwd, U, V, attn, slope, ef, wf)]
    got += [a for a in tgf.vattn_slot_grad(fwd, U, V, attn, ds, slope, ef,
                                           wf) if a is not None]
    got += [tgf.vattn_node_grad(fwd, U, V, attn, ds, slope, side, ef, wf)
            for side in ("dst", "src")]
    torch.cuda.synchronize()
    # without the edge term the slot gradient is K9's da, folded into the
    # node-gradient walk by dst
    assert [k.launches - b for k, b in zip(counters, before)] == (
        [1, 1, 2, 0] if fe else [1, 0, 2, 1])
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


@pytest.mark.parametrize("heads,dim", [(8, 8), (1, 41), (4, 32), (3, 5),
                                       (2, 6)])
def test_node_grad_row_walk_matches_plain_exactly(card, heads, dim):
    """K9's node gradient as the row walk, on both sides, from a slot-major
    ds (as vattn_backward hands it) and from a (B, H, C) one, equal to the
    plain version bit for bit: U, V and attn on a grid of 1/16, ds of 1/8
    and a slope of 1/4 keep every sum exact."""
    fwd, _, _, _ = _tiled(card)
    fwd = fwd.with_src_first()
    gen = torch.Generator(device=card).manual_seed(heads * 10 + dim)

    def grid(*shape, top):
        return torch.randint(-top, top + 1, shape, device=card,
                             generator=gen).float()

    b, cap = fwd.num_buckets, fwd.cap
    U = grid(fwd.num_src, heads, dim, top=16) / 16
    V = grid(fwd.num_dst, heads, dim, top=16) / 16
    attn = grid(heads, dim, top=8) / 16
    ds = grid(b, heads, cap, top=8) / 8 * fwd.valid.view(b, 1, cap)
    sm = ds.transpose(1, 2).contiguous().transpose(1, 2)
    for side in ("dst", "src"):
        want = tgf.vattn_node_grad_plain(fwd, U, V, attn, ds, 0.25, side)
        before = tgf.vattn_node_grad.launches
        for d in (sm, ds):
            assert torch.equal(
                tgf.vattn_node_grad(fwd, U, V, attn, d, 0.25, side), want)
        assert tgf.vattn_node_grad.launches == before + 2


# route 5's two layers, a narrow head, a wide one, rows over 1,024 columns
# (two column parts; two head groups) and a head width that takes the pad
SCORES_WALK_SHAPES = [(8, 8), (1, 41), (4, 16), (2, 64), (1, 1100), (4, 300),
                      (3, 5)]


@pytest.mark.parametrize("heads,dim", SCORES_WALK_SHAPES)
def test_vattn_scores_walk_matches_plain(card, heads, dim):
    """K9's scores on the dot-product walk by dst (``row_sddmm_kernel<CPL,
    true>`` and ``slot_finish_kernel``'s exp mode) against the plain
    version: U, V and attn on a grid of 1/16 and a slope of 1/4 keep every
    logit exact in f32 in any order, so the two differ only by their exp
    (rtol 1e-6); then
    attn of 16 times one sign on U, V >= 0 takes logits past +40 and past
    -40 (the clip); 0 at every padded slot; two calls give the same bits;
    one count a call."""
    fwd, _, _, _ = _tiled(card)
    gen = torch.Generator(device=card).manual_seed(heads * 1000 + dim)

    def grid(*shape, top):
        return torch.randint(-top, top + 1, shape, device=card,
                             generator=gen).float() / 16

    U = grid(fwd.num_src, heads, dim, top=16)
    V = grid(fwd.num_dst, heads, dim, top=16)
    a = grid(heads, dim, top=8)
    pad = fwd.valid.reshape(fwd.num_buckets, 1, fwd.cap) == 0
    for case, (u, v, attn) in enumerate(
            ((U, V, a), (U.abs(), V.abs(), 16 * a.abs()),
             (U.abs(), V.abs(), -16 * a.abs()))):
        before = tgf.vattn_scores.launches
        got = tgf.vattn_scores(fwd, u, v, attn, 0.25)
        torch.cuda.synchronize()
        assert tgf.vattn_scores.launches == before + 1
        want = tgf.vattn_scores_plain(fwd, u, v, attn, 0.25)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        assert (got.masked_select(pad) == 0).all() and pad.any()
        assert torch.equal(got, tgf.vattn_scores(fwd, u, v, attn, 0.25))
        if case == 1:
            assert (want >= math.exp(40.0) * (1 - 1e-6)).any()
        if case == 2:
            assert ((want > 0) & (want <= math.exp(-40.0) * (1 + 1e-6))).any()


def test_vattn_scores_without_a_term_retired_from_gatv2(card):
    """``gatv2.cu`` holds no scores kernel: ``dgl_vattn_scores`` left it
    with the bucket walk for ``tools/fwd_scores_probe.cu``, and
    ``tools/perf_scores_rows.py`` builds K9's instance of that walk again
    from an edit of the probe's source, which gives the walk's p."""
    from dgl_tpu_torch.tools import perf_scores_rows as tsr
    fwd, _, _, _ = _tiled(card)
    U, V, attn, _, _, _ = _vattn_inputs(card, fwd, 4, 32, 0, False, 3)
    lib = tts.build.load("gatv2", tgf._VATTN_SIGNATURES)
    with pytest.raises(AttributeError):
        getattr(lib, "dgl_vattn_scores")
    torch.testing.assert_close(tsr.bucket_scores(fwd, U, V, attn, 0.2),
                               tgf.vattn_scores(fwd, U, V, attn, 0.2),
                               rtol=RTOL, atol=ATOL)


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
    """The slot reduce at 64 heads and tile 1024 (whose (tile, H) f32 sums
    exceeded a block's shared memory, so that the tiled reduce took a
    launch a group of heads) is one launch of the row reduce on each side,
    in both layouts, and equals its plain version."""
    row, col, n_src, n_dst = _coo()
    fwd = tts.build_tiled_format_device(row, col, n_src, n_dst, 1024, 128,
                                        device=card).with_src_first()
    assert 1024 * 64 * 4 > tgf._SMEM_PER_BLOCK
    vals = torch.randn(fwd.num_buckets, 64, fwd.cap, device=card) * \
        fwd.valid.view(fwd.num_buckets, 1, fwd.cap)
    for v in (vals, tgf._slot_major(vals)):
        for side in ("dst", "src"):
            before = tgf.slot_reduce.launches
            got = tgf.slot_reduce(fwd, v, side)
            torch.cuda.synchronize()
            assert tgf.slot_reduce.launches - before == 1
            torch.testing.assert_close(
                got, tgf.slot_reduce_plain(fwd, v, side), rtol=RTOL,
                atol=ATOL)


def _hub_tiled(card):
    """The tiled format of a square COO with 40 hub dst nodes, a src hub
    (node 77, 3,000 out-edges) and nodes of no in-edge and no out-edge."""
    row, col, n = _hub_coo()
    row[1000:4000] = 77
    row[(row >= 5000) & (row < 5100)] -= 1000
    col[(col >= 5500) & (col < 5600)] -= 1000
    return tts.build_tiled_format_device(row, col, n, n,
                                         device=card).with_src_first()


@pytest.mark.parametrize("heads", [1, 4, 8, 64])
@pytest.mark.parametrize("slot_major", [False, True])
def test_row_reduce_bit_for_bit(card, heads, slot_major):
    """The row reduce on both sides equals its plain version bit for bit
    on a dyadic grid (every sum exact) and gives the same bits twice."""
    fwd = _hub_tiled(card)
    gen = torch.Generator(device=card).manual_seed(heads)
    vals = _grid(card, gen, fwd.num_buckets, heads, fwd.cap, step=1 / 16,
                 top=1) * fwd.valid.view(fwd.num_buckets, 1, fwd.cap)
    if slot_major:
        vals = tgf._slot_major(vals)
    for side in ("dst", "src"):
        want = tgf.slot_reduce_plain(fwd, vals, side)
        got = tgf.slot_reduce(fwd, vals, side)
        assert torch.equal(got, want)
        assert torch.equal(tgf.slot_reduce(fwd, vals, side), got)
        view = fwd.row_view(side)
        assert (got[view.ptr[1:] == view.ptr[:-1]] == 0).all()


@pytest.mark.parametrize("vec,cpl", [(v, c) for v in (1, 4)
                                     for c in (1, 2, 4, 8)])
def test_row_reduce_registers(card, vec, cpl):
    """Every instance of the row reduce: at most 128 registers a thread,
    no local memory (no spill)."""
    regs, local = tts.reduce_kernel_attrs(vec, cpl, card)
    assert regs <= 128 and local == 0, (regs, local)


@pytest.mark.parametrize("f", [3, 8, 16, 41])
@pytest.mark.parametrize("weighted", [False, True])
def test_k3_walk_bit_for_bit(card, f, weighted):
    """K3 on the row walk by dst (weightless without weights; rows of
    fewer lanes than U at F = 3, 8 and 16) equals its plain version bit
    for bit on a dyadic grid and gives the same bits twice."""
    fwd = _hub_tiled(card)
    gen = torch.Generator(device=card).manual_seed(f)
    x = _grid(card, gen, fwd.num_src, f, step=1 / 16, top=1)
    w = (_grid(card, gen, *fwd.valid.shape, step=1 / 4, top=1) * fwd.valid
         if weighted else None)
    want = tts.tiled_spmm_plain(fwd, x, w)
    before = tts.tiled_spmm.launches
    got = tts.tiled_spmm(fwd, x, slot_weights=w)
    assert tts.tiled_spmm.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(tts.tiled_spmm(fwd, x, slot_weights=w), got)


def test_reduce_k3_probe_retired_kernels(card):
    """``tools/perf_reduce_k3.py`` builds the tiled reduce and the tiled K3
    walk that the row walks replaced, and its three edits of the walks;
    on a grid all give the plain versions' sums."""
    from dgl_tpu_torch.tools import perf_reduce_k3 as trk
    fwd = _hub_tiled(card)
    gen = torch.Generator(device=card).manual_seed(3)
    vals = _grid(card, gen, fwd.num_buckets, 8, fwd.cap, step=1 / 16,
                 top=1) * fwd.valid.view(fwd.num_buckets, 1, fwd.cap)
    for side in ("dst", "src"):
        want = tgf.slot_reduce_plain(fwd, vals, side)
        assert torch.equal(trk.tiled_reduce(fwd, vals, side), want)
        assert torch.equal(trk.nocap_reduce(fwd, vals, side), want)
    x = _grid(card, gen, fwd.num_src, 16, step=1 / 16, top=1)
    w = _grid(card, gen, *fwd.valid.shape, step=1 / 4, top=1) * fwd.valid
    for wi in (None, w):
        want = tts.tiled_spmm_plain(fwd, x, wi)
        assert torch.equal(trk.tiled_k3(fwd, x, wi), want)
        for variant in ("narrow", "rounds"):
            assert torch.equal(trk.variant_k3(variant, fwd, x, wi), want)


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


@pytest.mark.parametrize("f", [1, 8, 16, 41, 128])
@pytest.mark.parametrize("k,n_pad,n_x", [(1003, 5008, 5000),
                                         (77, 23_936, 23_900),
                                         (300, 400, 400)])
def test_int8_rows_tensor_cores_exact_and_repeatable(card, f, k, n_pad,
                                                     n_x):
    """The row kernel (bf16 mma.sync over three parts of x, the contraction
    permuted within each 128 columns) at ragged k (not a multiple of its
    256-row block or 64-row box) and N_pad (not of its 128-column stage),
    x shorter than N_pad, on int8 values over -128..127: exactly the
    plain version on a grid of 2^-12 in [-1/4, 1/4] (values bf16 does not
    hold; every sum exact in f32), two calls the same bits on normal
    inputs, and its instance spills nothing (shared memory, not its
    registers, keeps it at one block an SM)."""
    gen = torch.Generator(device=card).manual_seed(f * 1000 + k)
    a = torch.randint(-128, 128, (k, n_pad), dtype=torch.int8, device=card,
                      generator=gen)
    a *= torch.rand(k, n_pad, device=card, generator=gen) < 0.005
    a[0, 0], a[-1, n_x - 1] = -128, 127
    assert int(a.abs().sum(1, dtype=torch.int64).max()) / 4 < 2 ** 12
    x = torch.randint(-1024, 1025, (n_x, f), device=card,
                      generator=gen).float() * 2.0 ** -12
    before = tgi8.int8_matmul_rows.launches
    got = tgi8.int8_matmul_rows(a, x)
    torch.cuda.synchronize()
    assert tgi8.int8_matmul_rows.launches == before + 1
    assert torch.equal(got, tgi8.int8_matmul_rows_plain(a, x))
    normal = torch.randn(n_x, f, device=card, generator=gen)
    assert torch.equal(tgi8.int8_matmul_rows(a, normal),
                       tgi8.int8_matmul_rows(a, normal))
    regs, local, smem, per_sm = tgi8.rows_kernel_attrs(f)
    assert local == 0 and per_sm == 1 and smem <= 232_448


def test_int8_rows_probe_retired_kernel(card):
    """``tools/perf_scores_rows.py`` builds the f32-FMA row walk that the
    tensor-core product replaced, and on a grid both give the plain
    version's bits."""
    from dgl_tpu_torch.tools import perf_scores_rows as tsr
    a = _int8_block(card, 700, 5008, 5000, density=0.03, seed=5)
    gen = torch.Generator(device=card).manual_seed(5)
    x = torch.randint(-1024, 1025, (5000, 16), device=card,
                      generator=gen).float() * 2.0 ** -12
    want = tgi8.int8_matmul_rows_plain(a, x)
    assert torch.equal(tsr.fma_rows(a, x), want)
    assert torch.equal(tgi8.int8_matmul_rows(a, x), want)


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
    version, the stored slot tensors in ``dtype``; the slot gradient's dFNJ
    too.  Inputs lie on dyadic grids, so every per-slot value and every sum
    over a node's slots is exact in any order; da sums over every slot
    (atol of its magnitude)."""
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
    da, dfe, dfnj = tgf.egatc_slot_grad(fwd, U, V, attn, fe, ds, 0.25)
    want_da, want_dfe, want_dfnj = tgf.egatc_slot_grad_plain(
        fwd, U, V, attn, fe, ds, 0.25)
    assert dfe.dtype == dtype
    dx, dfe2 = tgf.dx_dfe(fwd, zn, p, dtype)
    want_dx, want_dfe2 = tgf.dx_dfe_plain(fwd, zn, p, dtype)
    pairs = [
        (tgf.egatc_scores(fwd, U, V, attn, fe, 0.25),
         tgf.egatc_scores_plain(fwd, U, V, attn, fe, 0.25)),
        (dfe.float(), want_dfe.float()), (dfnj, want_dfnj),
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


# -- K6's ds on the dot-product walk, K9's da folded into its node gradient --

@pytest.mark.parametrize("heads,fh", [(4, 32), (1, 41), (8, 8), (1, 2048),
                                      (8, 256)])
def test_ds_walk_matches_plain_exactly(card, heads, fh):
    """K6's ds through the dot-product walk by dst and its finishing pass,
    equal to its plain version bit for bit in both layouts, on dyadic
    inputs (x, zn, rp and g multiples of 1/16 in [-1, 1]: every dot and
    product is exact in f32), at the main path's widths and on rows over
    1,024 columns (several launches of the walk, the parts added in
    order); 0 at padded slots, the slot-major result a (B, H, C) view of
    a (B, C, H) tensor, a scale applied after the product; one count a
    call."""
    fwd, _, _, _ = _tiled(card)
    gen = torch.Generator(device=card).manual_seed(heads * 1000 + fh)
    b, cap = fwd.num_buckets, fwd.cap
    x = _grid(card, gen, fwd.num_src, heads, fh, step=1 / 16, top=1)
    zn = _grid(card, gen, fwd.num_dst, heads, fh, step=1 / 16, top=1)
    rp = _grid(card, gen, fwd.num_dst, heads, step=1 / 16, top=1)
    g = _grid(card, gen, b, heads, cap, step=1 / 16, top=1) * \
        fwd.valid.view(b, 1, cap)
    want = tgf.gat_ds_plain(fwd, x, zn, rp, g)
    before = tgf.gat_ds.launches
    got = tgf.gat_ds(fwd, x, zn, rp, g)
    sm = tgf.gat_ds(fwd, x, zn, rp, g, slot_major=True)
    scaled = tgf.gat_ds(fwd, x, zn, rp, g, True, 0.125)
    torch.cuda.synchronize()
    assert tgf.gat_ds.launches == before + 3
    assert got.is_contiguous() and torch.equal(got, want)
    assert sm.stride() == (cap * heads, 1, heads) and torch.equal(sm, want)
    assert torch.equal(scaled, want * 0.125)
    pad = fwd.valid.reshape(b, 1, cap) == 0
    assert (sm.masked_select(pad) == 0).all() and pad.any()


def _fold_inputs(card, fwd, heads, dim, seed):
    """U, V, attn on a grid of 1/16 and ds of 1/8 (0 at padded slots),
    slot-major as gat_ds writes it: with a slope of 1/4 every sum of the
    node gradient and of da is exact."""
    gen = torch.Generator(device=card).manual_seed(seed)
    b, cap = fwd.num_buckets, fwd.cap
    U = _grid(card, gen, fwd.num_src, heads, dim, step=1 / 16, top=1)
    V = _grid(card, gen, fwd.num_dst, heads, dim, step=1 / 16, top=1)
    attn = _grid(card, gen, heads, dim, step=1 / 16, top=0.5)
    ds = _grid(card, gen, b, heads, cap, step=1 / 8, top=1) * \
        fwd.valid.view(b, 1, cap)
    return U, V, attn, ds.transpose(1, 2).contiguous().transpose(1, 2)


@pytest.mark.parametrize("heads,dim", [(8, 8), (1, 41), (4, 32), (3, 5),
                                       (1, 600), (4, 160)])
def test_node_grad_da_fold_matches_plain(card, heads, dim):
    """K9's dV and da from the node-gradient walk by dst with da folded
    in: dV the walk without da's, bit for bit, and the plain version's; da
    within ``chip_smoke.close_sum``'s tolerance of the plain slot gradient
    (atol 1e-3 times its largest magnitude: its sums meet in L2 in no
    fixed order), at the main path's widths, a head width that takes
    scalar loads (5) and rows walked in two column chunks ((1, 600), (4,
    160)), where the lanes flush their sums at each chunk; the fold
    spills nothing."""
    fwd, _, _, _ = _tiled(card)
    U, V, attn, ds = _fold_inputs(card, fwd, heads, dim, heads * 10 + dim)
    before = (tgf.vattn_node_grad.launches, tgf.vattn_node_grad_da.launches)
    dv, da = tgf.vattn_node_grad(fwd, U, V, attn, ds, 0.25, "dst",
                                 with_da=True)
    alone = tgf.vattn_node_grad(fwd, U, V, attn, ds, 0.25, "dst")
    torch.cuda.synchronize()
    assert (tgf.vattn_node_grad.launches - before[0],
            tgf.vattn_node_grad_da.launches - before[1]) == (1, 1)
    assert torch.equal(dv, alone)
    assert torch.equal(dv, tgf.vattn_node_grad_plain(fwd, U, V, attn, ds,
                                                     0.25, "dst"))
    want = tgf.vattn_slot_grad_plain(fwd, U, V, attn, ds, 0.25)[0]
    tol = dict(rtol=RTOL, atol=ATOL * max(1.0, float(want.abs().max())))
    torch.testing.assert_close(da, want, **tol)
    # the slot gradient without the edge term launches the same fold
    torch.testing.assert_close(
        tgf.vattn_slot_grad(fwd, U, V, attn, ds, 0.25)[0], want, **tol)
    hp = -(-dim // 4) * 4
    hp = dim if (hp - dim) * 8 > dim else hp
    vec, cpl, _, chunks = tts._row_layout(heads * hp, hp,
                                          max_cpl=tts.FOLD_CPL)
    assert chunks == (2 if (heads, dim) in ((1, 600), (4, 160)) else 1)
    assert tts.node_grad_kernel_attrs(vec, cpl, True)[1] == 0


def test_route5_backward_folds_da_and_copies_no_ds(card, monkeypatch):
    """GATv2's backward on K9: no slot-gradient launch (da comes from the
    walk by dst), ds handed to both node-gradient walks slot-major as
    gat_ds wrote it (no copy), one ds, and every gradient against the
    plain chain."""
    fwd, _, _, _ = _tiled(card)
    fwd = fwd.with_src_first()
    heads, dim, slope = 8, 8, 0.2
    U, V, attn, _, _, _ = _vattn_inputs(card, fwd, heads, dim, 0, False, 5)
    x = torch.randn_like(U)
    dz = torch.randn(fwd.num_dst, heads, dim, device=card)
    seen = []
    walk = tts.row_aggregate

    def spy(tf, side, y3, w_slot, wrapper, *args, **kwargs):
        if wrapper in (tgf.vattn_node_grad, tgf.vattn_node_grad_da):
            seen.append(w_slot.transpose(1, 2).is_contiguous())
        return walk(tf, side, y3, w_slot, wrapper, *args, **kwargs)

    monkeypatch.setattr(tts, "row_aggregate", spy)
    names = ("gat_ds", "vattn_slot_grad", "vattn_node_grad",
             "vattn_node_grad_da")
    before = [getattr(tgf, n).launches for n in names]
    ins = [t.clone().requires_grad_() for t in (U, V, attn, x)]
    out = tgf.gatv2_attention_aggregate(fwd, ins[0], ins[1], ins[3], ins[2],
                                        heads, dim, dim, slope)
    out.backward(dz)
    torch.cuda.synchronize()
    assert [getattr(tgf, n).launches - b
            for n, b in zip(names, before)] == [1, 0, 1, 1]
    assert seen == [True, True]
    p = tgf.vattn_scores_plain(fwd, U, V, attn, slope)
    den = tgf.slot_reduce_plain(fwd, p, "dst").clamp_(min=tgf.DEN_EPS)
    ref = tts.tiled_spmm_multihead_plain(fwd, x, p) / den.unsqueeze(-1)
    zn, rp = tgf._scales(ref, dz, den)
    g = tgf.gat_ds_plain(fwd, x, zn, rp, p)
    want = [tgf.vattn_node_grad_plain(fwd, U, V, attn, g, slope, "src"),
            tgf.vattn_node_grad_plain(fwd, U, V, attn, g, slope, "dst"),
            tgf.vattn_slot_grad_plain(fwd, U, V, attn, g, slope)[0],
            tgf.src_aggregate_plain(fwd, zn, p)]
    for a, w in zip([t.grad for t in ins], want):
        torch.testing.assert_close(a, w, rtol=RTOL, atol=ATOL)


def test_ds_fold_probe_builds_the_retired_kernels(card):
    """``tools/perf_ds_fold.py`` builds the two retired kernels from edits
    of the package's sources: the bucket ds walk equals the dot-product
    walk on dyadic inputs, and the tiled da walk the fold within
    close_sum's tolerance."""
    from dgl_tpu_torch.tools import perf_ds_fold as tdf
    fwd, _, _, _ = _tiled(card)
    gen = torch.Generator(device=card).manual_seed(3)
    b, cap = fwd.num_buckets, fwd.cap
    x = _grid(card, gen, fwd.num_src, 4, 32, step=1 / 16, top=1)
    zn = _grid(card, gen, fwd.num_dst, 4, 32, step=1 / 16, top=1)
    rp = _grid(card, gen, fwd.num_dst, 4, step=1 / 16, top=1)
    g = _grid(card, gen, b, 4, cap, step=1 / 16, top=1) * \
        fwd.valid.view(b, 1, cap)
    assert torch.equal(tdf.bucket_ds(fwd, x, zn, rp, g),
                       tgf.gat_ds(fwd, x, zn, rp, g))
    U, V, attn, ds = _fold_inputs(card, fwd, 8, 8, 4)
    da = tgf.vattn_node_grad(fwd, U, V, attn, ds, 0.25, "dst",
                             with_da=True)[1]
    torch.testing.assert_close(
        tdf.tiled_da(fwd, U, V, attn, ds, 0.25), da, rtol=RTOL,
        atol=ATOL * max(1.0, float(da.abs().max())))


# -- K7's dz on the listed walk by src, K11 v2's slot gradient on the tensor
# cores -------------------------------------------------------------------

DZ_SHAPES = [(2, 64), (1, 128), (4, 32), (3, 8)]


def _dz_case(card, heads, dim, saturate):
    """K7 dz's operands on ``_listed_graph`` (a src hub of 5,000 edges,
    src rows 100-199 without one): q and z on a grid of 1/16 (with
    ``saturate``, z positive and every eighth row of q set so that about
    half of those rows' scores lie past +-40), g normal, linv and rho from
    the plain forward.  (bf, packed_rev, q, z, g, linv, rho, isd)."""
    row, col, n_src, n_dst = _listed_graph()
    bf = tbm.build_bit_format_device(row, col, n_src, n_dst, device=card)
    gen = torch.Generator(device=card).manual_seed(heads * 100 + dim)
    q = _grid(card, gen, n_dst, heads, dim, step=1 / 16, top=1)
    z = _grid(card, gen, n_src, heads, dim, step=1 / 16, top=1)
    if saturate:
        z = z.abs() + 1 / 16
        c = round(40 / (0.5625 * dim ** 0.5) * 16) / 16
        q[::16], q[8::16] = c, -c
    g = torch.randn(n_dst, heads, dim, device=card, generator=gen)
    isd = 1 / dim ** 0.5
    out, l = tbd.bitdot_fwd_plain(bf.packed, q, z, isd)
    linv, rho = tbg.backward_scales(g, out, l, None)
    return bf, (bf.packed_rev, q, z, g, linv, rho, isd)


@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("heads,dim", DZ_SHAPES)
def test_dz_walk_matches_plain(card, heads, dim, saturate):
    """K7's dz, the listed walk by src in the backward's claim order,
    against its plain version; two launches give the same bits, and the
    rows without an edge are 0."""
    bf, args = _dz_case(card, heads, dim, saturate)
    order = tbg.bwd_claim_order(bf)
    before = tbd.bitdot_bwd_dz.launches
    got = tbd.bitdot_bwd_dz(*args, order)
    again = tbd.bitdot_bwd_dz(*args)          # the order built anew
    torch.cuda.synchronize()
    assert tbd.bitdot_bwd_dz.launches - before == 2
    assert torch.equal(got, again)
    assert (got[100:200] == 0).all()
    torch.testing.assert_close(got, tbd.bitdot_bwd_dz_plain(*args),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("heads,dim", DZ_SHAPES)
def test_dz_walk_kernel_attrs(card, heads, dim):
    """The dz walk's instance at the wrapper's layout stays within 128
    registers a thread with no local memory."""
    regs, local, warps = tbd.dz_kernel_attrs(heads, dim)
    assert 0 < regs <= 128 and local == 0 and warps >= 16


def test_dz_walk_through_the_autograd_function(card):
    """``bitdot_attention_aggregate``'s backward launches the dz walk once
    in the format's kept claim order, and its dz equals the plain one."""
    bf, (packed_rev, q, z, g, linv, rho, isd) = _dz_case(card, 2, 64, False)
    zt = z.clone().requires_grad_()
    before = tbd.bitdot_bwd_dz.launches
    tbd.bitdot_attention_aggregate(bf, q, zt).backward(g)
    torch.cuda.synchronize()
    assert tbd.bitdot_bwd_dz.launches - before == 1
    assert bf._bwd_order is not None
    out, l = tbd.bitdot_fwd_plain(bf.packed, q, z, isd)
    linv, rho = tbg.backward_scales(g, out, l, None)
    want = tbd.bitdot_bwd_dz_plain(packed_rev, q, z, g, linv, rho, isd)
    torch.testing.assert_close(zt.grad, want, rtol=RTOL, atol=ATOL)


def _slot_grad_grid(card, fwd, heads, dim, fe, seed):
    """Dyadic inputs of the slot gradient (as chip_smoke's
    slot_grad_grid_checks): U, V and attn multiples of 1/4 in [-1, 1], wf
    with the bias row of 1/4 in [-1/2, 1/2], edge features and ds in {-1,
    0, 1}; with a slope of 1/4 every product is exact in one bf16 part and
    every sum exact in f32 in any order at this graph's 60,000 edges."""
    gen = torch.Generator(device=card).manual_seed(seed)
    b, cap = fwd.num_buckets, fwd.cap
    U = _grid(card, gen, fwd.num_src, heads, dim, step=1 / 4, top=1)
    V = _grid(card, gen, fwd.num_dst, heads, dim, step=1 / 4, top=1)
    attn = _grid(card, gen, heads, dim, step=1 / 4, top=1)
    wf = _grid(card, gen, fe + 1, heads * dim, step=1 / 4, top=0.5)
    ef = _grid(card, gen, b, cap, fe, step=1, top=1) * \
        fwd.valid.view(b, cap, 1)
    ds = _grid(card, gen, b, heads, cap, step=1, top=1) * \
        fwd.valid.view(b, 1, cap)
    return U, V, attn, ds, ef, wf


@pytest.mark.parametrize("fe", [5, 16])
@pytest.mark.parametrize("heads,dim", [(8, 8), (1, 41), (4, 32)])
def test_slot_grad_mma_exact_on_a_grid(card, heads, dim, fe):
    """K11 v2's slot gradient on the tensor cores equals its plain version
    bit for bit on a dyadic grid, with and without d(ef), and a second
    launch gives the same bits."""
    fwd, _, _, _ = _tiled(card)
    args = _slot_grad_grid(card, fwd, heads, dim, fe, heads + dim + fe)
    want = tgf.vattn_slot_grad_plain(fwd, *args[:4], 0.25, *args[4:])
    for need_def in (True, False):
        got = tgf.vattn_slot_grad(fwd, *args[:4], 0.25, *args[4:],
                                  need_def=need_def)
        again = tgf.vattn_slot_grad(fwd, *args[:4], 0.25, *args[4:],
                                    need_def=need_def)
        for name, a, b, w in zip(("da", "d_ef", "dwf"), got, again, want):
            if not need_def and name == "d_ef":
                assert a is None
                continue
            assert torch.equal(a, w), name
            assert torch.equal(b, a), name


@pytest.mark.parametrize("heads,dim,fe,bias", [
    (4, 32, 16, True), (8, 8, 31, True), (2, 100, 12, False),
    (3, 5, 32, False), (128, 1, 7, True)])
def test_slot_grad_mma_matches_plain(card, heads, dim, fe, bias):
    """Normal inputs at the widths and edge rows the wrapper takes (two
    k-steps past 16 features, passes of slices past 128 columns, columns
    not a multiple of 4, 128 heads of one column), with and without d(ef):
    rtol 1e-4 / atol 1e-3, the sums over every slot's atol times their
    largest magnitude; a slope of 1 keeps lrelu's kink out (f32 rounding
    of raw may pick the other slope at a slot)."""
    fwd, _, _, _ = _tiled(card)
    gen = torch.Generator(device=card).manual_seed(heads + dim + fe)
    b, cap = fwd.num_buckets, fwd.cap
    U = torch.randn(fwd.num_src, heads, dim, device=card, generator=gen)
    V = torch.randn(fwd.num_dst, heads, dim, device=card, generator=gen)
    attn = torch.randn(heads, dim, device=card, generator=gen)
    wf = torch.randn(fe + int(bias), heads * dim, device=card,
                     generator=gen) / 4
    ef = torch.randn(b, cap, fe, device=card, generator=gen) * \
        fwd.valid.view(b, cap, 1)
    ds = torch.randn(b, heads, cap, device=card, generator=gen) * \
        fwd.valid.view(b, 1, cap)
    want = tgf.vattn_slot_grad_plain(fwd, U, V, attn, ds, 1.0, ef, wf)
    for need_def in (True, False):
        got = tgf.vattn_slot_grad(fwd, U, V, attn, ds, 1.0, ef, wf,
                                  need_def=need_def)
        for name, a, w in zip(("da", "d_ef", "dwf"), got, want):
            if not need_def and name == "d_ef":
                continue
            scale = 1.0 if name == "d_ef" else max(1.0,
                                                   float(w.abs().max()))
            torch.testing.assert_close(a, w, rtol=RTOL, atol=ATOL * scale)


@pytest.mark.parametrize("fe,need_def", [(16, False), (16, True), (5, False),
                                         (31, False), (31, True)])
def test_slot_grad_mma_kernel_attrs(card, fe, need_def):
    """The tensor-core instances fit an SM; those without d(ef) (EGATConv's
    training step) use no local memory, and with d(ef) at most 8 bytes a
    thread (ptxas spills two words of the 16-feature instance at 168
    registers; PERF.md)."""
    regs, local, per_sm, smem = tgf.slot_grad_kernel_attrs(fe, need_def, 4, 4)
    assert 0 < regs <= 255 and per_sm >= 1 and smem > 0
    assert local <= (8 if need_def else 0)


def test_dz_slot_grad_probe_retired_kernels(card):
    """``tools/perf_dz_slot_grad.py`` builds the warp dz walk and the edge
    instance of the tiled slot gradient the two kernels replaced, and the
    edits u2x and one_part: each against the package's kernel."""
    bf, args = _dz_case(card, 2, 64, False)
    order = tbg.bwd_claim_order(bf)
    new = tbd.bitdot_bwd_dz(*args, order)
    torch.testing.assert_close(tdz.warp_dz(*args), new, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(tdz.dz_edit("u2x", *args, order), new,
                               rtol=RTOL, atol=ATOL)
    fwd, _, _, _ = _tiled(card)
    U, V, attn, ds, ef, wf = _slot_grad_grid(card, fwd, 4, 32, 16, 9)
    new = tgf.vattn_slot_grad(fwd, U, V, attn, ds, 0.25, ef, wf)
    old = tdz.tiled_slot_grad(fwd, U, V, attn, ds, 0.25, ef, wf, True)
    one = tdz.one_part_slot_grad(fwd, U, V, attn, ds, 0.25, ef, wf, True)
    for a, b, c in zip(new, old, one):
        # on the grid every sum is exact: all three agree bit for bit
        assert torch.equal(b, a) and torch.equal(c, a)


def _dq_case(card, heads, dim, saturate):
    """K7 dq's operands on ``_listed_graph`` reversed (16,300 src and
    8,100 dst nodes: dst 7 a hub of 5,000 in-edges, dst rows 100-199
    without one, rows of 510 words reaching bit plane 31), as
    ``_dz_case``'s.  (bf, (packed, q, z, g, linv, rho, isd))."""
    row, col, n_src, n_dst = _listed_graph()
    bf = tbm.build_bit_format_device(col, row, n_dst, n_src, device=card)
    gen = torch.Generator(device=card).manual_seed(heads * 10 + dim)
    q = _grid(card, gen, bf.num_dst, heads, dim, step=1 / 16, top=1)
    z = _grid(card, gen, bf.num_src, heads, dim, step=1 / 16, top=1)
    if saturate:
        z = z.abs() + 1 / 16
        c = round(40 / (0.5625 * dim ** 0.5) * 16) / 16
        q[::16], q[8::16] = c, -c
    g = torch.randn(bf.num_dst, heads, dim, device=card, generator=gen)
    isd = 1 / dim ** 0.5
    out, l = tbd.bitdot_fwd_plain(bf.packed, q, z, isd)
    linv, rho = tbg.backward_scales(g, out, l, None)
    return bf, (bf.packed, q, z, g, linv, rho, isd)


@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("heads,dim", DZ_SHAPES)
def test_dq_walk_matches_plain(card, heads, dim, saturate):
    """K7's dq, the listed walk by dst in the forward's claim order (the
    hub first), against its plain version; two launches give the same
    bits, and the rows without an edge are 0."""
    bf, args = _dq_case(card, heads, dim, saturate)
    order = tbg.fwd_claim_order(bf)
    assert int(order[0]) == 7
    before = tbd.bitdot_bwd_dq.launches
    got = tbd.bitdot_bwd_dq(*args, order)
    again = tbd.bitdot_bwd_dq(*args)          # the order built anew
    torch.cuda.synchronize()
    assert tbd.bitdot_bwd_dq.launches - before == 2
    assert torch.equal(got, again)
    assert (got[100:200] == 0).all()
    torch.testing.assert_close(got, tbd.bitdot_bwd_dq_plain(*args),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("heads,dim", DZ_SHAPES)
def test_dq_walk_kernel_attrs(card, heads, dim):
    """The dq walk's instance at the wrapper's layout stays within 128
    registers a thread with no local memory, 16 warps an SM or more."""
    regs, local, warps = tbd.dq_kernel_attrs(heads, dim)
    assert 0 < regs <= 128 and local == 0 and warps >= 16


def test_dq_walk_through_the_autograd_function(card):
    """``bitdot_attention_aggregate``'s backward launches the dq walk once
    in the format's kept claim order, and its dq equals the plain one."""
    bf, (packed, q, z, g, linv, rho, isd) = _dq_case(card, 2, 64, False)
    qt = q.clone().requires_grad_()
    before = tbd.bitdot_bwd_dq.launches
    tbd.bitdot_attention_aggregate(bf, qt, z).backward(g)
    torch.cuda.synchronize()
    assert tbd.bitdot_bwd_dq.launches - before == 1
    assert bf._fwd_order is not None
    want = tbd.bitdot_bwd_dq_plain(packed, q, z, g, linv, rho, isd)
    torch.testing.assert_close(qt.grad, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fe", [5, 16, 31])
@pytest.mark.parametrize("heads,dim", [(8, 8), (1, 41), (4, 32)])
def test_fe_grad_walk_exact_on_a_grid(card, heads, dim, fe):
    """K11 v2's node gradient, the row walk with the edge term, on both
    sides equals its plain version bit for bit on the slot gradient's
    dyadic grid (raw exact, every sum exact in any order), from a
    slot-major ds (as vattn_backward hands it) and from a (B, H, C) one;
    two launches give the same bits."""
    fwd, _, _, _ = _tiled(card)
    fwd = fwd.with_src_first()
    U, V, attn, ds, ef, wf = _slot_grad_grid(card, fwd, heads, dim, fe,
                                             heads + dim + fe)
    sm = ds.transpose(1, 2).contiguous().transpose(1, 2)
    for side in ("dst", "src"):
        want = tgf.vattn_node_grad_plain(fwd, U, V, attn, ds, 0.25, side, ef,
                                         wf)
        before = tgf.vattn_node_grad.launches
        got = tgf.vattn_node_grad(fwd, U, V, attn, sm, 0.25, side, ef, wf)
        assert want.abs().max() > 0 and torch.equal(got, want)
        assert torch.equal(tgf.vattn_node_grad(fwd, U, V, attn, sm, 0.25,
                                               side, ef, wf), got)
        assert torch.equal(tgf.vattn_node_grad(fwd, U, V, attn, ds, 0.25,
                                               side, ef, wf), got)
        assert tgf.vattn_node_grad.launches == before + 3


@pytest.mark.parametrize("heads,dim,fe,bias", [
    (4, 32, 16, True), (8, 8, 31, True), (2, 100, 12, False),
    (3, 5, 32, False), (128, 1, 7, True), (2, 6, 5, True),
    (1, 300, 16, True)])
def test_fe_grad_walk_matches_plain(card, heads, dim, fe, bias):
    """The widths and edge rows the wrapper takes (columns in two or three
    chunks past 128 floats, heads not a multiple of 4 wide, 2-float and
    1-float loads, 32 features without the bias row, 128 heads of one
    column) at EGAT's slope on both sides: raw exact, ds normal."""
    fwd, _, _, _ = _tiled(card)
    fwd = fwd.with_src_first()
    U, V, attn, ds, ef, wf = _vattn_inputs(card, fwd, heads, dim, fe, bias,
                                           heads + dim + fe)
    for side in ("dst", "src"):
        torch.testing.assert_close(
            tgf.vattn_node_grad(fwd, U, V, attn, ds, 0.01, side, ef, wf),
            tgf.vattn_node_grad_plain(fwd, U, V, attn, ds, 0.01, side, ef,
                                      wf), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("vec,cpl", [(4, 1), (2, 1), (2, 2), (1, 1),
                                     (1, 2), (1, 4)])
@pytest.mark.parametrize("kf", [8, 16, 32])
def test_fe_grad_kernel_attrs(card, vec, cpl, kf):
    """Every instance of the walk with the edge term fits an SM (a lane's
    columns of wf, at most 4 x 32, in registers); those of 16-byte loads,
    which every head width of 4 or more columns a multiple of 4 takes (or
    padded to one, 41 to 44), use no local memory.  At 2-float loads ptxas
    keeps some instances at 64 or 128 registers with a few words of local
    memory."""
    regs, local, per_sm = tts.fe_grad_kernel_attrs(vec, cpl, kf)
    assert 0 < regs <= 255 and per_sm >= 1
    assert local == 0 or vec < 4


def test_dq_node_grad_probe_retired_kernels(card):
    """``tools/perf_dq_node_grad.py`` builds the warp dq walk and the tiled
    node-gradient walk the two kernels replaced, and the edits dz_count and
    double and the narrow layout: each against the package's kernel."""
    bf, args = _dq_case(card, 2, 64, False)
    order = tbg.fwd_claim_order(bf)
    new = tbd.bitdot_bwd_dq(*args, order)
    torch.testing.assert_close(tdq.warp_dq(*args), new, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(tdq.dq_edit("dz_count", *args, order), new,
                               rtol=RTOL, atol=ATOL)
    fwd, _, _, _ = _tiled(card)
    fwd = fwd.with_src_first()
    U, V, attn, ds, ef, wf = _slot_grad_grid(card, fwd, 4, 32, 16, 9)
    for side in ("dst", "src"):
        new = tgf.vattn_node_grad(fwd, U, V, attn, ds, 0.25, side, ef, wf)
        # on the grid every sum is exact: all four agree bit for bit
        assert torch.equal(tdq.tiled_node_grad(fwd, U, V, attn, ds, 0.25,
                                               side, ef, wf), new)
        assert torch.equal(tdq.fe_walk(fwd, U, V, attn, ds, 0.25, side, ef,
                                       wf, "double"), new)
        assert torch.equal(tdq.fe_walk(fwd, U, V, attn, ds, 0.25, side, ef,
                                       wf, layout=tdq.narrow_layout(4, 32)),
                           new)


# -- K10's and K11 v1's slot walks, K10's edge ds on the dot-product walk -----

def _slot_walk_grid(card, fwd, heads, dim, fe, dtype, seed):
    """Dyadic inputs of the slot walks and the edge ds on ``fwd``: x, zn,
    zp and the stored rows (``dtype``) multiples of 1/16 in [-1, 1], p of
    1/16 in [0, 4] slot-major, rp, g and m of 1/16 in [-1, 1] ([-1/4, 1/4]
    for m): every sum of a node's slots and every ds and d(ef) is exact in
    f32, in any order."""
    gen = torch.Generator(device=card).manual_seed(seed)
    b, cap = fwd.num_buckets, fwd.cap
    v_r, v_h = fwd.valid.view(b, cap, 1), fwd.valid.view(b, 1, cap)
    x = _grid(card, gen, fwd.num_src, heads, dim, step=1 / 16, top=1)
    zn = _grid(card, gen, fwd.num_dst, heads, dim, step=1 / 16, top=1)
    st = (_grid(card, gen, b, cap, heads * dim, step=1 / 16, top=1)
          * v_r).to(dtype)
    p = tgf._slot_major(_grid(card, gen, b, heads, cap, step=1 / 16, top=4,
                              low=0) * v_h)
    ef = _grid(card, gen, b, cap, fe, step=1 / 16, top=1) * v_r
    zp = _grid(card, gen, fwd.num_dst, heads, fe, step=1 / 16, top=1)
    rp = _grid(card, gen, fwd.num_dst, heads, step=1 / 16, top=1)
    g = _grid(card, gen, b, heads, cap, step=1 / 16, top=1) * v_h
    m = _grid(card, gen, fe, heads, step=1 / 16, top=0.25)
    return x, zn, st, p, ef, zp, rp, g, m


@pytest.mark.parametrize("heads,dim", [(4, 32), (1, 41), (8, 8), (3, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slot_walks_exact_on_a_grid(card, heads, dim, dtype):
    """The six wrappers on the slot walk and the dot-product walk, each
    bit for bit equal to its plain version on dyadic inputs, and a second
    launch to the same bits; dfe and d(ef) 0 at every padded slot."""
    fwd, _, _, _ = _tiled(card)
    fwd = fwd.with_src_first()
    x, zn, st, p, ef, zp, rp, g, m = _slot_walk_grid(card, fwd, heads, dim,
                                                     5, dtype, heads + dim)
    pad = fwd.valid.view(fwd.num_buckets, fwd.cap) == 0
    pairs = [(lambda: tgf.fe_aggregate(fwd, x, st, p),
              tgf.fe_aggregate_plain(fwd, x, st, p)),
             (lambda: tgf.dx_dfe(fwd, zn, p, dtype),
              tgf.dx_dfe_plain(fwd, zn, p, dtype)),
             (lambda: tgf.slot_vec_reduce(fwd, st, "dst"),
              tgf.slot_vec_reduce_plain(fwd, st, "dst")),
             (lambda: tgf.slot_vec_reduce(fwd, st, "src"),
              tgf.slot_vec_reduce_plain(fwd, st, "src")),
             (lambda: tgf.fe_ds(fwd, x, st, zn, rp, g),
              tgf.fe_ds_plain(fwd, x, st, zn, rp, g)),
             (lambda: tgf.slot_feat_reduce(fwd, p, ef),
              tgf.slot_feat_reduce_plain(fwd, p, ef)),
             (lambda: tgf.edgegat_ds(fwd, x, zn, rp, g, ef, zp),
              tgf.edgegat_ds_plain(fwd, x, zn, rp, g, ef, zp)),
             (lambda: tgf.edgegat_ds(fwd, x, zn, rp, g, ef, zp, p, m),
              tgf.edgegat_ds_plain(fwd, x, zn, rp, g, ef, zp, p, m))]
    for i, (kernel, want) in enumerate(pairs):
        for _ in range(2):
            got = kernel()
            for a, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                if w is None:
                    assert a is None
                    continue
                assert torch.equal(a, w), (i, float((a.float() - w.float())
                                                    .abs().max()))
    dfe = tgf.dx_dfe(fwd, zn, p, dtype)[1]
    d_ef = tgf.edgegat_ds(fwd, x, zn, rp, g, ef, zp, p, m)[1]
    assert (dfe[pad] == 0).all() and (d_ef[pad] == 0).all()


@pytest.mark.parametrize("fe", [36, 1])
def test_edge_ds_any_feature_count(card, fe):
    """K10 v2's ds with d(ef) past 32 edge features (the pass's d(ef) after
    the heads, Zp read again) and at one feature: bit for bit on a grid."""
    fwd, _, _, _ = _tiled(card)
    x, zn, _, p, ef, zp, rp, g, m = _slot_walk_grid(card, fwd, 4, 8, fe,
                                                    torch.float32, fe)
    got = tgf.edgegat_ds(fwd, x, zn, rp, g, ef, zp, p, m)
    want = tgf.edgegat_ds_plain(fwd, x, zn, rp, g, ef, zp, p, m)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("mode", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slot_walk_main_instances_spill_nothing(card, mode, dtype):
    """The slot walk's instances at the main path's layouts (16-byte loads,
    one vector a lane: 128 and 64 columns) keep every value in registers,
    and one block an SM fits."""
    if mode == tts.SLOT_FEAT and dtype != torch.float32:
        pytest.skip("K10 v2's edge features are f32")
    regs, local, per_sm = tts.slot_kernel_attrs(mode, dtype, 4, 1)
    assert 0 < regs <= 128 and local == 0 and per_sm >= 2


def test_slot_walks_probe_retired_kernels(card):
    """``tools/perf_slot_walks.py`` builds the bucket walks the slot walk
    and the edge ds replaced, and the edit half: on a grid each equals the
    package's kernel bit for bit."""
    from dgl_tpu_torch.tools import perf_slot_walks as tsl
    fwd, _, _, _ = _tiled(card)
    fwd = fwd.with_src_first()
    heads, dim = 4, 32
    f = heads * dim
    x, zn, st, p, ef, zp, rp, g, m = _slot_walk_grid(card, fwd, heads, dim,
                                                     16, torch.float32, 17)
    pc = p.contiguous()
    slots = fwd.num_buckets * fwd.cap
    new = tgf.fe_aggregate(fwd, x, st, p).view(-1, f)
    assert torch.equal(tsl.tiled_slot_agg(fwd, tts.SLOT_FE, st, heads, dim,
                                          pc, x), new)
    out = torch.empty_like(new)
    tsl.slot_edit("half", fwd, tts.SLOT_FE, st.view(slots, f), out, p,
                  x.view(-1, f), dim)
    assert torch.equal(out, new)
    for mode, side in ((tts.SLOT_VEC_DST, "dst"), (tts.SLOT_VEC_SRC, "src")):
        assert torch.equal(tsl.tiled_slot_agg(fwd, mode, st, 1, f),
                           tgf.slot_vec_reduce(fwd, st, side))
    dx, dfe = tgf.dx_dfe(fwd, zn, p)
    dfe_old = torch.empty_like(dfe)
    assert torch.equal(tsl.tiled_slot_agg(fwd, tts.SLOT_DX_DFE, dfe_old,
                                          heads, dim, pc, zn),
                       dx.view(-1, f))
    assert torch.equal(dfe_old, dfe)
    assert torch.equal(tsl.tiled_feat_reduce(fwd, pc, ef),
                       tgf.slot_feat_reduce(fwd, p, ef))
    for extra in ((), (pc, m)):
        old = tsl.bucket_ds(fwd, x, zn, rp, g, ef, zp, *extra)
        new = tgf.edgegat_ds(fwd, x, zn, rp, g, ef, zp,
                             *((p, m) if extra else ()))
        for a, b in zip(old, new):
            assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(tsl.bucket_ds(fwd, x, zn, rp, g, fe_s=st)[0],
                       tgf.fe_ds(fwd, x, st, zn, rp, g))


# -- K7's forward on the listed walk by dst, K11's scores on the dot-product
# -- walk by dst ---------------------------------------------------------

FWD_SHAPES = [(2, 64), (1, 128), (4, 32), (3, 8), (1, 41)]
# DotGatConv's gate (D >= 64, H D <= 128): the forward's instances there
FWD_GATE = [(2, 64), (1, 128), (1, 64), (1, 65)]
FWD_EMPTY = range(100, 150)


def _dst_hub_coo():
    """The simple COO above with dst 7 a hub of 3,000 distinct src (its
    list drained when full, many times) and the dst rows FWD_EMPTY with no
    edge."""
    row, col, n_src, n_dst = _simple_coo()
    keep = (col < FWD_EMPTY.start) | (col >= FWD_EMPTY.stop)
    hub = np.random.default_rng(7).permutation(n_src)[:3000]
    row = np.concatenate([row[keep], hub])
    col = np.concatenate([col[keep], np.full(3000, 7)])
    key = np.unique(col * n_src + row)
    return key % n_src, key // n_src, n_src, n_dst


@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("heads,dim", FWD_SHAPES)
def test_bitdot_fwd_walk_matches_plain(card, heads, dim, saturate):
    """K7's forward, the listed walk by dst, against its plain version on a
    graph with a dst hub and dst rows with no edge, in the forward's claim
    order (the hub first) and with none given: out and l within tolerance,
    the same bits twice and in either order, the empty rows exactly 0, one
    count a call."""
    row, col, n_src, n_dst = _dst_hub_coo()
    bf = tbm.build_bit_format_device(row, col, n_src, n_dst, device=card)
    order = tbg.fwd_claim_order(bf)
    assert int(order[0]) == 7
    q, z, _ = _bitdot_inputs(card, n_src, n_dst, heads, dim, heads + dim,
                             saturate)
    isd = 1 / math.sqrt(dim)
    before = tbd.bitdot_fwd.launches
    out, l = tbd.bitdot_fwd(bf.packed, q, z, isd, order)
    again = tbd.bitdot_fwd(bf.packed, q, z, isd, order)
    unordered = tbd.bitdot_fwd(bf.packed, q, z, isd)
    torch.cuda.synchronize()
    assert tbd.bitdot_fwd.launches == before + 3
    for a, b in zip((out, l), again):
        assert torch.equal(a, b)
    for a, b in zip((out, l), unordered):
        assert torch.equal(a, b)
    want_out, want_l = tbd.bitdot_fwd_plain(bf.packed, q, z, isd)
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(l, want_l, rtol=1e-4, atol=1e-4)
    assert not out[FWD_EMPTY.start:FWD_EMPTY.stop].any()
    assert not l[FWD_EMPTY.start:FWD_EMPTY.stop].any()
    # every score 0: l is each dst's in-degree, exactly
    l0 = tbd.bitdot_fwd(bf.packed, torch.zeros_like(q), z, isd, order)[1]
    deg = torch.bincount(torch.as_tensor(col, device=card),
                         minlength=n_dst).float()
    assert torch.equal(l0, deg.unsqueeze(1).expand_as(l0))


@pytest.mark.parametrize("heads,dim", FWD_GATE + [(4, 32), (3, 8), (1, 41)])
def test_bitdot_fwd_walk_attrs(card, heads, dim):
    """The forward's instances behind DotGatConv's gate take at most 128
    registers a thread and no local memory; every instance fits 16 warps
    an SM."""
    regs, local, warps = tbd.fwd_kernel_attrs(heads, dim)
    assert warps == 16
    if (heads, dim) in FWD_GATE:
        assert regs <= 128 and local == 0, (regs, local)


def _plain_logits(tf, U, V, attn, slope, ef=None, wf=None, fe=None):
    """The plain versions' sum_d attn lrelu(raw) (B, H, C), 0 at padded
    slots, raw formed by their own helper."""
    out = torch.zeros(tf.num_buckets, U.shape[1], tf.cap, device=U.device)
    for b, c, src, dst in tts._slot_chunks(tf):
        raw = tgf._vattn_raw(U, V, src, dst,
                             None if ef is None else ef[b, c], wf,
                             None if fe is None else fe[b, c])
        out[b, :, c] = (torch.nn.functional.leaky_relu(raw, slope)
                        * attn.float()).sum(-1)
    return out


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("fe", [5, 16, 31])
@pytest.mark.parametrize("heads,dim", [(8, 8), (1, 41), (4, 32)])
def test_vattn_scores_edge_walk_exact(card, heads, dim, fe, bias):
    """K11 v2's scores on the dot-product walk with the edge term formed
    per entry: the raw sums bit for bit against the plain version's on a
    dyadic grid at a slope of 1/4, p within tolerance at EGAT's slope, the
    same bits twice, one count a call."""
    fwd, _, _, _ = _tiled(card)
    U, V, attn, _, ef, wf = _vattn_inputs(card, fwd, heads, dim, fe, bias,
                                          heads * dim + fe)
    raw = tgf._vattn_scores_walk(fwd, U, V, attn, 0.25, edge=(ef, wf),
                                 exp_clip=False)
    want = _plain_logits(fwd, U, V, attn, 0.25, ef, wf)
    assert want.abs().max() > 0 and torch.equal(raw, want)
    before = tgf.vattn_scores.launches
    p = tgf.vattn_scores(fwd, U, V, attn, 0.01, ef, wf)
    assert torch.equal(tgf.vattn_scores(fwd, U, V, attn, 0.01, ef, wf), p)
    assert tgf.vattn_scores.launches == before + 2
    torch.testing.assert_close(
        p, tgf.vattn_scores_plain(fwd, U, V, attn, 0.01, ef, wf),
        rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dim", [(4, 32), (1, 41), (8, 8), (3, 5)])
def test_egatc_scores_walk_exact(card, heads, dim, dtype):
    """K11 v1's scores on the dot-product walk with the stored row: the raw
    sums bit for bit against the plain version's on a dyadic grid (the
    stored rows exact in bf16), p within tolerance, the same bits twice."""
    fwd, _, _, _ = _tiled(card)
    U, V, attn, _, _, _ = _vattn_inputs(card, fwd, heads, dim, 0, False,
                                        heads + dim)
    gen = torch.Generator(device=card).manual_seed(dim)
    b, cap = fwd.num_buckets, fwd.cap
    fe = (torch.randint(-8, 9, (b, cap, heads * dim), device=card,
                        generator=gen).float() / 16
          * fwd.valid.view(b, cap, 1)).to(dtype)
    raw = tgf._vattn_scores_walk(fwd, U, V, attn, 0.25, fe_slot=fe,
                                 exp_clip=False)
    want = _plain_logits(fwd, U, V, attn, 0.25, fe=fe)
    assert want.abs().max() > 0 and torch.equal(raw, want)
    before = tgf.egatc_scores.launches
    p = tgf.egatc_scores(fwd, U, V, attn, fe, 0.01)
    assert torch.equal(tgf.egatc_scores(fwd, U, V, attn, fe, 0.01), p)
    assert tgf.egatc_scores.launches == before + 2
    torch.testing.assert_close(
        p, tgf.egatc_scores_plain(fwd, U, V, attn, fe, 0.01), rtol=1e-4,
        atol=1e-6)


def test_scores_walks_attrs(card):
    """K11 v2's scores walk at 16 edge features (EGAT's) fits 2 blocks an
    SM in at most 128 registers, with at most 16 bytes of local memory a
    thread; at 8 in no local memory; K11 v1's instances at the layouts of
    (4, 32), (8, 8) and (1, 41) (one and two vectors a lane) take at most
    128 registers and no local memory in both stored dtypes."""
    regs, local, blocks = tts.vattn_fe_kernel_attrs(16)
    assert regs <= 128 and local <= 16 and blocks == 2, (regs, local)
    assert tts.vattn_fe_kernel_attrs(8)[1] == 0
    assert tts.vattn_fe_kernel_attrs(32)[0] > 0
    for cpl in (1, 2):
        for dtype in (torch.float32, torch.bfloat16):
            regs, local, _ = tts.store_kernel_attrs(cpl, dtype, True)
            assert regs <= 128 and local == 0, (cpl, dtype, regs, local)


def test_fwd_scores_probe_retired_kernels(card):
    """``tools/perf_fwd_scores.py``: the retired warp walk gives the
    forward's out and l, the retired bucket walk K11's p (v2's, v1's on
    f32 and bf16 rows) within tolerance, and each edit of a new walk its
    bits."""
    from dgl_tpu_torch.tools import perf_fwd_scores as tfs
    row, col, n_src, n_dst = _dst_hub_coo()
    bf = tbm.build_bit_format_device(row, col, n_src, n_dst, device=card)
    order = tbg.fwd_claim_order(bf)
    for heads, dim in ((2, 64), (1, 128)):
        q, z, _ = _bitdot_inputs(card, n_src, n_dst, heads, dim, 5)
        new = tbd.bitdot_fwd(bf.packed, q, z, 1 / math.sqrt(dim), order)
        for a, b in zip(tfs.warp_fwd(bf.packed, q, z, 1 / math.sqrt(dim)),
                        new):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        for a, b in zip(tfs.fwd_edit("u2x", bf.packed, q, z,
                                     1 / math.sqrt(dim), order), new):
            assert torch.equal(a, b)
    fwd, _, _, _ = _tiled(card)
    U, V, attn, _, ef, wf = _vattn_inputs(card, fwd, 4, 32, 16, True, 9)
    p = tgf.vattn_scores(fwd, U, V, attn, 0.01, ef, wf)
    torch.testing.assert_close(tfs.bucket_scores(fwd, U, V, attn, 0.01, ef,
                                                 wf), p, rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(tfs.scores_edit("u2x", fwd, U, V, attn, 0.01, ef,
                                       wf), p)
    fe = (torch.randn(fwd.num_buckets, fwd.cap, 128, device=card)
          * fwd.valid.view(fwd.num_buckets, fwd.cap, 1))
    for t in (fe, fe.to(torch.bfloat16)):
        torch.testing.assert_close(
            tfs.bucket_scores(fwd, U, V, attn, 0.01, fe_slot=t),
            tgf.egatc_scores(fwd, U, V, attn, t, 0.01), rtol=RTOL, atol=ATOL)


# -- K11 v1's slot gradient on the slot walk, K10 v2's scores -----------------

def _slot_grad_inputs(card, tf, heads, dim, dtype, seed):
    """U, V (multiples of 1/16 in [-1, 1]), attn and FE (of 1/16 in [-1/2,
    1/2], FE in ``dtype``, 0 at padded slots) and ds (of 1/8 in [-1, 1]):
    with slope 0.25 every dW lies on 1/512 and every sum is exact."""
    gen = torch.Generator(device=card).manual_seed(seed)
    b, cap = tf.num_buckets, tf.cap
    U = _grid(card, gen, tf.num_src, heads, dim, step=1 / 16, top=1)
    V = _grid(card, gen, tf.num_dst, heads, dim, step=1 / 16, top=1)
    attn = _grid(card, gen, heads, dim, step=1 / 16, top=0.5)
    fe = (_grid(card, gen, b, cap, heads * dim, step=1 / 16, top=0.5)
          * tf.valid.view(b, cap, 1)).to(dtype)
    ds = _grid(card, gen, b, heads, cap, step=1 / 8, top=1) * \
        tf.valid.view(b, 1, cap)
    return U, V, attn, fe, ds


@pytest.mark.parametrize("heads,dim", [(4, 32), (1, 41), (8, 8), (2, 64),
                                       (4, 80), (3, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slot_grad_walk_bit_for_bit(card, heads, dim, dtype):
    """K11 v1's slot gradient on the hub graph (dst hubs, rows with no
    entry): da, dFE and dFNJ equal the plain version's bit for bit with ds
    slot-major and in (B, H, C), twice; dFE 0 at the padded slots, dFNJ 0
    on the empty rows and equal to the slot vector sum of dFE by dst (the
    sum it took over) bit for bit; one launch a call."""
    fwd = _hub_tiled(card)
    U, V, attn, fe, ds = _slot_grad_inputs(card, fwd, heads, dim, dtype,
                                           heads * 100 + dim)
    want = tgf.egatc_slot_grad_plain(fwd, U, V, attn, fe, ds, 0.25)
    before = tgf.egatc_slot_grad.launches
    for layout in (ds, tgf._slot_major(ds), tgf._slot_major(ds)):
        got = tgf.egatc_slot_grad(fwd, U, V, attn, fe, layout, 0.25)
        for a, w in zip(got, want):
            assert torch.equal(a, w)
    torch.cuda.synchronize()
    assert tgf.egatc_slot_grad.launches == before + 3
    assert got[1].dtype == dtype
    b, cap = fwd.num_buckets, fwd.cap
    assert (got[1].masked_select(fwd.valid.view(b, cap, 1) == 0) == 0).all()
    view = fwd.row_view("dst")
    empty = (view.ptr[1:] - view.ptr[:-1]) == 0
    assert empty.any() and (got[2][empty] == 0).all()
    assert torch.equal(got[2], tgf.slot_vec_reduce(fwd, got[1], "dst"))


def test_slot_grad_walk_normal_inputs(card):
    """On normal inputs the slot gradient is close to its plain version
    (da's atol scaled by its magnitude), dFNJ equals the slot vector sum of
    its dFE bit for bit, and two launches give the same bits."""
    fwd = _hub_tiled(card)
    gen = torch.Generator(device=card).manual_seed(3)
    b, cap = fwd.num_buckets, fwd.cap
    U = torch.randn(fwd.num_src, 4, 32, device=card, generator=gen)
    V = torch.randn(fwd.num_dst, 4, 32, device=card, generator=gen)
    attn = torch.randn(4, 32, device=card, generator=gen)
    fe = torch.randn(b, cap, 128, device=card, generator=gen) * \
        fwd.valid.view(b, cap, 1)
    ds = torch.randn(b, 4, cap, device=card, generator=gen) * \
        fwd.valid.view(b, 1, cap)
    got = tgf.egatc_slot_grad(fwd, U, V, attn, fe, ds, 0.2)
    again = tgf.egatc_slot_grad(fwd, U, V, attn, fe, ds, 0.2)
    for a, w in zip(got, again):
        assert torch.equal(a, w)
    want = tgf.egatc_slot_grad_plain(fwd, U, V, attn, fe, ds, 0.2)
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL * max(
        1.0, float(want[0].abs().max())))
    for a, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, w, rtol=RTOL, atol=ATOL)
    assert torch.equal(got[2], tgf.slot_vec_reduce(fwd, got[1], "dst"))


def test_slot_grad_walk_attrs(card):
    """The slot-gradient walk's main instances (one vector of 4 floats a
    lane, f32 and bf16 rows: EGATConv's (4, 32)) take no local memory and
    at most 128 registers; every instance builds and reports its
    attributes."""
    for dtype in (torch.float32, torch.bfloat16):
        regs, local, blocks = tts.slot_grad_kernel_attrs(dtype, 4, 1)
        assert regs <= 128 and local == 0 and blocks >= 2, (regs, local)
        for vec, cpl in ((4, 2), (1, 1), (1, 2), (1, 4)):
            assert tts.slot_grad_kernel_attrs(dtype, vec, cpl)[0] > 0


def test_egatc_v1_step_launches(card):
    """EGATConv v1's backward through the autograd function: one slot
    gradient and one slot vector sum (dFNI) a step, every gradient equal to
    the plain versions' chain on dyadic inputs."""
    fwd = _hub_tiled(card)
    heads, dim = 4, 32
    U, V, attn, fe, _ = _slot_grad_inputs(card, fwd, heads, dim,
                                          torch.float32, 7)
    gen = torch.Generator(device=card).manual_seed(8)
    x = _grid(card, gen, fwd.num_src, heads, dim, step=1 / 16, top=1)
    leaves = [t.clone().requires_grad_() for t in (U, V, fe, attn, x)]
    before = (tgf.egatc_slot_grad.launches, tgf.slot_vec_reduce.launches)
    out = tgf.egatconv_attention_aggregate(fwd, *leaves[:3], leaves[3],
                                           leaves[4], heads, dim, dim, 0.25)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (tgf.egatc_slot_grad.launches - before[0],
            tgf.slot_vec_reduce.launches - before[1]) == (1, 1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in leaves)


@pytest.mark.parametrize("fe", [1, 4, 5, 8, 12, 16, 31, 32])
@pytest.mark.parametrize("heads", [1, 4, 8])
def test_edge_scores_bit_for_bit(card, heads, fe):
    """K10 v2's scores (each lane's own row) equal the plain version bit
    for bit on dyadic inputs (the logit exact, the same expf), twice, and
    the kernel they replaced and the staged design
    (``tools/perf_slot_grad_scores.py``) bit for bit on normal inputs,
    with ef 16-byte aligned and not; p and g 0 at padded slots."""
    from dgl_tpu_torch.tools import perf_slot_grad_scores as tsg
    fwd = _hub_tiled(card)
    b, cap = fwd.num_buckets, fwd.cap
    gen = torch.Generator(device=card).manual_seed(heads * 100 + fe)
    el = _grid(card, gen, fwd.num_src, heads, step=1 / 16, top=1)
    er = _grid(card, gen, fwd.num_dst, heads, step=1 / 16, top=1)
    ef = torch.randint(-1, 2, (b, cap, fe), device=card,
                       generator=gen).float() * fwd.valid.view(b, cap, 1)
    m = _grid(card, gen, fe, heads, step=1 / 256, top=0.5)
    want = tgf.edgegat_scores_plain(fwd, el, er, ef, m, 0.2)
    for _ in range(2):
        for a, w in zip(tgf.edgegat_scores(fwd, el, er, ef, m, 0.2), want):
            assert torch.equal(a, w)
    pad = fwd.valid.view(b, 1, cap) == 0
    assert (want[0].masked_select(pad) == 0).all()
    el, er = (torch.randn(n, heads, device=card, generator=gen)
              for n in (fwd.num_src, fwd.num_dst))
    ef = torch.randn(b, cap, fe, device=card, generator=gen) * \
        fwd.valid.view(b, cap, 1)
    m = torch.randn(fe, heads, device=card, generator=gen)
    new = tgf.edgegat_scores(fwd, el, er, ef, m, 0.2)
    for a, w in zip(new, tsg.thread_scores(fwd, el, er, 0.2, ef_slot=ef,
                                           m=m)):
        assert torch.equal(a, w)
    for a, w in zip(new, tsg.staged_scores(fwd, el, er, ef, m, 0.2)):
        assert torch.equal(a, w)
    odd = torch.empty(ef.numel() + 1, device=card)[1:].view(ef.shape)
    odd.copy_(ef)
    for a, w in zip(tgf.edgegat_scores(fwd, el, er, odd, m, 0.2), new):
        assert torch.equal(a, w)


def test_edge_scores_attrs_and_gate(card):
    """The scores at EdgeGATConv's 16 features and at 5 and 31 take no
    local memory; the gate asks only that M fit a block, so a width whose
    staged rows would not fit 8 warps of the staged design runs on the
    kernel and equals the plain version."""
    from dgl_tpu_torch.tools import perf_slot_grad_scores as tsg
    regs, local, blocks = tgf.edge_scores_kernel_attrs(16, 4)
    assert local == 0 and blocks >= 2, (regs, local, blocks)
    for fe in (5, 31):
        assert tgf.edge_scores_kernel_attrs(fe, 4)[1] == 0
    fwd = _hub_tiled(card)
    b, cap, fe = fwd.num_buckets, fwd.cap, 300
    assert tsg.staged_scores_warps(fe, 1, True) < 8 and \
        tgf.edgegat_fits(1, fe) and tgf.edgegat_fits(1, 2000)
    gen = torch.Generator(device=card).manual_seed(4)
    el = _grid(card, gen, fwd.num_src, 1, step=1 / 16, top=1)
    er = _grid(card, gen, fwd.num_dst, 1, step=1 / 16, top=1)
    ef = torch.randint(-1, 2, (b, cap, fe), device=card,
                       generator=gen).float() * fwd.valid.view(b, cap, 1)
    m = _grid(card, gen, fe, 1, step=1 / 256, top=0.0625)
    for a, w in zip(tgf.edgegat_scores(fwd, el, er, ef, m, 0.2),
                    tgf.edgegat_scores_plain(fwd, el, er, ef, m, 0.2)):
        assert torch.equal(a, w)


def test_k6_scores_keep_their_bits(card):
    """K6's and K10 v1's instances of the scores (gat_scores_kernel<kBias>)
    give the bits of the retired template's same instances."""
    from dgl_tpu_torch.tools import perf_slot_grad_scores as tsg
    fwd, _, _, _ = _tiled(card)
    b, cap = fwd.num_buckets, fwd.cap
    gen = torch.Generator(device=card).manual_seed(5)
    el = torch.randn(fwd.num_src, 4, device=card, generator=gen)
    er = torch.randn(fwd.num_dst, 4, device=card, generator=gen)
    ee = torch.randn(b, 4, cap, device=card, generator=gen)
    for extra in ({}, {"ee_slot": ee}):
        for a, w in zip(tgf.gat_scores(fwd, el, er, 0.2, **extra),
                        tsg.thread_scores(fwd, el, er, 0.2, **extra)):
            assert torch.equal(a, w)


def test_slot_grad_scores_probe(card):
    """``tools/perf_slot_grad_scores.py``: the retired bucket walk gives
    the slot gradient's dFE and da on a grid (da exact in any order), the
    edit ``unfolded`` its dFE and da bit for bit, the edits of the
    entries in flight at one float a load its da, dFE and dFNJ bit for bit
    at (1, 41), the staged design the scores' p and g bit for bit;
    ``perf_ds_fold``'s K9 instances of the retired walk, built from the
    probe source, give K9's da."""
    from dgl_tpu_torch.tools import perf_ds_fold as tdf
    from dgl_tpu_torch.tools import perf_slot_grad_scores as tsg
    fwd = _hub_tiled(card)
    for dtype in (torch.float32, torch.bfloat16):
        U, V, attn, fe, ds = _slot_grad_inputs(card, fwd, 4, 32, dtype, 9)
        new = tgf.egatc_slot_grad(fwd, U, V, attn, fe, ds, 0.25)
        old = tsg.bucket_slot_grad(fwd, U, V, attn, fe, ds, 0.25)
        assert torch.equal(old[0], new[0]) and torch.equal(old[1], new[1])
        un = tsg.grad_edit("unfolded", fwd, U, V, attn, fe, ds, 0.25)
        assert torch.equal(un[0], new[0]) and torch.equal(un[1], new[1])
        U, V, attn, fe, ds = _slot_grad_inputs(card, fwd, 1, 41, dtype, 12)
        new = tgf.egatc_slot_grad(fwd, U, V, attn, fe, ds, 0.25)
        for name in ("vec1_unroll4", "vec1_unroll2"):
            for a, w in zip(tsg.grad_edit(name, fwd, U, V, attn, fe, ds,
                                          0.25), new):
                assert torch.equal(a, w), name
    gen = torch.Generator(device=card).manual_seed(10)
    b, cap = fwd.num_buckets, fwd.cap
    el = torch.randn(fwd.num_src, 4, device=card, generator=gen)
    er = torch.randn(fwd.num_dst, 4, device=card, generator=gen)
    ef = torch.randn(b, cap, 16, device=card, generator=gen) * \
        fwd.valid.view(b, cap, 1)
    m = torch.randn(16, 4, device=card, generator=gen)
    for a, w in zip(tsg.staged_scores(fwd, el, er, ef, m, 0.2),
                    tgf.edgegat_scores(fwd, el, er, ef, m, 0.2)):
        assert torch.equal(a, w)
    for variant in (None, *tsg.GRAD_EDITS):
        regs, local, _ = tsg.grad_attrs(torch.float32, 4, 1, variant)
        assert regs > 0 and local == 0
    for staged in (False, True):
        assert tsg.scores_attrs(16, 4, staged)[1] == 0
    U, V, attn, _, ds = _slot_grad_inputs(card, fwd, 8, 8, torch.float32, 11)
    da = tgf.vattn_node_grad_da(fwd, U, V, attn, ds, 0.25)[1]
    torch.testing.assert_close(tdf.tiled_da(fwd, U, V, attn, ds, 0.25), da,
                               rtol=RTOL, atol=ATOL * max(
                                   1.0, float(da.abs().max())))
