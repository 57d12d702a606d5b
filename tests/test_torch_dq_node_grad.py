"""K7's dq and K11 v2's node gradient as redesigned for Hopper, rendered on
the CPU: no compiler and no card here, so each rendering repeats its
kernel's index arithmetic in numpy.  No JAX here: the plain versions these
renderings are held to are held to the JAX functions by
``test_torch_bitdot.py`` and ``test_torch_gatv2.py``.

* K7's dq as a listed-bit walk by dst (``csrc/bitdot.cu``
  ``bitdot_dq_list_kernel``), lane by lane with the wrapper's layout
  (``bitdot.dz_layout``, the dz walk's): rows claimed in the forward's
  claim order, each row's lists filled and drained at ``kListDrainAt``
  (the listing shared with K5's walks, ``csrc/bitlist.cuh``, rendered by
  ``bit_listing``), groups of lpe lanes an entry, U entries in flight
  (``DqUnroll``), z . q and g . z per head over the lanes of the head's
  block, and the groups' sums combined in a fixed order at the row's end;
  held to ``bitdot_bwd_dq_plain`` at (2, 64), (1, 128), (4, 32) and (3,
  8), on a graph with a dst hub whose list fills several times and dst
  rows with no bit, with scores past +-40, at rtol 1e-4 / atol 1e-4 (sums
  of up to 600 entries in another order), and bit for bit on a dyadic
  grid where every score is 0 and isd is a power of two;
* K11 v2's node gradient as the row walk with the edge term
  (``csrc/row_agg.cu`` ``row_fe_grad_kernel``) on the operands the
  wrapper builds (``tiled_spmm.edge_operands``, ``pad_heads``) at its
  layout (``tiled_spmm.fe_layout``), lane by lane: each lane's columns and
  heads, its columns of wf, the bias row added to the row's own operand
  once, fe formed per entry from the padded edge-feature row read at the
  view's slot, raw and the select of
  lrelu's slope, each sum in slot order and attn applied once; on both
  sides at (8, 8), (1, 41) and (4, 32) with 5, 16 and 31 edge features,
  with and without the bias row: bit for bit against
  ``vattn_node_grad_plain`` on a dyadic grid, and at rtol 1e-4 / atol
  1e-3 on normal inputs;
* the layouts and unrolls in Python are the sources', ``vattn_backward``
  lays ds out once, the retired kernels are gone from
  ``dgl_tpu_torch/csrc/`` and ``ops/``, and the probe's edits apply.
"""
import math
import re
import unittest.mock as mock

import numpy as np
import pytest
import torch

import dgl_tpu_torch.ops.kernels.bitdot as tbd
import dgl_tpu_torch.ops.kernels.bitgat as tbg
import dgl_tpu_torch.ops.kernels.bitmm as tbm
import dgl_tpu_torch.ops.kernels.gat_fused as tgf
import dgl_tpu_torch.ops.kernels.tiled_spmm as tts
from dgl_tpu_torch.tools import perf_bwd_walks as tbw
from dgl_tpu_torch.tools import perf_dq_node_grad as tdq
from bit_listing import LANE, _drains

CSRC = tbd.build.CSRC_DIR
DQ_TOL = dict(rtol=1e-4, atol=1e-4)
RTOL, ATOL = 1e-4, 1e-3
CLIP = 40.0
DQ_UNROLL = {1: 8, 2: 4, 3: 1, 4: 1}      # csrc/bitdot.cu DqUnroll
SHAPES = [(2, 64), (1, 128), (4, 32), (3, 8)]
VATTN_SHAPES = [(8, 8), (1, 41), (4, 32)]
FES = [5, 16, 31]
F32 = np.float32
HUB, EMPTY = 7, range(200, 220)


def _fma(a, b, c):
    """fmaf on f32 arrays: the exact product plus c, rounded once (through
    f64, whose 53 bits hold the product of two f32 exactly)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(F32)


# -- K7's dq: the listed walk by dst --------------------------------------------

@pytest.fixture(scope="module")
def dq_graph():
    """Simple edges src -> dst: dst row HUB a hub of 600 in-edges (its
    list drained when full, several times), dst rows EMPTY with none, and
    src ids up to 16,299, so that the rows of the packing hold 510 words
    (two steps of the walk) and reach bit plane 31.  (bf, packed (numpy),
    the lists each row drains, the forward's claim order)."""
    rng = np.random.default_rng(21)
    n_src, n_dst, e, hub = 16_300, 240, 3000, 600
    dst = rng.integers(0, n_dst, e)
    dst[(dst >= EMPTY.start) & (dst < EMPTY.stop)] = 3
    src = rng.integers(0, n_src, e)
    dst[:hub], src[:hub] = HUB, rng.permutation(n_src)[:hub]
    src[hub:hub + 40] = rng.integers(n_src - 400, n_src, 40)
    key = np.unique(dst * n_src + src)
    bf = tbm.build_bit_format(key % n_src, key // n_src, n_src, n_dst,
                              device="cpu")
    packed = bf.packed.numpy()
    words = packed.view(np.uint32)
    lists = [_drains(words[d], words.shape[1], n_src) for d in range(n_dst)]
    return bf, packed, lists, tbg.claim_order(bf.packed, n_dst).numpy()


def _dq_inputs(seed, n_src, n_dst, heads, dim, saturate):
    """q and z on a grid of 1/16 in [-1, 1], g normal; with ``saturate`` z
    is positive and every eighth row of q is +c or -c, about half of those
    rows' scores past +40 or -40."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-16, 17, (n_dst, heads, dim)) / 16
    z = rng.integers(-16, 17, (n_src, heads, dim)) / 16
    if saturate:
        z = np.abs(z) + 1 / 16
        c = round(40 / (0.5625 * math.sqrt(dim)) * 16) / 16
        q[::16], q[8::16] = c, -c
    g = rng.normal(size=(n_dst, heads, dim))
    return [a.astype(F32) for a in (q, z, g)]


def _scales(packed, q, z, g, isd):
    out, l = tbd.bitdot_fwd_plain(torch.from_numpy(packed),
                                  torch.from_numpy(q), torch.from_numpy(z),
                                  isd)
    linv, rho = tbg.backward_scales(torch.from_numpy(g), out, l, None)
    return linv.numpy(), rho.numpy()


def _render_dq(lists, order, q, z, g, linv, rho, isd):
    """``bitdot_dq_list_kernel`` lane by lane: dq (rows, H, D) f32."""
    rows, heads, dim = q.shape
    dp, lpe, cpl = tbd.dz_layout(heads, dim)
    vph, one = dp // 4, heads == 1
    nv = heads * vph
    u_flight = DQ_UNROLL[cpl]
    nh = 1 if one else cpl
    groups = 32 // lpe
    grp, li = LANE // lpe, LANE % lpe
    red = lpe if one else vph
    vq = li[:, None] + lpe * np.arange(cpl)                  # (32, cpl)
    ok = vq < nv
    vqs = np.where(ok, vq, 0)
    hq = np.zeros((32, nh), np.int64) if one else vqs // vph
    chain = np.ones((32, nh), bool) if one else ok

    def vectors(t):    # (n, H, D) -> (n, nv, 4), heads zero-padded
        p = np.zeros((t.shape[0], heads, dp), F32)
        p[..., :dim] = t
        return p.reshape(t.shape[0], nv, 4)

    qp, zp, gp = vectors(q), vectors(z), vectors(g)
    isd = F32(isd)
    dq = np.zeros((rows, nv, 4), F32)
    for d in (int(r) for r in order):
        qd = np.where(ok[..., None], qp[d][vqs], F32(0))     # (32, cpl, 4)
        gd = np.where(ok[..., None], gp[d][vqs], F32(0))
        liv = np.where(chain, linv[d][hq], F32(0))           # (32, nh)
        rhv = np.where(chain, rho[d][hq], F32(0))
        acc = np.zeros((32, cpl, 4), F32)
        for entries in lists[d]:
            entries = np.asarray(entries, np.int64)
            n = len(entries)
            for i0 in range(0, n, groups * u_flight):
                batch = []
                for u in range(u_flight):      # the loads of U entries
                    e = i0 + u * groups + grp
                    s = np.where(e < n, entries[np.minimum(e, max(n - 1, 0))]
                                 if n else -1, -1)
                    live = s >= 0
                    on = (live[:, None] & ok)[..., None]
                    zv = np.where(on, zp[np.where(live, s, 0)[:, None], vqs],
                                  F32(0))
                    batch.append((live, zv))
                for live, zv in batch:         # then the arithmetic
                    zd = (zv * qd).sum(-1, dtype=F32)        # (32, cpl)
                    ud = (gd * zv).sum(-1, dtype=F32)
                    if one:
                        zd = zd.sum(1, keepdims=True, dtype=F32)
                        ud = ud.sum(1, keepdims=True, dtype=F32)
                    off = red >> 1
                    while off:
                        zd = zd + zd[LANE ^ off]
                        ud = ud + ud[LANE ^ off]
                        off >>= 1
                    e = zd * isd
                    alpha = np.exp(np.clip(e, -CLIP, CLIP)).astype(F32) * liv
                    de = alpha * (ud - rhv)
                    draw = np.where((e > -CLIP) & (e < CLIP), de * isd,
                                    F32(0))
                    r = draw[:, :1] if one else draw
                    acc = np.where(live[:, None, None],
                                   _fma(r[..., None], zv, acc), acc)
        off = lpe
        while off < 32:        # the groups' sums, in a fixed order
            acc = acc + acc[LANE ^ off]
            off <<= 1
        for lane in np.nonzero(grp == 0)[0]:
            dq[d, vq[lane][ok[lane]]] = acc[lane][ok[lane]]
    return dq.reshape(rows, heads, dp)[..., :dim]


def _plain_dq(packed, q, z, g, linv, rho, isd):
    return tbd.bitdot_bwd_dq_plain(*(torch.from_numpy(a) for a in (
        packed, q, z, g, linv, rho)), isd).numpy()


@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("heads,dim", SHAPES)
def test_dq_walk_rendering_matches_plain(dq_graph, heads, dim, saturate):
    bf, packed, lists, order = dq_graph
    q, z, g = _dq_inputs(heads * 100 + dim, bf.num_src, bf.num_dst, heads,
                         dim, saturate)
    isd = 1 / math.sqrt(dim)
    linv, rho = _scales(packed, q, z, g, isd)
    if saturate:
        dst, src = (a.numpy() for a in next(tbg.bit_edges(bf.packed,
                                                          bf.num_dst)))
        scores = (z[src] * q[dst]).sum(-1) * isd
        assert (np.abs(scores) >= CLIP).mean() > 0.01
    got = _render_dq(lists, order, q, z, g, linv, rho, isd)
    np.testing.assert_allclose(got, _plain_dq(packed, q, z, g, linv, rho,
                                              isd), **DQ_TOL)
    assert order[0] == HUB, "the hub row must be claimed first"
    assert sum(1 for x in lists[HUB] if x) > 1, "its list must fill"
    assert (got[EMPTY.start:EMPTY.stop] == 0).all()


@pytest.mark.parametrize("heads,dim", [(2, 64), (4, 16)])
def test_dq_walk_rendering_exact_on_a_grid(dq_graph, heads, dim):
    """Every score 0 (q = 0: p = 1), isd a power of two, z and g in {-1,
    0, 1}, linv a power of two and rho an integer: g . z is an integer,
    each term draw z[s] lies on a grid of 1/64 and every sum is exact in
    any order, so the rendering equals the plain version's bits."""
    bf, packed, lists, order = dq_graph
    rng = np.random.default_rng(dim)
    q = np.zeros((bf.num_dst, heads, dim), F32)
    z = rng.integers(-1, 2, (bf.num_src, heads, dim)).astype(F32)
    g = rng.integers(-1, 2, (bf.num_dst, heads, dim)).astype(F32)
    linv = (2.0 ** -rng.integers(0, 4, (bf.num_dst, heads))).astype(F32)
    rho = rng.integers(-2, 3, (bf.num_dst, heads)).astype(F32)
    isd = 1 / math.sqrt(dim)
    assert isd == 2.0 ** round(math.log2(isd))
    got = _render_dq(lists, order, q, z, g, linv, rho, isd)
    assert got.any()
    np.testing.assert_array_equal(got, _plain_dq(packed, q, z, g, linv, rho,
                                                 isd))


def test_dq_on_cpu_takes_the_plain_version(dq_graph):
    """On CPU tensors ``bitdot_bwd_dq`` (given a claim order or not) and
    the autograd function's backward take the plain version and count no
    launch."""
    bf, packed, _, _ = dq_graph
    q, z, g = _dq_inputs(3, bf.num_src, bf.num_dst, 2, 64, False)
    isd = 1 / 8
    linv, rho = _scales(packed, q, z, g, isd)
    want = _plain_dq(packed, q, z, g, linv, rho, isd)
    args = [torch.from_numpy(a) for a in (q, z, g, linv, rho)]
    before = tbd.bitdot_bwd_dq.launches
    for order in (None, tbg.fwd_claim_order(bf)):
        got = tbd.bitdot_bwd_dq(bf.packed, *args, isd, order)
        np.testing.assert_array_equal(got.numpy(), want)
    qt = args[0].clone().requires_grad_()
    tbd.bitdot_attention_aggregate(bf, qt, args[1]).backward(args[2])
    assert bf._fwd_order is not None      # built above, kept on the format
    np.testing.assert_allclose(qt.grad.numpy(), want, **DQ_TOL)
    assert tbd.bitdot_bwd_dq.launches == before


# -- K11 v2's node gradient: the row walk with the edge term --------------------

@pytest.fixture(scope="module")
def tiled():
    """A multigraph of 600 nodes and 3,000 edges on tiles of 256 and
    buckets of 128 slots: dst 5 a hub of 150 in-edges, src 9 one of 150
    out-edges, dst rows 512-599 and src rows 256-300 with none."""
    rng = np.random.default_rng(41)
    n, e = 600, 3000
    row = rng.integers(0, n, e)
    row[(row >= 256) & (row <= 300)] = 1
    col = rng.integers(0, 512, e)
    col[:150], row[150:300] = 5, 9
    row[300:400], col[300:400] = row[400:500], col[400:500]   # multi-edges
    return tts.build_tiled_format(row, col, n, n, 256, 128,
                                  device="cpu").with_src_first()


def _render_fe_grad(tf, side, U3, V3, attn, ds, slope, ef_slot, wf):
    """``row_fe_grad_kernel`` lane by lane on the operands
    ``row_aggregate`` builds for it: (rows, H, D) f32.  Rows are taken
    whole (a row's sums do not depend on the rows beside it); within a
    row each lane sums its entries in slot order."""
    own3, nbr3 = (V3, U3) if side == "dst" else (U3, V3)
    heads, hc = nbr3.shape[1:]
    hp = tts.padded_width(hc)
    f = heads * hp
    y = tts.pad_heads(nbr3, hp).numpy().reshape(-1, f)
    own = tts.pad_heads(own3, hp).numpy().reshape(-1, f)
    at = tts.pad_heads(attn.reshape(1, heads, hc), hp).numpy().reshape(f)
    efp, fq, wfp, fe, bias, kf = tts.edge_operands(ef_slot, wf, heads, hp)
    efp, wfp = efp.numpy(), wfp.numpy().reshape(-1)
    bias = None if bias is None else bias.numpy()
    vec, cpl, lpr, n_chunks = tts.fe_layout(
        f, hp, torch.from_numpy(y), torch.from_numpy(own))
    # ds slot-major, as the walk reads it: (B, C, H), strides (C H, 1, H)
    w = ds.transpose(1, 2).contiguous().numpy().reshape(-1)
    cap = tf.cap
    w_bs, w_hs, w_cs = cap * heads, 1, heads
    view = tf.row_view(side)
    ptr, slot, nbr = (t.numpy().astype(np.int64)
                      for t in (view.ptr, view.slot, view.nbr))
    rows = len(ptr) - 1
    deg = ptr[1:] - ptr[:-1]
    row_of = np.repeat(np.arange(rows), deg)
    nv = f // vec
    li = np.arange(lpr)
    out = np.zeros((rows, f), F32)
    slope = F32(slope)
    for chunk in range(n_chunks):
        cv = (chunk * cpl + np.arange(cpl))[None, :] * lpr + li[:, None]
        ok = cv < nv                                         # (lpr, cpl)
        col = np.where(ok, cv, 0)[..., None] * vec + np.arange(vec)
        hq = np.where(ok, cv * vec // hp, 0)
        # the lane's columns of wf by feature (0 past fe) and of the bias
        k = np.arange(kf)
        wfr = np.where(ok[..., None, None] & (k < fe),
                       wfp[np.minimum(k, max(fe - 1, 0)) * f
                           + col[..., None]], F32(0))   # (lpr, cpl, vec, kf)
        bq = (np.zeros(col.shape, F32) if bias is None
              else np.where(ok[..., None], bias[col], F32(0)))
        own_b = (own[:, col] + bq).astype(F32)  # the bias row joins own
        # every entry's terms: its slot's features, weight and gather
        b = slot // cap
        wb = b * w_bs + (slot - b * cap) * w_cs
        wq = w[wb[:, None, None] + hq * w_hs]                # (E, lpr, cpl)
        xv = y[nbr][:, col]                             # (E, lpr, cpl, vec)
        oq = own_b[row_of]
        fv = np.zeros(xv.shape, F32)
        e_rows = efp[slot]                                   # (E, 4 fq)
        for j in range(4 * fq):
            fv = _fma(e_rows[:, j, None, None, None], wfr[..., j], fv)
        raw = (oq + xv).astype(F32) + fv
        sel = np.where(raw >= 0, F32(1), slope)
        acc = np.zeros((rows, lpr, cpl, vec), F32)
        for t in range(int(deg.max(initial=0))):   # slot order within a row
            r = np.nonzero(deg > t)[0]
            ent = ptr[r] + t
            acc[r] = _fma(wq[ent][..., None], sel[ent], acc[r])
        acc = acc * at[col]
        for lane, q in zip(*np.nonzero(ok)):
            out[:, col[lane, q]] = acc[:, lane, q]
    return out.reshape(rows, heads, hp)[..., :hc]


def _fe_inputs(tf, heads, dim, fe, bias, grid, seed):
    """U, V, attn, ds, ef_slot and wf (with the bias row where ``bias``).
    On the grid: U, V and attn multiples of 1/4 in [-1, 1], wf of 1/4 in
    [-1/2, 1/2], edge features and ds in {-1, 0, 1}: raw is exact, and
    with a slope of 1/4 every sum is exact in f32 in any order.  Else
    normal values, ds 0 at a (slot, head) whose raw, taken in f64, lies
    within 1e-3 of lrelu's kink in any of the head's columns (there the
    f32 roundings of two orders of sums may pick different slopes)."""
    rng = np.random.default_rng(seed)
    b, cap = tf.num_buckets, tf.cap
    n, hd = tf.num_src, heads * dim
    valid = tf.valid.numpy().reshape(b, cap)

    def q(shape, step, top):
        return (rng.integers(-round(top / step), round(top / step) + 1,
                             shape) * step).astype(F32)

    rows = fe + int(bias)
    if grid:
        U, V = q((n, heads, dim), 0.25, 1), q((n, heads, dim), 0.25, 1)
        attn, wf = q((heads, dim), 0.25, 1), q((rows, hd), 0.25, 0.5)
        ef = rng.integers(-1, 2, (b, cap, fe)).astype(F32)
        ds = rng.integers(-1, 2, (b, heads, cap)).astype(F32)
    else:
        U, V = (rng.normal(size=(n, heads, dim)).astype(F32)
                for _ in range(2))
        attn = rng.normal(size=(heads, dim)).astype(F32)
        wf = (rng.normal(size=(rows, hd)) / 4).astype(F32)
        ef = rng.normal(size=(b, cap, fe)).astype(F32)
        ds = rng.normal(size=(b, heads, cap)).astype(F32)
        src = tf.src_local.numpy().reshape(b, cap) + \
            tf.src_tile.numpy()[:, None] * tf.tile
        dst = tf.dst_local.numpy().reshape(b, cap) + \
            tf.dst_tile.numpy()[:, None] * tf.tile
        term = ef.astype(np.float64) @ wf[:fe].astype(np.float64)
        if bias:
            term = term + wf[fe]
        raw = (U[src].astype(np.float64) + V[dst]).reshape(b, cap, hd) + term
        near = (np.abs(raw) < 1e-3).reshape(b, cap, heads, dim).any(-1)
        ds[near.transpose(0, 2, 1)] = 0
    ef *= valid[..., None]
    ds *= valid[:, None, :]
    return [torch.from_numpy(a) for a in (U, V, attn, ds, ef, wf)]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("fe", FES)
@pytest.mark.parametrize("heads,dim", VATTN_SHAPES)
def test_fe_grad_rendering_exact_on_a_grid(tiled, heads, dim, fe, bias):
    U, V, attn, ds, ef, wf = _fe_inputs(tiled, heads, dim, fe, bias, True,
                                        heads + dim + fe)
    for side in ("dst", "src"):
        want = tgf.vattn_node_grad_plain(tiled, U, V, attn, ds, 0.25, side,
                                         ef, wf).numpy()
        got = _render_fe_grad(tiled, side, U, V, attn, ds, 0.25, ef, wf)
        assert np.abs(want).max() > 0
        np.testing.assert_array_equal(got, want, err_msg=side)


@pytest.mark.parametrize("fe,bias", [(5, True), (16, True), (31, False)])
@pytest.mark.parametrize("heads,dim", VATTN_SHAPES)
def test_fe_grad_rendering_matches_plain(tiled, heads, dim, fe, bias):
    """Normal inputs at EGAT's slope: f32 sums in another order."""
    U, V, attn, ds, ef, wf = _fe_inputs(tiled, heads, dim, fe, bias, False,
                                        heads * dim + fe)
    for side in ("dst", "src"):
        want = tgf.vattn_node_grad_plain(tiled, U, V, attn, ds, 0.01, side,
                                         ef, wf).numpy()
        got = _render_fe_grad(tiled, side, U, V, attn, ds, 0.01, ef, wf)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=side)


def test_vattn_backward_lays_ds_out_once(tiled):
    """K11 v2's backward asks K6's ds for the slot-major layout, hands
    both node gradients that tensor as it is and the slot gradient one
    (B, H, C) copy of it."""
    heads, dim, fe = 4, 8, 5
    U, V, attn, ds, ef, wf = _fe_inputs(tiled, heads, dim, fe, True, True, 3)
    x3 = torch.randn(tiled.num_src, heads, dim)
    dZ = torch.randn(tiled.num_dst, heads, dim)
    out, p, den = tgf.vattn_forward(tiled, U, V, x3, attn, heads, dim, 0.2,
                                    ef, wf)
    with mock.patch.object(tgf, "gat_ds", wraps=tgf.gat_ds) as ds_call, \
            mock.patch.object(tgf, "vattn_node_grad",
                              wraps=tgf.vattn_node_grad) as node_call, \
            mock.patch.object(tgf, "vattn_slot_grad",
                              wraps=tgf.vattn_slot_grad) as slot_call:
        tgf.vattn_backward(tiled, U, V, x3, attn, p, den, out, dZ, 0.2, ef,
                           wf)
    assert ds_call.call_count == 1
    assert ds_call.call_args.kwargs["slot_major"] is True
    strides = {call.args[4].stride() for call in node_call.call_args_list}
    assert node_call.call_count == 2
    assert strides == {(tiled.cap * heads, 1, heads)}, strides
    assert slot_call.call_args.args[4].is_contiguous()


def test_layouts_and_unrolls_match_the_sources():
    """The renderings' entries in flight and lanes are the sources', and
    the dq walk's layout is the dz walk's."""
    with open(f"{CSRC}/bitdot.cu") as f:
        bitdot = f.read()
    assert "static constexpr int value = CPL == 1 ? 8 : CPL == 2 ? 4 : 1;" \
        in bitdot
    with open(f"{CSRC}/row_agg.cu") as f:
        row_agg = f.read()
    assert "((VEC) * (CPL) * (KF) + 4 * (CPL) * ((VEC) + 1) <= 60 ? 4 : 2)" \
        in row_agg
    assert f"constexpr int kFeMinLanes = {tts.FE_MIN_LANES};" in row_agg
    assert tbd.dz_layout(2, 64) == (64, 16, 2)
    assert tbd.dz_layout(1, 128) == (128, 8, 4)
    assert tts.fe_layout(128, 32) == (4, 1, 32, 1)     # (4, 32)
    assert tts.fe_layout(64, 8) == (4, 1, 16, 1)       # (8, 8)
    assert tts.fe_layout(44, 44) == (4, 1, 16, 1)      # (1, 41) padded
    assert tts.fe_layout(12, 3) == (1, 1, 16, 1)
    assert tts.fe_layout(6, 6) == (2, 1, 8, 1)
    assert tts.fe_layout(256, 64) == (4, 1, 32, 2)
    assert [tts.fe_kf(fe) for fe in (1, 5, 8, 9, 16, 17, 31, 32)] == [
        8, 8, 8, 16, 16, 32, 32, 32]
    assert tts.padded_width(41) == 44 and tts.padded_width(6) == 6


def test_edge_operands_pad_to_whole_vectors():
    """The wrapper's edge operands: ef padded with zeros to whole 16-byte
    vectors, wf's and the bias's columns padded as the heads are."""
    ef = torch.randn(3, 4, 5)
    wf = torch.randn(6, 2 * 41)
    efp, fq, wfp, fe, bias, kf = tts.edge_operands(ef, wf, 2, 44)
    assert (fq, fe, kf) == (2, 5, 8) and efp.shape == (12, 8)
    assert torch.equal(efp[:, :5], ef.reshape(12, 5))
    assert not efp[:, 5:].any()
    assert wfp.shape == (5, 88) and bias.shape == (88,)
    assert torch.equal(wfp.view(5, 2, 44)[..., :41], wf[:5].view(5, 2, 41))
    assert not wfp.view(5, 2, 44)[..., 41:].any()
    assert torch.equal(bias.view(2, 44)[:, :41], wf[5].view(2, 41))
    assert tts.edge_operands(ef, wf[:5], 2, 44)[4] is None


# -- the retired kernels and the probe -------------------------------------------

def test_retired_kernels_left_the_package():
    """``bitdot_dq_kernel`` and ``vattn_node_grad_kernel`` are in the probe
    alone; no wrapper names their C functions."""
    for path in tbd.build.sources().values():
        with open(path) as f:
            src = f.read()
        # defined (``name(``) or launched (``name<...><<<``)
        for name in ("bitdot_dq_kernel", "vattn_node_grad_kernel"):
            assert not re.search(rf"\b{name}(<[^>]*>)?\s*(\(|<<<)", src), \
                (name, path)
        assert "dgl_vattn_node_grad(" not in src
    assert "dgl_bitdot_bwd_dq" not in tbd._SIGNATURES
    assert "dgl_bitdot_bwd_dq_list" in tbd._SIGNATURES
    assert "dgl_vattn_node_grad" not in tgf._VATTN_SIGNATURES
    assert not hasattr(tgf, "node_grad_tiled")
    with open(tdq.PROBE_SOURCE) as f:
        probe = f.read()
    assert re.search(r"\bbitdot_dq_kernel\(", probe)
    assert re.search(r"\bvattn_node_grad_kernel\(", probe)
    assert "int dgl_vattn_node_grad(" in probe


def test_probe_edits_apply():
    """``tools/perf_dq_node_grad.py``: ``dz_count`` gives the dq walk the
    dz walk's entries in flight, ``double`` doubles the node-gradient
    walk's, each applied once; the narrow layout keeps 2 columns a lane; and
    ``tools/perf_bwd_walks.py``'s edit of the tiled walk (its instances
    without the edge term) applies to the probe's source."""
    assert tdq.tiny_check() == ["retired", "dz_count", "double"]
    dq, fe = tdq.edited_sources()
    assert "CPL == 1 ? 4 : CPL == 2 ? 2 : 1; // dz's" in dq["dz_count"]
    assert "<= 60 ? 8 : 4)" in fe["double"]
    assert tdq.narrow_layout(4, 32) == (2, 1, 32, 2)
    assert "launch_node_grad<G, kSrc, 0>" in tbw.edited_sources()[1]
