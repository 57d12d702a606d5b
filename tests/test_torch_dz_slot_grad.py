"""K7's dz and K11 v2's slot gradient as redesigned for Hopper, rendered on
the CPU: no compiler and no card here, so each rendering repeats its
kernel's index arithmetic in numpy.

* K7's dz as a listed-bit walk by src (``csrc/bitdot.cu``
  ``bitdot_dz_list_kernel``), lane by lane with the wrapper's layout
  (``bitdot.dz_layout``): rows claimed in the backward's claim order, each
  row's lists filled and drained at ``kListDrainAt`` (the listing shared
  with K5's walks, ``csrc/bitlist.cuh``), groups of lpe lanes an entry, U
  entries in flight (``DzUnroll``), z . q and g . z per head over the
  lanes of the head's block, and the groups' sums combined in a fixed
  order at the row's end; held to ``bitdot_bwd_dz_plain`` at (2, 64), (1,
  128), (4, 32) and (3, 8), on a graph with a src hub whose list fills
  several times and src rows with no bit, with scores past +-40, at rtol
  1e-4 / atol 1e-4 (sums of up to 3,000 entries in another order), and
  bit for bit on a dyadic grid where every score is 0 and isd is a power
  of two (every product and sum exact in f32);
* K11 v2's slot gradient as tensor-core products (``csrc/gatv2.cu``
  ``vattn_slot_grad_mma_kernel`` and ``vattn_grad_finish_kernel``): static
  ranges of 32-slot chunks a block, 32-column slices a warp in passes of
  up to 4, each operand cut into three bf16 parts (the top 16 bits of what
  is left) with the 6 products whose part indices sum below 3, each
  ``mma.sync`` an f32 sum of its tile, the accumulator's rows permuted so
  that lane (g, t) owns columns 4g .. 4g + 3, da and the bias row summed
  per lane and then over the lanes t, the blocks' partials added in block
  order, and d(ef) from each warp's partial summed in warp order, with and
  without kDef; held to ``vattn_slot_grad_plain`` bit for bit on a dyadic
  grid at (8, 8), (1, 41) and (4, 32) with 5 and 16 edge features and the
  bias row, and at rtol 1e-4 / atol 1e-3 (times the largest magnitude for
  the sums over every slot) on normal inputs;
* ``bitdot_bwd_dz`` and ``vattn_slot_grad`` on the CPU (their plain
  versions) inside ``bitdot_attention_aggregate``'s VJP and
  ``egatconv_attention_aggregate_v2``'s gradient, against the JAX
  functions with their Pallas kernels interpreted, as
  ``test_torch_bitdot.py`` and ``test_torch_gatv2.py`` hold them: dz at
  rtol 1e-4 / atol 1e-5 (f32 on both sides), d(ef), dWf and d(attn) by
  the rule for gradients through lrelu's kink (the JAX kernels cast their
  operands to bf16);
* the probe's edits restore what they should, the retired kernels are gone
  from ``dgl_tpu_torch/csrc/`` and ``ops/``, and K5's listing is the one
  header both ``bitgat.cu`` and ``bitdot.cu`` include.
"""
import math
import re
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import dgl_tpu.ops.pallas.bitdot as jbd
import dgl_tpu.ops.pallas.bitmm as jbm
import dgl_tpu.ops.pallas.gat_fused as jgf
import dgl_tpu.ops.pallas.tiled_spmm as jts
import dgl_tpu_torch.ops.kernels.bitdot as tbd
import dgl_tpu_torch.ops.kernels.bitgat as tbg
import dgl_tpu_torch.ops.kernels.bitmm as tbm
import dgl_tpu_torch.ops.kernels.gat_fused as tgf
import dgl_tpu_torch.ops.kernels.tiled_spmm as tts
from dgl_tpu_torch.tools import perf_dz_slot_grad as tdz
from dgl_tpu_torch.tools import perf_slot_grad_scores as tsg
from test_torch_bwd_walks import LANE, _bit_graph, _drains
from test_torch_gat_fused import N, _coo, _formats, _kink_close
from test_torch_gatv2 import (EGAT_SLOPE, FE, J_DIM, J_FIN, J_HEADS, _ef_t,
                              _exact, _unpad_wf)

CSRC = tbd.build.CSRC_DIR
DZ_TOL = dict(rtol=1e-4, atol=1e-4)
JAX_BWD = dict(rtol=1e-4, atol=1e-5)
RTOL, ATOL = 1e-4, 1e-3
CLIP = 40.0
DZ_UNROLL = {1: 4, 2: 2, 3: 1, 4: 1}      # csrc/bitdot.cu DzUnroll
CHUNK, SLICE_WARPS, SPLIT = 32, 4, 3      # csrc/gatv2.cu kChunk, ...
SHAPES = [(2, 64), (1, 128), (4, 32), (3, 8)]
F32 = np.float32


# -- K7's dz: the listed walk by src ------------------------------------------

def _dz_inputs(seed, n_src, n_dst, heads, dim, saturate):
    """q and z on a grid of 1/16 in [-1, 1], g normal, and the backward's
    linv and rho from K7's plain forward; with ``saturate`` z is positive
    and every eighth row of q is +c or -c, about half of those rows'
    scores past +40 or -40 (as ``test_torch_bitdot._inputs``)."""
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


def _render_dz(packed_rev, num_dst, q, z, g, linv, rho, isd, lanes=None):
    """``bitdot_dz_list_kernel`` lane by lane: (dz (rows, H, D) f32, the
    lists drained for each row)."""
    rows = z.shape[0]
    heads, dim = z.shape[1:]
    dp, lpe, cpl = tbd.dz_layout(heads, dim, lanes)
    vph, one = dp // 4, heads == 1
    nv = heads * vph
    u_flight = DZ_UNROLL[cpl]
    nh = 1 if one else cpl
    groups = 32 // lpe
    grp, li = LANE // lpe, LANE % lpe
    red = lpe if one else vph
    vq = li[:, None] + lpe * np.arange(cpl)                  # (32, cpl)
    ok = vq < nv
    hq = np.zeros((32, nh), np.int64) if one else np.where(ok, vq // vph, 0)
    chain = np.ones((32, nh), bool) if one else ok

    def vectors(t):    # (n, H, D) -> (n, nv, 4), heads zero-padded
        p = np.zeros((t.shape[0], heads, dp), F32)
        p[..., :dim] = t
        return p.reshape(t.shape[0], nv, 4)

    qp, zp, gp = vectors(q), vectors(z), vectors(g)
    words_all = packed_rev.view(np.uint32)
    k32 = words_all.shape[1]
    isd = F32(isd)
    dz = np.zeros((rows, nv, 4), F32)
    drained = np.zeros(rows, np.int64)
    order = tbg.claim_order(torch.from_numpy(packed_rev), rows).numpy()
    for s in (int(r) for r in order):
        zq = np.where(ok[..., None], zp[s][np.where(ok, vq, 0)], F32(0))
        dzq = np.zeros((32, cpl, 4), F32)
        lists = _drains(words_all[s], k32, num_dst)
        drained[s] = sum(1 for x in lists if x)
        for entries in lists:
            entries = np.asarray(entries, np.int64)
            n = len(entries)
            for i0 in range(0, n, groups * u_flight):
                batch = []
                for u in range(u_flight):      # the loads of U entries
                    e = i0 + u * groups + grp
                    d = np.where(e < n, entries[np.minimum(e, max(n - 1, 0))]
                                 if n else -1, -1)
                    live = d >= 0
                    dd = np.where(live, d, 0)
                    on = (live[:, None] & ok)[..., None]
                    qv = np.where(on, qp[dd[:, None], np.where(ok, vq, 0)],
                                  F32(0))
                    gv = np.where(on, gp[dd[:, None], np.where(ok, vq, 0)],
                                  F32(0))
                    onc = live[:, None] & chain
                    liv = np.where(onc, linv[dd[:, None], hq], F32(0))
                    rhv = np.where(onc, rho[dd[:, None], hq], F32(0))
                    batch.append((live, qv, gv, liv, rhv))
                for live, qv, gv, liv, rhv in batch:   # then the arithmetic
                    zd = (zq * qv).sum(-1, dtype=F32)     # (32, cpl)
                    ud = (gv * zq).sum(-1, dtype=F32)
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
                    a = alpha[:, :1] if one else alpha
                    r = draw[:, :1] if one else draw
                    dzq += np.where(live[:, None, None],
                                    r[..., None] * qv + a[..., None] * gv,
                                    F32(0))
        off = lpe
        while off < 32:        # the groups' sums, in a fixed order
            dzq = dzq + dzq[LANE ^ off]
            off <<= 1
        for lane in np.nonzero(grp == 0)[0]:
            dz[s, vq[lane][ok[lane]]] = dzq[lane][ok[lane]]
    return dz.reshape(rows, heads, dp)[..., :dim], drained


@pytest.fixture(scope="module")
def hub_graph():
    """``test_torch_bwd_walks._bit_graph``: src row 7 a hub of 3,000 out-
    edges (its list drained when full, several times), src rows 500-519
    with none, rows of 512 words reaching bit plane 31."""
    row, col, n_src, n_dst = _bit_graph()
    bf = tbm.build_bit_format(row, col, n_src, n_dst, device="cpu")
    return bf, bf.packed_rev.numpy(), bf.packed.numpy()


@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("heads,dim", SHAPES)
def test_dz_walk_rendering_matches_plain(hub_graph, heads, dim, saturate):
    bf, packed_rev, packed = hub_graph
    q, z, g = _dz_inputs(heads * 100 + dim, bf.num_src, bf.num_dst, heads,
                         dim, saturate)
    isd = 1 / math.sqrt(dim)
    linv, rho = _scales(packed, q, z, g, isd)
    if saturate:
        src, dst = (a.numpy() for a in next(tbg.bit_edges(bf.packed_rev,
                                                          bf.num_src)))
        scores = (z[src] * q[dst]).sum(-1) * isd
        assert (np.abs(scores) >= CLIP).mean() > 0.01
    got, drained = _render_dz(packed_rev, bf.num_dst, q, z, g, linv, rho, isd)
    want = tbd.bitdot_bwd_dz_plain(*(torch.from_numpy(a) for a in (
        packed_rev, q, z, g, linv, rho)), isd).numpy()
    np.testing.assert_allclose(got, want, **DZ_TOL)
    assert drained[7] > 1, "the hub's list must fill and drain"
    assert (got[500:520] == 0).all()


@pytest.mark.parametrize("heads,dim", [(2, 64), (4, 16)])
def test_dz_walk_rendering_exact_on_a_grid(hub_graph, heads, dim):
    """Every score 0 (z = 0: p = 1), isd a power of two, q, g, linv and
    rho on grids: each term draw q + alpha g is exact and so is every sum,
    in any order, so the rendering equals the plain version's bits."""
    bf, packed_rev, _ = hub_graph
    rng = np.random.default_rng(dim)
    q = (rng.integers(-16, 17, (bf.num_dst, heads, dim)) / 16).astype(F32)
    g = (rng.integers(-16, 17, (bf.num_dst, heads, dim)) / 16).astype(F32)
    z = np.zeros((bf.num_src, heads, dim), F32)
    linv = (2.0 ** -rng.integers(0, 4, (bf.num_dst, heads))).astype(F32)
    rho = (rng.integers(-8, 9, (bf.num_dst, heads)) / 8).astype(F32)
    isd = 1 / math.sqrt(dim)
    assert isd == 2.0 ** round(math.log2(isd))
    got, _ = _render_dz(packed_rev, bf.num_dst, q, z, g, linv, rho, isd)
    want = tbd.bitdot_bwd_dz_plain(*(torch.from_numpy(a) for a in (
        packed_rev, q, z, g, linv, rho)), isd).numpy()
    assert got.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("heads,dim", [(1, 128)])
def test_dz_walk_rendering_at_the_probe_layouts(hub_graph, heads, dim):
    """The layouts the probe times on either side of the package's give
    the same dz."""
    bf, packed_rev, packed = hub_graph
    q, z, g = _dz_inputs(7, bf.num_src, bf.num_dst, heads, dim, False)
    isd = 1 / math.sqrt(dim)
    linv, rho = _scales(packed, q, z, g, isd)
    want = tbd.bitdot_bwd_dz_plain(*(torch.from_numpy(a) for a in (
        packed_rev, q, z, g, linv, rho)), isd).numpy()
    for lanes in tdz.dz_layouts(heads, dim):
        got, _ = _render_dz(packed_rev, bf.num_dst, q, z, g, linv, rho, isd,
                            lanes)
        np.testing.assert_allclose(got, want, err_msg=f"{lanes} lanes",
                                   **DZ_TOL)


def test_dz_layout_and_unroll_match_the_source():
    """The rendering's entries in flight are the source's, and the layout
    is K5's listed walks' (``bitgat.list_layout``) or the lanes given."""
    with open(f"{CSRC}/bitdot.cu") as f:
        src = f.read()
    assert ("static constexpr int value = CPL == 1 ? 4 : CPL == 2 ? 2 : 1;"
            in src)
    assert tbd.dz_layout(2, 64) == (64, 16, 2)
    assert tbd.dz_layout(1, 128) == (128, 8, 4)
    assert tbd.dz_layout(1, 128, 16) == (128, 16, 2)
    assert tbd.dz_layout(4, 32) == (32, 16, 2)
    assert tbd.dz_layout(3, 8) == (8, 4, 2)
    for heads, dim in ((3, 5), (128, 1), (1, 41), (8, 16)):
        assert tbd.dz_layout(heads, dim) == tbg.list_layout(heads, dim)


# -- K11 v2's slot gradient on the tensor cores --------------------------------

def _split3(x):
    """The three bf16 parts of f32 ``x``, as f32: each the top 16 bits of
    what the parts before it leave (csrc/gatv2.cu split3)."""
    x = np.asarray(x, F32)
    hi = (x.view(np.uint32) & 0xFFFF0000).view(F32)
    r1 = (x - hi).astype(F32)
    mid = (r1.view(np.uint32) & 0xFFFF0000).view(F32)
    r2 = (r1 - mid).astype(F32)
    lo = (r2.view(np.uint32) & 0xFFFF0000).view(F32)
    return [hi, mid, lo]


def _mma(acc, a, b):
    """One mma.sync a tile: f32 ``acc`` plus the exact products of bf16
    ``a`` and ``b``, summed and rounded to f32 once."""
    return (acc.astype(np.float64) + a.astype(np.float64)
            @ b.astype(np.float64)).astype(F32)


def _combos():
    """(part of the first operand, part of the second) in the kernels'
    order: the products whose part indices sum below SPLIT, smallest
    first."""
    return [(pa, s - pa) for s in range(SPLIT - 1, -1, -1)
            for pa in range(s + 1)]


def _render_slot_grad(tf, U3, V3, attn, ds, slope, ef_slot, wf, need_def,
                      blocks):
    """``vattn_slot_grad_mma_kernel`` and ``vattn_grad_finish_kernel`` on
    ``blocks`` blocks: (da (H, D), d_ef (B, C, Fe) or None, dwf)."""
    heads, dim = U3.shape[1:]
    hd = heads * dim
    fe = ef_slot.shape[2]
    rows = wf.shape[0]
    has_bias = rows > fe
    kp = 16 if fe <= 16 else 32
    slope = F32(slope)
    nsl = -(-hd // 32)
    warps = min(nsl, SLICE_WARPS)
    b_n, cap = tf.num_buckets, tf.cap
    n_chunks = b_n * cap // CHUNK
    src_l = tf.src_local.numpy().reshape(-1)
    dst_l = tf.dst_local.numpy().reshape(-1)
    valid = tf.valid.numpy().reshape(-1)
    src_t, dst_t = tf.src_tile.numpy(), tf.dst_tile.numpy()
    u = U3.numpy().reshape(U3.shape[0], hd)
    v = V3.numpy().reshape(V3.shape[0], hd)
    at = attn.numpy().reshape(hd)
    dsn = ds.numpy()
    ef = ef_slot.numpy().reshape(-1, fe)
    wfn = wf.numpy()
    # the accumulator's row r of a slice (m-tile r // 16, row g + 8 hi of
    # it) is the slice's column 4 g + 2 mi + hi
    r = np.arange(32)
    col_of_row = 4 * (r % 8) + 2 * (r // 16) + (r % 16) // 8
    part = np.zeros((blocks, rows + 1, hd), F32)
    d_ef = np.zeros((b_n * cap, fe), F32) if need_def else None
    for blk in range(blocks):
        k_lo = n_chunks * blk // blocks
        k_hi = n_chunks * (blk + 1) // blocks
        for c_lo in range(0, hd, 32 * warps):         # passes
            pass_slices = [s for s in range(c_lo // 32, c_lo // 32 + warps)
                           if s < nsl]
            state = {}
            for sl in pass_slices:
                cols = 32 * sl + col_of_row               # (32,)
                cok = cols < hd
                cc = np.where(cok, cols, 0)
                wsl = np.zeros((kp, 32), F32)             # WF's slice
                wsl[:fe] = np.where(cok, wfn[:fe][:, cc], F32(0))
                bias = np.where(cok & has_bias, wfn[fe if has_bias else 0,
                                                    cc], F32(0))
                state[sl] = dict(
                    cols=cols, cok=cok, cc=cc, bias=bias,
                    at=np.where(cok, at[cc], F32(0)),
                    wa=_split3(wsl.T),                    # (32, kp) parts
                    wd=_split3(wsl),                      # (kp, 32) parts
                    dw=np.zeros((32, kp), F32),           # dWf^T
                    da=np.zeros((32, 4), F32),            # per lane t
                    db=np.zeros((32, 4), F32))
            for k in range(k_lo, k_hi):
                s0 = k * CHUNK
                b, c0 = k // (cap // CHUNK), (k % (cap // CHUNK)) * CHUNK
                vld = valid[s0:s0 + CHUNK] != 0
                if not vld.any():
                    if need_def and c_lo == 0:
                        d_ef[s0:s0 + CHUNK] = 0
                    continue
                efc = np.zeros((CHUNK, kp), F32)
                efc[:, :fe] = ef[s0:s0 + CHUNK]
                efp = _split3(efc)                        # (32, kp) parts
                srcs = src_t[b] * tf.tile + src_l[s0:s0 + CHUNK]
                dsts = dst_t[b] * tf.tile + dst_l[s0:s0 + CHUNK]
                defp = {}
                for sl in pass_slices:
                    st = state[sl]
                    defp[sl] = np.zeros((CHUNK, kp), F32)
                    for step in range(2):
                        m = np.arange(16 * step, 16 * step + 16)
                        live_m = vld[m]
                        # raw's start: (U + V) + the bias row, (32, 16)
                        uv = (u[srcs[m]][:, st["cc"]]
                              + v[dsts[m]][:, st["cc"]]).T
                        uv = np.where(st["cok"][:, None] & live_m[None], uv,
                                      F32(0))
                        acc = (uv + st["bias"][:, None]).astype(F32)
                        for pa, pb in _combos():
                            for ks in range(kp // 16):
                                kk = slice(16 * ks, 16 * ks + 16)
                                acc = _mma(acc, st["wa"][pa][:, kk],
                                           efp[pb][m][:, kk].T)
                        heads_of = np.where(st["cok"], st["cc"] // dim, 0)
                        live = st["cok"][:, None] & live_m[None]
                        dsv = np.where(live, dsn[b][heads_of][:, c0 + m],
                                       F32(0))
                        pos = acc >= 0
                        lr = np.where(pos, acc, slope * acc)
                        dw = np.where(live, dsv * st["at"][:, None]
                                      * np.where(pos, F32(1), slope), F32(0))
                        # da and the bias row: lane t takes slots 2t, 2t + 1,
                        # 8 + 2t, 9 + 2t of the step, in that order
                        for t in range(4):
                            for j in (2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t):
                                st["da"][:, t] += np.where(
                                    live[:, j], dsv[:, j] * lr[:, j], F32(0))
                                st["db"][:, t] += dw[:, j]
                        dwp = _split3(dw)                 # (32 cols, 16)
                        for pa, pb in _combos():
                            st["dw"] = _mma(st["dw"], dwp[pa], efp[pb][m])
                        if need_def:
                            dacc = np.zeros((kp, 16), F32)
                            for kc in range(2):
                                rr = slice(16 * kc, 16 * kc + 16)
                                for pa, pb in _combos():
                                    dacc = _mma(dacc, st["wd"][pa][:, rr],
                                                dwp[pb][rr])
                            defp[sl][m] = dacc.T
                if need_def:     # the warps' partials, in warp order
                    tot = np.zeros((CHUNK, fe), F32)
                    for sl in pass_slices:
                        tot = (tot + defp[sl][:, :fe]).astype(F32)
                    if c_lo == 0:
                        d_ef[s0:s0 + CHUNK] = tot
                    else:
                        d_ef[s0:s0 + CHUNK] += tot
            for sl in pass_slices:   # over the lanes t, then written once
                st = state[sl]
                for name, row_i in (("da", rows), ("db", fe)):
                    x = st[name]
                    x = (x + x[:, [1, 0, 3, 2]]).astype(F32)
                    x = (x + x[:, [2, 3, 0, 1]]).astype(F32)
                    if name == "db" and not has_bias:
                        continue
                    part[blk][row_i, st["cols"][st["cok"]]] = x[st["cok"], 0]
                part[blk][:fe, st["cols"][st["cok"]]] = \
                    st["dw"][st["cok"], :fe].T
    out = np.zeros((rows + 1, hd), F32)
    for blk in range(blocks):                   # in block order
        out = (out + part[blk]).astype(F32)
    return (out[rows].reshape(heads, dim),
            None if d_ef is None else d_ef.reshape(ef_slot.shape),
            out[:rows])


def _slot_grad_inputs(tf, heads, dim, fe, grid, seed):
    """U, V, attn, ds, ef_slot and wf (with the bias row).  On the grid:
    U, V and attn multiples of 1/4 in [-1, 1], wf of 1/4 in [-1/2, 1/2],
    edge features and ds in {-1, 0, 1}, so that with a slope of 1/4 every
    product is exact in one bf16 part and every sum exact in f32 in any
    order; else normal values."""
    rng = np.random.default_rng(seed)
    b, cap = tf.num_buckets, tf.cap
    hd = heads * dim
    valid = tf.valid.numpy().reshape(b, cap)

    def q(shape, step, top):
        return (rng.integers(-round(top / step), round(top / step) + 1,
                             shape) * step).astype(F32)

    if grid:
        U, V = q((N, heads, dim), 0.25, 1), q((N, heads, dim), 0.25, 1)
        attn, wf = q((heads, dim), 0.25, 1), q((fe + 1, hd), 0.25, 0.5)
        ef = rng.integers(-1, 2, (b, cap, fe)).astype(F32)
        ds = rng.integers(-1, 2, (b, heads, cap)).astype(F32)
    else:
        U, V = (rng.normal(size=(N, heads, dim)).astype(F32)
                for _ in range(2))
        attn = rng.normal(size=(heads, dim)).astype(F32)
        wf = (rng.normal(size=(fe + 1, hd)) / 4).astype(F32)
        ef = rng.normal(size=(b, cap, fe)).astype(F32)
        ds = rng.normal(size=(b, heads, cap)).astype(F32)
    ef *= valid[..., None]
    ds *= valid[:, None, :]
    return [torch.from_numpy(a) for a in (U, V, attn, ds, ef, wf)]


@pytest.fixture(scope="module")
def tiled():
    row, col = _coo(41)
    return tts.build_tiled_format(row, col, N, N, 256, 128, device="cpu")


@pytest.mark.parametrize("need_def", [True, False])
@pytest.mark.parametrize("fe", [5, 16])
@pytest.mark.parametrize("heads,dim", [(8, 8), (1, 41), (4, 32)])
def test_slot_grad_rendering_exact_on_a_grid(tiled, heads, dim, fe,
                                             need_def):
    args = _slot_grad_inputs(tiled, heads, dim, fe, True, heads + dim + fe)
    U, V, attn, ds, ef, wf = args
    want = tgf.vattn_slot_grad_plain(tiled, U, V, attn, ds, 0.25, ef, wf,
                                     need_def)
    got = _render_slot_grad(tiled, U, V, attn, ds, 0.25, ef, wf, need_def,
                            blocks=3)
    for name, a, w in zip(("da", "d_ef", "dwf"), got, want):
        if w is None:
            assert a is None, name
            continue
        assert w.abs().max() > 0, name
        np.testing.assert_array_equal(a, w.numpy(), err_msg=name)


@pytest.mark.parametrize("fe,bias", [(5, True), (16, False), (31, True)])
@pytest.mark.parametrize("heads,dim", [(4, 32), (3, 5), (1, 200)])
def test_slot_grad_rendering_matches_plain(tiled, heads, dim, fe, bias):
    """Normal inputs: the three-part products keep f32's accuracy (31
    features and the bias row: two k-steps; 200 columns: a second pass of
    slices).  A slope of 1 keeps lrelu's kink out of the comparison, where
    an f32 rounding of raw could pick the other slope at one slot (the
    grid test holds the kink exactly)."""
    U, V, attn, ds, ef, wf = _slot_grad_inputs(tiled, heads, dim, fe, False,
                                               heads + dim)
    if not bias:
        wf = wf[:fe].contiguous()
    want = tgf.vattn_slot_grad_plain(tiled, U, V, attn, ds, 1.0, ef, wf)
    got = _render_slot_grad(tiled, U, V, attn, ds, 1.0, ef, wf, True, 2)
    for name, a, w in zip(("da", "d_ef", "dwf"), got, want):
        w = w.numpy()
        atol = ATOL * (1 if name == "d_ef" else max(1.0, np.abs(w).max()))
        np.testing.assert_allclose(a, w, rtol=RTOL, atol=atol, err_msg=name)


def test_slot_grad_layout_and_smem():
    """A warp a 32-column slice, at most 4 a block; the heads a pass spans
    and the kernel's shared memory (two stages, the edge features' three
    bf16 parts, d(ef)'s partials)."""
    assert tgf.slot_grad_layout(4, 32) == (4, 4)
    assert tgf.slot_grad_layout(8, 8) == (2, 8)
    assert tgf.slot_grad_layout(1, 41) == (2, 1)
    assert tgf.slot_grad_layout(200, 1) == (4, 128)
    assert tgf.slot_grad_smem(4, 32, 16, False) == (2 * 128 * 23
                                                    + 2 * 3 * 32 * 24)
    assert tgf.slot_grad_smem(4, 32, 17, True) == (
        2 * 128 * 24 + 2 * 3 * 32 * 40 + 4 * 4 * 32 * 32)
    with open(f"{CSRC}/gatv2.cu") as f:
        src = f.read()
    assert "constexpr int kChunk = 32;" in src
    assert "constexpr int kSliceWarps = 4;" in src
    assert "constexpr int kSplit = 3;" in src


# -- against the JAX functions, interpreted -------------------------------------

def _interpreted(*modules):
    orig = pl.pallas_call

    def interpreted(*a, **kw):
        return orig(*a, **{**kw, "interpret": True})

    return [mock.patch.object(m.pl, "pallas_call", interpreted)
            for m in modules]


def test_bitdot_bwd_dz_matches_jax():
    """``bitdot_attention_aggregate``'s dz, through ``bitdot_bwd_dz`` on
    the CPU, against JAX's VJP with ``_bwdA_call`` interpreted, at (2, 64)
    with scores past +-40."""
    rng = np.random.default_rng(20)
    n_src, n_dst, heads, dim = 300, 220, 2, 64
    row = rng.integers(0, n_src, 4000)
    col = rng.integers(0, n_dst - 20, 4000)
    key = np.unique(col.astype(np.int64) * n_src + row)
    row, col = key % n_src, key // n_src
    q, z, g = _dz_inputs(5, n_src, n_dst, heads, dim, True)
    bj = jbm.build_bit_format(row, col, n_src, n_dst)
    patches = _interpreted(jbd)
    for p in patches:
        p.start()
    try:
        _, vjp = jax.vjp(lambda a, b: jbd.bitdot_attention_aggregate(
            bj, a, b), jnp.asarray(q), jnp.asarray(z))
        want = np.asarray(vjp(jnp.asarray(g))[1])
    finally:
        for p in patches:
            p.stop()
    bf = tbm.build_bit_format(row, col, n_src, n_dst, device="cpu")
    qt, zt = (torch.from_numpy(a).requires_grad_() for a in (q, z))
    with mock.patch.object(tbd, "bitdot_bwd_dz",
                           wraps=tbd.bitdot_bwd_dz) as dz_call:
        out = tbd.bitdot_attention_aggregate(bf, qt, zt)
        out.backward(torch.from_numpy(g))
    assert dz_call.call_count == 1
    np.testing.assert_allclose(zt.grad.numpy(), want, **JAX_BWD)


def test_vattn_slot_grad_matches_jax():
    """``egatconv_attention_aggregate_v2``'s d(ef), dWf (the bias row too)
    and d(attn), through ``vattn_slot_grad`` on the CPU, against the JAX
    function's gradient with its kernels interpreted, on the inputs of
    ``test_torch_gatv2.jax_k9`` (raw exact in bf16 on both sides)."""
    row, col = _coo(37)
    t, j = _formats(row, col)
    rng = np.random.default_rng(38)
    hd = J_HEADS * J_DIM
    x = rng.normal(size=(N, J_HEADS, J_DIM)).astype(F32)
    dz = rng.normal(size=(N, J_HEADS, J_DIM)).astype(F32)
    X = rng.integers(-1, 2, (N, J_FIN)).astype(F32)
    ef = rng.integers(-1, 2, (len(row), FE)).astype(F32)
    w = {n: _exact(rng, (J_FIN, hd)) for n in ("fc_ni", "fc_nj")}
    wf_full = np.concatenate([_exact(rng, (FE, hd)), _exact(rng, (1, hd))])
    attn = _exact(rng, (J_HEADS, J_DIM))
    fni, fnj = ((X @ w[n]).reshape(N, J_HEADS, J_DIM) for n in w)
    ef_t, fe_pad = _ef_t(j, ef, True)
    wf_p = jgf.pad_We_heads(jnp.asarray(wf_full), J_HEADS, J_DIM, fe_pad)
    patches = _interpreted(jgf, jts)
    for p in patches:
        p.start()
    try:
        _, vjp = jax.vjp(
            lambda e, wp, a: jgf.egatconv_attention_aggregate_v2(
                j, jnp.asarray(fni), jnp.asarray(fnj), e, wp, a,
                jnp.asarray(x), J_HEADS, J_DIM, J_DIM, EGAT_SLOPE),
            ef_t, wf_p, jnp.asarray(attn))
        d_eft, d_wfp, d_attn = (np.asarray(a, F32)
                                for a in vjp(jnp.asarray(dz)))
    finally:
        for p in patches:
            p.stop()
    ef_slot = tgf.slot_edge_tensor(t, torch.from_numpy(ef)).requires_grad_()
    wf = torch.from_numpy(wf_full).requires_grad_()
    at = torch.from_numpy(attn).requires_grad_()
    with mock.patch.object(tgf, "vattn_slot_grad",
                           wraps=tgf.vattn_slot_grad) as grad_call:
        out = tgf.egatconv_attention_aggregate_v2(
            t, torch.from_numpy(fni), torch.from_numpy(fnj), ef_slot, wf,
            at, torch.from_numpy(x), J_HEADS, J_DIM, J_DIM, EGAT_SLOPE)
        out.backward(torch.from_numpy(dz))
    assert grad_call.call_count == 1
    _kink_close(ef_slot.grad.numpy(), d_eft[:, :FE, :].transpose(0, 2, 1),
                "d_ef")
    _kink_close(wf.grad.numpy(), _unpad_wf(d_wfp, FE + 1), "dWf")
    _kink_close(at.grad.numpy(), d_attn, "da")


# -- the probe, the retired kernels and the shared listing ----------------------

def test_probe_edits_restore_the_retired_designs():
    """``tools/perf_dz_slot_grad.py``: ``u2x`` doubles the dz walk's
    entries in flight, ``one_part`` cuts the slot gradient's operands into
    one bf16 part, each applied once to the package's source; the probe's
    own source holds both retired kernels."""
    assert tdz.tiny_check() == ["retired", "u2x", "one_part"]
    dz, mma = tdz.edited_sources()
    assert "CPL == 1 ? 8 : CPL == 2 ? 4 : 2;" in dz["u2x"]
    assert "constexpr int kSplit = 1;" in mma["one_part"]
    with open(tdz.PROBE_SOURCE) as f:
        probe = f.read()
    assert re.search(r"\bbitdot_dz_kernel\(", probe)
    assert "template <int kCols, int kFe, bool kDef, typename T = float," \
        in probe
    assert "DGL_GRAD_CASE(2, 32, true)" in probe


def test_retired_kernels_left_the_package():
    """``bitdot_dz_kernel`` and ``vattn_slot_grad_kernel``'s edge instances
    (its kFe and kDef parameters, the reduce-scatter of d(ef)) are in the
    probe alone; the wrappers no longer name the retired C function."""
    for path in tbd.build.sources().values():
        with open(path) as f:
            src = f.read()
        # defined (``name(``) or launched (``name<...><<<``)
        assert not re.search(r"\bbitdot_dz_kernel(<[^>]*>)?\s*(\(|<<<)",
                             src), path
        assert "reduce_scatter" not in src and "DGL_GRAD_CASE" not in src
    with open(f"{CSRC}/gatv2.cu") as f:
        gatv2 = f.read()
    # K11 v1's stored instances left too, for the slot-gradient probe
    assert "template <int kCols, typename T, bool kStore>" not in gatv2
    with open(tsg.PROBE_SOURCE) as f:
        assert "template <int kCols, typename T, bool kStore>" in f.read()
    assert "template <int kCols, int kFe, bool kDef" not in gatv2
    assert "dgl_bitdot_bwd_dz\"" not in str(tbd._SIGNATURES)
    assert "dgl_bitdot_bwd_dz_list" in tbd._SIGNATURES


def test_listing_is_one_shared_header():
    """K5's listing lives in ``csrc/bitlist.cuh``, which ``bitgat.cu`` and
    ``bitdot.cu`` include, and nowhere else."""
    with open(f"{CSRC}/bitlist.cuh") as f:
        header = f.read()
    assert "void list_bits(" in header and "void list_start(" in header
    assert "constexpr int kListDrainAt = 128;" in header
    for name in ("bitgat", "bitdot"):
        with open(f"{CSRC}/{name}.cu") as f:
            src = f.read()
        assert '#include "bitlist.cuh"' in src, name
        assert "void list_bits(" not in src and "kListDrainAt =" not in src
    for name, path in tbd.build.sources().items():
        if name in ("bitgat", "bitdot"):
            continue
        with open(path) as f:
            assert "void list_bits(" not in f.read(), name
