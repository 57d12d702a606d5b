"""K7's forward and K11's scores as redesigned for Hopper, rendered on the
CPU: no compiler and no card here, so each rendering repeats its kernel's
index arithmetic in numpy.  No JAX here: the plain versions these
renderings are held to are held to the JAX functions by
``test_torch_bitdot.py``, ``test_torch_gatv2.py`` and
``test_torch_gat_fused_v1.py``.

* K7's forward as a listed-bit walk by dst (``csrc/bitdot.cu``
  ``bitdot_fwd_list_kernel``), lane by lane with the wrapper's layout
  (``bitdot.dz_layout``, the dq walk's): rows claimed in the forward's
  claim order, each row's lists filled and drained (``bit_listing``),
  groups of lpe lanes an entry, U entries in flight (``FwdUnroll``), z . q
  per head over the lanes of the head's block, p = exp(clip(e, +-40))
  into l's sum and p z[s] into out's, the groups' sums combined in a
  fixed order at the row's end, out = acc / max(l, 1e-20); held to
  ``bitdot_fwd_plain`` at (2, 64), (1, 128), (4, 32), (3, 8) and (1, 41)
  on a graph with a dst hub whose list fills several times and dst rows
  with no bit (exactly 0), with scores past +-40, at rtol / atol 1e-4,
  and l exactly the in-degree where every score is 0;
* K11's scores on the dot-product walk by dst (``csrc/row_agg.cu``):
  v1's ``row_sddmm_kernel<CPL, true, true, T>`` (the stored FE row, f32 or
  bf16, read at the entry's slot and added to U[nbr]) and v2's
  ``row_vattn_fe_kernel<KF>`` (fe = ef[slot] . wf formed per entry from
  the wrapper's padded operands, ``tiled_spmm.edge_operands``, the bias
  row added to V[r] once; one vector a lane, at least 8 lanes a row),
  each launch of the wrapper's plan rendered lane by lane
  (``sddmm_render``), the parts added in order: the raw sums bit for bit
  against the plain versions' on dyadic grids (v1 at 4 shapes with f32
  and bf16 stores; v2 at (8, 8), (1, 41) and (4, 32) with 5, 16 and 31
  features, with and without the bias row, and a head of 200 columns in
  two parts), and p at rtol 1e-4 / atol 1e-6 on normal inputs;
* the retired kernels are gone from ``dgl_tpu_torch/csrc/`` and live in
  the probe's source, the probes' edits apply, the layouts and unrolls
  in Python are the sources', and each wrapper on CPU tensors takes its
  plain version and counts no launch.
"""
import math
import re

import numpy as np
import pytest
import torch

import dgl_tpu_torch.ops.kernels.bitdot as tbd
import dgl_tpu_torch.ops.kernels.bitgat as tbg
import dgl_tpu_torch.ops.kernels.bitmm as tbm
import dgl_tpu_torch.ops.kernels.gat_fused as tgf
import dgl_tpu_torch.ops.kernels.tiled_spmm as tts
from dgl_tpu_torch.tools import perf_fwd_scores as tfs
from dgl_tpu_torch.tools import perf_scores_rows as tsr
from bit_listing import LANE, _drains
from sddmm_render import _launch_rendered

CSRC = tbd.build.CSRC_DIR
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
P_TOL = dict(rtol=1e-4, atol=1e-6)
CLIP = 40.0
FWD_UNROLL = {1: 8, 2: 4, 3: 2, 4: 2}     # csrc/bitdot.cu FwdUnroll
FE_SCORE_UNROLL = {8: 4, 16: 4, 32: 2}    # csrc/row_agg.cu FeScoreUnroll
FWD_SHAPES = [(2, 64), (1, 128), (4, 32), (3, 8), (1, 41)]
VATTN_SHAPES = [(8, 8), (1, 41), (4, 32)]
FES = [5, 16, 31]
F32 = np.float32
HUB, EMPTY = 7, range(200, 220)
RETIRED = ("bitdot_fwd_kernel", "walk_row", "Columns", "head_sums",
           "dgl_bitdot_fwd", "vattn_scores_kernel", "load_ef_chunk",
           "dgl_vattn_scores")


def _fma(a, b, c):
    """fmaf on f32 arrays: the exact product plus c, rounded once (through
    f64, whose 53 bits hold the product of two f32 exactly)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


# -- K7's forward: the listed walk by dst -------------------------------------

@pytest.fixture(scope="module")
def fwd_graph():
    """Simple edges src -> dst: dst row HUB a hub of 600 in-edges (its
    list drained when full, several times), dst rows EMPTY with none, and
    src ids up to 16,299, so that the rows of the packing hold 510 words
    (two steps of the walk) and reach bit plane 31.  (bf, the lists each
    row drains, the forward's claim order, the in-degrees)."""
    rng = np.random.default_rng(24)
    n_src, n_dst, e, hub = 16_300, 240, 3000, 600
    dst = rng.integers(0, n_dst, e)
    dst[(dst >= EMPTY.start) & (dst < EMPTY.stop)] = 3
    src = rng.integers(0, n_src, e)
    dst[:hub], src[:hub] = HUB, rng.permutation(n_src)[:hub]
    src[hub:hub + 40] = rng.integers(n_src - 400, n_src, 40)
    key = np.unique(dst * n_src + src)
    bf = tbm.build_bit_format(key % n_src, key // n_src, n_src, n_dst,
                              device="cpu")
    words = bf.packed.numpy().view(np.uint32)
    lists = [_drains(words[d], words.shape[1], n_src) for d in range(n_dst)]
    order = tbg.fwd_claim_order(bf).numpy()
    return bf, lists, order, np.bincount(key // n_src, minlength=n_dst)


def _fwd_inputs(seed, n_src, n_dst, heads, dim, saturate):
    """q and z on a grid of 1/16 in [-1, 1]; with ``saturate`` z is
    positive and every eighth row of q is +c or -c, about half of those
    rows' scores past +40 or -40."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-16, 17, (n_dst, heads, dim)) / 16
    z = rng.integers(-16, 17, (n_src, heads, dim)) / 16
    if saturate:
        z = np.abs(z) + 1 / 16
        c = round(40 / (0.5625 * math.sqrt(dim)) * 16) / 16
        q[::16], q[8::16] = c, -c
    return q.astype(F32), z.astype(F32)


def _render_fwd(lists, order, q, z, isd):
    """``bitdot_fwd_list_kernel`` lane by lane: (out (rows, H, D), l (rows,
    H)) f32."""
    rows, heads, dim = q.shape
    dp, lpe, cpl = tbd.dz_layout(heads, dim)
    vph, one = dp // 4, heads == 1
    nv = heads * vph
    u_flight = FWD_UNROLL[cpl]
    nh = 1 if one else cpl
    groups = 32 // lpe
    grp, li = LANE // lpe, LANE % lpe
    red = lpe if one else vph
    vq = li[:, None] + lpe * np.arange(cpl)                  # (32, cpl)
    ok = vq < nv
    vqs = np.where(ok, vq, 0)
    hq = np.zeros((32, nh), np.int64) if one else vqs // vph
    lead = ((grp == 0) & (li == 0))[:, None] if one else \
        (grp == 0)[:, None] & ok & (li % vph == 0)[:, None]

    def vectors(t):    # (n, H, D) -> (n, nv, 4), heads zero-padded
        p = np.zeros((t.shape[0], heads, dp), F32)
        p[..., :dim] = t
        return p.reshape(t.shape[0], nv, 4)

    qp, zp = vectors(q), vectors(z)
    isd = F32(isd)
    out = np.zeros((rows, nv, 4), F32)
    l = np.zeros((rows, heads), F32)
    for d in (int(r) for r in order):
        qd = np.where(ok[..., None], qp[d][vqs], F32(0))     # (32, cpl, 4)
        acc = np.zeros((32, cpl, 4), F32)
        lsum = np.zeros((32, nh), F32)
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
                    zd = np.zeros((32, nh), F32)
                    for c in range(cpl):       # the fma chain of each chain
                        t = 0 if one else c
                        for k in range(4):
                            zd[:, t] = _fma(zv[:, c, k], qd[:, c, k],
                                            zd[:, t])
                    off = red >> 1
                    while off:
                        zd = zd + zd[LANE ^ off]
                        off >>= 1
                    p = np.exp(np.clip(zd * isd, -CLIP, CLIP)).astype(F32)
                    lsum = np.where(live[:, None], lsum + p, lsum)
                    pc = p[:, :1] if one else p
                    acc = np.where(live[:, None, None],
                                   _fma(pc[..., None], zv, acc), acc)
        off = lpe
        while off < 32:        # the groups' sums, in a fixed order
            acc = acc + acc[LANE ^ off]
            lsum = lsum + lsum[LANE ^ off]
            off <<= 1
        for lane in np.nonzero(grp == 0)[0]:
            for c in np.nonzero(ok[lane])[0]:
                den = max(lsum[lane, 0 if one else c], F32(1e-20))
                out[d, vq[lane, c]] = acc[lane, c] / den
            for t in np.nonzero(lead[lane])[0]:
                l[d, hq[lane, t]] = lsum[lane, t]
    return out.reshape(rows, heads, dp)[..., :dim], l


def _plain_fwd(bf, q, z, isd):
    out, l = tbd.bitdot_fwd_plain(bf.packed, torch.from_numpy(q),
                                  torch.from_numpy(z), isd)
    return out.numpy(), l.numpy()


@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("heads,dim", FWD_SHAPES)
def test_fwd_walk_rendering_matches_plain(fwd_graph, heads, dim, saturate):
    bf, lists, order, _ = fwd_graph
    q, z = _fwd_inputs(heads * 100 + dim, bf.num_src, bf.num_dst, heads,
                       dim, saturate)
    isd = 1 / math.sqrt(dim)
    if saturate:
        dst, src = (a.numpy() for a in next(tbg.bit_edges(bf.packed,
                                                          bf.num_dst)))
        scores = (z[src] * q[dst]).sum(-1) * isd
        assert (np.abs(scores) >= CLIP).mean() > 0.01
    out, l = _render_fwd(lists, order, q, z, isd)
    want_out, want_l = _plain_fwd(bf, q, z, isd)
    np.testing.assert_allclose(out, want_out, **FWD_TOL)
    np.testing.assert_allclose(l, want_l, **FWD_TOL)
    assert order[0] == HUB, "the hub row must be claimed first"
    assert sum(1 for x in lists[HUB] if x) > 1, "its list must fill"
    assert (out[EMPTY.start:EMPTY.stop] == 0).all()
    assert (l[EMPTY.start:EMPTY.stop] == 0).all()


@pytest.mark.parametrize("heads,dim", [(2, 64), (1, 41)])
def test_fwd_walk_l_is_the_in_degree_at_zero_scores(fwd_graph, heads, dim):
    """q = 0: every p is 1, l is each dst's in-degree and out the mean of
    its z rows, whatever the order of the sums."""
    bf, lists, order, deg = fwd_graph
    _, z = _fwd_inputs(dim, bf.num_src, bf.num_dst, heads, dim, False)
    q = np.zeros((bf.num_dst, heads, dim), F32)
    out, l = _render_fwd(lists, order, q, z, 1 / math.sqrt(dim))
    np.testing.assert_array_equal(l, np.repeat(deg[:, None], heads, 1))
    np.testing.assert_allclose(out, _plain_fwd(bf, q, z, 0.125)[0],
                               **FWD_TOL)


def test_fwd_on_cpu_takes_the_plain_version(fwd_graph):
    """On CPU tensors ``bitdot_fwd`` (given a claim order or not) and the
    autograd function's forward take the plain version and count no
    launch."""
    bf, _, order, _ = fwd_graph
    q, z = _fwd_inputs(5, bf.num_src, bf.num_dst, 2, 64, False)
    want = _plain_fwd(bf, q, z, 0.125)
    qt, zt = torch.from_numpy(q), torch.from_numpy(z)
    before = tbd.bitdot_fwd.launches
    for o in (None, torch.from_numpy(order)):
        out, l = tbd.bitdot_fwd(bf.packed, qt, zt, 0.125, o)
        np.testing.assert_array_equal(out.numpy(), want[0])
        np.testing.assert_array_equal(l.numpy(), want[1])
    got = tbd.bitdot_attention_aggregate(bf, qt, zt)
    np.testing.assert_array_equal(got.numpy(), want[0])
    assert tbd.bitdot_fwd.launches == before


# -- K11's scores on the dot-product walk -------------------------------------

@pytest.fixture(scope="module")
def tiled():
    """A multigraph of 600 nodes and 3,000 edges on tiles of 256 and
    buckets of 128 slots (padded ones among them): dst 5 a hub of 150
    in-edges, dst rows 512-599 with none."""
    rng = np.random.default_rng(42)
    n, e = 600, 3000
    row = rng.integers(0, n, e)
    col = rng.integers(0, 512, e)
    col[:150] = 5
    row[300:400], col[300:400] = row[400:500], col[400:500]   # multi-edges
    return tts.build_tiled_format(row, col, n, n, 256, 128, device="cpu")


def _vattn_chain(a, s, slope):
    """``vattn_dot``'s sum over a vector's four floats of a lrelu(s): the
    first product rounded, then an fma a float."""
    lr = np.where(s >= 0, s, F32(slope) * s).astype(F32)
    d = (a[..., 0] * lr[..., 0]).astype(F32)
    for i in range(1, 4):
        d = _fma(a[..., i], lr[..., i], d)
    return d


def _render_scores(tf, U3, V3, attn, slope, ef_slot=None, wf=None,
                   fe_slot=None, raw=False):
    """K11's scores as the walk and its pass compute them: (B, H, C) f32,
    the raw sums (``raw``; 0 at padded slots) or p.  v1 (``fe_slot``):
    each entry's gathered row U[nbr] + FE[slot] (heads padded, FE 0 there)
    against V[r], the walk's plan and lanes.  v2 (``ef_slot``, ``wf``):
    the plan at one vector a lane, at least 8 lanes a row, FeScoreUnroll
    entries a round; a lane's partial sums attn lrelu((V[r] + bias) +
    U[nbr] + fe) with fe an fma a feature over the padded edge-feature row
    at the entry's slot and the lane's columns of wf.  Then the parts
    added in order; p = exp(clip(., +-40)) by torch's exp."""
    heads, dim = U3.shape[1:]
    hp = -(-dim // 4) * 4
    hv = hp // 4
    view = tf.row_view("dst")
    ptr, slot, nbr = (t.numpy().astype(np.int64)
                      for t in (view.ptr, view.slot, view.nbr))
    e = len(slot)
    rows = np.repeat(np.arange(view.rows), np.diff(ptr))
    u = tts._vec4_rows(U3, hp).numpy()
    v = tts._vec4_rows(V3, hp).numpy()
    a = tts._vec4_rows(attn.reshape(1, heads, dim), hp).numpy()[0]
    gather = view
    edge = None
    if fe_slot is not None:
        x = u[nbr].copy()
        st = fe_slot.float().numpy().reshape(-1, heads, dim)[slot]
        x[..., :dim] = (x[..., :dim] + st).astype(F32)
        gather = type("Entries", (), {"ptr": view.ptr,
                                      "nbr": torch.arange(e)})
        plan, parts = tts._sddmm_plan(heads, hv)
    else:
        x = u
        plan, parts = tts._sddmm_plan(heads, hv, tts.FE_SCORE_CPL)
        if ef_slot is not None:
            efp, fq, wfp, fe, bias, kf = tts.edge_operands(ef_slot, wf,
                                                           heads, hp)
            efp, wfp = efp.numpy(), wfp.numpy()
            if bias is not None:
                v = (v + bias.numpy().reshape(1, heads, hp)).astype(F32)
            edge = (efp, fq, wfp, kf)
    x = x.reshape(x.shape[0], heads, hv, 4)
    z = v.reshape(-1, heads, hv, 4)
    a = a.reshape(heads, hv, 4)
    sm = np.full((parts, e, heads), np.nan, F32)
    for h0, nh, v0, nv, part in plan:
        sub = (slice(h0, h0 + nh), slice(v0, v0 + nv))
        a_l = a[sub].reshape(nh * nv, 4)
        xl = np.ascontiguousarray(x[(slice(None),) + sub]).reshape(
            -1, nh * nv, 4)
        zl = np.ascontiguousarray(z[(slice(None),) + sub]).reshape(
            -1, nh * nv, 4)
        if edge is None and fe_slot is None:
            raise ValueError("the scores need a term")
        if edge is None:
            def partial(xs, zs, vq, a_l=a_l):
                return _vattn_chain(a_l[vq], (xs + zs).astype(F32), slope)
            found = _launch_rendered(gather, xl, zl, nh, nv, rows, partial)
        else:
            efp, fq, wfp, kf = edge

            def partial(xs, zs, vq, ent, a_l=a_l, h0=h0, v0=v0, nv=nv):
                c0 = (h0 + vq // nv) * hp + 4 * (v0 + vq % nv)
                fv = np.zeros((len(ent), 4), F32)
                for k in range(4 * fq):
                    wk = (wfp[k, c0:c0 + 4] if k < wfp.shape[0]
                          else np.zeros(4, F32))
                    fv = _fma(efp[slot[ent], k][:, None], wk[None], fv)
                s = ((zs + xs).astype(F32) + fv).astype(F32)
                return _vattn_chain(a_l[vq], s, slope)

            lph, cph, lpr, cpl = tts._sddmm_layout(nh, nv, tts.FE_SCORE_CPL)
            found = _launch_rendered(
                view, xl, zl, nh, nv, rows, partial,
                layout=(lph, cph, max(lpr, tts.FE_MIN_LANES), cpl),
                u_n=FE_SCORE_UNROLL[kf], with_entries=True)
        for ent, h, val in found:
            sm[part, ent, h0 + h] = val
    assert not np.isnan(sm).any()          # every entry of every part
    tot = sm[0]
    for j in range(1, parts):              # the parts, in order
        tot = (tot + sm[j]).astype(F32)
    out = np.zeros((tf.num_buckets, heads, tf.cap), F32)
    b, c = slot // tf.cap, slot % tf.cap
    out[b, :, c] = tot if raw else torch.exp(torch.clamp(
        torch.from_numpy(tot), -CLIP, CLIP)).numpy()
    return out


def _plain_raw(tf, U3, V3, attn, slope, ef_slot=None, wf=None,
               fe_slot=None):
    """The plain versions' logits, sum_d attn lrelu(raw) (B, H, C) f32, 0
    at padded slots, raw formed by their own helper."""
    out = torch.zeros(tf.num_buckets, U3.shape[1], tf.cap)
    for b, c, src, dst in tts._slot_chunks(tf):
        raw = tgf._vattn_raw(
            U3, V3, src, dst, None if ef_slot is None else ef_slot[b, c], wf,
            None if fe_slot is None else fe_slot[b, c])
        out[b, :, c] = (torch.nn.functional.leaky_relu(raw, slope)
                        * attn.float()).sum(-1)
    return out.numpy()


def _q(rng, shape, step, top):
    return (rng.integers(-round(top / step), round(top / step) + 1, shape)
            * step).astype(F32)


def _v2_inputs(tf, heads, dim, fe, bias, grid, seed):
    """U, V, attn, ef_slot and wf (with the bias row where ``bias``).  On
    the grid U, V and attn multiples of 1/4 in [-1, 1], wf of 1/4 in
    [-1/2, 1/2] and the edge features in {-1, 0, 1}: every logit is exact
    in f32 in any order at a slope of 1/4.  Else normal values."""
    rng = np.random.default_rng(seed)
    n, hd = tf.num_src, heads * dim
    b, cap = tf.num_buckets, tf.cap
    rows = fe + int(bias)
    if grid:
        U, V = _q(rng, (n, heads, dim), 0.25, 1), _q(rng, (n, heads, dim),
                                                     0.25, 1)
        attn, wf = _q(rng, (heads, dim), 0.25, 1), _q(rng, (rows, hd), 0.25,
                                                      0.5)
        ef = rng.integers(-1, 2, (b, cap, fe)).astype(F32)
    else:
        U, V = (rng.normal(size=(n, heads, dim)).astype(F32)
                for _ in range(2))
        attn = rng.normal(size=(heads, dim)).astype(F32)
        wf = (rng.normal(size=(rows, hd)) / 4).astype(F32)
        ef = rng.normal(size=(b, cap, fe)).astype(F32)
    ef *= tf.valid.numpy().reshape(b, cap, 1)
    return [torch.from_numpy(t) for t in (U, V, attn, ef, wf)]


def _v1_inputs(tf, heads, dim, dtype, grid, seed):
    """U, V (multiples of 1/16 in [-1, 1] on the grid), attn (of 1/16 in
    [-1/2, 1/2]) and the stored FE (B, C, H D) in ``dtype`` (of 1/16 in
    [-1/2, 1/2], exact in bf16), 0 at padded slots; else normal values."""
    rng = np.random.default_rng(seed)
    n, b, cap = tf.num_src, tf.num_buckets, tf.cap
    if grid:
        U, V = _q(rng, (n, heads, dim), 1 / 16, 1), _q(rng, (n, heads, dim),
                                                       1 / 16, 1)
        attn = _q(rng, (heads, dim), 1 / 16, 0.5)
        fe = _q(rng, (b, cap, heads * dim), 1 / 16, 0.5)
    else:
        U, V = (rng.normal(size=(n, heads, dim)).astype(F32)
                for _ in range(2))
        attn = rng.normal(size=(heads, dim)).astype(F32)
        fe = (rng.normal(size=(b, cap, heads * dim)) / 2).astype(F32)
    fe *= tf.valid.numpy().reshape(b, cap, 1)
    return [torch.from_numpy(t) for t in (U, V, attn)] + [
        torch.from_numpy(fe).to(dtype)]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("fe", FES)
@pytest.mark.parametrize("heads,dim", VATTN_SHAPES)
def test_v2_scores_rendering_exact_on_a_grid(tiled, heads, dim, fe, bias):
    U, V, attn, ef, wf = _v2_inputs(tiled, heads, dim, fe, bias, True,
                                    heads + dim + fe)
    got = _render_scores(tiled, U, V, attn, 0.25, ef, wf, raw=True)
    want = _plain_raw(tiled, U, V, attn, 0.25, ef, wf)
    assert np.abs(want).max() > 0
    np.testing.assert_array_equal(got, want)


def test_v2_scores_rendering_wide_head_in_two_parts(tiled):
    """A head of 200 columns (50 vectors) takes two launches, each a part
    of its own at one vector a lane; the pass adds them in order."""
    plan, parts = tts._sddmm_plan(1, 50, tts.FE_SCORE_CPL)
    assert parts == 2 and len(plan) == 2
    U, V, attn, ef, wf = _v2_inputs(tiled, 1, 200, 5, True, True, 200)
    got = _render_scores(tiled, U, V, attn, 0.25, ef, wf, raw=True)
    np.testing.assert_array_equal(got, _plain_raw(tiled, U, V, attn, 0.25,
                                                  ef, wf))


@pytest.mark.parametrize("fe,bias", [(5, True), (16, True), (31, False)])
@pytest.mark.parametrize("heads,dim", VATTN_SHAPES)
def test_v2_scores_rendering_matches_plain(tiled, heads, dim, fe, bias):
    """Normal inputs at EGAT's slope: f32 sums in another order."""
    U, V, attn, ef, wf = _v2_inputs(tiled, heads, dim, fe, bias, False,
                                    heads * dim + fe)
    got = _render_scores(tiled, U, V, attn, 0.01, ef, wf)
    want = tgf.vattn_scores_plain(tiled, U, V, attn, 0.01, ef, wf).numpy()
    np.testing.assert_allclose(got, want, **P_TOL)
    pad = np.broadcast_to(tiled.valid.numpy().reshape(
        tiled.num_buckets, 1, tiled.cap) == 0, got.shape)
    assert pad.any() and (got[pad] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dim", [(4, 32), (1, 41), (8, 8), (3, 5)])
def test_v1_scores_rendering_exact_on_a_grid(tiled, heads, dim, dtype):
    U, V, attn, fe = _v1_inputs(tiled, heads, dim, dtype, True, heads + dim)
    got = _render_scores(tiled, U, V, attn, 0.25, fe_slot=fe, raw=True)
    want = _plain_raw(tiled, U, V, attn, 0.25, fe_slot=fe)
    assert np.abs(want).max() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dim", [(4, 32), (1, 41)])
def test_v1_scores_rendering_matches_plain(tiled, heads, dim, dtype):
    U, V, attn, fe = _v1_inputs(tiled, heads, dim, dtype, False, 3 * dim)
    got = _render_scores(tiled, U, V, attn, 0.01, fe_slot=fe)
    want = tgf.egatc_scores_plain(tiled, U, V, attn, fe, 0.01).numpy()
    np.testing.assert_allclose(got, want, **P_TOL)


def test_scores_on_cpu_take_the_plain_versions(tiled):
    """On CPU tensors ``vattn_scores`` with the edge term and
    ``egatc_scores`` take their plain versions and count no launch."""
    U, V, attn, ef, wf = _v2_inputs(tiled, 4, 8, 5, True, True, 1)
    fe = _v1_inputs(tiled, 4, 8, torch.float32, True, 2)[3]
    before = (tgf.vattn_scores.launches, tgf.egatc_scores.launches)
    assert torch.equal(tgf.vattn_scores(tiled, U, V, attn, 0.2, ef, wf),
                       tgf.vattn_scores_plain(tiled, U, V, attn, 0.2, ef,
                                              wf))
    assert torch.equal(tgf.egatc_scores(tiled, U, V, attn, fe, 0.2),
                       tgf.egatc_scores_plain(tiled, U, V, attn, fe, 0.2))
    assert (tgf.vattn_scores.launches, tgf.egatc_scores.launches) == before


# -- the sources, the probe and the layouts -----------------------------------

def test_retired_kernels_left_the_package():
    """The retired kernels, their helpers and C functions appear nowhere in
    ``dgl_tpu_torch/csrc/`` and live in the probe's source; no wrapper
    names their C functions."""
    for path in [*tbd.build.sources().values(),
                 *(f"{CSRC}/{h}" for h in ("bitlist.cuh", "persistent.cuh",
                                           "tma.cuh"))]:
        with open(path) as f:
            src = f.read()
        for name in RETIRED:
            assert not re.search(rf"\b{name}\b", src), (name, path)
    assert "dgl_bitdot_fwd" not in tbd._SIGNATURES
    assert "dgl_bitdot_fwd_list" in tbd._SIGNATURES
    assert "dgl_vattn_scores" not in tgf._VATTN_SIGNATURES
    with open(tfs.PROBE_SOURCE) as f:
        probe = f.read()
    for name in ("bitdot_fwd_kernel(", "walk_row(", "struct Columns",
                 "head_sums(", "int dgl_bitdot_fwd(", "vattn_scores_kernel(",
                 "load_ef_chunk(", "int dgl_vattn_scores("):
        assert name in probe, name


def test_probe_edits_apply():
    """``tools/perf_fwd_scores.py``: ``u2x`` doubles the entries in flight
    of the forward and of K11 v2's scores walk, each applied once;
    ``tools/perf_scores_rows.py``'s edit, which puts K9's instance back in
    the bucket walk, applies to the probe's source."""
    assert tfs.tiny_check() == ["retired", "fwd_u2x", "scores_u2x"]
    fwd, scores = tfs.edited_sources()
    assert "CPL == 1 ? 16 : CPL == 2 ? 8 : 4;" in fwd["u2x"]
    assert "KF <= 16 ? 8 : 4;" in scores["u2x"]
    assert tsr.tiny_check() == ["bucket_scores", "fma_rows"]
    assert "DGL_SCORES_LAUNCH(false, float, false)\n" in \
        tsr.edited_scores_source()


def test_layouts_and_unrolls_match_the_sources():
    """The renderings' entries in flight and lanes are the sources', and
    the forward's layout is the dq walk's."""
    with open(f"{CSRC}/bitdot.cu") as f:
        bitdot = f.read()
    assert "static constexpr int value = CPL == 1 ? 8 : CPL == 2 ? 4 : 2;" \
        in bitdot
    with open(f"{CSRC}/row_agg.cu") as f:
        row_agg = f.read()
    assert "static constexpr int value = KF <= 16 ? 4 : 2;" in row_agg
    assert f"constexpr int kFeMinLanes = {tts.FE_MIN_LANES};" in row_agg
    assert tbd.dz_layout(1, 41) == (44, 4, 3)
    assert tbd.dz_layout(3, 8) == (8, 4, 2)
    # K11 v2's walk at EGAT's (4, 32), (8, 8) and (1, 41): one launch
    assert tts._sddmm_plan(4, 8, 1) == ([(0, 4, 0, 8, 0)], 1)
    assert tts._sddmm_layout(4, 8, 1) == (8, 1, 32, 1)
    assert tts._sddmm_layout(8, 2, 1) == (2, 1, 16, 1)
    assert tts._sddmm_layout(1, 11, 1) == (16, 1, 16, 1)
    assert tts._sddmm_plan(8, 8, 1)[0] == [(0, 4, 0, 8, 0), (4, 4, 0, 8, 0)]
    with pytest.raises(ValueError):
        tts._sddmm_layout(8, 8, 1)
