"""K11 v1's slot gradient on the slot walk by dst and K10 v2's scores
from each lane's own edge-feature row, as redesigned for Hopper, and the
staged design of the scores that lost to them on the card, rendered on
the CPU: no compiler and no
card here, so each rendering repeats its kernel's index arithmetic and
order of operations in numpy.

* The slot gradient (``csrc/row_agg.cu`` ``row_slot_grad_kernel``, the
  zero pass and ``range_sum_kernel`` twice) at the wrapper's layout
  (``tiled_spmm.slot_layout``): per entry of each dst row, in the view's
  slot order, raw = (U[src] + V[dst]) + FE[slot], dW written at the slot
  in FE's dtype and added, as stored, into the row's dFNJ; da summed per
  lane over the rows of a static range of the claim order, the groups of
  a warp combined by an xor butterfly, the ranges' partials added in
  range order in segments.  On a dyadic grid (every product and sum exact
  in f32) da, dFE and dFNJ equal the plain version bit for bit, in f32
  and bf16; on normal inputs dFNJ equals the slot vector sum of the
  rendering's dFE taken in ``row_slot_kernel``'s order (kSlotVec) bit for
  bit, the order the parent summed dFNJ in, and the plain version to rtol
  1e-4 / atol 1e-4 (da's atol scaled by its largest magnitude: a sum over
  every edge in another order).
* The scores (``csrc/gat_fused.cu`` ``edge_scores_kernel``): a lane a
  slot, its own row read (16 or 4 bytes at a time) only where the slot is
  live (the padded rows hold NaN here and must not be read), its logit t =
  sum_f ef[f] M[f, h] by FMAs from f = 0, added to el + er: equal to
  ``edgegat_scores_plain`` bit for bit on the grid of
  ``chip_smoke.edgegat_inputs`` at Fe 5, 16 and 31.  The staged design
  (``tools/slot_grad_scores_probe.cu`` ``edge_scores_staged_kernel``): a
  warp's 32 slots' ef rows copied 16 or 4 bytes at a time into rows of
  ``edge_row_floats`` floats, only the live slots', then the same sum from
  the staged row: the same bits; the staged rows' reads meet no bank
  conflict.
* The new plain version (da, dFE, dFNJ) against a float64 rendering of its
  function on the same inputs (f32 rounding only: rtol 1e-6 on dFE, each
  sum within 1e-5 of the sum of its terms' magnitudes), and, chained as
  the autograd function chains it, against the JAX
  ``egatconv_attention_aggregate``'s backward with its Pallas kernels
  interpreted (as ``test_torch_gat_fused_v1.py`` runs them), at (4, 8) on
  a graph of a few hundred edges: the JAX kernels round the node
  operands, attn, ds and dFE to bf16, and its ds = (<x, zn> - rp) * g
  differs from the port's f32 one by a rounding relative to the terms of
  that difference, not to ds, so the rule of
  ``tests/test_pallas.py:226-235`` (at most 0.5% of elements outside 2e-1
  + 8e-2 |ref|, ``_kink_close``).
* The wrappers take their plain versions on CPU tensors, ``egatc_backward``
  takes dFNJ from the slot gradient (one slot vector sum, by src, and ds
  slot-major), the retired kernels live in the probe alone and the probe's
  and ``perf_ds_fold``'s edits apply.
"""
import re
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import dgl_tpu.ops.pallas.gat_fused as jgf
import dgl_tpu.ops.pallas.tiled_spmm as jts
import dgl_tpu_torch.ops.kernels.gat_fused as tgf
import dgl_tpu_torch.ops.kernels.tiled_spmm as tts
from dgl_tpu_torch.tools import perf_ds_fold as tdf
from dgl_tpu_torch.tools import perf_slot_grad_scores as tsg
from test_torch_gat_fused import _kink_close
# tiled: test_torch_slot_walks.py's fixture (600 nodes, 3,000 edges, a dst
# hub, rows with no edge, padded slots), used here by name
from test_torch_slot_walks import _fma, _grid, _render_slot, _view, tiled  # noqa: F401,E501

CSRC = tts.build.CSRC_DIR
F32 = np.float32
SLOPE = 0.2
EXACT_SLOPE = 0.25          # dW on a grid: chip_smoke.EXACT_SLOPE
F32_, BF16_ = torch.float32, torch.bfloat16
# (H, D, FE's dtype): 4 groups a warp (4, 8), one (4, 32), 1-float loads
# (1, 41), two column chunks (4, 80)
GRAD_CASES = [(4, 8, F32_), (4, 8, BF16_), (4, 32, F32_), (4, 32, BF16_),
              (1, 41, F32_), (4, 80, BF16_)]
RANGE_SUBS = 8              # csrc/row_agg.cu kRangeSubs


# -- the slot gradient -------------------------------------------------------

def _grad_inputs(tf, heads, dim, dtype, grid, seed):
    """U (src, H D), V (dst, H D), attn (H D,) f32 numpy, FE (B, C, H D) in
    ``dtype`` and ds (B, H, C) slot-major.  On the grid (chip_smoke's
    ``egatc_inputs``): U, V multiples of 1/16 in [-1, 1], attn and FE in
    [-1/2, 1/2], ds of 1/8 in [-1, 1], so with EXACT_SLOPE every dW is a
    multiple of 1/512 and every sum exact; else normal values."""
    rng = np.random.default_rng(seed)
    b, cap, f = tf.num_buckets, tf.cap, heads * dim
    valid = tf.valid.numpy().reshape(b, cap)
    if grid:
        u = _grid(rng, (tf.num_src, f), 1 / 16, 1)
        v = _grid(rng, (tf.num_dst, f), 1 / 16, 1)
        attn = _grid(rng, (f,), 1 / 16, 0.5)
        fe = _grid(rng, (b, cap, f), 1 / 16, 0.5)
        ds = _grid(rng, (b, heads, cap), 1 / 8, 1)
    else:
        u, v = (rng.normal(size=(n, f)).astype(F32)
                for n in (tf.num_src, tf.num_dst))
        attn = rng.normal(size=f).astype(F32)
        fe = rng.normal(size=(b, cap, f)).astype(F32)
        ds = rng.normal(size=(b, heads, cap)).astype(F32)
    fe *= valid[..., None]
    ds *= valid[:, None, :]
    return (u, v, attn, torch.from_numpy(fe).to(dtype),
            tgf._slot_major(torch.from_numpy(ds)))


def _range_sum(part, seg, segs):
    """``range_sum_kernel``: out[s] = the sum of part's rows [s seg, (s + 1)
    seg), warp w summing rows w, w + RANGE_SUBS, ..., the warps' sums then
    added in warp order."""
    out = np.zeros((segs, part.shape[1]), F32)
    for s in range(segs):
        lo, hi = s * seg, min(len(part), (s + 1) * seg)
        sums = np.zeros((RANGE_SUBS, part.shape[1]), F32)
        for w in range(RANGE_SUBS):
            for i in range(lo + w, hi, RANGE_SUBS):
                sums[w] = sums[w] + part[i]
        t = sums[0]
        for w in range(1, RANGE_SUBS):
            t = t + sums[w]
        out[s] = t
    return out


def _render_slot_grad(tf, u, v, attn, fe, ds, slope, head_cols):
    """The slot gradient's four launches on the wrapper's operands: (da
    (f,) f32, dFE (slots, f) in FE's dtype, dFNJ (rows, f) f32)."""
    slots = tf.num_buckets * tf.cap
    f = u.shape[1]
    fe2 = fe.reshape(slots, f)
    vec, cpl, lpr, n_chunks = tts.slot_layout(f, (head_cols,), fe2)
    owned = np.zeros(f, np.int64)
    for chunk in range(n_chunks):
        for li in range(lpr):
            for q in range(cpl):
                cv = (chunk * cpl + q) * lpr + li
                if cv < f // vec:
                    owned[cv * vec:(cv + 1) * vec] += 1
    assert (owned == 1).all(), "every column owned by one lane once"
    assert n_chunks == 1 or lpr == 32, "column chunks only with one group"
    ptr, slot, nbr = _view(tf, "dst")
    order = tf.row_view("dst").order.numpy()
    rows = len(ptr) - 1
    groups = 32 // lpr
    k_rows = tts.SLOT_GRAD_RANGE_ROWS
    n_ranges = -(-rows // k_rows)
    heads_of = np.arange(f) // head_cols
    dsn = ds.float().numpy()          # (B, H, C) whatever its strides
    fen = fe2.float().numpy()
    sl = F32(slope)
    dfe = np.full((slots, f), np.nan, F32)
    dfnj = np.full((rows, f), np.nan, F32)
    part = np.zeros((n_ranges, f), F32)
    for k in range(n_ranges):
        first, last = k * k_rows, min((k + 1) * k_rows, rows)
        da = np.zeros((groups, f), F32)
        for g in range(groups):
            for item in range(first + g, last, groups):
                r = order[item]
                ent = np.arange(ptr[r], ptr[r + 1])
                s, n = slot[ent], nbr[ent]
                # each entry's terms (independent of the order)
                dq = dsn[(s // tf.cap)[:, None], heads_of[None, :],
                         (s % tf.cap)[:, None]]
                raw = (u[n] + v[r]) + fen[s]
                pos = raw >= 0
                lr = np.where(pos, raw, sl * raw)
                dw = (dq * attn) * np.where(pos, F32(1), sl)
                dfe[s] = torch.from_numpy(dw).to(fe.dtype).float().numpy()
                # the sums, entry by entry in the view's order
                acc = np.zeros(f, F32)
                for i in range(len(ent)):
                    da[g] = _fma(dq[i], lr[i], da[g])
                    acc = acc + dfe[s[i]]
                dfnj[r] = acc
        m = 1
        while m < groups:          # the xor butterfly over the groups
            da = da + da[np.arange(groups) ^ m]
            m <<= 1
        assert (da == da[0]).all(), "every group holds the same sums"
        part[k] = da[0]
    dfe[tf.valid.reshape(-1).numpy() == 0] = 0     # the zero pass
    assert not np.isnan(dfe).any() and not np.isnan(dfnj).any()
    segs = tts.SLOT_GRAD_SEGMENTS
    part2 = _range_sum(part, -(-n_ranges // segs), segs)
    da = _range_sum(part2, segs, 1)[0]
    return da, torch.from_numpy(dfe).to(fe.dtype), dfnj


@pytest.mark.parametrize("heads,dim,dtype", GRAD_CASES,
                         ids=[f"{h}-{d}-{str(t)[-4:]}" for h, d, t in
                              GRAD_CASES])
def test_slot_grad_rendering_exact_on_grid(tiled, heads, dim, dtype):
    """On the grid the rendered walk's da, dFE and dFNJ equal the plain
    version's bit for bit, and its dFNJ equals the plain slot vector sum
    of its dFE by dst; dFE is 0 at every padded slot."""
    u, v, attn, fe, ds = _grad_inputs(tiled, heads, dim, dtype, True, 50)
    da, dfe, dfnj = _render_slot_grad(tiled, u, v, attn, fe, ds, EXACT_SLOPE,
                                      dim)
    b, cap = tiled.num_buckets, tiled.cap
    U3 = torch.from_numpy(u).view(-1, heads, dim)
    V3 = torch.from_numpy(v).view(-1, heads, dim)
    want = tgf.egatc_slot_grad_plain(tiled, U3, V3,
                                     torch.from_numpy(attn).view(heads, dim),
                                     fe, ds, EXACT_SLOPE)
    assert torch.equal(torch.from_numpy(da).view(heads, dim), want[0])
    assert torch.equal(dfe.view(b, cap, -1), want[1])
    assert torch.equal(torch.from_numpy(dfnj), want[2])
    assert torch.equal(torch.from_numpy(dfnj), tgf.slot_vec_reduce_plain(
        tiled, dfe.view(b, cap, -1), "dst"))
    pad = tiled.valid.reshape(-1) == 0
    assert (dfe[pad].float() == 0).all()


@pytest.mark.parametrize("heads,dim,dtype", [(4, 32, F32_), (1, 41, BF16_)],
                         ids=["4-32-f32", "1-41-bf16"])
def test_slot_grad_rendering_keeps_dfnj_order(tiled, heads, dim, dtype):
    """On normal inputs the walk's dFNJ is the slot walk's kSlotVec sum of
    its own dFE bit for bit (the same order: entries in slot order, each
    added as stored), and all three outputs are close to the plain
    version's."""
    u, v, attn, fe, ds = _grad_inputs(tiled, heads, dim, dtype, False, 51)
    da, dfe, dfnj = _render_slot_grad(tiled, u, v, attn, fe, ds, SLOPE, dim)
    b, cap = tiled.num_buckets, tiled.cap
    vec_sum, _ = _render_slot(tiled, tts.SLOT_VEC_DST, dfe.view(b, cap, -1),
                              heads * dim)
    assert np.array_equal(dfnj, vec_sum)
    want = tgf.egatc_slot_grad_plain(
        tiled, torch.from_numpy(u).view(-1, heads, dim),
        torch.from_numpy(v).view(-1, heads, dim),
        torch.from_numpy(attn).view(heads, dim), fe, ds, SLOPE)
    np.testing.assert_allclose(
        da, want[0].reshape(-1).numpy(), rtol=1e-4,
        atol=1e-4 * float(want[0].abs().max()))
    np.testing.assert_allclose(dfe.float().numpy(),
                               want[1].reshape(-1, heads * dim).float()
                               .numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dfnj, want[2].numpy(), rtol=1e-4, atol=1e-4)


def test_slot_grad_ranges_and_hubs():
    """The static ranges of the claim order: each range's rows are taken
    by the warp's groups in turn, a dst hub (claimed first) is in the
    first range, rows with no entry (dFNJ 0) count in theirs; at lpr 32
    one group takes all of a range's rows."""
    rng = np.random.default_rng(52)
    n, e = 300, 1200
    row = rng.integers(0, n, e)
    col = rng.integers(0, 200, e)           # dst 200-299: no in-edge
    col[:400] = 3                            # a dst hub of 400 in-edges
    tf = tts.build_tiled_format(row, col, n, n, 256, 128,
                                device="cpu").with_src_first()
    view = tf.row_view("dst")
    assert int(view.order[0]) == 3
    u, v, attn, fe, ds = _grad_inputs(tf, 4, 32, torch.float32, True, 53)
    da, dfe, dfnj = _render_slot_grad(tf, u, v, attn, fe, ds, EXACT_SLOPE,
                                      32)
    assert (dfnj[200:] == 0).all()
    want = tgf.egatc_slot_grad_plain(
        tf, torch.from_numpy(u).view(-1, 4, 32),
        torch.from_numpy(v).view(-1, 4, 32),
        torch.from_numpy(attn).view(4, 32), fe, ds, EXACT_SLOPE)
    assert torch.equal(torch.from_numpy(da).view(4, 32), want[0])
    assert torch.equal(torch.from_numpy(dfnj), want[2])
    assert tts.SLOT_GRAD_RANGE_ROWS >= 1 and tts.SLOT_GRAD_SEGMENTS >= 1


# -- K10 v2's scores and their staged design -----------------------------------

def _score_inputs(tf, heads, fe, seed):
    """``chip_smoke.edgegat_inputs``' grid: el, er multiples of 1/16 in
    [-1, 1], ef in {-1, 0, 1} (NaN at padded slots: a padded row must not
    be read), M = We . attn_e of 1/256: every logit exact in f32."""
    rng = np.random.default_rng(seed)
    b, cap = tf.num_buckets, tf.cap
    el = _grid(rng, (tf.num_src, heads), 1 / 16, 1)
    er = _grid(rng, (tf.num_dst, heads), 1 / 16, 1)
    ef = rng.integers(-1, 2, (b, cap, fe)).astype(F32)
    ef[tf.valid.numpy().reshape(b, cap) == 0] = np.nan
    we = _grid(rng, (fe, heads, 8), 1 / 16, 0.25)
    at = _grid(rng, (heads, 8), 1 / 16, 0.25)
    m = np.einsum("fhd,hd->fh", we, at).astype(F32)
    return el, er, ef, m


def _render_edge_scores(tf, el, er, ef, m, slope, vec16, staged=False):
    """(p, g (B, H, C)) of ``edge_scores_kernel`` (a lane a slot, its own
    row read 16 bytes at a time where ``vec16``, else 4, only where the
    slot is live), or (``staged``) of the staged design: each warp's chunk
    of 32 slots staged (16-byte copies where ``vec16``, else 4-byte), only
    the live slots' rows, then a lane a slot on its staged row."""
    b, cap = tf.num_buckets, tf.cap
    fe, heads = m.shape
    width = 4 if vec16 else 1
    slots = b * cap
    flat = ef.reshape(slots * fe)
    valid = tf.valid.numpy().reshape(-1)
    src_local, dst_local = (t.numpy().reshape(-1)
                            for t in (tf.src_local, tf.dst_local))
    raw = np.zeros((slots, heads), F32)
    for k in range(slots // 32):
        live = valid[32 * k:32 * k + 32] != 0
        block = flat[32 * k * fe:32 * (k + 1) * fe]
        if staged:
            ld = tsg.edge_row_floats(fe, vec16)
            buf = np.full((32, ld), np.nan, F32)
            for j in range(32 * fe // width):
                r = j * width // fe
                if live[r]:
                    col = j * width - r * fe
                    buf[r, col:col + width] = block[j * width:(j + 1) * width]
        else:
            buf = np.full((32, fe), np.nan, F32)
            for r in np.nonzero(live)[0]:   # a lane's own loads
                for q in range(fe // width):
                    buf[r, q * width:(q + 1) * width] = block[
                        r * fe + q * width:r * fe + (q + 1) * width]
        lanes = np.nonzero(live)[0]
        if len(lanes) == 0:
            continue
        s = 32 * k + lanes
        bk = s // cap
        src = tf.src_tile.numpy()[bk] * tf.tile + src_local[s]
        dst = tf.dst_tile.numpy()[bk] * tf.tile + dst_local[s]
        x = buf[lanes]
        for h in range(heads):
            t = np.zeros(len(lanes), F32)
            for f in range(fe):
                t = _fma(x[:, f], np.full(len(lanes), m[f, h], F32), t)
            raw[s, h] = (el[src, h] + er[dst, h]) + t
    rt = torch.from_numpy(raw)
    pos = rt >= 0
    pv = torch.exp(torch.clamp(torch.where(pos, rt, slope * rt), -tgf.CLIP,
                               tgf.CLIP)) * torch.from_numpy(valid)[:, None]
    gv = pv * torch.where(pos, 1.0, slope)
    p = pv.view(b, cap, heads).permute(0, 2, 1).contiguous()
    g = gv.view(b, cap, heads).permute(0, 2, 1).contiguous()
    return p, g


SCORE_CASES = [(5, False), (16, True), (16, False), (31, False)]


@pytest.mark.parametrize("fe,vec16", SCORE_CASES,
                         ids=["5-4B", "16-16B", "16-4B", "31-4B"])
def test_edge_scores_equal_plain(tiled, fe, vec16):
    """The package's scores (each lane's own row) give
    ``edgegat_scores_plain``'s p and g bit for bit, the padded slots' rows
    never read (NaN there), p and g 0 at the padded slots."""
    el, er, ef, m = _score_inputs(tiled, 4, fe, 60 + fe)
    p, g = _render_edge_scores(tiled, el, er, ef, m, SLOPE, vec16)
    want = tgf.edgegat_scores_plain(tiled, *(torch.from_numpy(a) for a in (
        el, er, ef, m)), SLOPE)
    assert torch.equal(p, want[0]) and torch.equal(g, want[1])
    pad = tiled.valid.view(tiled.num_buckets, 1, tiled.cap) == 0
    assert (p.masked_select(pad) == 0).all()
    assert (g.masked_select(pad) == 0).all()


@pytest.mark.parametrize("fe,vec16", SCORE_CASES,
                         ids=["5-4B", "16-16B", "16-4B", "31-4B"])
def test_staged_scores_equal_plain(tiled, fe, vec16):
    """The staged design's p and g equal ``edgegat_scores_plain``'s bit
    for bit (16-byte copies where Fe is a multiple of 4 and ef aligned,
    else 4-byte ones), the padded slots' rows never read (NaN there), p
    and g 0 at the padded slots."""
    el, er, ef, m = _score_inputs(tiled, 4, fe, 60 + fe)
    p, g = _render_edge_scores(tiled, el, er, ef, m, SLOPE, vec16, True)
    want = tgf.edgegat_scores_plain(tiled, *(torch.from_numpy(a) for a in (
        el, er, ef, m)), SLOPE)
    assert torch.equal(p, want[0]) and torch.equal(g, want[1])
    pad = tiled.valid.view(tiled.num_buckets, 1, tiled.cap) == 0
    assert (p.masked_select(pad) == 0).all()


@pytest.mark.parametrize("fe", [4, 12, 32])
def test_staged_scores_16b_stage(tiled, fe):
    """At 16-byte widths (the template ones 4 and 32, and 12: the runtime
    loop) the staged design and the package's 16-byte loads equal the
    plain version."""
    el, er, ef, m = _score_inputs(tiled, 2, fe, 70 + fe)
    want = tgf.edgegat_scores_plain(tiled, *(torch.from_numpy(a) for a in (
        el, er, ef, m)), SLOPE)
    for staged in (True, False):
        p, g = _render_edge_scores(tiled, el, er, ef, m, SLOPE, True, staged)
        assert torch.equal(p, want[0]) and torch.equal(g, want[1])


@pytest.mark.parametrize("fe", list(range(1, 41)))
def test_staged_rows_meet_no_bank_conflict(fe):
    """A staged row's floats (the staged design's ``edge_row_floats``):
    16-byte reads, the 8 lanes of a quarter warp at once, fall in 8
    distinct groups of 4 banks; 4-byte reads, 32 lanes at once, in 32
    distinct banks; a row holds Fe floats, 16-byte rows start 16-byte
    aligned."""
    for vec16 in ((True, False) if fe % 4 == 0 else (False,)):
        ld = tsg.edge_row_floats(fe, vec16)
        assert ld >= fe
        lanes = np.arange(32)
        if vec16:
            assert ld % 4 == 0
            for q in range(fe // 4):
                for quarter in range(4):
                    ln = lanes[8 * quarter:8 * quarter + 8]
                    quads = ((ln * ld + 4 * q) % 32) // 4
                    assert len(set(quads)) == 8, (fe, q)
        else:
            for f in range(fe):
                assert len(set((lanes * ld + f) % 32)) == 32, (fe, f)


def test_edge_scores_smem_and_gate():
    """The package's scores hold only M in shared memory: the gate admits
    EdgeGATConv's widths and wide edge features at one head, and refuses
    M past a block.  The staged design's M and one warp's staged rows must
    fit a block: its warps a block shrink to fit them."""
    assert tgf.edgegat_fits(4, 16) and not tgf.edgegat_fits(64, 1000)
    assert tgf.edgegat_fits(1, 2000)         # M alone: 8,000 bytes
    assert tgf.edgegat_fits(1, tgf._SMEM_PER_BLOCK // 4)
    assert not tgf.edgegat_fits(1, tgf._SMEM_PER_BLOCK // 4 + 1)
    assert tsg.staged_scores_warps(16, 4, True) == 8
    assert tsg.staged_scores_smem(16, 4, 8, True) == 4 * (64 + 8 * 32 * 20)
    wide = tsg.staged_scores_warps(1000, 1, True)
    assert 1 <= wide < 8
    assert tsg.staged_scores_smem(1000, 1, wide, True) <= \
        tgf._SMEM_PER_BLOCK
    assert tsg.staged_scores_smem(1000, 1, wide + 1, True) > \
        tgf._SMEM_PER_BLOCK
    assert tsg.staged_scores_warps(2000, 1, True) == 0


# -- the wrappers and the backward ---------------------------------------------

def test_wrappers_take_plain_on_cpu(tiled, monkeypatch):
    """On CPU tensors the slot gradient and the edge scores return their
    plain versions and launch nothing."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel launched on CPU tensors")

    monkeypatch.setattr(tts, "slot_grad_walk", refuse)
    monkeypatch.setattr(tgf, "_launch", refuse)
    u, v, attn, fe, ds = _grad_inputs(tiled, 4, 8, torch.float32, True, 54)
    ins = (torch.from_numpy(u).view(-1, 4, 8), torch.from_numpy(v).view(
        -1, 4, 8), torch.from_numpy(attn).view(4, 8), fe, ds)
    before = (tgf.egatc_slot_grad.launches, tgf.edgegat_scores.launches)
    got = tgf.egatc_slot_grad(tiled, *ins, EXACT_SLOPE)
    for a, w in zip(got, tgf.egatc_slot_grad_plain(tiled, *ins,
                                                   EXACT_SLOPE)):
        assert torch.equal(a, w)
    el, er, ef, m = (torch.from_numpy(a) for a in _score_inputs(
        tiled, 4, 16, 55))
    for a, w in zip(tgf.edgegat_scores(tiled, el, er, ef, m, SLOPE),
                    tgf.edgegat_scores_plain(tiled, el, er, ef, m, SLOPE)):
        assert torch.equal(a, w)
    assert (tgf.egatc_slot_grad.launches,
            tgf.edgegat_scores.launches) == before


def test_egatc_backward_takes_dfnj_from_the_slot_gradient(tiled):
    """``egatc_backward`` asks ds slot-major, calls the slot gradient once
    and the slot vector sum once (by src: dFNI); its dFNJ is the slot
    gradient's, equal to the plain chain's."""
    rng = np.random.default_rng(56)
    heads, dim = 4, 8
    n = tiled.num_src
    fni, fnj, x, dz = (torch.from_numpy(_grid(rng, (n, heads, dim), 1 / 16,
                                              1)) for _ in range(4))
    attn = torch.from_numpy(_grid(rng, (heads, dim), 1 / 16, 0.5))
    _, _, _, fe, _ = _grad_inputs(tiled, heads, dim, torch.float32, True, 57)
    out, p, den = tgf.egatc_forward(tiled, fni, fnj, fe, attn, x, heads, dim,
                                    dim, EXACT_SLOPE)
    with mock.patch.object(tgf, "gat_ds", wraps=tgf.gat_ds) as gd, \
            mock.patch.object(tgf, "egatc_slot_grad",
                              wraps=tgf.egatc_slot_grad) as sg, \
            mock.patch.object(tgf, "slot_vec_reduce",
                              wraps=tgf.slot_vec_reduce) as svr:
        du, dv, dfe, da, dx = tgf.egatc_backward(tiled, fni, fnj, fe, attn,
                                                 x, p, den, out, dz,
                                                 EXACT_SLOPE)
    assert gd.call_count == 1 and gd.call_args.kwargs["slot_major"] is True
    assert sg.call_count == 1
    assert svr.call_count == 1 and svr.call_args.args[2] == "src"
    zn, rp = tgf._scales(out, dz, den)
    ds = tgf.gat_ds_plain(tiled, x, zn, rp, p)
    want = tgf.egatc_slot_grad_plain(tiled, fni, fnj, attn, fe, ds,
                                     EXACT_SLOPE)
    assert torch.equal(dv, want[2].view(-1, heads, dim))
    assert torch.equal(dfe, want[1]) and torch.equal(da, want[0])
    assert torch.equal(du, tgf.slot_vec_reduce_plain(tiled, want[1], "src")
                       .view(-1, heads, dim))


@pytest.mark.parametrize("heads,dim,dtype", [(4, 8, F32_), (1, 41, F32_),
                                            (4, 8, BF16_)],
                         ids=["4-8-f32", "1-41-f32", "4-8-bf16"])
def test_slot_grad_plain_matches_float64(tiled, heads, dim, dtype):
    """The plain (da, dFE, dFNJ) on normal inputs against its function in
    float64 on the same inputs (FE's dtype, ds slot-major): the only
    difference is the plain version's f32 rounding, so dFE (a product of
    three f32 values, rounded to FE's dtype) within rtol 1e-6 of the
    float64 value rounded the same way, and each sum (da over every edge,
    dFNJ over a node's edges) within 1e-5 of the sum of its terms'
    magnitudes; dFE 0 at padded slots."""
    u, v, attn, fe, ds = _grad_inputs(tiled, heads, dim, dtype, False, 59)
    f = heads * dim
    got = tgf.egatc_slot_grad_plain(
        tiled, torch.from_numpy(u).view(-1, heads, dim),
        torch.from_numpy(v).view(-1, heads, dim),
        torch.from_numpy(attn).view(heads, dim), fe, ds, SLOPE)
    b, cap = tiled.num_buckets, tiled.cap
    s = np.nonzero(tiled.valid.numpy().reshape(-1))[0]
    bk = s // cap
    src = tiled.src_tile.numpy()[bk] * tiled.tile + \
        tiled.src_local.numpy().reshape(-1)[s]
    dst = tiled.dst_tile.numpy()[bk] * tiled.tile + \
        tiled.dst_local.numpy().reshape(-1)[s]
    f64 = np.float64
    fen = fe.float().numpy().reshape(b * cap, f)[s].astype(f64)
    dq = ds.float().numpy()[bk[:, None], np.arange(f)[None, :] // dim,
                            (s % cap)[:, None]]
    raw = u[src].astype(f64) + v[dst].astype(f64) + fen
    pos = raw >= 0
    dw = dq.astype(f64) * attn.astype(f64) * np.where(pos, 1.0, SLOPE)
    terms = dq.astype(f64) * np.where(pos, raw, SLOPE * raw)
    da = got[0].numpy().reshape(f).astype(f64)
    assert (np.abs(da - terms.sum(0)) <= 1e-5 * np.abs(terms).sum(0)).all()
    dfe = got[1].float().numpy().reshape(b * cap, f)
    want = torch.from_numpy(dw).to(dtype).double().numpy()
    np.testing.assert_allclose(dfe[s], want, rtol=1e-6, atol=0)
    assert (np.delete(dfe, s, axis=0) == 0).all()
    # dFNJ: the sums of dFE as stored, over each dst node's edges
    want_j = np.zeros((tiled.num_dst, f), f64)
    mag = np.zeros((tiled.num_dst, f), f64)
    np.add.at(want_j, dst, dfe[s].astype(f64))
    np.add.at(mag, dst, np.abs(dfe[s]).astype(f64))
    assert (np.abs(got[2].numpy() - want_j) <= 1e-5 * mag).all()


# -- against the JAX function in Pallas interpret mode --------------------------

JAX_N, JAX_E, JAX_H, JAX_D = 160, 400, 4, 8


@pytest.fixture(scope="module")
def jax_egatc():
    """The JAX ``egatconv_attention_aggregate``'s value and vjp at (4, 8)
    on 400 edges, its Pallas kernels interpreted, on the lane-padded slot
    tensor of its own ``slot_edge_tensor``; the port's format of the same
    COO and the inputs (multiples of 1/16, exact in bf16)."""
    rng = np.random.default_rng(58)
    row = rng.integers(0, JAX_N, JAX_E)
    col = rng.integers(0, JAX_N, JAX_E)
    t = tts.build_tiled_format(row, col, JAX_N, JAX_N, 256, 128,
                               device="cpu").with_src_first()
    j = jts.build_tiled_format(row, col, JAX_N, JAX_N, tile=256,
                               cap=128).with_src_first()
    h, d = JAX_H, JAX_D
    ex = lambda *s: _grid(rng, s, 1 / 16, 0.5)          # noqa: E731
    ins = dict(fni=ex(JAX_N, h, d), fnj=ex(JAX_N, h, d), fe=ex(JAX_E, h * d),
               attn=ex(h, d),
               x=rng.normal(size=(JAX_N, h, d)).astype(F32),
               dz=rng.normal(size=(JAX_N, h, d)).astype(F32))
    d_pad = jgf._lane_pad(h, d)
    fe_pad = np.zeros((JAX_E, h, d_pad), F32)
    fe_pad[..., :d] = ins["fe"].reshape(JAX_E, h, d)
    fe_j = jgf.slot_edge_tensor(j, fe_pad.reshape(JAX_E, -1), h * d_pad)
    orig = pl.pallas_call

    def interpreted(*a, **kw):
        return orig(*a, **{**kw, "interpret": True})

    jx = {k: jnp.asarray(v) for k, v in ins.items()}
    with mock.patch.object(jgf.pl, "pallas_call", interpreted), \
            mock.patch.object(jts.pl, "pallas_call", interpreted):
        _, vjp = jax.vjp(
            lambda fni, fnj, fe, attn, x: jgf.egatconv_attention_aggregate(
                j, fni, fnj, fe, attn, x, h, d, d, SLOPE),
            jx["fni"], jx["fnj"], fe_j, jx["attn"], jx["x"])
        grads = [np.asarray(a, F32) for a in vjp(jx["dz"])]
    dfe = grads[2].reshape(t.num_buckets, t.cap, h, d_pad)[..., :d]
    return t, ins, dict(dfnj=grads[1], dfe=dfe.reshape(t.num_buckets, t.cap,
                                                       h * d),
                        dattn=grads[3])


def test_slot_grad_plain_matches_jax(jax_egatc):
    """The new plain version's (da, dFE, dFNJ), on the ds of the port's
    plain chain, against the interpreted JAX backward's dattn, dFE and
    dFNJ; dFE 0 at padded slots.  The tolerance is the bf16 rule
    (``_kink_close``) because the JAX side rounds to bf16: its kernels
    cast the node operands, attn, ds and dFE to bf16, and its ds = (<x,
    zn> - rp) * g is formed from bf16 operands, so it differs from the
    port's f32 ds by a rounding of the difference's terms, which can be
    large beside ds itself.  The port's side is f32 throughout
    (``test_slot_grad_plain_matches_float64`` holds it to its rounding)."""
    t, ins, want = jax_egatc
    h, d = JAX_H, JAX_D
    fni, fnj, attn, x, dz = (torch.from_numpy(ins[k]) for k in (
        "fni", "fnj", "attn", "x", "dz"))
    fe = tgf.slot_edge_tensor(t, torch.from_numpy(ins["fe"]))
    out, p, den = tgf.egatc_forward(t, fni, fnj, fe, attn, x, h, d, d, SLOPE)
    zn, rp = tgf._scales(out, dz, den)
    ds = tgf.gat_ds_plain(t, x, zn, rp, p)
    da, dfe, dfnj = tgf.egatc_slot_grad_plain(t, fni, fnj, attn, fe, ds,
                                              SLOPE)
    valid = t.valid.numpy().reshape(t.num_buckets, t.cap) > 0
    _kink_close(da.numpy(), want["dattn"], "dattn")
    _kink_close(dfe.numpy()[valid], want["dfe"][valid], "dfe")
    assert (dfe.numpy()[~valid] == 0).all()
    _kink_close(dfnj.numpy(), want["dfnj"].reshape(JAX_N, h * d), "dfnj")


# -- the retired kernels and the probe -------------------------------------------

def test_retired_kernels_left_the_package():
    """``vattn_slot_grad_kernel`` (every instance) and
    ``gat_scores_kernel``'s edge instance are in the probe alone;
    ``gatv2.cu`` keeps K11 v2's tensor-core slot gradient and
    ``gat_fused.cu`` K6's scores (one template flag, kBias) beside the
    edge scores, each lane's own row (no stage: the staged design is the
    probe's); no wrapper names the retired C function."""
    for path in tts.build.sources().values():
        with open(path) as f:
            src = f.read()
        # defined (``name(``) or launched (``name<...><<<``)
        assert not re.search(r"\bvattn_slot_grad_kernel(<[^>]*>)?(\(|<<<)",
                             src), path
        assert "int dgl_vattn_slot_grad(" not in src, path
    with open(f"{CSRC}/gat_fused.cu") as f:
        fused = f.read()
    assert "template <bool kBias>\n__global__" in fused
    assert "kEdge>" not in fused and "kEdge," not in fused
    assert re.search(r"\bedge_scores_kernel\(", fused)
    assert "cp_async" not in fused and "edge_scores_staged" not in fused
    with open(f"{CSRC}/gatv2.cu") as f:
        gatv2 = f.read()
    assert re.search(r"\bvattn_slot_grad_mma_kernel\(", gatv2)
    with open(f"{CSRC}/row_agg.cu") as f:
        walks = f.read()
    assert re.search(r"\brow_slot_grad_kernel\(", walks)
    assert re.search(r"\brange_sum_kernel\(", walks)
    assert "dgl_vattn_slot_grad" not in tgf._VATTN_SIGNATURES
    with open(tsg.PROBE_SOURCE) as f:
        probe = f.read()
    assert re.search(r"\bvattn_slot_grad_kernel\(", probe)
    assert "template <bool kBias, bool kEdge>\n__global__" in probe
    assert re.search(r"\bedge_scores_staged_kernel\(", probe)
    for fn in tsg.RETIRED_SIGNATURES:
        assert f"int {fn}(" in probe


def test_probe_edits_apply():
    """``tools/perf_slot_grad_scores.py``'s edits apply once (the walk
    without the dFNJ sum, and with 4 or 2 entries in flight at one float a
    load), and ``tools/perf_ds_fold.py``'s edit bringing K9's instances of
    the retired slot gradient back applies to the probe source, where the
    kernel now lives."""
    assert tsg.tiny_check() == ["retired", "grad_unfolded",
                                "grad_vec1_unroll2", "grad_vec1_unroll4"]
    grad = tsg.edited_sources()
    assert "constexpr bool kSlotGradFold = false;" in grad["unfolded"]
    for u in (4, 2):
        assert f"VEC == 1 ? {u} : VEC * CPL <= 4 ? 4 : 2;" in \
            grad[f"vec1_unroll{u}"]
    _, tiled_da = tdf.edited_sources()
    with open(tsg.PROBE_SOURCE) as f:
        probe = f.read()
    assert tiled_da != probe
    assert "launch_slot_grad<4, float, false>(DGL_GRAD_ARGS)" in tiled_da
    assert tdf.tiny_check() == ["bucket_ds", "tiled_da"]
