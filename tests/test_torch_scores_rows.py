"""K9's scores on the dot-product walk by dst and K12's row product on the
tensor cores, rendered on the CPU (no compiler and no card here), each
against its plain version and the JAX package:

* K9's scores (``gat_fused.vattn_scores`` without an edge term): K4's
  SDDMM walk by dst in its scores mode (``csrc/row_agg.cu``
  ``row_sddmm_kernel<CPL, true>``, rendered lane by lane by
  ``test_torch_sddmm_walk._launch_rendered`` with the partial attn .
  lrelu(U + V) over a lane's four floats in place of the dot) writes the
  raw sums into an entry-major scratch a part (a row over 1,024 columns
  takes several launches, a chunk of a head's columns a part); the
  finishing pass (``slot_finish_kernel<VEC, true>``), rendered a slot at a
  time, reads the slot's entry through the view's entry map, adds the
  parts in order and writes exp(clip(., +-40)), 0 at a padded slot.  U, V
  and attn on a grid of 1/16 and a slope of 1/4 make every logit exact in
  f32 in any order, so the rendering must equal ``vattn_scores_plain`` bit
  for bit (both take torch's exp of the same f32 logit), padded slots, a
  dst row with no edge and logits past +-40 included; and ``vattn_scores``
  on CPU tensors is held to the JAX ``gatv2_forward``'s p (Pallas
  interpret mode) at ``test_torch_gatv2.py``'s tolerance for the JAX
  kernels (rtol 5e-2 / atol 6e-2);
* K12's row product (``int8mm.int8_matmul_rows``): ``split_z_kernel<true>``
  (x in three bf16 parts in the row kernel's contraction order,
  ``int8mm.rows_contraction_rows``) and ``int8_rows_mma_kernel`` rendered
  fragment by fragment: the blocks of ``int8mm.rows_plan``, the stages of
  128 columns, four 64-row TMA boxes under the 128-byte swizzle (a box
  past k not loaded), each lane's two 16-byte reads of a row, the byte
  pairs of one word turned into bf16x2 registers by ``s8x2_bf16x2(w, w >>
  8, b)``, mma.sync's fragment layouts, hi then mid then lo into one
  accumulator; held bit for bit to ``int8_matmul_rows_plain`` on a grid of
  2^-12 in [-1/4, 1/4] (values bf16 does not hold; every sum exact in f32)
  at F = 1, 8, 16 and 41, with signed bytes, x shorter than N_pad and a
  ragged k.  The plan takes every output once; the permutation takes
  every column of A once a stage.

The helpers of ``test_torch_sddmm_walk.py`` and
``test_torch_tma_kernels.py`` are imported, not copied.
"""
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import dgl_tpu.ops.pallas.gat_fused as jgf
import dgl_tpu.ops.pallas.tiled_spmm as jts
import dgl_tpu_torch.ops.kernels.gat_fused as tgf
import dgl_tpu_torch.ops.kernels.int8mm as i8
import dgl_tpu_torch.ops.kernels.tiled_spmm as tts
from dgl_tpu_torch.tools import perf_scores_rows as tsr
from test_torch_sddmm_walk import CAP, DST_HUB, N, TILE, _coo, _launch_rendered
from test_torch_tma_kernels import (_bf16_value, _render_split, _s8x2_bf16x2,
                                    _swizzled)

BF16 = dict(rtol=5e-2, atol=6e-2)     # test_torch_gatv2.py's, JAX kernels
SLOPE = 0.25
# route 5's two layers, a narrow head, a wide one, rows over 1,024 columns
# (a head in two column parts; heads in two groups), a head width that
# takes the pad to 8
SCORES_SHAPES = [(8, 8), (1, 41), (4, 16), (2, 64), (1, 1100), (4, 300),
                 (3, 5)]


def _format():
    row, col = _coo()
    return tts.build_tiled_format(row, col, N, N, TILE, CAP, device="cpu")


def _scores_inputs(heads, dim, seed, case="grid"):
    """U, V (N, H, D) and attn (H, D) on a grid of 1/16: U, V in [-1, 1],
    attn in [-1/2, 1/2]; "up" and "down": U, V >= 0 and attn 16 |attn| of
    one sign, so that logits pass +40 or -40."""
    rng = np.random.default_rng(seed)

    def grid(*shape, top):
        return rng.integers(-top, top + 1, shape).astype(np.float32) / 16

    U, V = grid(N, heads, dim, top=16), grid(N, heads, dim, top=16)
    attn = grid(heads, dim, top=8)
    if case != "grid":
        U, V = np.abs(U), np.abs(V)
        attn = 16 * np.abs(attn) * (1 if case == "up" else -1)
    return tuple(torch.from_numpy(a) for a in (U, V, attn))


def _lrelu(t, slope):
    return np.where(t >= 0, t, np.float32(slope) * t).astype(np.float32)


def _scores_rendered(tf, U3, V3, attn, slope):
    """K9's p as the walk and its pass compute it: each launch of
    ``_sddmm_plan`` rendered lane by lane with the scores' partial (U =
    x gathered, V = z the row's own, attn the launch's slice, all padded
    to a multiple of 4 columns with zeros), its stores at entry * H + h of
    its part; then the pass: the parts at entries[s] added in order,
    exp(clip(., +-40)) by torch's exp, 0 where the map is -1."""
    heads, dim = U3.shape[1:]
    hp = -(-dim // 4) * 4
    hv = hp // 4
    u = tts._vec4_rows(U3, hp).numpy().reshape(N, heads, hv, 4)
    v = tts._vec4_rows(V3, hp).numpy().reshape(N, heads, hv, 4)
    a = tts._vec4_rows(attn.reshape(1, heads, dim), hp).numpy().reshape(
        heads, hv, 4)
    view = tf.row_view("dst")
    ptr = view.ptr.numpy().astype(np.int64)
    rows = np.repeat(np.arange(view.rows), np.diff(ptr))
    plan, parts = tts._sddmm_plan(heads, hv)
    sm = np.full((parts, len(rows) * heads), np.nan, np.float32)
    for h0, nh, v0, nv, part in plan:
        sub = (slice(h0, h0 + nh), slice(v0, v0 + nv))
        a_l = a[sub].reshape(nh * nv, 4)

        def partial(xs, zs, vq, a_l=a_l):
            return (a_l[vq] * _lrelu(xs + zs, slope)).sum(-1)

        for e, h, val in _launch_rendered(
                view, u[(slice(None),) + sub].reshape(N, nh * nv, 4),
                v[(slice(None),) + sub].reshape(N, nh * nv, 4), nh, nv,
                rows, partial):
            sm[part, e * heads + h0 + h] = val
    assert not np.isnan(sm).any()          # every entry of every part
    slots = tf.num_buckets * tf.cap
    k = view.entries(slots).numpy().astype(np.int64)
    s = sm[0].reshape(-1, heads)[np.maximum(k, 0)]
    for j in range(1, parts):              # the parts, in order
        s = s + sm[j].reshape(-1, heads)[np.maximum(k, 0)]
    p = torch.exp(torch.clamp(torch.from_numpy(s), -tgf.CLIP, tgf.CLIP))
    p[torch.from_numpy(k < 0)] = 0
    return p.reshape(tf.num_buckets, tf.cap, heads).transpose(1, 2) \
        .contiguous(), parts


@pytest.mark.parametrize("heads,dim", SCORES_SHAPES)
def test_scores_walk_rendering_equals_plain(heads, dim):
    """Bit for bit at every shape (rows over 1,024 columns in two parts),
    on a graph with a hub row of 400 slots and dst rows with no edge; 0 at
    every padded slot, exp of the logit at every other; the CPU wrapper
    takes the plain version."""
    t = _format()
    v = t.row_view("dst")
    deg = np.diff(v.ptr.numpy())
    assert deg[DST_HUB] >= 400 and (deg[500:] == 0).all()
    U, V, attn = _scores_inputs(heads, dim, heads * 1000 + dim)
    got, parts = _scores_rendered(t, U, V, attn, SLOPE)
    assert parts == (2 if dim > 1024 else 1)
    assert (len(tts._sddmm_plan(heads, -(-dim // 4))[0]) > 1) == (
        heads * dim > 1024)
    want = tgf.vattn_scores_plain(t, U, V, attn, SLOPE)
    assert torch.equal(got, want)
    pad = t.valid.reshape(t.num_buckets, 1, t.cap) == 0
    assert (got.masked_select(pad) == 0).all() and pad.any()
    assert (got.masked_select(~pad) > 0).all()
    assert torch.equal(tgf.vattn_scores(t, U, V, attn, SLOPE), want)


@pytest.mark.parametrize("case", ["up", "down"])
@pytest.mark.parametrize("heads,dim", [(8, 8), (1, 41)])
def test_scores_walk_clips_past_40(heads, dim, case):
    """Logits past +40 (or -40) give exp(40) (exp(-40)) in the rendering as
    in the plain version: the clip is taken once, in the pass, on the whole
    sum."""
    t = _format()
    U, V, attn = _scores_inputs(heads, dim, 7 + dim, case)
    got, _ = _scores_rendered(t, U, V, attn, SLOPE)
    want = tgf.vattn_scores_plain(t, U, V, attn, SLOPE)
    assert torch.equal(got, want)
    valid = t.valid.reshape(t.num_buckets, 1, t.cap).expand_as(got) > 0
    bound = torch.exp(torch.tensor(tgf.CLIP if case == "up" else -tgf.CLIP))
    assert (got[valid] == bound).any()
    assert (got[valid] <= bound).all() if case == "up" else \
        (got[valid] >= bound).all()


@pytest.fixture(scope="module")
def jax_scores():
    """p of the JAX package's ``gatv2_forward`` (``_gatv2_scores_kernel``,
    interpreted) on the walk's graph at (8, 8) and (1, 41): {shape: (U, V,
    attn, p)}.  The grid inputs and the slope of 1/4 keep raw, lrelu(raw)
    and attn exact in bf16, as the JAX kernel casts them."""
    row, col = _coo()
    j = jts.build_tiled_format(row, col, N, N, TILE, CAP)
    orig = pl.pallas_call

    def interpreted(*a, **kw):
        return orig(*a, **{**kw, "interpret": True})

    cases = {}
    with mock.patch.object(jgf.pl, "pallas_call", interpreted), \
            mock.patch.object(jts.pl, "pallas_call", interpreted):
        for heads, dim in ((8, 8), (1, 41)):
            U, V, attn = _scores_inputs(heads, dim, heads * 1000 + dim)
            x = jnp.zeros((N, heads, 1), jnp.float32)
            p = jgf.gatv2_forward(j, jnp.asarray(U.numpy()),
                                  jnp.asarray(V.numpy()), x,
                                  jnp.asarray(attn.numpy()), heads, dim, 1,
                                  SLOPE)[1]
            cases[heads, dim] = (U, V, attn, np.asarray(p))
    return cases


@pytest.mark.parametrize("heads,dim", [(8, 8), (1, 41)])
def test_scores_match_jax(jax_scores, heads, dim):
    """``vattn_scores`` on CPU tensors and the walk's rendering against the
    JAX kernel's p, at every slot (0 at the padded ones on both sides)."""
    t = _format()
    U, V, attn, p_j = jax_scores[heads, dim]
    got = tgf.vattn_scores(t, U, V, attn, SLOPE)
    np.testing.assert_allclose(got.numpy(), p_j, **BF16)
    rendered, _ = _scores_rendered(t, U, V, attn, SLOPE)
    np.testing.assert_allclose(rendered.numpy(), p_j, **BF16)
    pad = np.broadcast_to(t.valid.numpy().reshape(t.num_buckets, 1, t.cap)
                          == 0, p_j.shape)
    assert (p_j[pad] == 0).all() and (got.numpy()[pad] == 0).all()


@pytest.mark.parametrize("heads,offsets,vec", [
    (8, (0,), 4), (4, (0, 0), 4), (1, (0,), 1), (6, (0,), 1),
    (8, (1,), 1), (8, (0, 2), 1)])
def test_finish_vec_takes_16_bytes_only_where_aligned(heads, offsets, vec):
    """The walk's finishing passes (K4's SDDMM and K9's scores, one C
    function; K6's ds) take a slot's heads 4 at a time by one rule: H a
    multiple of 4 and every operand read or written in vectors 16-byte
    aligned."""
    tensors = [torch.zeros(64)[o:] for o in offsets]
    assert tts.finish_vec(heads, *tensors) == vec


def test_scores_probe_edit_restores_the_bucket_walk():
    """The probe's edit of the bucket walk's source (once ``csrc/gatv2.cu``,
    now ``tools/fwd_scores_probe.cu``) applies once and puts K9's instance
    back in ``dgl_vattn_scores``, which refuses that case in that source;
    the package's sources hold no bucket walk; the probe's own source holds
    the retired rows walk."""
    from dgl_tpu_torch.tools import perf_fwd_scores as tfs
    assert tsr.tiny_check() == ["bucket_scores", "fma_rows"]
    with open(tfs.PROBE_SOURCE) as f:
        src = f.read()
    assert "DGL_SCORES_LAUNCH(false, float, false)" not in src
    assert "DGL_SCORES_LAUNCH(false, float, true)" in src
    assert "DGL_SCORES_LAUNCH(false, float, false)" in \
        tsr.edited_scores_source()
    with open(tts.build.sources()["gatv2"]) as f:
        assert "DGL_SCORES_LAUNCH" not in f.read()


# -- K12's row product on the tensor cores ------------------------------------

def _fragment_a(regs):
    """The 16 x 16 A fragment of mma.sync m16n8k16 from the 32 lanes' four
    bf16x2 registers: reg i holds (row g + 8 (i & 1), columns 2t + 8 (i >>
    1) + h) in half h."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    am = np.zeros((16, 16))
    for i, (dm, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for h in (0, 1):
            am[g + dm, 2 * t + dk + h] = _bf16_value(
                (regs[i] >> (16 * h)) & 0xFFFF)
    return am


def _fragment_b(bb):
    """The 16 x 8 B fragment from the lanes' two registers (32, 2): reg i
    holds (rows 2t + 8 i + h, column g) in half h."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    bm = np.zeros((16, 8))
    for i in (0, 1):
        for h in (0, 1):
            bm[2 * t + 8 * i + h, g] = _bf16_value((bb[:, i] >> (16 * h))
                                                   & 0xFFFF)
    return bm


def _render_rows(a, x):
    """``int8_rows_mma_kernel`` in numpy, with ``split_z_kernel<true>``:
    A x (k, f) f32."""
    k, n_pad = a.shape
    n_x, f = x.shape
    nt = i8.col_tiles(f)
    xf = _render_split(x, n_x, f, box_perm=True, k_pad=n_pad)
    boxes = -(-n_pad // i8.ROW_SPAN)
    assert xf.shape[1] == boxes * 8
    assert xf.size * 4 == i8.rows_scratch_words(n_pad, f) * 8
    out = np.full((k, f), np.nan, np.float32)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    au = a.view(np.uint8)
    # a box's 16-byte chunks as the 128-byte swizzle places them
    chunk_at = np.array([[_swizzled(r * 128 + ch * 16, 128)
                          for ch in range(8)] for r in range(64)])
    for r0, r1, c0, c1 in i8.rows_plan(k, f):
        grp = c0 // (8 * nt)
        live_boxes = min(4, -(-(k - r0) // 64))
        acc = np.zeros((4, 4, nt, 16, 8), np.float32)  # warp, m-tile, q
        for c in range(boxes):
            for w in range(live_boxes):
                box = np.zeros((64, 128), np.uint8)     # zeros past A
                blk = au[r0 + 64 * w:r0 + 64 * w + 64, 128 * c:128 * c + 128]
                box[:blk.shape[0], :blk.shape[1]] = blk
                smem = np.zeros(64 * 128, np.uint8)
                for r in range(64):
                    for ch in range(8):
                        o = chunk_at[r, ch]
                        smem[o:o + 16] = box[r, 16 * ch:16 * ch + 16]
                for half in range(2):
                    words = {}    # (m-tile, e): (32 lanes, 4 words)
                    for j in range(4):
                        for e in range(2):
                            offs = [_swizzled((16 * j + gg + 8 * e) * 128
                                              + 32 * tt + 16 * half, 128)
                                    for gg, tt in zip(g, t)]
                            words[j, e] = np.stack(
                                [smem[o:o + 16] for o in offs]).view(
                                    np.uint32)
                    for s in range(4):
                        ks = 4 * half + s
                        am = []
                        for j in range(4):
                            w0, w8 = words[j, 0][:, s], words[j, 1][:, s]
                            am.append(_fragment_a(
                                [_s8x2_bf16x2(w0, w0 >> 8, 0),
                                 _s8x2_bf16x2(w8, w8 >> 8, 0),
                                 _s8x2_bf16x2(w0, w0 >> 8, 2),
                                 _s8x2_bf16x2(w8, w8 >> 8, 2)]))
                        for part in range(3):
                            for q in range(nt):
                                bm = _fragment_b(xf[grp, 8 * c + ks, q,
                                                    part])
                                for j in range(4):
                                    acc[w, j, q] = (acc[w, j, q]
                                                    + am[j] @ bm).astype(
                                                        np.float32)
        for w in range(live_boxes):
            for j in range(4):
                for q in range(nt):
                    for m in range(16):
                        r = r0 + 64 * w + 16 * j + m
                        for col in range(8):
                            fc = (grp * nt + q) * 8 + col
                            if r < k and fc < f:
                                out[r, fc] = acc[w, j, q, m, col]
    return out


@pytest.mark.parametrize("f", [1, 8, 16, 41])
def test_rows_kernel_rendering_matches_plain(f):
    """Ragged k (300: a second block with one live box of 44 rows; not a
    multiple of 16) and N_pad (400: not a multiple of the 128-column
    stage), x shorter than N_pad (390 rows), signed bytes over -128..127,
    x on a grid of 2^-12 that bf16 does not hold: the rendering equals the
    plain version exactly."""
    k, n_pad, n_x = 300, 400, 390
    rng = np.random.default_rng(f)
    a = rng.integers(-128, 128, (k, n_pad)).astype(np.int8)
    a[rng.random((k, n_pad)) < 0.5] = 0
    a[0, 0], a[1, 1] = -128, 127
    x = (rng.integers(-1024, 1025, (n_x, f)) * 2.0 ** -12).astype(
        np.float32)
    xt = torch.from_numpy(x)
    assert not torch.equal(xt.bfloat16().float(), xt)
    want = i8.int8_matmul_rows_plain(torch.from_numpy(a), xt).numpy()
    got = _render_rows(a, x)
    np.testing.assert_array_equal(got, want)
    # on the CPU the wrapper takes the plain version
    np.testing.assert_array_equal(
        i8.int8_matmul_rows(torch.from_numpy(a), xt).numpy(), want)


@pytest.mark.parametrize("k,f", [(1, 1), (255, 16), (256, 8), (257, 41),
                                 (32_768, 16), (1003, 128)])
def test_rows_plan_takes_every_output_once(k, f):
    plan = i8.rows_plan(k, f)
    w = 8 * i8.col_tiles(f)
    assert len(plan) == -(-k // i8.ROW_BLOCK_ROWS) * -(-f // w)
    seen = np.zeros((k, f), np.int32)
    for r0, r1, c0, c1 in plan:
        assert r0 % i8.ROW_BLOCK_ROWS == 0 and 0 < r1 - r0 <= 256
        assert c0 % w == 0 and 0 < c1 - c0 <= w
        seen[r0:r1, c0:c1] += 1
    assert (seen == 1).all()


def test_rows_contraction_order_takes_every_column_once():
    """The permutation: in each stage of 128 columns, the 8 k-steps' four
    rows for the four lanes t cover every column once; lane t's rows of
    k-step s are the bytes of word s of its 32-byte read (columns 32 t +
    4 s .. + 3), the same for every g."""
    for stage in range(3):
        seen = np.zeros(128 * 3, np.int32)
        for s in range(8 * stage, 8 * stage + 8):
            for lane in range(32):
                rows = i8.rows_contraction_rows(s, lane)
                t = lane % 4
                assert rows == tuple(128 * stage + 32 * t + 4 * (s % 8) + j
                                     for j in range(4))
                if lane < 4:
                    seen[list(rows)] += 1
        assert (seen[128 * stage:128 * stage + 128] == 1).all()
        assert seen.sum() == 128
    assert i8.rows_scratch_words(400, 16) == 4 * 8 * 2 * 3 * 32
    assert i8.rows_scratch_words(233_088, 16) * 8 == 22_376_448
