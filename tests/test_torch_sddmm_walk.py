"""The arithmetic of the port's two redesigned kernels on the CPU:

* K4's SDDMM, the dot-product walk by dst (``csrc/row_agg.cu``
  ``row_sddmm_kernel``, ``tiled_spmm.sddmm_walk``): a plain rendering of
  its lane layout (``tiled_spmm._sddmm_layout``: the vectors a lane holds,
  the rounds of U slots, the butterfly over a head's lanes that leaves
  each lane some of the round's slots, the lanes that write), of its
  launches (``tiled_spmm._sddmm_plan``: groups of heads, chunks of a
  head's columns, for rows over 1,024 columns) and of its three write
  layouts (at the slot's entry in the row view and then gathered through
  ``RowView.entries``, the parts added in order, the wrapper's; the
  probe's into (B, H, C) at the slot, and slot-major then transposed;
  the padded slots set to 0 by the finishing pass) equals
  ``tiled_sddmm_dot_multihead_plain`` and the JAX
  ``tiled_sddmm_dot_multihead`` (``dgl_tpu/ops/pallas/tiled_spmm.py:521``,
  interpreted) at H = 1, 2, 4, 8, a head width of 41 (padded to 44), a
  dst tile with no bucket, dst rows with no slot and a hub row;
* K2, the bit-list walk (``csrc/bitmm.cu`` ``bit_matmul_kernel``): a plain
  rendering of its list (per step of 256 words, each lane's words in
  turn, each word's set bits ascending, src ids past num_src dropped,
  pieces of 256 entries) equals ``bit_matmul_plain`` and the JAX
  ``bit_spmm`` (``dgl_tpu/ops/pallas/bitmm.py:371``, interpreted) at
  F = 97, 128, 160, with bit 31 set, a dst row with no set bit and a hub
  row of more than 256 bits a step.

Tolerance: the inputs lie on dyadic grids (multiples of 1/16 in [-1, 1])
on which bf16 holds every value and every product, and every f32 sum is
exact in any order; so the comparisons ask for equality with the plain
versions and rtol 1e-5 / atol 1e-6 against the JAX kernels.  At padded
slots the JAX SDDMM writes the product of row 0 of each tile, the port 0.
"""
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import dgl_tpu.ops.pallas.bitmm as jbm
import dgl_tpu.ops.pallas.tiled_spmm as jts
import dgl_tpu_torch.ops.kernels.bitmm as tbm
import dgl_tpu_torch.ops.kernels.tiled_spmm as tts
from sddmm_render import _launch_rendered

EXACT = dict(rtol=1e-5, atol=1e-6)
N, E, TILE, CAP = 600, 3000, 256, 128
DST_HUB = 3
SHAPES = [(1, 41), (2, 16), (4, 32), (8, 8)]
# beyond the JAX comparison: several vectors a lane and head (1, 160),
# several heads a lane (8, 64), a head slot with no head (3, 5), one lane
# a row (1, 4)
LAYOUT_SHAPES = SHAPES + [(1, 160), (8, 64), (3, 5), (1, 4)]


def _grid(rng, *shape):
    return (rng.integers(-16, 17, shape) / 16).astype(np.float32)


def _coo(seed=0):
    """A multigraph with a dst hub of 400 edges, no edge into dst tile 2
    (rows 512-599) and dst rows 500-511 with no slot."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, N, E)
    col = rng.integers(0, 500, E)
    row[:100], col[:100] = row[100:200], col[100:200]      # multi-edges
    col[200:600] = DST_HUB
    return row, col


def _walk_rendered(tf, x3, z3, layout):
    """K4's SDDMM as the walk computes it: each launch of
    ``tiled_spmm._sddmm_plan`` (:func:`_launch_rendered`) on its heads
    and columns of x and z padded to a multiple of 4 columns, its stores
    at the layout's places; then the finishing pass.  "entry" (the
    wrapper's): an (E, H) scratch a part, at entry * H + h, then
    ``slot_finish_kernel``: gathered through ``RowView.entries``, the parts
    added in order, 0 where the map is -1.  The probe's ("direct" into
    (B, H, C) at the slot, "slot_major" at slot * H + h) take one launch,
    then its pass writes 0 at the padded slots (and transposes)."""
    heads, fh = x3.shape[1:]
    hp = -(-fh // 4) * 4
    hv = hp // 4
    x = tts._vec4_rows(x3, hp).numpy().reshape(x3.shape[0], heads, hv, 4)
    z = tts._vec4_rows(z3, hp).numpy().reshape(z3.shape[0], heads, hv, 4)
    v = tf.row_view("dst")
    ptr = v.ptr.numpy().astype(np.int64)
    rows = np.repeat(np.arange(v.rows), np.diff(ptr))
    s = v.slot.numpy().astype(np.int64)
    b, c = s // tf.cap, s % tf.cap
    plan, parts = tts._sddmm_plan(heads, hv)
    assert layout == "entry" or len(plan) == 1
    size = {"entry": len(s) * heads,
            "slot_major": tf.num_buckets * tf.cap * heads,
            "direct": tf.num_buckets * heads * tf.cap}[layout]
    dst = np.full((parts, size), np.nan, np.float32)
    for h0, nh, v0, nv, part in plan:
        sub = (slice(None), slice(h0, h0 + nh), slice(v0, v0 + nv))
        for e, h, val in _launch_rendered(
                v, x[sub].reshape(len(x), nh * nv, 4),
                z[sub].reshape(len(z), nh * nv, 4), nh, nv, rows):
            h = h0 + h
            at = {"entry": e * heads + h, "slot_major": s[e] * heads + h,
                  "direct": b[e] * heads * tf.cap + h * tf.cap + c[e]}
            dst[part, at[layout]] = val
    valid = tf.valid.numpy().reshape(-1) != 0
    if layout == "entry":        # the pass gathers through the entry map
        k = v.entries(tf.num_buckets * tf.cap).numpy().astype(np.int64)
        sm = dst.reshape(parts, -1, heads)[:, np.maximum(k, 0)]
        got = sm[0]
        for j in range(1, parts):
            got = got + sm[j]
        got[k < 0] = 0
        return torch.from_numpy(got.reshape(tf.num_buckets, tf.cap, heads)
                                .transpose(0, 2, 1).copy())
    if layout == "slot_major":
        sm = np.where(valid[:, None], dst[0].reshape(-1, heads), 0)
        return torch.from_numpy(sm.reshape(tf.num_buckets, tf.cap, heads)
                                .transpose(0, 2, 1).copy())
    out = dst[0].reshape(tf.num_buckets, heads, tf.cap)
    out[np.broadcast_to(~valid.reshape(tf.num_buckets, 1, tf.cap),
                        out.shape)] = 0
    return torch.from_numpy(out)


def _format():
    row, col = _coo()
    t = tts.build_tiled_format(row, col, N, N, TILE, CAP, device="cpu")
    return row, col, t


@pytest.mark.parametrize("layout", ["entry", "direct", "slot_major"])
@pytest.mark.parametrize("heads,fh", LAYOUT_SHAPES)
def test_walk_rendering_equals_plain(heads, fh, layout):
    _, _, t = _format()
    v = t.row_view("dst")
    deg = np.diff(v.ptr.numpy())
    assert deg[DST_HUB] >= 400 and (deg[500:] == 0).all()
    assert int(v.order[0]) == DST_HUB
    rng = np.random.default_rng(heads * 1000 + fh)
    x = torch.from_numpy(_grid(rng, N, heads, fh))
    z = torch.from_numpy(_grid(rng, N, heads, fh))
    want = tts.tiled_sddmm_dot_multihead_plain(t, x, z)
    got = _walk_rendered(t, x, z, layout)
    assert torch.equal(got, want)
    pad = t.valid.reshape(t.num_buckets, 1, t.cap) == 0
    assert (got.masked_select(pad) == 0).all() and pad.any()
    # on the CPU the wrapper takes the plain version
    assert torch.equal(tts.tiled_sddmm_dot_multihead(t, x, z, heads, fh),
                       want)


@pytest.fixture(scope="module")
def jax_sddmm():
    """The JAX package's K4 SDDMM at SHAPES on dyadic inputs, each
    interpreted once: {shape: (x, z, e)}."""
    row, col, _ = _format()
    j = jts.build_tiled_format(row, col, N, N, TILE, CAP)
    orig = pl.pallas_call

    def interpreted(*a, **kw):
        return orig(*a, **{**kw, "interpret": True})

    cases = {}
    with mock.patch.object(jts.pl, "pallas_call", interpreted):
        for heads, fh in SHAPES:
            rng = np.random.default_rng(heads * 1000 + fh)
            x, z = _grid(rng, N, heads, fh), _grid(rng, N, heads, fh)
            e = jts.tiled_sddmm_dot_multihead(j, jnp.asarray(x),
                                              jnp.asarray(z), heads, fh)
            cases[heads, fh] = (x, z, np.asarray(e))
    return cases


@pytest.mark.parametrize("heads,fh", SHAPES)
def test_walk_matches_jax(jax_sddmm, heads, fh):
    _, _, t = _format()
    x, z, e_j = jax_sddmm[heads, fh]
    xt, zt = torch.from_numpy(x), torch.from_numpy(z)
    valid = np.broadcast_to(
        t.valid.numpy().reshape(t.num_buckets, 1, t.cap) > 0, e_j.shape)
    for got in (tts.tiled_sddmm_dot_multihead_plain(t, xt, zt),
                *(_walk_rendered(t, xt, zt, layout)
                  for layout in ("entry", "direct", "slot_major"))):
        np.testing.assert_allclose(got.numpy()[valid], e_j[valid], **EXACT)
        assert (got.numpy()[~valid] == 0).all()


# rows wider than one launch holds: two groups of 4 heads, a group of 2
# heads and one of 1, two groups of 3, two column chunks of one head
WIDE_SHAPES = [(8, 256), (3, 300), (6, 160), (1, 2048)]


@pytest.mark.parametrize("heads,fh", WIDE_SHAPES)
def test_wide_rows_rendering_equals_plain(heads, fh):
    """A row of more than 1,024 columns takes several launches of the walk
    (each within the registers), and their stores and the pass that adds
    the parts give the plain version's dots (exact on the dyadic grid:
    at most 2,048 products of multiples of 1/256)."""
    _, _, t = _format()
    plan, _ = tts._sddmm_plan(heads, -(-fh // 4))
    assert len(plan) > 1
    rng = np.random.default_rng(heads * 1000 + fh)
    x = torch.from_numpy(_grid(rng, N, heads, fh))
    z = torch.from_numpy(_grid(rng, N, heads, fh))
    want = tts.tiled_sddmm_dot_multihead_plain(t, x, z)
    got = _walk_rendered(t, x, z, "entry")
    assert torch.equal(got, want)
    pad = t.valid.reshape(t.num_buckets, 1, t.cap) == 0
    assert (got.masked_select(pad) == 0).all() and pad.any()
    assert torch.equal(tts.tiled_sddmm_dot_multihead(t, x, z, heads, fh),
                       want)


def test_sddmm_plan():
    """The plan: one launch where the row fits; else the fewest equal
    groups of heads, and a head over 1,024 columns in equal chunks, each
    chunk a scratch part; every (head, vector) once, each launch within 8
    vectors a lane."""
    assert tts._sddmm_plan(4, 8) == ([(0, 4, 0, 8, 0)], 1)       # (4, 32)
    assert tts._sddmm_plan(1, 11) == ([(0, 1, 0, 11, 0)], 1)     # (1, 41)
    assert tts._sddmm_plan(16, 16) == ([(0, 16, 0, 16, 0)], 1)   # 1,024
    assert tts._sddmm_plan(8, 64) == ([(0, 4, 0, 64, 0),
                                       (4, 4, 0, 64, 0)], 1)     # (8, 256)
    assert tts._sddmm_plan(3, 75) == ([(0, 2, 0, 75, 0),
                                       (2, 1, 0, 75, 0)], 1)     # (3, 300)
    assert tts._sddmm_plan(1, 512) == ([(0, 1, 0, 256, 0),
                                        (0, 1, 256, 256, 1)], 2)  # (1, 2048)
    assert tts._sddmm_plan(2, 300) == ([(0, 1, 0, 150, 0), (1, 1, 0, 150, 0),
                                        (0, 1, 150, 150, 1),
                                        (1, 1, 150, 150, 1)], 2)
    for heads in (1, 2, 3, 5, 8, 12, 32):
        for hv in (1, 2, 3, 8, 11, 40, 64, 75, 256, 257, 700):
            plan, parts = tts._sddmm_plan(heads, hv)
            seen = np.zeros((heads, hv), np.int64)
            for h0, nh, v0, nv, part in plan:
                assert tts._sddmm_layout(nh, nv)[3] <= 8
                assert part == v0 // -(-hv // parts)
                seen[h0:h0 + nh, v0:v0 + nv] += 1
            assert (seen == 1).all(), (heads, hv)


def test_walk_layout_limits():
    """The layout: 16-byte vectors, lanes a head a power of two, rows of
    up to 1,024 columns in one launch's registers; a wider launch is
    refused (the plan splits such rows)."""
    assert tts._sddmm_layout(4, 8) == (8, 1, 32, 1)      # (4, 32)
    assert tts._sddmm_layout(1, 11) == (16, 1, 16, 1)    # (1, 41) at 44
    assert tts._sddmm_layout(8, 2) == (2, 1, 16, 1)      # (8, 8)
    assert tts._sddmm_layout(1, 64) == (32, 2, 32, 2)    # (1, 256)
    assert tts._sddmm_layout(16, 16) == (16, 1, 32, 8)   # 1,024 columns
    with pytest.raises(ValueError, match="1,024"):
        tts._sddmm_layout(32, 16)
    t = torch.arange(2 * 3 * 41, dtype=torch.float32).view(2, 3, 41)
    p = tts._vec4_rows(t, 44)
    assert p.shape == (2, 3, 44) and torch.equal(p[..., :41], t)
    assert (p[..., 41:] == 0).all()
    q = torch.zeros(2, 3, 44)
    assert tts._vec4_rows(q, 44) is q


# -- K2, the bit-list walk ----------------------------------------------------

K2_SRC, K2_DST = 16_000, 300     # n32 = 512 words a row: two steps
K2_HUB, K2_EMPTY = 5, 7


def _bit_coo():
    """Random edges, a dst hub with an edge from every third src (over 256
    set bits in each step), no edge into dst K2_EMPTY, and srcs in bit
    plane 31 (src >= 31 * 512)."""
    rng = np.random.default_rng(5)
    row = rng.integers(0, K2_SRC, 6000)
    col = rng.integers(0, K2_DST, 6000)
    row[:300] = rng.integers(31 * 512, K2_SRC, 300)
    hub = np.arange(0, K2_SRC, 3)
    row = np.r_[row, hub]
    col = np.r_[col, np.full(len(hub), K2_HUB)]
    keep = col != K2_EMPTY
    return row[keep], col[keep]


def _bit_list_rendered(packed, x, num_dst):
    """K2 as ``bit_matmul_kernel`` sums it: per step of 32 * 8 words, the
    list of src ids in the warp's order (lane 0's eight words first, each
    word's set bits ascending), ids past num_src dropped, summed in list
    order in f32 (pieces of 256 entries keep that order)."""
    words = packed.numpy().view(np.uint32)
    n32 = words.shape[1]
    num_src, f = x.shape
    xn = x.numpy()
    out = np.zeros((num_dst, f), np.float32)
    planes = np.arange(32, dtype=np.uint32)
    for d in range(num_dst):
        j, b = np.nonzero((words[d][:, None] >> planes) & 1)
        # word j is lane j % 32's word u = (j % 256) // 32 of step j // 256
        order = np.lexsort((b, (j % 256) // 32, j % 32, j // 256))
        acc = np.zeros(f, np.float32)
        for s in (b * n32 + j)[order]:
            if s < num_src:
                acc = acc + xn[s]
        out[d] = acc
    return torch.from_numpy(out)


@pytest.mark.parametrize("f", [97, 128, 160])
def test_bit_list_walk_matches_plain_and_jax(f):
    row, col = _bit_coo()
    bf = tbm.build_bit_format(row, col, K2_SRC, K2_DST, device="cpu")
    bj = jbm.build_bit_format(row, col, K2_SRC, K2_DST)
    assert (bf.packed[:K2_DST] < 0).any()                  # bit 31
    assert (bf.packed[K2_EMPTY] == 0).all()
    hub_bits = int(np.unpackbits(bf.packed[K2_HUB].numpy().view(np.uint8))
                   .sum())
    assert hub_bits > 2 * 256
    rng = np.random.default_rng(f)
    x = torch.from_numpy(_grid(rng, K2_SRC, f))
    got = _bit_list_rendered(bf.packed, x, K2_DST)
    want = tbm.bit_matmul_plain(bf.packed, x, K2_DST)
    assert torch.equal(got, want)
    assert (got[K2_EMPTY] == 0).all()
    # the JAX route for F > 96 (``_bit_matmul``), with the remainder
    out_j = np.asarray(jbm.bit_spmm(bj, jnp.asarray(x.numpy())))
    full = tbm.add_remainder(got.clone(), x, bf.rem_src, bf.rem_dst,
                             bf.rem_w)
    np.testing.assert_allclose(full.numpy(), out_j, **EXACT)
    assert torch.equal(tbm.bit_spmm(bf, x), full)
    # the launch layout: floats a load and vectors a lane
    assert tbm._k2_layout(f, x) == {97: (1, 4), 128: (4, 1),
                                    160: (4, 2)}[f]


def test_row_view_entries():
    """``RowView.entries``: each listed slot's entry in the view, -1 at
    every other slot, built once."""
    _, _, t = _format()
    v = t.row_view("dst")
    slots = t.num_buckets * t.cap
    e = v.entries(slots)
    assert e.dtype == torch.int32 and e.shape == (slots,)
    assert torch.equal(e[v.slot.long()], torch.arange(v.slot.numel(),
                                                      dtype=torch.int32))
    listed = torch.zeros(slots, dtype=torch.bool)
    listed[v.slot.long()] = True
    assert (e[~listed] == -1).all()
    assert torch.equal(listed, t.valid.reshape(-1) > 0)
    assert v.entries(slots) is e
