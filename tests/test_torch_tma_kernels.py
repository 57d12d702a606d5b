"""The host side of the two kernels that stream their operand by TMA: K12's
column product on the tensor cores (``csrc/int8mm.cu``
``int8_cols_kernel``) and K1's bit walk (``csrc/bitmm.cu``
``bit_matmul_t_kernel``).  No JAX here: their parity with the JAX package
is held by ``test_torch_hybrid.py`` and ``test_torch_bitmm.py``.

* ``split_bf16x3``, the three bf16 parts of z: their sum is z bit for bit
  on normal f32 (numpy-made, seeded, over a wide range of exponents), and
  mid and lo are 0 where z is exact in bf16;
* the launch plans (``cols_plan``, ``k1_plan``): every output row of every
  column group, and every (slab, row) of the words, is taken once, for
  ragged shapes;
* a lane-by-lane rendering of each kernel in numpy, with the kernel's
  index arithmetic (the split's fragment order, the swizzled boxes, the
  byte-to-bf16 conversion, mma.sync's fragment layouts; K1's scan, lists
  in pieces and drains), held exactly to the plain version on
  dyadic inputs, so that an index slip shows here before the card;
* the wrappers' checks of the slab width on the CPU path.
"""
import numpy as np
import pytest
import torch

from dgl_tpu_torch.ops.kernels import bitmm as bm
from dgl_tpu_torch.ops.kernels import int8mm as i8


# -- the three bf16 parts ----------------------------------------------------

def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_sums_to_z_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=(4000,))
         * 2.0 ** rng.integers(-100, 100, 4000)).astype(np.float32)
    z[:7] = [0.0, -0.0, 1.0, -3.5, 2 ** -110, -(2 ** 120), 1 / 3]
    zt = torch.from_numpy(z)
    hi, mid, lo = i8.split_bf16x3(zt)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.float() + mid.float() + lo.float()
    np.testing.assert_array_equal(_bits(total)[2:], _bits(zt)[2:])
    # every part keeps z's sign, and each is the top of what is left
    assert ((hi.float() * zt) >= 0).all() and ((lo.float() * zt) >= 0).all()
    assert (mid.float().abs() <= hi.float().abs()).all()


def test_split_of_bf16_values_leaves_mid_and_lo_zero():
    rng = np.random.default_rng(5)
    z = torch.from_numpy(rng.normal(size=(3000,)).astype(np.float32))
    zb = z.bfloat16().float()      # exact in bf16
    hi, mid, lo = i8.split_bf16x3(zb)
    assert torch.equal(hi.float(), zb)
    assert not mid.float().any() and not lo.float().any()
    # the 2^-12 grid of the K12 checks needs two parts, not one
    grid = torch.from_numpy(rng.integers(-1024, 1025, 3000)
                            .astype(np.float32)) * 2.0 ** -12
    hi, mid, lo = i8.split_bf16x3(grid)
    assert mid.float().any() and not lo.float().any()
    assert torch.equal(hi.float() + mid.float(), grid)


# -- the launch plans ----------------------------------------------------------

@pytest.mark.parametrize("n_pad,f,ctas", [
    (16, 1, 1), (5008, 16, 7), (23_936, 41, 264), (23_936, 128, 5),
    (4096, 8, 1000), (233_088, 16, 264), (480_000, 16, 264)])
def test_cols_plan_takes_every_output_row_once(n_pad, f, ctas):
    plan = i8.cols_plan(n_pad, f, ctas)
    assert len(plan) == ctas
    groups = -(-f // (8 * i8.col_tiles(f)))
    seen = np.zeros((groups, n_pad), np.int32)
    for passes in plan:
        for grp, c0, rows in passes:
            assert 0 < rows <= 512 and c0 % 16 == 0 and rows % 16 == 0
            seen[grp, c0:c0 + rows] += 1
    assert (seen == 1).all()
    loads = [sum(r for _, _, r in p) for p in plan]
    assert max(loads) - min(loads) <= 16      # equal runs, in 16-row units


@pytest.mark.parametrize("rows,n32,w,blocks", [
    (1, 4, 8, 1), (700, 256, 32, 5), (24_000, 128, 16, 132),
    (233_472, 7296, 32, 132), (300, 36, 32, 7), (110_592, 3456, 8, 132),
    (5, 256, 32, 1000)])
def test_k1_plan_takes_every_row_of_every_slab_once(rows, n32, w, blocks):
    plan = bm.k1_plan(rows, n32, w, blocks)
    slabs = -(-n32 // w)
    seen = np.zeros((slabs, rows), np.int32)
    for segs in plan:
        assert len({s for s, _, _ in segs}) == len(segs)  # a slab once
        for slab, r0, r1 in segs:
            assert 0 <= r0 < r1 <= rows
            for t0 in range(r0, r1, bm.T_TILE_ROWS):   # the tiles
                seen[slab, t0:min(r1, t0 + bm.T_TILE_ROWS)] += 1
    assert (seen == 1).all()
    loads = [sum(r1 - r0 for _, r0, r1 in s) for s in plan]
    assert max(loads) - min(loads) <= 1


def test_cols_scratch_words_counts_the_split_kernels_writes():
    for k, f in ((1003, 16), (32_768, 16), (1, 1), (70, 41), (64, 128)):
        nt = i8.col_tiles(f)
        ksteps = -(-k // i8.COL_ROWS) * i8.COL_ROWS // 16
        groups = -(-f // (8 * nt))
        # one thread a (group, step, n-tile, lane), 3 words each
        assert i8.cols_scratch_words(k, f) == groups * ksteps * nt * 32 * 3


# -- K12's column kernel, lane by lane ------------------------------------

def _bf16_value(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def _s8x2_bf16x2(lo, hi, b):
    """``s8x2_bf16x2``: byte b of lo and of hi as a bf16x2 (two uint32
    lanes' worth at once)."""
    lo, hi = np.asarray(lo, np.uint32), np.asarray(hi, np.uint32)
    t = ((lo >> (8 * b)) & 0xFF) | ((hi >> (8 * b)) & 0xFF) << 16
    x = (t & 0x007F007F) | 0x43004300
    y = (t & 0x00800080) | 0xC300C300
    out = []
    for half in (0, 16):
        v = (_bf16_value((x >> half) & 0xFFFF).astype(np.float64)
             + _bf16_value((y >> half) & 0xFFFF))
        v32 = v.astype(np.float32)
        assert (v32 == v).all() and (v32.view(np.uint32) & 0xFFFF == 0).all()
        out.append(v32.view(np.uint32) >> 16)
    return out[0] | out[1] << 16


def _swizzled(off, row_bytes):
    return off ^ (((off >> 7) & (row_bytes // 16 - 1)) << 4)


def _render_split(z, k, f):
    """The split kernel's scratch: [group][step][n-tile][part][lane] x 2
    registers."""
    nt = i8.col_tiles(f)
    groups = -(-f // (8 * nt))
    kp = -(-k // i8.COL_ROWS) * i8.COL_ROWS
    zp = np.zeros((kp, groups * nt * 8), np.float32)
    zp[:k, :f] = z
    parts = [_bits(p.float())[:, :] >> 16 & 0xFFFF
             for p in i8.split_bf16x3(torch.from_numpy(zp))]
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    zf = np.zeros((groups, kp // 16, nt, 3, 32, 2), np.uint32)
    for grp in range(groups):
        for s in range(kp // 16):
            for q in range(nt):
                col = (grp * nt + q) * 8 + g
                r0 = s * 16 + 2 * t
                for p, bits in enumerate(parts):
                    bits = bits.astype(np.uint32)
                    zf[grp, s, q, p, :, 0] = bits[r0, col] | bits[r0 + 1,
                                                                 col] << 16
                    zf[grp, s, q, p, :, 1] = (bits[r0 + 8, col]
                                              | bits[r0 + 9, col] << 16)
    return zf


def _render_cols(a, z, ctas):
    """``int8_cols_kernel`` in numpy: A^T z (n_pad, f) f32."""
    k, n_pad = a.shape
    f = z.shape[1]
    nt = i8.col_tiles(f)
    zf = _render_split(z, k, f)
    out = np.full((n_pad, f), np.nan, np.float32)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    au = a.view(np.uint8)
    for passes in i8.cols_plan(n_pad, f, ctas):
        for grp, c0, cols in passes:
            acc = np.zeros((4, 8, nt, 16, 8), np.float32)   # (warp, j, q, m, n)
            rows = i8.COL_ROWS
            for k0 in range(0, k, rows):
                for w in range(4):
                    if w * 128 >= cols:
                        continue
                    box = np.zeros((rows, 128), np.uint8)  # zeros past A
                    c = c0 + w * 128
                    blk = au[k0:k0 + rows, c:c + 128]
                    box[:blk.shape[0], :blk.shape[1]] = blk
                    smem = np.zeros(rows * 128, np.uint8)
                    for r in range(rows):
                        for ch in range(8):
                            o = _swizzled(r * 128 + ch * 16, 128)
                            smem[o:o + 16] = box[r, ch * 16:ch * 16 + 16]
                    for ks in range(rows // 16):
                        r0 = ks * 16 + 2 * t
                        wv = []   # (lane, 4 words) for rows 2t, +1, +8, +9
                        for rr in (r0, r0 + 1, r0 + 8, r0 + 9):
                            offs = _swizzled(rr * 128 + g * 16, 128)
                            wv.append(np.stack([smem[o:o + 16]
                                                for o in offs]).view(
                                                    np.uint32))
                        for j in range(8):
                            b = (2 * j) & 3
                            regs = [_s8x2_bf16x2(wv[0][:, j >> 1],
                                                 wv[1][:, j >> 1], b),
                                    _s8x2_bf16x2(wv[0][:, j >> 1],
                                                 wv[1][:, j >> 1], b + 1),
                                    _s8x2_bf16x2(wv[2][:, j >> 1],
                                                 wv[3][:, j >> 1], b),
                                    _s8x2_bf16x2(wv[2][:, j >> 1],
                                                 wv[3][:, j >> 1], b + 1)]
                            am = np.zeros((16, 16))
                            for i, (dm, dk) in enumerate(((0, 0), (8, 0),
                                                          (0, 8), (8, 8))):
                                for h in (0, 1):
                                    am[g + dm, 2 * t + dk + h] = _bf16_value(
                                        (regs[i] >> (16 * h)) & 0xFFFF)
                            for q in range(nt):
                                for p in range(3):
                                    bb = zf[grp, k0 // 16 + ks, q, p]
                                    bm_ = np.zeros((16, 8))
                                    for i, dk in enumerate((0, 8)):
                                        for h in (0, 1):
                                            bm_[2 * t + dk + h, g] = \
                                                _bf16_value((bb[:, i] >> (
                                                    16 * h)) & 0xFFFF)
                                    acc[w, j, q] = (acc[w, j, q]
                                                    + (am @ bm_)).astype(
                                                        np.float32)
            for w in range(4):
                for gg in range(8):
                    if w * 128 + 16 * gg >= cols:
                        continue
                    n0 = c0 + w * 128 + 16 * gg
                    for j in range(8):
                        for q in range(nt):
                            for col in range(8):
                                fc = (grp * nt + q) * 8 + col
                                if fc < f:
                                    out[n0 + 2 * j, fc] = acc[w, j, q, gg,
                                                              col]
                                    out[n0 + 2 * j + 1, fc] = acc[
                                        w, j, q, gg + 8, col]
    return out


@pytest.mark.parametrize("k,n_pad,f,ctas,signed", [
    (70, 272, 16, 3, False), (33, 528, 41, 2, True), (20, 160, 1, 1, True),
    (40, 144, 8, 4, True)])
def test_cols_kernel_rendering_matches_plain(k, n_pad, f, ctas, signed):
    """Ragged k (not a multiple of 32) and n_pad (not of 128 or 512),
    int8 over -128..127 or counts, z on a grid of 2^-12 that bf16 does not
    hold: the rendering equals the plain version exactly."""
    rng = np.random.default_rng(k + f)
    lo = -128 if signed else 0
    a = rng.integers(lo, 128, (k, n_pad)).astype(np.int8)
    a[rng.random((k, n_pad)) < 0.5] = 0
    z = (rng.integers(-1024, 1025, (k, f)) * 2.0 ** -12).astype(np.float32)
    want = i8.dense_cols_t(torch.from_numpy(a), torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(_render_cols(a, z, ctas), want)


# -- K1's bit walk, lane by lane --------------------------------------------

def _render_k1(packed_t, x, num_dst, w, blocks, cap=256, drain_at=128):
    """``bit_matmul_t_kernel`` in numpy, with lists of ``cap`` entries
    drained at ``drain_at``: A x (num_dst, F) f32, every listed entry's x
    row added into out (in list order here; the kernel's reductions in L2
    meet in any order, and the inputs make every order exact)."""
    rows, f = x.shape
    n32 = packed_t.shape[1]
    words = packed_t.view(np.uint32)
    pairs = w // 2
    planes = 32 // (16 // pairs)
    out = np.zeros((num_dst, f), np.float32)

    def drain(lst):
        for s, d in lst:
            if d < num_dst:
                out[d] += x[s]
        lst.clear()

    for segs in bm.k1_plan(rows, n32, w, blocks):
        lists = [[] for _ in range(16)]
        it = 0   # the block's stages so far; the parts pass warp to warp
        for slab, r0, r1 in segs:
            for t0 in range(r0, r1, bm.T_TILE_ROWS):
                valid = min(bm.T_TILE_ROWS, r1 - t0)
                for warp in range(16):
                    part = (warp + it) % 16
                    pair, plane0 = part % pairs, (part // pairs) * planes
                    lst = lists[warp]
                    entries = []   # the tile's order
                    for lane in range(32):
                        for q in range(bm.T_TILE_ROWS // 32):
                            r = q * 32 + lane
                            if r >= valid:
                                continue
                            for i in range(2):
                                j = slab * w + pair * 2 + i
                                wd = int(words[t0 + r, j]) if j < n32 else 0
                                for p in range(plane0, plane0 + planes):
                                    if (wd >> p) & 1:
                                        entries.append((t0 + r, p * n32 + j))
                    if not entries:
                        continue
                    if len(lst) + len(entries) > cap:
                        drain(lst)
                    done = 0
                    while True:
                        take = entries[done:done + cap - len(lst)]
                        lst += take
                        done += len(take)
                        if done == len(entries):
                            break
                        drain(lst)
                    if len(lst) >= drain_at:
                        drain(lst)
                it += 1
        for lst in lists:
            drain(lst)
    return out


@pytest.mark.parametrize("rows,n32,f,w,blocks,density,cap", [
    (300, 36, 16, 32, 3, 0.05, 256), (700, 64, 41, 16, 5, 0.03, 256),
    (200, 16, 96, 8, 2, 0.02, 256), (150, 32, 16, 32, 2, 0.5, 16),
    (130, 8, 32, 8, 1, 0.5, 8), (64, 40, 1, 16, 4, 0.1, 4)])
def test_k1_kernel_rendering_matches_plain(rows, n32, f, w, blocks, density,
                                           cap):
    """Ragged rows (not a multiple of the 128-row tile, fewer than the
    packing's), ragged words (the last slab partial), plane 31 set, sparse
    and dense words (lists drained in pieces when ``cap`` is small): the
    rendering equals the plain version exactly on a grid of 1/16."""
    rng = np.random.default_rng(rows + f)
    bits = rng.random((rows + 3, n32, 32)) < density
    bits[:5, :, 31] = True
    packed = np.zeros((rows + 3, n32), np.uint64)
    for p in range(32):
        packed |= bits[:, :, p].astype(np.uint64) << np.uint64(p)
    packed = packed.astype(np.uint32).view(np.int32)
    x = (rng.integers(-16, 17, (rows, f)) / 16).astype(np.float32)
    num_dst = 32 * n32 - 5
    want = bm.bit_matmul_t_plain(torch.from_numpy(packed),
                                 torch.from_numpy(x), num_dst).numpy()
    got = _render_k1(packed, x, num_dst, w, blocks, cap=cap,
                     drain_at=min(128, cap))
    np.testing.assert_array_equal(got, want)


# -- the wrappers' checks --------------------------------------------------------

def test_k1_slab_widths():
    packed = torch.zeros(64, 8, dtype=torch.int32)
    for f in (1, 16, 32, 64, 96):
        x = torch.ones(64, f)
        assert bm.T_SLAB_WORDS in bm.SLAB_WORDS
        for w in bm.SLAB_WORDS:
            assert bm.bit_matmul_t(packed, x, 256, slab_words=w).shape == \
                (256, f)
    for w in (1, 4, 12, 64):
        with pytest.raises(ValueError, match="slab_words"):
            bm.bit_matmul_t(packed, torch.ones(64, 16), 256, slab_words=w)
