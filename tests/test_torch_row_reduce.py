"""The row reduce (K6's slot reduce) and K3 on the row walk by dst, on the
CPU, where neither CUDA kernel runs:

* a lane-by-lane numpy rendering of csrc ``row_reduce_kernel`` (the
  wrapper's layout, ``tiled_spmm.reduce_layout`` and ``reduce_vec``: the
  lanes a slot and a row, each lane's entries in entry order, the slot
  lanes of a head combined by an xor butterfly, the first lane writing)
  against ``slot_reduce_plain``, on both sides, at H in {1, 3, 4, 8, 64},
  in the (B, H, C) layout and slot-major, on a graph with rows of no entry
  and a hub row of each side;
* a lane-by-lane rendering of ``row_agg_kernel`` at one head (K3: the
  wrapper's layout, lpr entries a step, of which a lane keeps min(lpr,
  U) in flight, the weightless instance's weight of 1) against
  ``tiled_spmm_plain`` at F in {3, 8, 16, 41}, with and without
  weights;
* ``slot_reduce`` and ``tiled_spmm`` on the CPU against the JAX package's
  functions with their Pallas kernels interpreted: ``gat_forward``'s den,
  ``gat_backward``'s der and del, ``tiled_spmm`` with and without
  weights.

Tolerances.  The renderings and the plain versions take inputs on dyadic
grids whose every sum is exact in f32, so each must equal the other bit
for bit, whatever the order of its sums.  The JAX den sums p cast to bf16
(``gat_fused.py:113``) in f32: the port's reduce of the same bf16 values
is held to it at rtol 1e-6 / atol 1e-6 (f32 sums in another order).
The JAX der and del cast ds to bf16 after the JAX ds, which casts x and
zn: on the grid below (x, dZ, out and g multiples of 1/2 or 1/4 in [-1,
1], den 1) every such value is exact in bf16, so der and del must equal
the port's exactly.  The JAX K3 takes f32 operands off the TPU: exact on
its grid too.
"""
import re
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import dgl_tpu.ops.pallas.gat_fused as jgf
import dgl_tpu.ops.pallas.tiled_spmm as jts
import dgl_tpu_torch.ops.kernels.gat_fused as tgf
import dgl_tpu_torch.ops.kernels.tiled_spmm as tts

N, TILE, CAP = 700, 128, 128
HUB_DST, HUB_SRC = 5, 640        # a hub row of each side
CSRC = tts.build.CSRC_DIR


def _coo(seed=0, n=N, e=6000):
    """A multigraph with a dst hub (node 5, 900 in-edges), a src hub
    (node 640, 700 out-edges), rows of no entry on both sides (nodes
    600-639 receive none, nodes 300-339 send none) and multi-edges."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, e)
    row[(row >= 300) & (row < 340)] += 100
    col = rng.integers(0, 600, e)
    col[:900] = HUB_DST
    row[900:1600] = HUB_SRC
    row[1600:1700], col[1600:1700] = row[1700:1800], col[1700:1800]
    return row, col


@pytest.fixture(scope="module")
def fmt():
    row, col = _coo()
    return tts.build_tiled_format(row, col, N, N, TILE, CAP, device="cpu")


def _grid(rng, *shape, step=1 / 16, top=1.0):
    """f32 values on a grid of ``step`` in [-top, top]."""
    k = int(round(top / step))
    return (rng.integers(-k, k + 1, shape) * step).astype(np.float32)


def _slot_vals(t, heads, seed, slot_major):
    """(B, H, C) slot values on a grid of 1/16, 0 at padded slots, laid
    out (B, H, C) or slot-major."""
    v = _grid(np.random.default_rng(seed), t.num_buckets, heads, t.cap)
    v *= t.valid.numpy().reshape(t.num_buckets, 1, t.cap)
    vals = torch.from_numpy(v)
    return tgf._slot_major(vals) if slot_major else vals


def _unroll(vec, cpl):
    """csrc/row_agg.cu Unroll<VEC, CPL>: slots in flight a lane."""
    cols = vec * cpl
    return 8 if cols <= 4 else 4 if cols <= 8 else 2


def test_unroll_matches_the_source():
    with open(f"{CSRC}/row_agg.cu") as f:
        src = f.read()
    assert ("static constexpr int value = kCols <= 4 ? 8 : kCols <= 8 ? 4 "
            ": 2;") in src
    assert "for (int pb = p0; pb < p1; pb += lpr) {" in src


def _memory(vals):
    """The storage of ``vals`` from its first element, flat, as numpy, and
    its strides: what the kernel reads through them."""
    n = 1 + sum((s - 1) * st for s, st in zip(vals.shape, vals.stride()))
    return vals.as_strided((n,), (1,)).numpy(), vals.stride()


def render_row_reduce(view, cap, vals, lpr=None):
    """``row_reduce_kernel`` in numpy, lane by lane, at the wrapper's
    layout: (rows, H) f32."""
    heads = vals.shape[1]
    vec = tts.reduce_vec(vals)
    cpl, lps, auto, n_chunks = tts.reduce_layout(
        heads, vec, view.slot.numel() / max(view.rows, 1))
    lpr = auto if lpr is None else max(lpr, lps)
    spr = lpr // lps
    nv = heads // vec
    mem, (bs, hs, cs) = _memory(vals)
    ptr, slot = view.ptr.numpy(), view.slot.numpy()
    out = np.full((view.rows, heads), np.nan, np.float32)
    for r in view.order.numpy():
        ents = slot[ptr[r]:ptr[r + 1]]
        for ch in range(n_chunks):
            cvs = np.arange(ch * cpl * lps, (ch + 1) * cpl * lps)
            cvs = cvs[cvs < nv]
            h = (cvs[:, None] * vec + np.arange(vec)).reshape(-1)
            lanes = np.zeros((spr, h.size), np.float32)
            for sl in range(spr):         # slot lane sl: entries sl, sl+spr..
                for s in ents[sl::spr]:
                    b, c = divmod(int(s), cap)
                    lanes[sl] = lanes[sl] + mem[b * bs + h * hs + c * cs]
            o = 1
            while o < spr:                # the butterfly over slot lanes
                lanes = lanes + lanes[np.arange(spr) ^ o]
                o *= 2
            out[r, h] = lanes[0]          # slot lane 0 writes
    return out


@pytest.mark.parametrize("side", ["dst", "src"])
@pytest.mark.parametrize("heads", [1, 3, 4, 8, 64])
@pytest.mark.parametrize("slot_major", [False, True])
def test_row_reduce_rendering_equals_plain(fmt, side, heads, slot_major):
    vals = _slot_vals(fmt, heads, heads * 7 + slot_major, slot_major)
    view = fmt.row_view(side)
    got = render_row_reduce(view, fmt.cap, vals)
    want = tgf.slot_reduce_plain(fmt, vals, side).numpy()
    np.testing.assert_array_equal(got, want)
    hub = HUB_DST if side == "dst" else HUB_SRC
    ptr = view.ptr.numpy()
    assert ptr[hub + 1] - ptr[hub] >= 700          # the hub row
    empty = np.nonzero(ptr[1:] == ptr[:-1])[0]
    assert empty.size >= 40 and (got[empty] == 0).all()


@pytest.mark.parametrize("lpr", [1, 4, 32])
def test_row_reduce_rendering_any_group(fmt, lpr):
    """Narrower groups (more rows a warp) give the same sums."""
    vals = _slot_vals(fmt, 1, 3, False)
    np.testing.assert_array_equal(
        render_row_reduce(fmt.row_view("dst"), fmt.cap, vals, lpr),
        tgf.slot_reduce_plain(fmt, vals, "dst").numpy())


@pytest.mark.parametrize("heads,slot_major,want", [
    (1, False, (1, 1, 1, 32, 1)), (4, True, (4, 1, 1, 32, 1)),
    (4, False, (1, 1, 4, 32, 1)), (8, True, (4, 1, 2, 32, 1)),
    (8, False, (1, 1, 8, 32, 1)), (64, True, (4, 1, 16, 32, 1)),
    (64, False, (1, 2, 32, 32, 1)), (3, True, (1, 1, 4, 32, 1))])
def test_reduce_layout_at_the_main_widths(heads, slot_major, want):
    """(vec, cpl, lps, lpr, n_chunks) at Reddit's mean degree (about 490):
    16-byte loads only where the values are slot-major and H a multiple
    of 4; at most 8 vectors a lane; one launch for any head count."""
    t = torch.zeros(2, heads, 128)
    vals = tgf._slot_major(t) if slot_major else t
    vec = tts.reduce_vec(vals)
    assert (vec,) + tts.reduce_layout(heads, vec, 490.0) == want
    assert tts.reduce_layout(512, 4, 490.0) == (4, 32, 32, 1)
    assert tts.reduce_layout(2048, 1, 490.0)[3] == 8


def render_k3(t, x, w=None):
    """``row_agg_kernel`` at one head (K3) in numpy, lane by lane, at the
    layout ``tiled_spmm`` gives it (``row_aggregate``'s pad, then
    ``_row_layout``): (num_dst, F) f32."""
    f = x.shape[1]
    hp = -(-f // 4) * 4
    if hp == f or (hp - f) * 8 > f:
        hp = f
    y = np.zeros((x.shape[0], hp), np.float32)
    y[:, :f] = x.numpy()
    vec, cpl, lpr, n_chunks = tts._row_layout(hp, hp, torch.from_numpy(y))
    view = t.row_view("dst")
    ptr, slot, nbr = (a.numpy() for a in (view.ptr, view.slot, view.nbr))
    wf = None if w is None else w.reshape(-1).numpy()
    out = np.full((t.num_dst, hp), np.nan, np.float32)
    nv = hp // vec
    for r in view.order.numpy():
        for ch in range(n_chunks):
            for li in range(lpr):
                cv = (ch * cpl + np.arange(cpl)) * lpr + li
                cols = (cv[cv < nv, None] * vec + np.arange(vec)).reshape(-1)
                acc = np.zeros(cols.size, np.float32)
                for pb in range(ptr[r], ptr[r + 1], lpr):   # a step
                    for k in range(pb, min(pb + lpr, ptr[r + 1])):
                        wk = 1.0 if wf is None else float(wf[slot[k]])
                        # fmaf: one rounding of w * y + acc
                        acc = (wk * y[nbr[k], cols].astype(np.float64)
                               + acc).astype(np.float32)
                out[r, cols] = acc
    return out[:, :f]


@pytest.mark.parametrize("f,narrow", [(3, True), (8, True), (16, True),
                                      (41, False)])
@pytest.mark.parametrize("weighted", [False, True])
def test_k3_walk_rendering_equals_plain(fmt, f, narrow, weighted):
    """``narrow``: a row has fewer lanes than U, so a lane keeps lpr slots
    in flight, not U (at F = 16 four: 8 in flight ran slower on the card,
    ``tools/perf_reduce_k3.py``'s NARROW edit)."""
    rng = np.random.default_rng(f)
    x = torch.from_numpy(_grid(rng, N, f))
    w = None
    if weighted:
        w = torch.from_numpy(_grid(rng, *fmt.valid.shape, step=1 / 4)
                             * fmt.valid.numpy())
    hp = 44 if f == 41 else f
    vec, cpl, lpr, _ = tts._row_layout(hp, hp, torch.zeros(1, hp))
    assert (lpr < _unroll(vec, cpl)) == narrow
    if f == 16:                  # 4 lanes a row, 8 slots in flight a lane
        assert (vec, cpl, lpr, _unroll(vec, cpl)) == (4, 1, 4, 8)
    got = render_k3(fmt, x, w)
    np.testing.assert_array_equal(got, tts.tiled_spmm_plain(fmt, x, w)
                                  .numpy())
    np.testing.assert_array_equal(got, tts.tiled_spmm(
        fmt, x, slot_weights=w).numpy())


# -- against the JAX package, its Pallas kernels interpreted -----------------

@pytest.fixture
def interpret():
    orig = pl.pallas_call

    def interpreted(*a, **k):
        return orig(*a, **{**k, "interpret": True})

    with mock.patch.object(jgf.pl, "pallas_call", interpreted), \
            mock.patch.object(jts.pl, "pallas_call", interpreted):
        yield


J_N, J_HEADS, J_FH = 300, 4, 8


def _jax_formats(seed):
    """Both packages' formats of one graph whose every tile has a bucket
    (the interpreted JAX kernels leave an uncovered tile's rows NaN)."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, J_N, 2500)
    col = rng.integers(0, J_N, 2500)
    t = tts.build_tiled_format(row, col, J_N, J_N, TILE, CAP,
                               device="cpu").with_src_first()
    j = jts.build_tiled_format(row, col, J_N, J_N, TILE, CAP).with_src_first()
    return t, j


def test_slot_reduce_matches_jax_gat(interpret):
    t, j = _jax_formats(11)
    rng = np.random.default_rng(12)
    el = rng.normal(size=(J_N, J_HEADS)).astype(np.float32)
    er = rng.normal(size=(J_N, J_HEADS)).astype(np.float32)
    x, dz, out = (_grid(rng, J_N, J_HEADS, J_FH, step=1 / 2)
                  for _ in range(3))
    g = _grid(rng, t.num_buckets, J_HEADS, t.cap, step=1 / 4) * (
        t.valid.numpy().reshape(t.num_buckets, 1, t.cap))
    # den: the JAX forward's, against the port's reduce of its p in bf16
    _, p_j, _, den_j = jgf.gat_forward(j, jnp.asarray(el), jnp.asarray(er),
                                       jnp.asarray(x), J_HEADS, J_FH, 0.2)
    p16 = torch.tensor(np.asarray(p_j)).to(torch.bfloat16).float()
    for vals in (p16, tgf._slot_major(p16)):
        den = tgf.slot_reduce(t, vals, "dst").clamp_(min=tgf.DEN_EPS)
        np.testing.assert_allclose(den.numpy(),
                                   np.asarray(den_j).T[:J_N], rtol=1e-6,
                                   atol=1e-6)
    # der and del: den 1, every bf16 cast of the JAX backward exact
    ones = np.ones((J_N, J_HEADS), np.float32)
    dl_j, dr_j, _, ds_j = jgf.gat_backward(
        j, jnp.asarray(x), p_j, jnp.asarray(g), jnp.asarray(ones.T),
        jnp.asarray(out), jnp.asarray(dz), J_HEADS, J_FH)
    dl, dr, _, ds = tgf.gat_backward(
        t, torch.from_numpy(x), torch.tensor(np.asarray(p_j)),
        torch.from_numpy(g), torch.from_numpy(ones), torch.from_numpy(out),
        torch.from_numpy(dz), J_HEADS, J_FH)
    assert ds.stride()[1] == 1                  # slot-major, as it is read
    np.testing.assert_array_equal(ds.numpy(), np.asarray(ds_j))
    np.testing.assert_array_equal(dr.numpy(), np.asarray(dr_j))
    np.testing.assert_array_equal(dl.numpy(), np.asarray(dl_j))


@pytest.mark.parametrize("weighted", [False, True])
def test_tiled_spmm_matches_jax(interpret, weighted):
    t, j = _jax_formats(13)
    rng = np.random.default_rng(14)
    x = _grid(rng, J_N, 16)
    w = _grid(rng, 2500, step=1 / 4) if weighted else None
    got = tts.tiled_spmm(t, torch.from_numpy(x),
                         None if w is None else torch.from_numpy(w))
    want = jts.tiled_spmm(j, jnp.asarray(x),
                          None if w is None else jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_retired_kernels_left_the_package():
    """The tiled reduce and the tiled K3 walk are built by the probe alone
    (``tools/reduce_k3_probe.cu``), and its edits of the row walk apply
    once each."""
    from dgl_tpu_torch.tools import perf_reduce_k3 as trk
    for path in tts.build.sources().values():
        with open(path) as f:
            src = f.read()
        for kernel in ("slot_reduce_kernel", "tiled_spmm_kernel"):
            # defined (``name(``) or launched (``name<...><<<``): comments
            # may name them
            assert not re.search(rf"\b{kernel}(<[^>]*>)?\s*(\(|<<<)", src)
    assert "tiled_spmm" not in tts.build.sources()
    with open(trk.PROBE_SOURCE) as f:
        probe = f.read()
    assert "slot_reduce_kernel(" in probe and "tiled_spmm_kernel(" in probe
    assert trk.tiny_check() == ["tiled_reduce", "tiled_k3", "narrow",
                                "rounds", "nocap"]
