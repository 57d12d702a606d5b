"""The row view of the port's tiled format and the function of the row walk
(``csrc/row_agg.cu``: K4's SpMM by dst, K6's dx by src) on the CPU.

* The row view of each side holds exactly the valid slots of each row,
  ascending, with the node at each slot's other end, and lists the hub
  rows first, by degree, then the rest by id; it is built once a format
  and side.
* A segment sum through the row view equals ``tiled_spmm_multihead_plain``
  and ``src_aggregate_plain`` exactly: the inputs lie on dyadic grids, so
  every f32 sum is exact in any order.
* Those plain versions are held to the JAX kernels, interpreted: K4's SpMM
  (``tiled_spmm_multihead`` :455) and the dx of ``gat_backward`` :428.
  The JAX kernels cast their operands and products to bf16
  (``tiled_spmm.py:439-451``, ``gat_fused.py:211-219``); on these grids
  bf16 holds every value exactly, so the comparison is at rtol 1e-5 /
  atol 1e-6 in f32.  The JAX kernels leave the rows of a tile without a
  bucket unwritten (NaN when interpreted); the port writes 0 there.
"""
import math
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import dgl_tpu.ops.edgeflat as jef
import dgl_tpu.ops.pallas.gat_fused as jgf
import dgl_tpu.ops.pallas.tiled_spmm as jts
import dgl_tpu_torch.ops.edgeflat as tef
import dgl_tpu_torch.ops.kernels.gat_fused as tgf
import dgl_tpu_torch.ops.kernels.tiled_spmm as tts
from test_torch_tiled import _coo as _tiled_coo

EXACT = dict(rtol=1e-5, atol=1e-6)
SHAPES = [(4, 32), (1, 41), (8, 8)]
N, E, TILE, CAP = 600, 3000, 256, 128
DST_HUB, SRC_HUB = 3, 520
# rows of the tiles with no bucket: dst tile 2 and src tile 1
DST_COVERED = np.arange(N) < 512
SRC_COVERED = (np.arange(N) < 256) | (np.arange(N) >= 512)


def _coo(seed=0):
    """A multigraph with a dst hub and a src hub of 400 edges each, no
    in-edge into dst tile 2 (rows 512-599) and no out-edge from src tile 1
    (rows 256-511), and rows of covered tiles with no slot."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, N - 256, E)
    row[row >= 256] += 256
    col = rng.integers(0, 500, E)                  # rows 500-511: no slot
    row[:100], col[:100] = row[100:200], col[100:200]      # multi-edges
    col[200:600] = DST_HUB
    row[600:1000] = SRC_HUB
    return row, col


def _formats(row, col):
    t = tts.build_tiled_format(row, col, N, N, TILE, CAP,
                               device="cpu").with_src_first()
    j = jts.build_tiled_format(row, col, N, N, TILE, CAP).with_src_first()
    return t, j


def _grid(rng, *shape, step, low, top):
    return (rng.integers(round(low / step), round(top / step) + 1, shape)
            * step).astype(np.float32)


def _segment_sum(tf, side, y3, w_slot):
    """The row walk's function in plain PyTorch through the row view:
    out[r] = sum over entries k of row r of w_slot[b, :, c] * y3[nbr[k]],
    slot[k] = b * cap + c."""
    v = tf.row_view(side)
    seg = torch.repeat_interleave(torch.arange(v.rows),
                                  (v.ptr[1:] - v.ptr[:-1]).long())
    s = v.slot.long()
    w = w_slot[s // tf.cap, :, s % tf.cap]
    out = torch.zeros((v.rows,) + tuple(y3.shape[1:]))
    return out.index_add_(0, seg, y3[v.nbr.long()] * w.unsqueeze(-1))


@pytest.mark.parametrize("kind", ["square", "uneven", "dense", "empty",
                                  "hub"])
@pytest.mark.parametrize("side", ["dst", "src"])
def test_row_view_lists_the_valid_slots(kind, side):
    if kind == "hub":
        row, col = _coo(1)
        n_src = n_dst = N
        tf = tts.build_tiled_format(row, col, N, N, TILE, CAP, device="cpu")
    else:
        row, col, n_src, n_dst, tile, cap = _tiled_coo(kind)
        tf = tts.build_tiled_format(row, col, n_src, n_dst, tile, cap,
                                    device="cpu")
    v = tf.row_view(side)
    n = n_dst if side == "dst" else n_src
    rows, nbrs = (col, row) if side == "dst" else (row, col)
    # each canonical edge's slot, and the slots of each row, ascending
    eid = tf.eid.numpy()
    slot_of = np.empty(len(row), np.int64)
    slot_of[eid[eid >= 0]] = np.nonzero(eid >= 0)[0]
    deg = np.bincount(rows, minlength=n)
    assert v.rows == n and v.slot.shape == v.nbr.shape == (len(row),)
    assert all(t.dtype == torch.int32 for t in (v.ptr, v.slot, v.nbr,
                                                v.order))
    np.testing.assert_array_equal(np.diff(v.ptr.numpy()), deg)
    ptr, got_slot, got_nbr = v.ptr.numpy(), v.slot.numpy(), v.nbr.numpy()
    for r in range(n):
        mine = np.nonzero(rows == r)[0]
        want = np.sort(slot_of[mine])
        np.testing.assert_array_equal(got_slot[ptr[r]:ptr[r + 1]], want)
        by_slot = dict(zip(slot_of[mine], nbrs[mine]))
        assert [by_slot[s] for s in want] == list(got_nbr[ptr[r]:ptr[r + 1]])
    assert (tf.valid.reshape(-1)[v.slot.long()] == 1).all()
    # the claim order: rows above 4x the mean degree by degree, largest
    # first, then the rest by id
    hub = deg * n > tts.HUB_DEGREE * len(row)
    ids = np.arange(n)
    want = np.r_[ids[hub][np.lexsort((ids[hub], -deg[hub]))], ids[~hub]]
    np.testing.assert_array_equal(v.order.numpy(), want)
    assert hub.any() == (kind in ("hub", "dense"))
    if kind == "hub" or (kind, side) == ("uneven", "dst"):
        assert (deg == 0).any()            # a tile with no bucket


@pytest.mark.parametrize("heads,fh", SHAPES + [(2, 64), (3, 5)])
def test_segment_sum_equals_plain_versions(heads, fh):
    """Through the row view, the walk's function equals K4's SpMM and the
    src-side aggregation's plain versions exactly on dyadic inputs,
    0 included at the rows with no slot."""
    row, col = _coo(2)
    t, _ = _formats(row, col)
    rng = np.random.default_rng(heads * 100 + fh)
    x = torch.from_numpy(_grid(rng, N, heads, fh, step=1 / 16, low=-1,
                               top=1))
    w = torch.from_numpy(_grid(rng, E * heads, step=1 / 16, low=0, top=1))
    w_slot = tef._w_slot_from_flat(t, w, heads)
    num = tts.tiled_spmm_multihead_plain(t, x, w_slot)
    dx = tgf.src_aggregate_plain(t, x, w_slot)
    assert torch.equal(_segment_sum(t, "dst", x, w_slot), num)
    assert torch.equal(_segment_sum(t, "src", x, w_slot), dx)
    # on the CPU the wrappers take these plain versions
    assert torch.equal(tts.tiled_spmm_multihead(t, x, w_slot, heads, fh),
                       num)
    assert torch.equal(tgf.src_aggregate(t, x, w_slot), dx)
    assert (num[~torch.from_numpy(DST_COVERED)] == 0).all()
    assert (dx[~torch.from_numpy(SRC_COVERED)] == 0).all()
    assert (num[500:512] == 0).all()


@pytest.mark.parametrize("hub_degree", [0, 2, 8, math.inf])
@pytest.mark.parametrize("side", ["dst", "src"])
def test_row_view_claim_orders(hub_degree, side):
    """``hub_degree`` sets the claim order and nothing else: the rows above
    that many times the mean degree by degree, largest first, then the
    rest by id (0: every row with a slot by degree; inf: every row by
    id); the slots are the default view's."""
    row, col = _coo(1)
    tf = tts.build_tiled_format(row, col, N, N, TILE, CAP, device="cpu")
    v = tts._build_row_view(tf, side, hub_degree)
    base = tf.row_view(side)
    for name in ("ptr", "slot", "nbr"):
        assert torch.equal(getattr(v, name), getattr(base, name))
    deg = np.diff(v.ptr.numpy())
    hub = deg * N > hub_degree * E
    ids = np.arange(N)
    want = np.r_[ids[hub][np.lexsort((ids[hub], -deg[hub]))], ids[~hub]]
    np.testing.assert_array_equal(v.order.numpy(), want)
    if hub_degree == math.inf:
        np.testing.assert_array_equal(v.order.numpy(), ids)


def test_row_view_is_built_once():
    row, col = _coo(3)
    t = tts.build_tiled_format(row, col, N, N, TILE, CAP, device="cpu")
    with mock.patch.object(tts, "_build_row_view",
                           wraps=tts._build_row_view) as build:
        views = [t.row_view("dst"), t.row_view("src"), t.row_view("dst"),
                 t.row_view("src")]
        assert views[0] is views[2] and views[1] is views[3]
        assert build.call_count == 2
        # the src-first copy of a format carries the views it had
        assert t.with_src_first().row_view("dst") is views[0]
        assert build.call_count == 2
    assert views[0].nbytes == 4 * (2 * (N + 1) - 1 + 2 * E)
    with pytest.raises(ValueError, match="side"):
        t.row_view("both")


@pytest.fixture(scope="module")
def jax_row_walks():
    """The JAX package's K4 SpMM and gat_backward's dx at SHAPES, each
    interpreted once, on dyadic inputs: (formats, inputs, results)."""
    row, col = _coo(4)
    t, j = _formats(row, col)
    orig = pl.pallas_call

    def interpreted(*a, **kw):
        return orig(*a, **{**kw, "interpret": True})

    cases = {}
    with mock.patch.object(jgf.pl, "pallas_call", interpreted), \
            mock.patch.object(jts.pl, "pallas_call", interpreted):
        for heads, fh in SHAPES:
            rng = np.random.default_rng(heads * 1000 + fh)
            x = _grid(rng, N, heads, fh, step=1 / 16, low=-1, top=1)
            z = _grid(rng, N, heads, fh, step=1 / 8, low=-1, top=1)
            w = _grid(rng, E * heads, step=1 / 16, low=0, top=1)
            w_j = jef._w_slot_from_flat(j, jnp.asarray(w), heads)
            num = jts.tiled_spmm_multihead(j, jnp.asarray(x), w_j, heads, fh)
            # dx = sum p zn[dst] with den = 1, so zn = dZ = z
            dx = jgf.gat_backward(
                j, jnp.zeros((N, heads, fh)), w_j, jnp.zeros_like(w_j),
                jnp.ones((heads, N)), jnp.zeros((N, heads, fh)),
                jnp.asarray(z), heads, fh)[2]
            cases[heads, fh] = (x, z, w, np.asarray(num), np.asarray(dx))
    return t, cases


@pytest.mark.parametrize("heads,fh", SHAPES)
def test_plain_versions_match_jax(jax_row_walks, heads, fh):
    t, cases = jax_row_walks
    x, z, w, num_j, dx_j = cases[heads, fh]
    w_slot = tef._w_slot_from_flat(t, torch.from_numpy(w), heads)
    num = tts.tiled_spmm_multihead_plain(t, torch.from_numpy(x), w_slot)
    dx = tgf.src_aggregate_plain(t, torch.from_numpy(z), w_slot)
    np.testing.assert_allclose(num.numpy()[DST_COVERED], num_j[DST_COVERED],
                               **EXACT)
    np.testing.assert_allclose(dx.numpy()[SRC_COVERED], dx_j[SRC_COVERED],
                               **EXACT)
    assert np.isnan(dx_j[~SRC_COVERED]).all()
    assert (dx.numpy()[~SRC_COVERED] == 0).all()
    assert (num.numpy()[~DST_COVERED] == 0).all()
