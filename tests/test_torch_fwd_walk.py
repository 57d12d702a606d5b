"""K5's forward redesigned for Hopper as a listed-bit walk by dst
(``csrc/bitgat.cu`` ``bitgat_fwd_list_kernel``), which ``bitgat_fwd`` and,
on a shard's dst-major view, ``bitgat_fwd_t`` launch, rendered lane by
lane on the CPU.  No compiler and no card here, so the rendering repeats
the kernel's index arithmetic in numpy, 32 lanes at a time: the claim
order (hub rows first), the listing of a row's set bits (the rendering
of ``tests/test_torch_bwd_walks.py``, shared with the backward's walk:
each step's words a lane, the warp prefix sum of popcounts, a step listed
in pieces when the list fills, the drains), the groups of lanes an entry
and their 16-byte vectors (heads padded, 41 columns to 44), U entries a
group loaded before their arithmetic, the dropout hash, the groups' sums
combined in a fixed order at the row's end, and the write of out and l.

It is held to ``bitgat_fwd_plain`` at (4, 32), (1, 41), (8, 16) and (2,
16), with and without dropout, at rtol 1e-4 / atol 1e-4 (f32 sums in
another order, over up to 3,000 edges at the hub row), on a graph with a
dst hub of 3,000 in-edges, dst rows with no edge, src bits on plane 31
and, in one case, set bits past num_src that the walk must skip; and to
the JAX package's ``_fwd_call`` (its ``_bitgat_fwd``, the Pallas kernel
interpreted) at (1, 41) with dropout and (2, 16) without, on a smaller
graph with a hub of 600.  The other shapes compile an interpreted kernel
of 32 x H unrolled planes each (4-25 s each to lower, about a minute and
a half for the eight, against this file's 30 s), so they are
held to JAX through the plain version, which ``test_torch_bitgat.py``
holds to ``bitgat_attention_aggregate`` of the JAX package at those
shapes.

The shard's dst-major view (``bitgat_spmd.shard_fwd_view``): bit-equal to
the transpose built from the COO at 1, 2 and 4 parts, symmetric or not;
the shard itself where the format is symmetric and npp == kp; and
``bitgat_fwd_t`` on it equal to ``bitgat_fwd_t`` on the shard.
"""
import numpy as np
import pytest
import torch

import dgl_tpu.ops.pallas.bitgat as jbg
import dgl_tpu.ops.pallas.bitmm as jbm
import dgl_tpu_torch.ops.kernels.bitgat as tbg
import dgl_tpu_torch.ops.kernels.bitmm as tbm
import dgl_tpu_torch.ops.kernels.tiled_spmm as tts
from dgl_tpu_torch.parallel import bitgat_spmd as tgs
from dgl_tpu_torch.parallel import bitspmd as tbs
from dgl_tpu_torch.tools import perf_fwd_walks as tfw
from test_torch_bwd_walks import LANE, _bit_graph, _drains, _keep, _popcount

import jax.numpy as jnp

RTOL, ATOL = 1e-4, 1e-4
SLOPE = 0.2
SEED = -123_456_789
SHAPES = [(4, 32), (1, 41), (8, 16), (2, 16)]


def _dst_hub_graph(seed=0, n_dst=600, n_src=16_300, e=9000, hub_degree=3000):
    """Simple edges src -> dst: dst 7 a hub of ``hub_degree`` in-edges
    (more than a list holds in one step), dst 500-519 with none, src ids up
    to 16,299, so that the rows of the dst-major packing hold 512 words
    (two steps of the walk) and reach bit plane 31: the backward walk's
    graph with src and dst swapped."""
    hub, other, n_hub, n_other = _bit_graph(seed, n_dst, n_src, e,
                                            hub_degree)
    return other, hub, n_other, n_hub          # src, dst, n_src, n_dst


def _row_lists(packed, num_dst, num_src):
    """{d: the lists the walk drains for dst row d}: the listing depends
    on the row's words and num_src alone, so every case shares it (a row
    with no set bit drains one empty list)."""
    words = packed.view(np.uint32)
    return {d: _drains(words[d], words.shape[1], num_src)
            if words[d].any() else [[]] for d in range(num_dst)}


def _render_fwd(packed, num_dst, el, er, z, slope, thresh=None, seed=0,
                lists=None, order=None):
    """``bitgat_fwd_list_kernel`` lane by lane: ((out (num_dst, H, D), l
    (num_dst, H)) f32, the number of lists drained for each row)."""
    num_src, heads, dim = z.shape
    dp, lpe, cpl = tbg.list_layout(heads, dim)
    vph, one = dp // 4, heads == 1
    nv = heads * vph
    u_flight = {1: 8, 2: 4, 3: 3}.get(cpl, 2)   # csrc/bitgat.cu ListUnroll
    nh = 1 if one else cpl
    groups = 32 // lpe
    grp, li = LANE // lpe, LANE % lpe
    vq = li[:, None] + lpe * np.arange(cpl)                   # (32, cpl)
    ok = vq < nv
    hq = np.zeros((32, nh), np.int64) if one else vq // vph
    chain = np.ones((32, nh), bool) if one else ok
    hq = np.where(chain, hq, 0)
    head_lane = li == 0 if one else li % vph == 0
    g0 = grp == 0
    tq = np.zeros(cpl, np.int64) if one else np.arange(cpl)
    l_at = head_lane[g0][:, None] & chain[g0]
    kp = np.float32(1.0 if thresh is None else thresh / 32768.0)
    zp = np.zeros((num_src, heads, dp), np.float32)
    zp[..., :dim] = z
    zp = zp.reshape(num_src, nv, 4)
    slope = np.float32(slope)
    if lists is None:
        lists = _row_lists(packed, num_dst, num_src)
    if order is None:
        order = tbg.claim_order(torch.from_numpy(packed), num_dst).numpy()
    out = np.zeros((num_dst, nv, 4), np.float32)
    l = np.zeros((num_dst, heads), np.float32)
    drained = np.zeros(num_dst, np.int64)
    for d in (int(r) for r in order):
        erq = np.where(chain, er[d][hq], 0).astype(np.float32)
        lsum = np.zeros((32, nh), np.float32)
        acc = np.zeros((32, cpl, 4), np.float32)
        drained[d] = sum(1 for x in lists[d] if x)
        for entries in lists[d]:
            entries = np.asarray(entries, np.int64)
            n = len(entries)
            for i0 in range(0, n, groups * u_flight):
                batch = []
                for u in range(u_flight):        # the loads of the batch
                    e = i0 + u * groups + grp
                    s = np.where(e < n, entries[np.minimum(e, n - 1)], -1)
                    live = s >= 0
                    ss = np.where(live, s, 0)
                    zv = np.where((live[:, None] & ok)[..., None],
                                  zp[ss[:, None], np.where(ok, vq, 0)], 0)
                    elv = np.where(live[:, None] & chain, el[ss[:, None], hq],
                                   0).astype(np.float32)
                    batch.append((s, live, zv, elv))
                for s, live, zv, elv in batch:   # their arithmetic
                    raw = elv + erq
                    p = np.exp(np.maximum(raw, slope * raw)).astype(
                        np.float32)
                    lsum += np.where(live[:, None], p, np.float32(0))
                    if thresh is not None:
                        keep = _keep(np.where(live, s, 0)[:, None], d, hq,
                                     thresh, seed)
                        p = np.where(keep, p, np.float32(0))
                    a = p[:, :1] if one else p
                    acc += np.where(live[:, None, None], a[..., None] * zv,
                                    np.float32(0))
        off = lpe
        while off < 32:      # the groups' sums, in a fixed order
            acc = acc + acc[LANE ^ off]
            lsum = lsum + lsum[LANE ^ off]
            off <<= 1
        # group 0 writes: out by each lane's vectors, l by the first lane
        # of each head's block
        den = np.maximum(lsum[g0][:, tq], np.float32(1e-20)) * kp
        out[d, vq[g0][ok[g0]]] = (acc[g0] / den[..., None])[ok[g0]]
        l[d, hq[g0][l_at]] = lsum[g0][l_at]
    return ((out.reshape(num_dst, heads, dp)[..., :dim], l), drained)


def _inputs(seed, n_src, n_dst, heads, dim):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return normal(n_src, heads), normal(n_dst, heads), normal(n_src, heads,
                                                              dim)


def _plain(packed, num_dst, el, er, z, thresh=None, seed=0):
    out, l = tbg.bitgat_fwd_plain(torch.from_numpy(packed),
                                  *(torch.from_numpy(a) for a in (el, er, z)),
                                  num_dst, SLOPE, thresh, seed)
    return out.numpy(), l.numpy()


def _assert_close(got, want, what):
    for name, a, b in zip(("out", "l"), got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {name}")


@pytest.fixture(scope="module")
def hub_graph():
    """(bf, packed as numpy, every row's drained lists)."""
    src, dst, n_src, n_dst = _dst_hub_graph()
    bf = tbm.build_bit_format(src, dst, n_src, n_dst, device="cpu")
    packed = bf.packed.numpy()
    return bf, packed, _row_lists(packed, n_dst, n_src)


@pytest.mark.parametrize("heads,dim", SHAPES)
@pytest.mark.parametrize("drop", [0.0, 0.6])
def test_fwd_walk_rendering_matches_plain(hub_graph, heads, dim, drop):
    bf, packed, lists = hub_graph
    thresh = tbg.drop_thresh(drop)
    el, er, z = _inputs(heads * 100 + dim, bf.num_src, bf.num_dst, heads,
                        dim)
    (out, l), drained = _render_fwd(packed, bf.num_dst, el, er, z, SLOPE,
                                    thresh, SEED, lists)
    _assert_close((out, l), _plain(packed, bf.num_dst, el, er, z, thresh,
                                   SEED), f"H={heads} D={dim} drop={drop}")
    # the hub row fills the list in its steps: drained more than once
    assert drained[7] > 3000 // 256
    # rows with no edge: 0, and l 0
    assert (out[500:520] == 0).all() and (l[500:520] == 0).all()


def test_fwd_walk_graph_reaches_plane_31_and_lists_every_bit(hub_graph):
    """The packing's words reach bit plane 31; each row's drains hold its
    set bits, each once, as src ids, the hub's 3,000 among them."""
    bf, packed, lists = hub_graph
    assert (packed < 0).any() and packed.shape[1] == 512
    words = packed.view(np.uint32)
    for d in (7, 0, 510, 599):
        listed = np.concatenate([np.asarray(x, np.int64) for x in lists[d]])
        j, b = np.nonzero((words[d][:, None] >> np.arange(32)) & 1)
        assert sorted(listed) == sorted(b * 512 + j)
        assert len(listed) == _popcount(words[d]).sum()
    assert sum(len(x) for x in lists[7]) >= 3000


def test_fwd_walk_skips_bits_past_num_src(hub_graph):
    """Set bits past num_src (a packing wider than the src rows given) are
    listed as -1 and skipped: the walk equals the plain version on the
    packing with those bits cleared."""
    bf, packed, _ = hub_graph
    num_src = 16_000
    words = packed.view(np.uint32)
    j = np.arange(words.shape[1])
    src = j[None, :] + words.shape[1] * np.arange(32)[:, None]   # (32, k32)
    past = ((src >= num_src).astype(np.uint64) << np.arange(32)[:, None]
            .astype(np.uint64)).sum(0).astype(np.uint32)
    assert (words & past).any()
    cleared = (words & ~past).view(np.int32)
    el, er, z = _inputs(3, num_src, bf.num_dst, 2, 16)
    (out, l), _ = _render_fwd(packed, bf.num_dst, el, er, z, SLOPE, 13107,
                              5)
    _assert_close((out, l), _plain(cleared, bf.num_dst, el, er, z, 13107, 5),
                  "bits past num_src")


def test_fwd_claim_order_puts_hubs_first(hub_graph):
    """The forward claims the dst rows of ``packed`` hubs first (over 4x
    the mean, largest first), then by id; kept on the format, and the
    backward's own where the format is symmetric and square."""
    bf = hub_graph[0]
    order = tbg.fwd_claim_order(bf).numpy()
    counts = tbg.row_counts(bf.packed, bf.num_dst).numpy()
    hub = counts * bf.num_dst > tts.HUB_DEGREE * counts.sum()
    n_hub = int(hub.sum())
    assert order[0] == 7 and n_hub >= 1
    assert (np.diff(counts[order[:n_hub]]) <= 0).all()
    assert (order[n_hub:] == np.nonzero(~hub)[0]).all()
    assert sorted(order) == list(range(bf.num_dst))
    assert tbg.fwd_claim_order(bf) is tbg.fwd_claim_order(bf)
    src, dst, n = _symmetric(*_bit_graph(3, n_src=1100, n_dst=1100, e=6000,
                                         hub_degree=700)[:3])
    sym = tbm.build_bit_format(src, dst, n, n, symmetric=True, device="cpu")
    assert tbg.fwd_claim_order(sym) is tbg.bwd_claim_order(sym)


@pytest.fixture(scope="module")
def jax_k5_fwd():
    """The JAX package's ``_bitgat_fwd`` (its ``_fwd_call`` interpreted) on
    a graph of 1,000 nodes with a dst hub of 600, at (1, 41) with dropout
    and (2, 16) without: (bf, cases)."""
    src, dst, n_src, n_dst = _dst_hub_graph(9, n_dst=1000, n_src=1000,
                                            e=7000, hub_degree=600)
    bj = jbm.build_bit_format(src, dst, n_src, n_dst)
    bf = tbm.build_bit_format(src, dst, n_src, n_dst, device="cpu")
    cases = {}
    for heads, dim, drop in ((1, 41, 0.6), (2, 16, 0.0)):
        el, er, z = _inputs(heads + dim, n_src, n_dst, heads, dim)
        thresh = jbg.drop_thresh(drop)
        seed = jnp.full((1, 1), 77, jnp.int32)
        out, res = jbg._bitgat_fwd(bj, jnp.asarray(el), jnp.asarray(er),
                                   jnp.asarray(z), seed if thresh else None,
                                   SLOPE, thresh)
        cases[heads, dim] = ((el, er, z, tbg.drop_thresh(drop)),
                             (np.asarray(out), np.asarray(res[5])))
    return bf, cases


@pytest.mark.parametrize("heads,dim", [(1, 41), (2, 16)])
def test_fwd_walk_rendering_matches_jax(jax_k5_fwd, heads, dim):
    bf, cases = jax_k5_fwd
    (el, er, z, thresh), want = cases[heads, dim]
    packed = bf.packed.numpy()
    (out, l), drained = _render_fwd(packed, bf.num_dst, el, er, z, SLOPE,
                                    thresh, 77)
    assert drained.max() > 2        # the hub's 600 entries: three lists
    _assert_close((out, l), want, f"JAX H={heads} D={dim}")


# -- the sharded forward: the shard's dst-major view --------------------------

def _symmetric(src, dst, n):
    """The simple symmetric closure of the edges src -> dst."""
    key = np.unique(np.r_[dst * n + src, src * n + dst])
    return key % n, key // n, n


def _pack_rows(rows, cols, n_rows, n_cols):
    """(n_rows, ceil(n_cols / 32)) int32 packing of the entries (rows,
    cols), from numpy alone: bit c // w of word c % w of row r."""
    w = -(-n_cols // 32)
    out = np.zeros((n_rows, w), np.uint32)
    np.bitwise_or.at(out, (rows, cols % w),
                     np.uint32(1) << (cols // w).astype(np.uint32))
    return out.view(np.int32)


def _view_from_coo(src, dst, fmt, p):
    """Shard p's dst-major view built from the COO alone: rows = the npp
    local dst, kp / 32 words, bit b of word j = src b kp / 32 + j."""
    mine = (dst >= p * fmt.npp) & (dst < (p + 1) * fmt.npp)
    return _pack_rows(dst[mine] - p * fmt.npp, src[mine], fmt.npp, fmt.kp)


@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("symmetric", [False, True])
def test_shard_fwd_view_is_the_coo_transpose(parts, symmetric):
    src, dst, n, _ = _bit_graph(3, n_src=5000, n_dst=5000, e=20_000,
                                hub_degree=900)
    if symmetric:
        src, dst, n = _symmetric(src, dst, n)
    fmt = tbs.build_bit_sharded_format(src, dst, n, parts,
                                       symmetric=symmetric, device="cpu")
    for p in range(parts):
        view, order = tgs.shard_fwd_view(fmt, fmt.shards[p])
        np.testing.assert_array_equal(view.numpy(),
                                      _view_from_coo(src, dst, fmt, p))
        assert view.shape == (fmt.npp, fmt.kp // 32)
        np.testing.assert_array_equal(
            order.numpy(), tbg.claim_order(view, fmt.npp).numpy())
        assert tgs.shard_fwd_view(fmt, fmt.shards[p])[0] is view
    assert len(fmt._fwd_views) == parts


@pytest.mark.parametrize("parts", [1, 2])
def test_shard_fwd_view_is_the_shard_where_symmetric_and_square(parts):
    """Symmetric with npp == kp (4,000 nodes: both 4,096): the view is the
    shard itself, its order K13's; no copy."""
    src, dst, n = _symmetric(*_bit_graph(4, n_src=4000, n_dst=4000,
                                         e=12_000, hub_degree=500)[:3])
    fmt = tbs.build_bit_sharded_format(src, dst, n, parts, symmetric=True,
                                       device="cpu")
    assert fmt.npp == fmt.kp == 4096
    for p in range(parts):
        shard = fmt.shards[p]
        view, order = tgs.shard_fwd_view(fmt, shard)
        assert view is shard
        assert order is tgs.shard_claim_order(fmt, shard)
        np.testing.assert_array_equal(view.numpy(),
                                      _view_from_coo(src, dst, fmt, p))


def test_fwd_t_on_the_view_equals_fwd_t_on_the_shard():
    """``bitgat_fwd_t`` with ``rows=`` (the view) equals its result without
    it, on each shard of a 2-part build; the rendering of the walk on the
    view equals both."""
    src, dst, n, _ = _bit_graph(3, n_src=1100, n_dst=1100, e=6000,
                                hub_degree=700)
    fmt = tbs.build_bit_sharded_format(src, dst, n, 2, device="cpu")
    for p in range(2):
        shard = fmt.shards[p]
        view, order = tgs.shard_fwd_view(fmt, shard)
        el, er, z = (torch.from_numpy(a) for a in
                     _inputs(p, fmt.kp, fmt.npp, 4, 32))
        want = tbg.bitgat_fwd_t(shard, el, er, z, fmt.npp, SLOPE)
        got = tbg.bitgat_fwd_t(shard, el, er, z, fmt.npp, SLOPE, view, order)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        rendered, _ = _render_fwd(view.numpy(), fmt.npp, el.numpy(),
                                  er.numpy(), z.numpy(), SLOPE,
                                  order=order.numpy())
        _assert_close(rendered, [t.numpy() for t in want], f"shard {p}")


def test_transpose_bits():
    """The bit transpose of a packing (rows = dst, bits = src) is the
    packing of its entries by src, built from the COO alone, also when
    built a few rows at a time; transposing it back gives the entries by
    dst again, at ceil(num_src / 32) words a row."""
    src, dst, n_src, n_dst = _dst_hub_graph(5, n_dst=700, n_src=3000,
                                            e=5000, hub_degree=400)
    bf = tbm.build_bit_format(src, dst, n_src, n_dst, device="cpu")
    once = tbg.transpose_bits(bf.packed, n_dst, n_src)
    np.testing.assert_array_equal(once.numpy(),
                                  _pack_rows(src, dst, n_src, n_dst))
    old = tbg.PLAIN_WORDS
    try:
        tbg.PLAIN_WORDS = 5 * bf.packed.shape[1]
        chunked = tbg.transpose_bits(bf.packed, n_dst, n_src)
    finally:
        tbg.PLAIN_WORDS = old
    assert torch.equal(chunked, once)
    np.testing.assert_array_equal(tbg.transpose_bits(once, n_src, n_dst)
                                  .numpy(), _pack_rows(dst, src, n_dst,
                                                       n_src))


def test_fwd_walks_probe_tiny():
    """The probe's edit of csrc/bitgat.cu applies once, and its own source
    holds the two retired kernels' C functions."""
    assert tfw.tiny_check() == ["u2x", "scatter", "warp"]
    src = tfw.edited_sources()["u2x"]
    assert "CPL == 1 ? 16 : CPL == 2 ? 8" in src
