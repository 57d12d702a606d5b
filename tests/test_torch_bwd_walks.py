"""The two backward walks redesigned for Hopper, rendered lane by lane on
the CPU: K5's backward as a listed-bit walk (``csrc/bitgat.cu``
``bitgat_bwd_list_kernel``, which K13 launches on a shard too) and K9's
node gradient as a register-summing row walk (``csrc/row_agg.cu``
``row_agg_kernel`` in its node-gradient form).  No compiler and no card
here, so each rendering repeats its kernel's index arithmetic in numpy,
32 lanes at a time:

* the listed walk: the claim order (hub rows first), each step's words a
  lane, the warp prefix sum of popcounts that places each lane's set bits
  in the list, a step listed in pieces when the list fills (a hub row),
  the drains, the groups of lanes an entry and their columns (heads padded
  to 16-byte vectors, 41 columns to 44), the head sums over a head's
  block of lanes, the dropout hash, and the groups' sums combined in a
  fixed order at the row's end; held to the JAX package's
  ``_bitgat_bwd`` (Pallas interpret mode) at rtol 1e-4 / atol 1e-5, as
  ``test_torch_bitgat.py`` holds the port to it (f32 on both sides, the
  sums over each node's edges in another order), and to
  ``bitgat_bwd_plain`` and ``bit_shard_gat_bwd_plain`` at rtol 1e-4 /
  atol 1e-4 on a graph with a hub row of 3,000 edges, whose sums in
  another order leave up to about 2e-5 near a cancellation;
* the node-gradient row walk: the row view's rows, lanes a row, the
  weights' rounds and shuffles, the 16-byte column vectors (41 columns
  padded to 44), the select of lrelu's slope and attn applied once at the
  end; on dyadic inputs every sum is exact, so it must equal
  ``vattn_node_grad_plain`` bit for bit; and, with ds from the port's
  plain backward, held to dU and dV of the JAX package's ``_gatv2_bwd``
  (interpreted) by the rule ``test_torch_gatv2.py`` uses for them (its
  kernels cast ds, attn and dW to bf16).
"""
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import dgl_tpu.ops.pallas.bitgat as jbg
import dgl_tpu.ops.pallas.bitmm as jbm
import dgl_tpu.ops.pallas.gat_fused as jgf
import dgl_tpu.ops.pallas.tiled_spmm as jts
import dgl_tpu_torch.ops.kernels.bitgat as tbg
import dgl_tpu_torch.ops.kernels.bitmm as tbm
import dgl_tpu_torch.ops.kernels.gat_fused as tgf
import dgl_tpu_torch.ops.kernels.tiled_spmm as tts
from dgl_tpu_torch.tools import perf_bwd_walks as tbw
from dgl_tpu_torch.parallel import bitgat_spmd as tgs
from dgl_tpu_torch.parallel import bitspmd as tbs
from bit_listing import (DRAIN_AT, LANE, LIST, STEP_WORDS, _drains,
                         _listed_steps, _popcount)
from test_torch_gat_fused import (DST_COVERED, N, SRC_COVERED, _coo,
                                  _formats, _kink_close)

RTOL, ATOL = 1e-4, 1e-5
# against the plain version: the hub row's sums run over 3,000 edges, in
# another order, and near a cancellation f32 leaves up to about 2e-5 of
# absolute error there
PLAIN_ATOL = 1e-4
SLOPE = 0.2
M32 = 0xFFFFFFFF


# -- K5's backward: the listed-bit walk ---------------------------------------

def _bit_graph(seed=0, n_src=600, n_dst=16_300, e=9000, hub_degree=3000):
    """Simple edges src -> dst: src row 7 a hub of ``hub_degree`` out-edges
    (more than a list holds in one step), src rows 500-519 with none, and
    dst ids up to 16,299, so that the rows of the A^T packing hold 512
    words (two steps of the walk) and reach bit plane 31."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, e)
    src[(src >= 500) & (src < 520)] = 3
    dst = rng.integers(0, n_dst, e)
    src[:hub_degree], dst[:hub_degree] = 7, rng.permutation(n_dst)[
        :hub_degree]
    dst[hub_degree:hub_degree + 40] = rng.integers(n_dst - 400, n_dst, 40)
    key = np.unique(dst * n_src + src)
    return key % n_src, key // n_src, n_src, n_dst


def _bwd_inputs(seed, n_src, n_dst, heads, dim, fwd=None):
    """el, er, z, g and the backward's linv and rho, the latter from the
    forward's out and l as the autograd function forms them: ``fwd`` maps
    (el, er, z) to the plain forward's (out, l); without it (dropout's
    threshold, seed) the bit format ``fwd`` is read as (bf, thresh,
    seed)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    el, er = normal(n_src, heads), normal(n_dst, heads)
    z, g = normal(n_src, heads, dim), normal(n_dst, heads, dim)
    out, l = fwd(*(torch.from_numpy(a) for a in (el, er, z)))
    thresh = getattr(fwd, "thresh", None)
    linv, rho = tbg.backward_scales(torch.from_numpy(g), out, l, thresh)
    return el, er, z, g, linv.numpy(), rho.numpy()


def _fwd(bf, thresh=None, seed=0):
    """K5's plain forward on ``bf`` as ``_bwd_inputs``' ``fwd``."""
    def fwd(el, er, z):
        return tbg.bitgat_fwd_plain(bf.packed, el, er, z, bf.num_dst, SLOPE,
                                    thresh, seed)
    fwd.thresh = thresh
    return fwd


def _keep(s, d, heads_of, thresh, seed):
    """The dropout hash of (s, d) for the heads ``heads_of``, uint32."""
    mults = np.array([int(m) for m in tbg._HEAD_MULTS], np.uint64)
    x0 = ((s * tbg._DC1) & M32) ^ (seed & M32) ^ ((d * tbg._DC2) & M32)
    x0 = np.uint64(x0)
    return (((x0 * mults[heads_of & 7]) & M32) >> 17) < thresh


def _render_bwd(packed_rev, rows, num_dst, el, er, z, g, linv, rho, slope,
                thresh=None, seed=0, lanes=None, order=None, vector_der=False):
    """``bitgat_bwd_list_kernel`` lane by lane: (del (rows, H), der
    (num_dst, H), dz (rows, H, D)), f32, and the number of lists drained
    for each row; with ``vector_der``, der as the probe's edit of that
    name adds it (``tools/perf_bwd_walks.py``)."""
    heads, dim = z.shape[1:]
    dp, lpe, cpl = tbw.layout(heads, dim, lanes)
    vph, one = dp // 4, heads == 1
    nv = heads * vph
    u_flight = {1: 8, 2: 4, 3: 3}.get(cpl, 2)   # csrc/bitgat.cu ListUnroll
    nh = 1 if one else cpl
    groups = 32 // lpe
    grp, li = LANE // lpe, LANE % lpe
    red = lpe if one else vph
    vq = li[:, None] + lpe * np.arange(cpl)                   # (32, cpl)
    ok = vq < nv
    hq = np.zeros((32, nh), np.int64) if one else vq // vph
    chain = np.ones((32, nh), bool) if one else ok
    hq = np.where(chain, hq, 0)
    der_lane = li == 0 if one else li % vph == 0
    gather = _der_gather(heads, dp, lpe, cpl) if vector_der else None
    pad = np.zeros((max(z.shape[0], g.shape[0]), heads, dp), np.float32)

    def vectors(t):     # (n, H, D) -> (n, nv, 4), heads zero-padded
        p = pad[:t.shape[0]].copy()
        p[..., :dim] = t
        return p.reshape(t.shape[0], nv, 4)

    zp, gp = vectors(z), vectors(g)
    nvec = np.stack([er, linv, rho], 1).astype(np.float32)   # (n, 3, H)
    words_all = packed_rev.view(np.uint32)
    k32 = words_all.shape[1]
    slope = np.float32(slope)
    d_el = np.zeros((rows, heads), np.float32)
    d_er = np.zeros((num_dst, heads), np.float32)
    dz = np.zeros((rows, nv, 4), np.float32)
    if order is None:
        order = tbg.claim_order(torch.from_numpy(packed_rev), rows).numpy()
    drained = np.zeros(rows, np.int64)
    for s in (int(r) for r in order):
        zq = np.where(ok[..., None], zp[s][np.where(ok, vq, 0)], 0)
        elq = np.where(chain, el[s][hq], 0).astype(np.float32)
        dzq = np.zeros((32, cpl, 4), np.float32)
        delq = np.zeros((32, nh), np.float32)
        lists = _drains(words_all[s], k32, num_dst)
        drained[s] = sum(1 for x in lists if x)
        for entries in lists:
            entries = np.asarray(entries, np.int64)
            n = len(entries)
            for i0 in range(0, n, groups * u_flight):
                for u in range(u_flight):
                    e = i0 + u * groups + grp
                    d = np.where(e < n, entries[np.minimum(e, max(n - 1, 0))]
                                 if n else -1, -1)
                    live = d >= 0
                    dd = np.where(live, d, 0)
                    gv = np.where((live[:, None] & ok)[..., None],
                                  gp[dd[:, None], np.where(ok, vq, 0)], 0)
                    nr = nvec[dd]                               # (32, 3, H)
                    on = live[:, None] & chain
                    erv, liv, rhv = (np.where(on, nr[LANE[:, None], k, hq],
                                              0) for k in range(3))
                    prod = (gv * zq).sum(-1)                    # (32, cpl)
                    dot = prod.sum(1, keepdims=True) if one else prod
                    off = red >> 1
                    while off:
                        dot = dot + dot[LANE ^ off]
                        off >>= 1
                    raw = elq + erv
                    alpha = np.exp(np.maximum(raw, slope * raw)) * liv
                    if thresh is None:
                        am = alpha
                    else:
                        keep = np.stack([
                            _keep(s, int(dd[lane]), hq[lane], thresh, seed)
                            for lane in range(32)])
                        am = np.where(keep, alpha, np.float32(0))
                    de = am * dot - alpha * rhv
                    dr = np.where(raw > 0, de, slope * de)
                    delq += np.where(on, dr, 0)
                    a = am[:, :1] if one else am
                    dzq += np.where(live[:, None, None],
                                    a[..., None] * gv, 0)
                    if gather is not None:   # lane 0 of a group: a vector
                        for lane in np.nonzero(live & (li == 0))[0]:
                            for h, (src_li, t) in enumerate(gather):
                                d_er[dd[lane], h] += dr[lane + src_li, t]
                        continue
                    for lane in np.nonzero(live & der_lane)[0]:
                        for t in range(nh):
                            if chain[lane, t]:
                                d_er[dd[lane], hq[lane, t]] += dr[lane, t]
        off = lpe
        while off < 32:      # the groups' sums, in a fixed order
            dzq = dzq + dzq[LANE ^ off]
            delq = delq + delq[LANE ^ off]
            off <<= 1
        for lane in np.nonzero(grp == 0)[0]:
            dz[s, vq[lane][ok[lane]]] = dzq[lane][ok[lane]]
            if der_lane[lane]:
                for t in range(nh):
                    if chain[lane, t]:
                        d_el[s, hq[lane, t]] = delq[lane, t]
    return (d_el, d_er,
            dz.reshape(rows, heads, dp)[..., :dim]), drained


def _der_gather(heads, dp, lpe, cpl):
    """The der gather of the probe's ``vector_der`` edit of the listed
    walk: None where it keeps scalar reductions (H not 4 or 8, or a lane
    chain that is no head), else for each head h (lane within the group,
    chain) of the value that the group's first lane takes by a shuffle:
    the first lane of block h % nb, chain h // nb (nb = lpe / vph blocks a
    group)."""
    vph = dp // 4
    if heads not in (4, 8) or heads * vph != lpe * cpl:
        return None
    nb = lpe // vph
    return [((h % nb) * vph, h // nb) for h in range(heads)]


def _plain_bwd(packed_rev, num_dst, el, er, z, g, linv, rho, thresh, seed):
    out = tbg.bitgat_bwd_plain(
        torch.from_numpy(packed_rev), *(torch.from_numpy(a) for a in (
            el, er, z, g, linv, rho)), num_dst, SLOPE, thresh, seed)
    return [t.numpy() for t in out]


def _assert_all_close(got, want, what, atol=PLAIN_ATOL):
    for name, a, b in zip(("d_el", "d_er", "d_z"), got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol,
                                   err_msg=f"{what} {name}")


@pytest.fixture(scope="module")
def bit_graph():
    row, col, n_src, n_dst = _bit_graph()
    bf = tbm.build_bit_format(row, col, n_src, n_dst, device="cpu")
    return bf, bf.packed_rev.numpy()


@pytest.mark.parametrize("heads,dim,drop", [
    (4, 32, 0.0), (4, 32, 0.6), (1, 41, 0.0), (1, 41, 0.6), (8, 16, 0.6),
    (2, 64, 0.0), (3, 5, 0.0), (1, 8, 0.6)])
def test_listed_walk_rendering_matches_plain(bit_graph, heads, dim, drop):
    bf, packed_rev = bit_graph
    thresh, seed = tbg.drop_thresh(drop), -123_456_789
    ins = _bwd_inputs(heads * 100 + dim, bf.num_src, bf.num_dst, heads, dim,
                      _fwd(bf, thresh, seed))
    got, drained = _render_bwd(packed_rev, bf.num_src, bf.num_dst, *ins,
                               SLOPE, thresh, seed)
    _assert_all_close(got, _plain_bwd(packed_rev, bf.num_dst, *ins, thresh,
                                      seed), f"H={heads} D={dim}")
    # the hub row fills the list in its steps: drained more than once
    assert drained[7] > 3000 // LIST


@pytest.mark.parametrize("lanes", [8, 32])
def test_listed_walk_rendering_other_lanes_an_entry(bit_graph, lanes):
    """Other lanes an entry (more or fewer vectors a lane) give the same
    gradients: the layouts ``tools/perf_bwd_walks.py`` times beside."""
    bf, packed_rev = bit_graph
    ins = _bwd_inputs(5, bf.num_src, bf.num_dst, 4, 32, _fwd(bf))
    got, _ = _render_bwd(packed_rev, bf.num_src, bf.num_dst, *ins, SLOPE,
                         lanes=lanes)
    _assert_all_close(got, _plain_bwd(packed_rev, bf.num_dst, *ins, None, 0),
                      f"{lanes} lanes")


def test_listed_walk_lists_every_set_bit_once(bit_graph):
    """Each row's drains hold its set bits, each once, as dst ids (the hub
    row's 3,000 among them), in the order of lanes, words and bits."""
    bf, packed_rev = bit_graph
    words = packed_rev.view(np.uint32)
    k32 = words.shape[1]
    for s in (0, 7, 3, 510, 599):
        listed = np.concatenate([np.asarray(x, np.int64)
                                 for x in _drains(words[s], k32, bf.num_dst)])
        j, b = np.nonzero((words[s][:, None] >> np.arange(32)) & 1)
        assert sorted(listed) == sorted(b * k32 + j)
        assert len(listed) == _popcount(words[s]).sum()
    assert len(np.concatenate([np.asarray(x) for x in _drains(
        words[7], k32, bf.num_dst)])) >= 3000


@pytest.mark.parametrize("heads,dim,want", [
    (4, 32, (32, 16, 2)), (1, 41, (44, 4, 3)), (8, 16, (16, 16, 2)),
    (8, 8, (8, 8, 2)), (2, 64, (64, 16, 2)), (3, 5, (8, 4, 2)),
    (3, 40, (64, 32, 2)), (1, 8, (8, 1, 2)), (128, 1, (4, 32, 4)),
    (1, 128, (128, 8, 4)), (16, 8, (8, 16, 2))])
def test_bwd_layout(heads, dim, want):
    """The padded head width, lanes an entry and vectors a lane; each
    group's lanes hold every vector of the row once, and with several
    heads each head's vectors fill an aligned block of vph lanes."""
    dp, lpe, cpl = tbg.list_layout(heads, dim)
    assert (dp, lpe, cpl) == want
    vph, nv = dp // 4, heads * dp // 4
    vq = np.arange(lpe)[:, None] + lpe * np.arange(cpl)
    assert sorted(vq[vq < nv]) == list(range(nv))
    if heads > 1:
        assert lpe % vph == 0 and vph & (vph - 1) == 0
        head = vq // vph
        for blk in range(lpe // vph):
            assert (head[blk * vph:(blk + 1) * vph] == head[blk * vph]).all()
    # the probe's other lanes an entry, checked as the kernel takes them
    assert tbw.layout(heads, dim) == want
    with pytest.raises(ValueError):
        tbw.layout(heads, dim, lanes=64)
    if nv > 4:                        # more than 4 vectors a lane
        with pytest.raises(ValueError):
            tbw.layout(heads, dim, lanes=max(1, nv // 8))
    if heads > 1 and vph > 1:         # fewer lanes than a head's vectors
        with pytest.raises(ValueError):
            tbw.layout(heads, dim, lanes=vph // 2)


def test_claim_order_puts_hubs_first(bit_graph):
    """The set bits of each row counted on the device's words, and the rows
    claimed hubs first (over 4x the mean, largest first), then by id."""
    bf, packed_rev = bit_graph
    counts = tbg.row_counts(bf.packed_rev, bf.num_src).numpy()
    want = _popcount(packed_rev[:bf.num_src].view(np.uint32)).sum(1)
    np.testing.assert_array_equal(counts, want)
    order = tbg.claim_order(bf.packed_rev, bf.num_src).numpy()
    hub = counts * bf.num_src > tts.HUB_DEGREE * counts.sum()
    n_hub = int(hub.sum())
    assert order[0] == 7 and n_hub >= 1
    assert (np.diff(counts[order[:n_hub]]) <= 0).all()
    assert (order[n_hub:] == np.nonzero(~hub)[0]).all()
    assert sorted(order) == list(range(bf.num_src))
    # chunked counting: a few rows at a time
    old = tbg.COUNT_WORDS
    try:
        tbg.COUNT_WORDS = 3 * packed_rev.shape[1]
        np.testing.assert_array_equal(
            tbg.row_counts(bf.packed_rev, bf.num_src).numpy(), want)
    finally:
        tbg.COUNT_WORDS = old
    fmt = tbs.build_bit_sharded_format(
        *_bit_graph(3, n_src=1100, n_dst=1100, e=6000, hub_degree=700)[:3],
        2, device="cpu")
    assert tgs.shard_claim_order(fmt, fmt.shards[1]) is \
        tgs.shard_claim_order(fmt, fmt.shards[1])
    b2 = tbm.build_bit_format(*_bit_graph()[:4], device="cpu")
    assert tbg.bwd_claim_order(b2) is tbg.bwd_claim_order(b2)


def test_k13_shard_rendering_matches_plain():
    """K13's orientation: the walk over a shard's kp src rows, bit columns
    the npp dst of one device, on each shard of a 2- and a 4-part build."""
    row, col, n, _ = _bit_graph(3, n_src=1100, n_dst=1100, e=6000,
                                hub_degree=700)
    for parts in (2, 4):
        fmt = tbs.build_bit_sharded_format(row, col, n, parts, device="cpu")
        kp, npp = fmt.kp, fmt.npp
        for p in range(parts):
            shard = fmt.shards[p]
            el, er, z, g, linv, rho = _bwd_inputs(
                p, kp, npp, 4, 32, lambda el, er, z, shard=shard:
                tbg.bitgat_fwd_t_plain(shard, el, er, z, npp, SLOPE))
            got, _ = _render_bwd(shard.numpy(), kp, npp, el, er, z, g, linv,
                                 rho, SLOPE)
            want = tgs.bit_shard_gat_bwd_plain(
                shard, *(torch.from_numpy(a) for a in (
                    el, er, z, g, linv, rho)), npp, SLOPE)
            _assert_all_close(got, [t.numpy() for t in want],
                              f"shard {p} of {parts}")


@pytest.mark.parametrize("heads,dim,drop", [
    (4, 32, 0.6), (8, 16, 0.0), (8, 8, 0.6)])
def test_listed_walk_rendering_vector_der(bit_graph, heads, dim, drop):
    """The probe's ``vector_der`` edit: the group's first lane takes each
    head's sum once, from the first lane of a block that holds that head
    in the named chain, and adds the same der."""
    dp, lpe, cpl = tbg.list_layout(heads, dim)
    gather = _der_gather(heads, dp, lpe, cpl)
    vph = dp // 4
    for h, (src_li, t) in enumerate(gather):
        assert 0 <= src_li < lpe and src_li % vph == 0 and 0 <= t < cpl
        assert (src_li + lpe * t) // vph == h
    assert _der_gather(1, *tbg.list_layout(1, 41)) is None
    bf, packed_rev = bit_graph
    thresh, seed = tbg.drop_thresh(drop), 77
    ins = _bwd_inputs(heads + dim, bf.num_src, bf.num_dst, heads, dim,
                      _fwd(bf, thresh, seed))
    got, _ = _render_bwd(packed_rev, bf.num_src, bf.num_dst, *ins, SLOPE,
                         thresh, seed, vector_der=True)
    _assert_all_close(got, _plain_bwd(packed_rev, bf.num_dst, *ins, thresh,
                                      seed), f"vector der H={heads}")


def test_bwd_walks_probe_tiny():
    """The probe's edits of csrc/bitgat.cu (der by vectors, 80 registers)
    and csrc/gatv2.cu (the tiled node-gradient walk with no edge term)
    each apply once, and its layouts at other lanes an entry hold every
    vector of a row."""
    assert tbw.tiny_check() == ["lb3", "vector_der", "tiled_k9", "warp"]
    bitgat_src, gatv2_src = tbw.edited_sources()
    assert "red_add_v4(der + d * heads + h0" in bitgat_src["vector_der"]
    assert "launch_node_grad<G, kSrc, 0>" in gatv2_src


def test_shard_claim_orders_are_kept_per_view():
    """A rank's view keeps claim orders of its own, not the full format's;
    an order is kept by the shard's device, address and shape."""
    row, col, n, _ = _bit_graph(3, n_src=1100, n_dst=1100, e=6000,
                                hub_degree=700)
    fmt = tbs.build_bit_sharded_format(row, col, n, 2, device="cpu")
    full = tgs.shard_claim_order(fmt, fmt.shards[1])
    view = tbs.shard_format(fmt, 1, device="cpu")
    assert view._claim_orders is None and len(fmt._claim_orders) == 1
    mine = tgs.shard_claim_order(view, view.shards[0])
    assert view.shards[0].data_ptr() == fmt.shards[1].data_ptr()
    assert mine is not full and torch.equal(mine, full)
    assert len(fmt._claim_orders) == 1 and len(view._claim_orders) == 1
    (key,) = view._claim_orders
    assert key == ("cpu", view.shards[0].data_ptr(),
                   tuple(view.shards[0].shape))


@pytest.fixture(scope="module")
def jax_k5_bwd():
    """The JAX package's ``_bitgat_bwd`` (its ``_bwd_call`` interpreted) on
    a graph of 1,000 nodes with a hub, at (8, 16) with dropout: (graph,
    cases)."""
    row, col, n, _ = _bit_graph(9, n_src=1000, n_dst=1000, e=7000,
                                hub_degree=600)
    bj = jbm.build_bit_format(row, col, n, n)
    orig = pl.pallas_call
    cases = {}
    with mock.patch.object(jbg.pl, "pallas_call",
                           lambda *a, **k: orig(*a, **{**k,
                                                       "interpret": True})):
        for heads, dim, drop in ((8, 16, 0.6),):
            rng = np.random.default_rng(heads + dim)
            el, er = (rng.normal(size=(n, heads)).astype(np.float32)
                      for _ in range(2))
            z, g = (rng.normal(size=(n, heads, dim)).astype(np.float32)
                    for _ in range(2))
            thresh = jbg.drop_thresh(drop)
            seed = jnp.full((1, 1), 77, jnp.int32)
            out, res = jbg._bitgat_fwd(bj, jnp.asarray(el), jnp.asarray(er),
                                       jnp.asarray(z), seed, SLOPE, thresh)
            grads = jbg._bitgat_bwd(SLOPE, thresh, res, jnp.asarray(g))[1:4]
            l = res[5]
            cases[heads, dim] = (el, er, z, g, np.array(out),
                                 np.array(l), thresh,
                                 [np.asarray(t) for t in grads])
    return (row, col, n), cases


@pytest.mark.parametrize("heads,dim", [(8, 16)])
def test_listed_walk_rendering_matches_jax(jax_k5_bwd, heads, dim):
    (row, col, n), cases = jax_k5_bwd
    el, er, z, g, out, l, thresh, want = cases[heads, dim]
    bf = tbm.build_bit_format(row, col, n, n, device="cpu")
    linv, rho = tbg.backward_scales(torch.from_numpy(g),
                                    torch.from_numpy(out),
                                    torch.from_numpy(l), thresh)
    got, _ = _render_bwd(bf.packed_rev.numpy(), n, n, el, er, z, g,
                         linv.numpy(), rho.numpy(), SLOPE, thresh, 77)
    _assert_all_close(got, want, f"JAX H={heads} D={dim}", ATOL)


# -- K9's node gradient: the row walk -----------------------------------------

def _render_node_grad(tf, side, U3, V3, attn, ds, slope):
    """``row_aggregate``'s padding and ``row_agg_kernel``'s node-gradient
    form lane by lane over the row view of ``side``: out[r] = attn * sum
    over the row's slots, in slot order, of ds[slot, h] * (own[r] +
    y[nbr] >= 0 ? 1 : slope), own = V3 (dst) or U3 (src), y the other."""
    heads, hc = U3.shape[1:]
    hp = -(-hc // 4) * 4
    if hp == hc or (hp - hc) * 8 > hc:
        hp = hc

    def padded(t):
        p = np.zeros(t.shape[:-1] + (hp,), np.float32)
        p[..., :hc] = t
        return p

    own, y = (V3, U3) if side == "dst" else (U3, V3)
    own, y, a = padded(own), padded(y), padded(attn.reshape(1, heads, hc))
    f = heads * hp
    own, y, a = own.reshape(-1, f), y.reshape(-1, f), a.reshape(f)
    view = tf.row_view(side)
    vec, cpl, lpr, n_chunks = tts._row_layout(
        f, hp, torch.from_numpy(y), torch.from_numpy(own))
    kcols = vec * cpl                     # csrc/row_agg.cu Unroll
    u_flight = 8 if kcols <= 4 else 4 if kcols <= 8 else 2
    nvv = f // vec
    w = ds.transpose(0, 2, 1).reshape(-1)          # slot-major: s * H + h
    slope = np.float32(slope)
    ptr, slot, nbr = (t.numpy() for t in (view.ptr, view.slot, view.nbr))
    rows = view.rows
    out = np.zeros((rows, f), np.float32)
    li = np.arange(lpr)
    for r in view.order.numpy():
        for chunk in range(n_chunks):
            cv = (chunk * cpl + np.arange(cpl)[None, :]) * lpr + li[:, None]
            ok = cv < nvv                                   # (lpr, cpl)
            hq = np.where(ok, cv * vec // hp, 0)
            cols = cv[..., None] * vec + np.arange(vec)     # (lpr, cpl, vec)
            cols = np.where(ok[..., None], cols, 0)
            oq = np.where(ok[..., None], own[r][cols], 0)
            acc = np.zeros((lpr, cpl, vec), np.float32)
            for pb in range(ptr[r], ptr[r + 1], lpr):
                n = min(lpr, ptr[r + 1] - pb)
                my_nbr = np.where(li < n, nbr[np.minimum(pb + li,
                                                         len(nbr) - 1)], 0)
                my_s = np.where(li < n, slot[np.minimum(pb + li,
                                                        len(slot) - 1)], 0)
                for u0 in range(0, n, u_flight):
                    # a round of weights: lane k holds slot k // H of the
                    # round, head k % H; each is shuffled to its lanes
                    wq = np.zeros((u_flight, lpr, cpl), np.float32)
                    for k0 in range(0, u_flight * heads, lpr):
                        k = k0 + li
                        u = k // heads
                        src_lane = np.minimum(u0 + u, lpr - 1)
                        wv = np.where((k < u_flight * heads) & (u0 + u < n),
                                      w[my_s[src_lane] * heads
                                        + (k - u * heads) % heads], 0)
                        for uu in range(u_flight):
                            src = uu * heads + hq - k0
                            hit = (src >= 0) & (src < lpr)
                            wq[uu] = np.where(hit, wv[np.clip(src, 0,
                                                              lpr - 1)],
                                              wq[uu])
                    for u in range(u_flight):
                        if u0 + u >= n:
                            continue
                        nb = my_nbr[u0 + u]
                        xv = np.where(ok[..., None], y[nb][cols], 0)
                        sel = np.where(oq + xv >= 0, np.float32(1), slope)
                        acc = acc + wq[u][..., None] * sel
            acc = acc * a[cols]
            out[r, cols[ok]] = acc[ok]
    return out.reshape(rows, heads, hp)[..., :hc]


def _grid(rng, *shape, step, top):
    return (rng.integers(-round(top / step), round(top / step) + 1, shape)
            * step).astype(np.float32)


def _node_grad_inputs(t, heads, dim, seed):
    """U, V, attn on a grid of 1/16 and ds on a grid of 1/8 in [-1, 1]
    (0 at padded slots): with slope 1/4 every product and sum is exact."""
    rng = np.random.default_rng(seed)
    U, V = (_grid(rng, N, heads, dim, step=1 / 16, top=1) for _ in range(2))
    attn = _grid(rng, heads, dim, step=1 / 16, top=0.5)
    b, cap = t.num_buckets, t.cap
    ds = _grid(rng, b, heads, cap, step=1 / 8, top=1) * \
        t.valid.numpy().reshape(b, 1, cap)
    return U, V, attn, ds


@pytest.mark.parametrize("side", ["dst", "src"])
@pytest.mark.parametrize("heads,dim", [(8, 8), (1, 41), (4, 32), (3, 5)])
def test_node_grad_row_walk_rendering_equals_plain(heads, dim, side):
    """Bit for bit: rows with no slot (dst tile 2, src tile 1) come out 0,
    and 41 columns are walked padded to 44."""
    t, _ = _formats(*_coo(11))
    U, V, attn, ds = _node_grad_inputs(t, heads, dim, heads * 10 + dim)
    got = _render_node_grad(t, side, U, V, attn, ds, 0.25)
    want = tgf.vattn_node_grad_plain(
        t, *(torch.from_numpy(a) for a in (U, V, attn, ds)), 0.25, side)
    np.testing.assert_array_equal(got, want.numpy())
    empty = ~(DST_COVERED if side == "dst" else SRC_COVERED)
    assert (got[empty] == 0).all()


def test_node_grad_takes_a_slot_major_ds():
    """vattn_node_grad reads ds through its strides: a (B, H, C) view of a
    slot-major tensor, as vattn_backward hands it on the card, gives the
    same gradient."""
    t, _ = _formats(*_coo(12))
    U, V, attn, ds = (torch.from_numpy(a) for a in
                      _node_grad_inputs(t, 4, 32, 3))
    sm = ds.transpose(1, 2).contiguous().transpose(1, 2)
    assert not sm.is_contiguous()
    for side in ("dst", "src"):
        assert torch.equal(tgf.vattn_node_grad(t, U, V, attn, sm, 0.25, side),
                           tgf.vattn_node_grad(t, U, V, attn, ds, 0.25,
                                               side))


@pytest.fixture(scope="module")
def jax_k9_bwd():
    """dU and dV of the JAX package's ``_gatv2_bwd`` (interpreted) at
    (2, 8) and (1, 41), the inputs that form raw on a grid of 1/16."""
    row, col = _coo(13)
    t, j = _formats(row, col)
    orig = pl.pallas_call

    def interpreted(*a, **kw):
        return orig(*a, **{**kw, "interpret": True})

    cases = {}
    with mock.patch.object(jgf.pl, "pallas_call", interpreted), \
            mock.patch.object(jts.pl, "pallas_call", interpreted):
        for heads, dim in ((2, 8), (1, 41)):
            rng = np.random.default_rng(heads * 100 + dim)
            U, V = (_grid(rng, N, heads, dim, step=1 / 16, top=1)
                    for _ in range(2))
            attn = _grid(rng, heads, dim, step=1 / 16, top=0.5)
            x, dz = (rng.normal(size=(N, heads, dim)).astype(np.float32)
                     for _ in range(2))
            _, vjp = jax.vjp(lambda u, v: jgf.gatv2_attention_aggregate(
                j, u, v, jnp.asarray(x), jnp.asarray(attn), heads, dim, dim,
                SLOPE), jnp.asarray(U), jnp.asarray(V))
            d_u, d_v = vjp(jnp.asarray(dz))
            cases[heads, dim] = (U, V, x, attn, dz, np.asarray(d_u),
                                 np.asarray(d_v))
    return t, cases


@pytest.mark.parametrize("heads,dim", [(2, 8), (1, 41)])
def test_node_grad_row_walk_rendering_matches_jax(jax_k9_bwd, heads, dim):
    t, cases = jax_k9_bwd
    U, V, x, attn, dz, d_u, d_v = cases[heads, dim]
    Ut, Vt, xt, at = (torch.from_numpy(a) for a in (U, V, x, attn))
    p = tgf.vattn_scores_plain(t, Ut, Vt, at, SLOPE)
    den = tgf.slot_reduce_plain(t, p, "dst").clamp_(min=tgf.DEN_EPS)
    out = tts.tiled_spmm_multihead_plain(t, xt, p) / den.unsqueeze(-1)
    zn, rp = tgf._scales(out, torch.from_numpy(dz), den)
    ds = tgf.gat_ds_plain(t, xt, zn, rp, p).numpy()
    got_u = _render_node_grad(t, "src", U, V, attn, ds, SLOPE)
    got_v = _render_node_grad(t, "dst", U, V, attn, ds, SLOPE)
    _kink_close(got_u[SRC_COVERED], d_u[SRC_COVERED], "dU")
    _kink_close(got_v[DST_COVERED], d_v[DST_COVERED], "dV")
    np.testing.assert_allclose(
        got_v, tgf.vattn_node_grad_plain(t, Ut, Vt, at, torch.from_numpy(ds),
                                         SLOPE, "dst").numpy(),
        rtol=RTOL, atol=ATOL)
