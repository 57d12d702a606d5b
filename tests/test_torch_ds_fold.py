"""K6's ds on the dot-product walk and K9's da folded into the node-gradient
walk by dst, rendered on the CPU (no compiler and no card here), each
against the plain version and the JAX package's kernel:

* ds (``gat_fused.gat_ds``): K4's SDDMM walk by dst (``csrc/row_agg.cu``
  ``row_sddmm_kernel``, rendered lane by lane by
  ``test_torch_sddmm_walk._launch_rendered``) writes each entry's dots into
  an entry-major scratch a part (a row over 1,024 columns takes several
  launches, a chunk of a head's columns a part); ``ds_finish_kernel``,
  rendered here a slot at a time, reads the slot's entry through the view's
  entry map, adds the parts in order, subtracts rp[dst] once, multiplies by
  g and the scale and writes (B, H, C) or the slot-major layout, 0 at a
  padded slot.  On dyadic inputs (multiples of 1/16 in [-1, 1]) every dot
  and product is exact in f32, so the rendering must equal ``gat_ds_plain``
  bit for bit, and the JAX package's ``_ds_kernel`` (``gat_backward``,
  Pallas interpret mode, as ``test_torch_gat_fused.py`` runs it), whose
  bf16 casts hold every such operand and product, at rtol 1e-6;
* da (``vattn_node_grad_da``): ``row_agg_kernel<VEC, CPL, true, true>``
  rendered warp by warp: warps claim rows in turn from one counter, each
  lane sums ds * lrelu(V[r] + U[nbr]) of its columns across the rows its
  group claims, flushes its sums into da when its column chunk changes (a
  row of more than 512 columns is walked in chunks), and at the end the
  warp's groups combine their sums by an xor butterfly and the first
  group's lanes add them.  On dyadic inputs (U, V on a grid of 1/16, ds of
  1/8, slope 1/4) every sum is exact in any order, so the rendering must
  equal ``vattn_slot_grad_plain``'s da bit for bit; against the JAX
  ``_gatv2_bwd``'s da (interpreted; its kernels cast ds, attn and
  lrelu(raw) to bf16) by ``test_torch_gatv2.py``'s rule for da
  (``_kink_close``).

And the host paths on the CPU: ``gat_ds``'s slot-major output, and
``vattn_backward``'s six outputs, the same as the chain of plain versions
and held to the JAX ``_gatv2_bwd`` as ``test_torch_gatv2.py`` holds them.
"""
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
from test_torch_gat_fused import (BF16, DST_COVERED, SRC_COVERED,
                                  _formats, _kink_close)
from test_torch_gat_fused import N as GN
from test_torch_gat_fused import _coo as gat_coo
from test_torch_sddmm_walk import (CAP, N, TILE, _coo, _grid,
                                   _launch_rendered)

EXACT = dict(rtol=1e-6, atol=0)
SLOPE = 0.2
# (4, 32), (1, 41), (8, 8): the main path's widths; (3, 5): heads that
# take scalar loads in the pass; (1, 2048), (8, 256): rows over 1,024
# columns (two launches of the walk: two parts of a head's columns, or
# two groups of heads into one part)
DS_SHAPES = [(4, 32), (1, 41), (8, 8), (3, 5), (1, 2048), (8, 256)]


def _interpreted():
    orig = pl.pallas_call

    def interpreted(*a, **kw):
        return orig(*a, **{**kw, "interpret": True})
    return interpreted


# -- K6's ds: the walk's scratch and the finishing pass ----------------------

def _scratch_rendered(tf, x3, z3):
    """(sm (parts, E * H), parts): each launch of ``_sddmm_plan`` rendered
    lane by lane, its stores at entry * H + h of its part."""
    heads, fh = x3.shape[1:]
    hp = -(-fh // 4) * 4
    hv = hp // 4
    x = tts._vec4_rows(x3, hp).numpy().reshape(x3.shape[0], heads, hv, 4)
    z = tts._vec4_rows(z3, hp).numpy().reshape(z3.shape[0], heads, hv, 4)
    v = tf.row_view("dst")
    ptr = v.ptr.numpy().astype(np.int64)
    rows = np.repeat(np.arange(v.rows), np.diff(ptr))
    plan, parts = tts._sddmm_plan(heads, hv)
    sm = np.full((parts, len(rows) * heads), np.nan, np.float32)
    for h0, nh, v0, nv, part in plan:
        sub = (slice(None), slice(h0, h0 + nh), slice(v0, v0 + nv))
        for e, h, val in _launch_rendered(
                v, x[sub].reshape(len(x), nh * nv, 4),
                z[sub].reshape(len(z), nh * nv, 4), nh, nv, rows):
            sm[part, e * heads + h0 + h] = val
    return sm, parts


def _finish_rendered(tf, sm, rp, g, scale=1.0, slot_major=False):
    """``ds_finish_kernel`` a slot at a time: entry k = entries[s]; where
    k >= 0, v = the parts at k * H + h added in order, then (v - rp[dst(s),
    h]) * g[b, h, c] * scale with dst(s) = dst_tile[b] * tile +
    dst_local[s], in f32; 0 where k is -1.  Returns ds as (B, H, C), laid
    out (B, C, H) with ``slot_major``."""
    b_n, heads, cap = g.shape
    slots = b_n * cap
    k = tf.row_view("dst").entries(slots).numpy().astype(np.int64)
    s = np.arange(slots)
    b, c = s // cap, s % cap
    dst = (tf.dst_tile.numpy().astype(np.int64)[b] * tf.tile
           + tf.dst_local.numpy().reshape(-1))
    live = k >= 0
    v = sm[0].reshape(-1, heads)[np.maximum(k, 0)]
    for j in range(1, sm.shape[0]):           # the parts, in order
        v = v + sm[j].reshape(-1, heads)[np.maximum(k, 0)]
    gs = g.numpy()[b, :, c]                    # (slots, H), read at b, h, c
    out = (v - rp.numpy()[np.where(live, dst, 0)]) * gs * np.float32(scale)
    out[~live] = 0
    out = out.reshape(b_n, cap, heads)
    if slot_major:
        return torch.from_numpy(out.copy()).transpose(1, 2)
    return torch.from_numpy(out.transpose(0, 2, 1).copy())


def _ds_inputs(tf, heads, fh, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(_grid(rng, tf.num_src, heads, fh))
    zn = torch.from_numpy(_grid(rng, tf.num_dst, heads, fh))
    rp = torch.from_numpy(_grid(rng, tf.num_dst, heads))
    b, cap = tf.num_buckets, tf.cap
    g = torch.from_numpy(_grid(rng, b, heads, cap)) * tf.valid.reshape(
        b, 1, cap)
    return x, zn, rp, g


def _ds_format():
    row, col = _coo()
    return tts.build_tiled_format(row, col, N, N, TILE, CAP, device="cpu")


@pytest.mark.parametrize("heads,fh", DS_SHAPES)
def test_ds_finish_rendering_equals_plain(heads, fh):
    """Bit for bit in both layouts, the scale applied after the product;
    rp is subtracted once, after the parts are added (a row over 1,024
    columns has two); 0 at every padded slot."""
    t = _ds_format()
    x, zn, rp, g = _ds_inputs(t, heads, fh, heads * 100 + fh)
    sm, parts = _scratch_rendered(t, x, zn)
    assert parts == (2 if fh > 1024 else 1)
    assert (len(tts._sddmm_plan(heads, -(-fh // 4))[0]) > 1) == (
        heads * fh > 1024)
    assert not np.isnan(sm).any()          # every entry of every part
    want = tgf.gat_ds_plain(t, x, zn, rp, g)
    assert torch.equal(_finish_rendered(t, sm, rp, g), want)
    got = _finish_rendered(t, sm, rp, g, 0.125, slot_major=True)
    assert torch.equal(got, want * 0.125)
    pad = t.valid.reshape(t.num_buckets, 1, t.cap) == 0
    assert (got.masked_select(pad) == 0).all() and pad.any()
    if parts > 1:     # rp once a part would leave (parts - 1) rp g more
        once_a_part = sum(_finish_rendered(t, sm[j:j + 1], rp, g)
                          for j in range(parts))
        assert not torch.equal(once_a_part, want)


def test_ds_entry_map_reaches_every_valid_slot_once():
    """The pass's slot -> entry map: each valid slot's entry in the dst
    view, in the row of its dst, -1 at the padded slots, which it writes
    as 0 without reading rp or g."""
    t = _ds_format()
    v = t.row_view("dst")
    slots = t.num_buckets * t.cap
    k = v.entries(slots).numpy().astype(np.int64)
    valid = t.valid.numpy().reshape(-1) > 0
    assert ((k >= 0) == valid).all()
    assert np.array_equal(np.sort(k[valid]), np.arange(valid.sum()))
    dst = (t.dst_tile.numpy().astype(np.int64)[np.arange(slots) // t.cap]
           * t.tile + t.dst_local.numpy().reshape(-1))
    row_of = np.repeat(np.arange(v.rows), np.diff(v.ptr.numpy()))
    assert np.array_equal(row_of[k[valid]], dst[valid])
    x, zn, rp, g = _ds_inputs(t, 2, 8, 1)
    sm, _ = _scratch_rendered(t, x, zn)
    rp_nan = torch.full_like(rp, float("nan"))
    g_nan = torch.where(t.valid.reshape(t.num_buckets, 1, t.cap) > 0, g,
                        torch.tensor(float("nan")))
    got = _finish_rendered(t, sm, rp, g_nan)
    assert (got.transpose(1, 2).reshape(-1, 2)[~valid] == 0).all()
    assert torch.isnan(_finish_rendered(t, sm, rp_nan, g))[
        t.valid.reshape(t.num_buckets, 1, t.cap).expand(-1, 2, -1) > 0].all()


@pytest.fixture(scope="module")
def jax_ds():
    """ds_slot of the JAX package's ``gat_backward`` (``_ds_kernel``,
    interpreted) on the walk's graph at (4, 32) and (1, 41): den = 1, so
    zn = dZ, and out zero but for its first column, so that rp = out[:, :,
    0] dZ[:, :, 0] is a multiple of 1/256 that bf16 holds."""
    row, col = _coo()
    j = jts.build_tiled_format(row, col, N, N, TILE, CAP).with_src_first()
    cases = {}
    with mock.patch.object(jgf.pl, "pallas_call", _interpreted()):
        for heads, fh in ((4, 32), (1, 41)):
            rng = np.random.default_rng(heads * 7 + fh)
            x = _grid(rng, N, heads, fh)
            dz = _grid(rng, N, heads, fh)
            out = np.zeros((N, heads, fh), np.float32)
            out[:, :, 0] = _grid(rng, N, heads)
            g = _grid(rng, j.num_buckets, heads, j.cap) * np.asarray(
                j.valid).reshape(j.num_buckets, 1, j.cap)
            den = jnp.ones((heads, j.num_dst_tiles * j.tile), jnp.float32)
            ds = jgf.gat_backward(j, jnp.asarray(x), jnp.asarray(g),
                                  jnp.asarray(g), den, jnp.asarray(out),
                                  jnp.asarray(dz), heads, fh)[3]
            cases[heads, fh] = (x, dz, out, g, np.asarray(ds))
    return cases


@pytest.mark.parametrize("heads,fh", [(4, 32), (1, 41)])
def test_ds_finish_rendering_matches_jax(jax_ds, heads, fh):
    t = _ds_format()
    x, dz, out, g, ds_j = jax_ds[heads, fh]
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    zn = torch.from_numpy(dz)
    rp = (torch.from_numpy(out) * zn).sum(-1)
    sm, _ = _scratch_rendered(t, xt, zn)
    got = _finish_rendered(t, sm, rp, gt).numpy()
    valid = np.broadcast_to(
        t.valid.numpy().reshape(t.num_buckets, 1, t.cap) > 0, got.shape)
    np.testing.assert_allclose(got[valid], ds_j[valid], **EXACT)
    assert (got[~valid] == 0).all()


@pytest.mark.parametrize("heads,fh", [(4, 32), (3, 5)])
def test_gat_ds_slot_major_on_cpu(heads, fh):
    """On the CPU, gat_ds in the slot-major layout: the (B, H, C) values of
    the plain version, a view of a (B, C, H) tensor (strides (C H, 1,
    H)); the scale applied after the product."""
    t = _ds_format()
    x, zn, rp, g = _ds_inputs(t, heads, fh, 5)
    want = tgf.gat_ds_plain(t, x, zn, rp, g)
    got = tgf.gat_ds(t, x, zn, rp, g, slot_major=True)
    assert got.shape == want.shape
    assert got.stride() == (t.cap * heads, 1, heads)
    assert got.transpose(1, 2).is_contiguous()
    assert torch.equal(got, want)
    assert torch.equal(tgf.gat_ds(t, x, zn, rp, g, True, 0.5), want * 0.5)
    plain = tgf.gat_ds(t, x, zn, rp, g)
    assert plain.is_contiguous() and torch.equal(plain, want)


# -- K9's da folded into the node-gradient walk by dst -----------------------

def _fold_rendered(tf, U3, V3, ds, slope, warps=3):
    """da (H, D) as ``row_agg_kernel<VEC, CPL, true, true>`` sums it over
    the dst view: ``warps`` warps claim items (row, column chunk) from one
    counter in turn, ``groups`` at a time; lane li of group grp sums
    ds[slot, h] * lrelu(V[r] + U[nbr]) of its column vectors (chunk * cpl
    + q) * lpr + li over the rows its group claims, in slot order; when
    its group's chunk changes it adds its sums into da (a flush) and
    starts again; at the end the warp's groups combine their sums by an
    xor butterfly over the group bits and the first group's lanes add
    them.  U3, V3 (n, H, D) and ds (B, H, C) numpy f32.  Also returns the
    number of flushes at chunk changes."""
    heads, hc = U3.shape[1:]
    hp = -(-hc // 4) * 4
    if hp == hc or (hp - hc) * 8 > hc:
        hp = hc

    def padded(t):
        p = np.zeros(t.shape[:-1] + (hp,), np.float32)
        p[..., :hc] = t
        return p.reshape(t.shape[0], heads * hp)

    own, y = padded(V3), padded(U3)
    f = heads * hp
    vec, cpl, lpr, n_chunks = tts._row_layout(
        f, hp, torch.from_numpy(y), torch.from_numpy(own),
        max_cpl=tts.FOLD_CPL)
    groups, nv = 32 // lpr, f // vec
    view = tf.row_view("dst")
    ptr, slot, nbr, order = (t.numpy() for t in (view.ptr, view.slot,
                                                 view.nbr, view.order))
    w = ds.transpose(0, 2, 1).reshape(-1, heads)         # (slots, H)
    slope = np.float32(slope)
    n_items = view.rows * n_chunks
    da = np.zeros(f, np.float32)
    lane = np.arange(32)
    grp, li = lane // lpr, lane % lpr
    sums = np.zeros((warps, 32, cpl, vec), np.float32)
    da_chunk = np.zeros(warps, np.int64)
    flushes = 0

    def flush(wp, lanes, chunk):
        for ln in lanes:
            for q in range(cpl):
                cv = (chunk * cpl + q) * lpr + li[ln]
                if cv < nv:
                    da[cv * vec:(cv + 1) * vec] += sums[wp, ln, q]
        sums[wp, lanes] = 0

    counter, done = 0, np.zeros(warps, bool)
    while not done.all():
        for wp in range(warps):         # the warps claim in turn
            if done[wp]:
                continue
            base, counter = counter, counter + groups
            if base >= n_items:
                done[wp] = True
                continue
            for gi in range(groups):
                item = base + gi
                has = item < n_items
                r = order[item // n_chunks] if has else 0
                chunk = item % n_chunks if has else 0
                lanes = lane[grp == gi]
                if chunk != da_chunk[wp]:   # one group a warp (lpr 32)
                    assert groups == 1
                    flush(wp, lanes, da_chunk[wp])
                    da_chunk[wp] = chunk
                    flushes += 1
                if not has:
                    continue
                cv = (chunk * cpl + np.arange(cpl)[None, :]) * lpr + \
                    li[lanes][:, None]                       # (lanes, cpl)
                ok = cv < nv
                cols = np.where(ok[..., None],
                                cv[..., None] * vec + np.arange(vec), 0)
                hq = cols // hp
                for k in range(ptr[r], ptr[r + 1]):     # slot order
                    raw = own[r][cols] + y[nbr[k]][cols]
                    lr = np.where(raw >= 0, raw, slope * raw)
                    wk = w[slot[k]][hq]
                    sums[wp, lanes] += np.where(ok[..., None], wk * lr, 0)
    for wp in range(warps):             # the butterfly, then group 0
        o = lpr
        while o < 32:
            sums[wp] = sums[wp] + sums[wp][lane ^ o]
            o *= 2
        flush(wp, lane[grp == 0], da_chunk[wp])
    return da.reshape(heads, hp)[:, :hc], flushes


def _fold_inputs(t, heads, dim, seed, n=N):
    rng = np.random.default_rng(seed)

    def grid(*shape, step, top):
        return (rng.integers(-round(top / step), round(top / step) + 1,
                             shape) * step).astype(np.float32)

    U = grid(n, heads, dim, step=1 / 16, top=1)
    V = grid(n, heads, dim, step=1 / 16, top=1)
    attn = grid(heads, dim, step=1 / 16, top=0.5)
    b, cap = t.num_buckets, t.cap
    ds = grid(b, heads, cap, step=1 / 8, top=1) * \
        t.valid.numpy().reshape(b, 1, cap)
    return U, V, attn, ds


# (1, 600) and (4, 160): rows of more than 512 columns, walked in two
# column chunks (the lanes flush at each change); (3, 5): scalar loads
FOLD_SHAPES = [(8, 8), (1, 41), (4, 32), (3, 5), (1, 600), (4, 160)]


@pytest.mark.parametrize("heads,dim", FOLD_SHAPES)
def test_fold_rendering_equals_plain(heads, dim):
    t = _ds_format()
    U, V, attn, ds = _fold_inputs(t, heads, dim, heads * 10 + dim)
    got, flushes = _fold_rendered(t, U, V, ds, 0.25)
    want = tgf.vattn_slot_grad_plain(
        t, *(torch.from_numpy(a) for a in (U, V, attn, ds)), 0.25)[0]
    np.testing.assert_array_equal(got, want.numpy())
    wide = heads * dim > 512
    assert (flushes > 0) == wide
    hp = dim if (-(-dim // 4) * 4 - dim) * 8 > dim else -(-dim // 4) * 4
    chunks = tts._row_layout(heads * hp, hp, max_cpl=tts.FOLD_CPL)[3]
    assert chunks == (2 if wide else 1)
    # the wrapper on the CPU: the plain versions, dV and da together
    tens = [torch.from_numpy(a) for a in (U, V, attn, ds)]
    dv, da = tgf.vattn_node_grad(t, *tens, 0.25, "dst", with_da=True)
    assert torch.equal(da, want)
    assert torch.equal(dv, tgf.vattn_node_grad_plain(t, *tens, 0.25, "dst"))


def test_fold_layout_keeps_four_vectors_a_lane():
    """The fold keeps at most FOLD_CPL vectors a lane (the walk without it
    8), so a row of 1,024 columns takes two chunks with da and one
    without; where a row takes chunks, a group is the whole warp."""
    assert tts._row_layout(1024, 1024)[1:] == (8, 32, 1)
    assert tts._row_layout(1024, 1024, max_cpl=tts.FOLD_CPL)[1:] == (4, 32,
                                                                      2)
    for f in (64, 44, 128, 512, 600, 640, 4096):
        vec, cpl, lpr, chunks = tts._row_layout(f, f,
                                                max_cpl=tts.FOLD_CPL)
        assert cpl <= tts.FOLD_CPL and lpr * cpl * chunks * vec >= f
        assert chunks == 1 or lpr == 32
    with pytest.raises(ValueError, match="side='dst'"):
        t = _ds_format()
        tgf.vattn_node_grad(t, *(torch.zeros(1),) * 4, 0.2, "src",
                            with_da=True)


@pytest.fixture(scope="module")
def jax_k9():
    """The JAX package's gatv2 attention and its vjp in U, V, x and attn
    (``_gatv2_bwd``, interpreted) at (2, 8) and (1, 41) on
    ``test_torch_gat_fused``'s graph, the inputs that form raw on a grid
    of 1/16."""
    row, col = gat_coo(17)
    t, j = _formats(row, col)
    cases = {}
    with mock.patch.object(jgf.pl, "pallas_call", _interpreted()), \
            mock.patch.object(jts.pl, "pallas_call", _interpreted()):
        for heads, dim in ((2, 8), (1, 41)):
            rng = np.random.default_rng(heads * 100 + dim + 1)
            U, V = (((rng.integers(-16, 17, (GN, heads, dim)) / 16)
                     .astype(np.float32)) for _ in range(2))
            attn = (rng.integers(-8, 9, (heads, dim)) / 16).astype(
                np.float32)
            x, dz = (rng.normal(size=(GN, heads, dim)).astype(np.float32)
                     for _ in range(2))
            out, vjp = jax.vjp(lambda u, v, z, a: jgf.gatv2_attention_aggregate(
                j, u, v, z, a, heads, dim, dim, SLOPE), *(
                jnp.asarray(a) for a in (U, V, x, attn)))
            cases[heads, dim] = (U, V, x, attn, dz) + tuple(
                np.asarray(gr, np.float32) for gr in vjp(jnp.asarray(dz)))
    return t, cases


@pytest.mark.parametrize("heads,dim", [(2, 8), (1, 41)])
def test_fold_rendering_matches_jax(jax_k9, heads, dim):
    """The rendered fold's da, on ds from the port's plain backward,
    against the JAX ``_gatv2_bwd``'s d(attn) by ``_kink_close``, the rule
    of ``test_torch_gatv2.py`` (the JAX kernels cast ds, attn and
    lrelu(raw) to bf16); and against the plain slot gradient at rtol 1e-4
    / atol 1e-5 (f32 sums over every edge in another order)."""
    t, cases = jax_k9
    U, V, x, attn, dz, _, _, _, d_attn = cases[heads, dim]
    Ut, Vt, xt, at = (torch.from_numpy(a) for a in (U, V, x, attn))
    p = tgf.vattn_scores_plain(t, Ut, Vt, at, SLOPE)
    den = tgf.slot_reduce_plain(t, p, "dst").clamp_(min=tgf.DEN_EPS)
    out = tts.tiled_spmm_multihead_plain(t, xt, p) / den.unsqueeze(-1)
    zn, rp = tgf._scales(out, torch.from_numpy(dz), den)
    ds = tgf.gat_ds_plain(t, xt, zn, rp, p)
    got, _ = _fold_rendered(t, U, V, ds.numpy(), SLOPE)
    _kink_close(got, d_attn, "da")
    np.testing.assert_allclose(
        got, tgf.vattn_slot_grad_plain(t, Ut, Vt, at, ds, SLOPE)[0].numpy(),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("heads,dim", [(2, 8), (1, 41)])
def test_vattn_backward_on_cpu(jax_k9, heads, dim):
    """vattn_backward's six outputs on the CPU (K9: ds slot-major, dV and
    da from one call): the chain of plain versions bit for bit, d_ef and
    dwf None; and the JAX ``_gatv2_bwd`` as ``test_torch_gatv2.py`` holds
    them (dU, dV, da by ``_kink_close``, dx at bf16's tolerance, on the
    covered rows)."""
    t, cases = jax_k9
    U, V, x, attn, dz, d_u, d_v, d_x, d_attn = cases[heads, dim]
    Ut, Vt, xt, at, dzt = (torch.from_numpy(a)
                           for a in (U, V, x, attn, dz))
    out, p, den = tgf.vattn_forward(t, Ut, Vt, xt, at, heads, dim, SLOPE)
    got = tgf.vattn_backward(t, Ut, Vt, xt, at, p, den, out, dzt, SLOPE)
    zn, rp = tgf._scales(out, dzt, den)
    ds = tgf.gat_ds_plain(t, xt, zn, rp, p)
    want = (tgf.vattn_node_grad_plain(t, Ut, Vt, at, ds, SLOPE, "src"),
            tgf.vattn_node_grad_plain(t, Ut, Vt, at, ds, SLOPE, "dst"),
            tgf.src_aggregate_plain(t, zn, p),
            tgf.vattn_slot_grad_plain(t, Ut, Vt, at, ds, SLOPE)[0])
    assert got[4] is None and got[5] is None
    for a, w in zip(got[:4], want):
        assert torch.equal(a, w)
    dU, dV, dx, da = (a.numpy() for a in got[:4])
    _kink_close(dU[SRC_COVERED], d_u[SRC_COVERED], "dU")
    _kink_close(dV[DST_COVERED], d_v[DST_COVERED], "dV")
    np.testing.assert_allclose(dx[SRC_COVERED], d_x[SRC_COVERED], **BF16)
    _kink_close(da, d_attn, "da")


def test_ds_fold_probe_tiny():
    """``tools/perf_ds_fold.py``: each edit that brings a retired instance
    back applies once to its package source."""
    from dgl_tpu_torch.tools import perf_ds_fold as tdf
    assert tdf.tiny_check() == ["bucket_ds", "tiled_da"]
