"""K10's and K11 v1's slot walks and K10's edge ds as redesigned for
Hopper, rendered on the CPU: no compiler and no card here, so each
rendering repeats its kernel's index arithmetic in numpy.  No JAX here:
the plain versions these renderings are held to are held to the JAX
functions by ``test_torch_gat_fused_v1.py`` and ``test_torch_edgegat.py``.

* The slot walk (``csrc/row_agg.cu`` ``row_slot_kernel``) in its four
  forms on the operands the wrappers build, at the wrapper's layout
  (``tiled_spmm.slot_layout``): every column owned by one lane of one
  chunk, each column's sum taken over the row's entries in slot order,
  the stored row read (or, for dfe, written) at the entry's slot, w read
  at the entry's slot and the column's head; K10 v1's numerator and dx
  with dfe, K11 v1's node sums by dst and by src, K10 v2's slot-feature
  reduce; f32 and bf16 stored tensors; at (4, 32), (1, 41), (8, 8) and
  (3, 5): bit for bit against the plain version on a dyadic grid, at rtol
  1e-4 / atol 1e-3 on normal inputs; dfe 0 at every padded slot (its
  zeros written by the pass over the slots alone).
* K10's edge ds on the dot-product walk by dst (``row_sddmm_kernel``,
  lane by lane through ``sddmm_render``, each launch of the wrapper's
  plan) and its finishing pass (``ds_finish_kernel``): mode 1 and 2, the
  edge dot ef[slot] . Zp[dst, h] and d(ef) in the pass, a head at a time;
  mode 3 and 4, the stored f32 or bf16 row added to x[src] in the walk;
  bit for bit on a grid, at rtol on normal inputs, a row wider than one
  launch holds, d(ef) 0 at every padded slot.
* The layouts and unrolls in Python are the sources', the bucket walks
  and their launch helpers are gone from ``dgl_tpu_torch/csrc/`` and
  ``ops/``, the wrappers take their plain versions on CPU tensors, the
  EdgeGAT forwards lay p out slot-major once, and the probe's edit and
  ``perf_ds_fold``'s moved edit apply.
"""
import re
import types
import unittest.mock as mock

import numpy as np
import pytest
import torch

import dgl_tpu_torch.ops.kernels.gat_fused as tgf
import dgl_tpu_torch.ops.kernels.tiled_spmm as tts
from dgl_tpu_torch.tools import perf_ds_fold as tdf
from dgl_tpu_torch.tools import perf_slot_walks as tsl
from sddmm_render import _launch_rendered

CSRC = tts.build.CSRC_DIR
RTOL, ATOL = 1e-4, 1e-3
F32 = np.float32
SHAPES = [(4, 32), (1, 41), (8, 8), (3, 5)]
DTYPES = [torch.float32, torch.bfloat16]
DEF_VECS = 8                             # csrc/row_agg.cu kDefVecs


def _fma(a, b, c):
    """fmaf on f32 arrays: the exact product plus c, rounded once."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(F32)


@pytest.fixture(scope="module")
def tiled():
    """A multigraph of 600 nodes and 3,000 edges on tiles of 256 and
    buckets of 128 slots (padded ones among them): dst 5 a hub of 150
    in-edges, src 9 one of 150 out-edges, dst rows 512-599 and src rows
    256-300 with none."""
    rng = np.random.default_rng(41)
    n, e = 600, 3000
    row = rng.integers(0, n, e)
    row[(row >= 256) & (row <= 300)] = 1
    col = rng.integers(0, 512, e)
    col[:150], row[150:300] = 5, 9
    row[300:400], col[300:400] = row[400:500], col[400:500]   # multi-edges
    tf = tts.build_tiled_format(row, col, n, n, 256, 128,
                                device="cpu").with_src_first()
    assert (tf.valid == 0).any()
    return tf


def _view(tf, side):
    v = tf.row_view(side)
    ptr, slot, nbr = (t.numpy().astype(np.int64)
                      for t in (v.ptr, v.slot, v.nbr))
    return ptr, slot, nbr


def _grid(rng, shape, step, top, low=None):
    lo = -top if low is None else low
    return (rng.integers(round(lo / step), round(top / step) + 1, shape)
            * step).astype(F32)


# -- the slot walk ---------------------------------------------------------

MODES = {"fe": tts.SLOT_FE, "dx_dfe": tts.SLOT_DX_DFE,
         "vec_dst": tts.SLOT_VEC_DST, "vec_src": tts.SLOT_VEC_SRC,
         "feat": tts.SLOT_FEAT}


def _render_slot(tf, mode, t, f, w=None, node=None, head_cols=None):
    """``row_slot_kernel`` on the wrapper's operands: (out (rows, f) f32,
    the stored tensor after the walk and the zero pass, (slots, t_cols) in
    its dtype).  The layout's lanes and chunks own every column once; each
    column's sum runs over the row's entries in slot order."""
    slots = tf.num_buckets * tf.cap
    t2 = t.reshape(slots, -1)
    t_cols = t2.shape[1]
    head_cols = f if head_cols is None else head_cols
    vec, cpl, lpr, n_chunks = tts.slot_layout(
        f, (head_cols, t_cols), t2, *(() if node is None else (node,)))
    owned = np.zeros(f, np.int64)
    for chunk in range(n_chunks):
        for li in range(lpr):
            for q in range(cpl):
                cv = (chunk * cpl + q) * lpr + li
                if cv < f // vec:
                    owned[cv * vec:(cv + 1) * vec] += 1
    assert (owned == 1).all(), "every column owned by one lane once"
    ptr, slot, nbr = _view(tf, tts.SLOT_SIDES[mode])
    rows = len(ptr) - 1
    deg = ptr[1:] - ptr[:-1]
    cols = np.arange(f)
    heads_of, tcol = cols // head_cols, cols % t_cols
    tv = t2.float().numpy()
    stored = np.full((slots, t_cols), np.nan, F32)
    wn = None if w is None else w.float().numpy()
    nd = None if node is None else node.float().numpy().reshape(-1, f)
    acc = np.zeros((rows, f), F32)
    for k in range(int(deg.max(initial=0))):
        r = np.nonzero(deg > k)[0]
        ent = ptr[r] + k
        s, n = slot[ent], nbr[ent]
        b, c = s // tf.cap, s % tf.cap
        wv = (None if wn is None else
              wn[b[:, None], heads_of[None, :], c[:, None]])
        if mode == tts.SLOT_FE:
            val = (nd[n] + tv[s]).astype(F32)
            acc[r] = _fma(wv, val, acc[r])
        elif mode == tts.SLOT_FEAT:
            acc[r] = _fma(wv, tv[s][:, tcol], acc[r])
        elif mode in (tts.SLOT_VEC_DST, tts.SLOT_VEC_SRC):
            acc[r] = (acc[r] + tv[s]).astype(F32)
        else:
            prod = (wv * nd[n]).astype(F32)
            acc[r] = (acc[r] + prod).astype(F32)
            stored[s] = prod
    if mode == tts.SLOT_DX_DFE:     # the pass over the padded slots alone
        stored[tf.valid.reshape(-1).numpy() == 0] = 0
        assert not np.isnan(stored).any(), "every slot of dfe written"
        out_t = torch.from_numpy(stored).to(t.dtype)
    else:
        out_t = t2
    return acc, out_t.reshape(t.shape)


def _slot_inputs(tf, heads, dim, dtype, grid, seed, fe=16):
    """x and zn (nodes, H, D), the stored (B, C, H D) slot tensor in
    ``dtype``, p (B, H, C) slot-major, ef (B, C, Fe): on the grid x, zn,
    the stored tensor and ef multiples of 1/16 in [-1, 1] (exact in bf16),
    p of 1/16 in [0, 4], so every product and sum is exact in f32; else
    normal values (the stored ones rounded to ``dtype``)."""
    rng = np.random.default_rng(seed)
    b, cap, n = tf.num_buckets, tf.cap, tf.num_src
    valid = tf.valid.numpy().reshape(b, cap)
    if grid:
        x, zn = (_grid(rng, (n, heads, dim), 1 / 16, 1) for _ in range(2))
        st = _grid(rng, (b, cap, heads * dim), 1 / 16, 1)
        p = _grid(rng, (b, heads, cap), 1 / 16, 4, low=0)
        ef = _grid(rng, (b, cap, fe), 1 / 16, 1)
    else:
        x, zn = (rng.normal(size=(n, heads, dim)).astype(F32)
                 for _ in range(2))
        st = rng.normal(size=(b, cap, heads * dim)).astype(F32)
        p = np.abs(rng.normal(size=(b, heads, cap))).astype(F32)
        ef = rng.normal(size=(b, cap, fe)).astype(F32)
    st *= valid[..., None]
    ef *= valid[..., None]
    p *= valid[:, None, :]
    pt = torch.from_numpy(p)
    return (torch.from_numpy(x), torch.from_numpy(zn),
            torch.from_numpy(st).to(dtype), tgf._slot_major(pt),
            torch.from_numpy(ef))


def _slot_case(tf, name, heads, dim, dtype, grid, seed):
    """(rendered outputs, plain outputs) of one wrapper."""
    x, zn, st, p, ef = _slot_inputs(tf, heads, dim, dtype, grid, seed)
    f = heads * dim
    if name == "fe":
        got, _ = _render_slot(tf, tts.SLOT_FE, st, f, w=p,
                              node=x.reshape(-1, f), head_cols=dim)
        return [got], [tgf.fe_aggregate_plain(tf, x, st, p).numpy()
                       .reshape(-1, f)]
    if name == "dx_dfe":
        dfe = torch.empty(st.shape, dtype=dtype)
        got, dfe = _render_slot(tf, tts.SLOT_DX_DFE, dfe, f, w=p,
                                node=zn.reshape(-1, f), head_cols=dim)
        dx, want_dfe = tgf.dx_dfe_plain(tf, zn, p, dtype)
        return ([got, dfe.float().numpy()],
                [dx.numpy().reshape(-1, f), want_dfe.float().numpy()])
    if name in ("vec_dst", "vec_src"):
        side = name[4:]
        got, _ = _render_slot(tf, MODES[name], st, f)
        return [got], [tgf.slot_vec_reduce_plain(tf, st, side).numpy()]
    fe = ef.shape[2]
    got, _ = _render_slot(tf, tts.SLOT_FEAT, ef, heads * fe, w=p,
                          head_cols=fe)
    return [got], [tgf.slot_feat_reduce_plain(tf, p, ef).numpy()
                   .reshape(-1, heads * fe)]


SLOT_CASES = [(n, d) for n in ("fe", "dx_dfe", "vec_dst", "vec_src")
              for d in DTYPES] + [("feat", torch.float32)]


@pytest.mark.parametrize("heads,dim", SHAPES)
@pytest.mark.parametrize("name,dtype", SLOT_CASES)
def test_slot_walk_rendering_exact_on_a_grid(tiled, name, dtype, heads,
                                             dim):
    got, want = _slot_case(tiled, name, heads, dim, dtype, True,
                           heads * 100 + dim)
    for a, b in zip(got, want):
        assert np.abs(b).max() > 0
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("name,dtype", SLOT_CASES)
def test_slot_walk_rendering_matches_plain(tiled, name, dtype):
    """Normal inputs at (4, 32): f32 sums in another order."""
    got, want = _slot_case(tiled, name, 4, 32, dtype, False, 7)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dfe_is_zero_at_padded_slots(tiled, dtype):
    """dfe's padded rows come from the pass over the slots alone: 0 there,
    where the walk lists no entry; the rows with no entry of dx are 0."""
    _, zn, st, p, _ = _slot_inputs(tiled, 4, 8, dtype, True, 3)
    dx, dfe = _render_slot(tiled, tts.SLOT_DX_DFE,
                           torch.empty(st.shape, dtype=dtype), 32, w=p,
                           node=zn.reshape(-1, 32), head_cols=8)
    pad = tiled.valid.reshape(tiled.num_buckets, tiled.cap) == 0
    assert pad.any() and (dfe[pad] == 0).all()
    assert (dx[256:301] == 0).all()


# -- K10's edge ds on the dot-product walk ---------------------------------

def _render_edge_ds(tf, x3, zn, rp, g, ef_slot=None, zp=None, p=None, m=None,
                    fe_s=None):
    """The edge ds as the walk and its finishing pass compute it: (ds (B,
    H, C), d_ef (B, C, Fe) or None) f32.  Each entry's gathered row is x's
    padded vectors (plus the stored row at its slot, K10 v1), the row's
    own zn's; each launch of the plan is rendered lane by lane
    (``sddmm_render``), then, per slot, the parts are added in order, K10
    v2's edge dot ef[s] . Zp[dst, h] (its 16-byte vectors in order, an fma
    a float) added, rp subtracted and g applied, and d(ef) summed a head
    at a time."""
    heads, fh = x3.shape[1:]
    hp = -(-fh // 4) * 4
    hx = hp // 4
    v = tf.row_view("dst")
    ptr, slot, nbr = _view(tf, "dst")
    e = len(slot)
    rows = np.repeat(np.arange(len(ptr) - 1), ptr[1:] - ptr[:-1])
    x = tts._vec4_rows(x3, hp).numpy()[nbr]                  # (E, H, hp)
    z = tts._vec4_rows(zn, hp).numpy()
    if fe_s is not None:
        st = fe_s.float().numpy().reshape(-1, heads, fh)[slot]
        x[..., :fh] = (x[..., :fh] + st).astype(F32)
    x = x.reshape(e, heads, hx, 4)
    z = z.reshape(-1, heads, hx, 4)
    plan, parts = tts._sddmm_plan(heads, hx)
    sm = np.zeros((parts, e, heads), F32)
    entries = types.SimpleNamespace(ptr=v.ptr, nbr=torch.arange(e))
    for h0, nh, v0, nv, part in plan:
        xl = np.ascontiguousarray(x[:, h0:h0 + nh, v0:v0 + nv]).reshape(
            e, nh * nv, 4)
        zl = np.ascontiguousarray(z[:, h0:h0 + nh, v0:v0 + nv]).reshape(
            -1, nh * nv, 4)
        for ent, h, val in _launch_rendered(entries, xl, zl, nh, nv, rows):
            sm[part, ent, h0 + h] = val
    tot = sm[0]
    for j in range(1, parts):
        tot = (tot + sm[j]).astype(F32)
    b, c = slot // tf.cap, slot % tf.cap
    dst = rows
    if ef_slot is not None:
        ef, efq = tts.edge_rows(ef_slot)
        efv = ef.numpy()[slot]                                 # (E, 4 efq)
        zq = tts._vec4_rows(zp, 4 * efq).numpy()[dst]      # (E, H, 4 efq)
        dot = np.zeros((e, heads), F32)
        for k in range(4 * efq):
            dot = _fma(efv[:, k, None], zq[..., k], dot)
        tot = (tot + dot).astype(F32)
    ds = np.zeros((tf.num_buckets, heads, tf.cap), F32)
    dsv = ((tot - rp.numpy()[dst]).astype(F32)
           * g.numpy()[b, :, c]).astype(F32)
    ds[b, :, c] = dsv
    if p is None:
        return ds, None
    fe = ef_slot.shape[2]
    pv = p.float().numpy()[b, :, c]
    zpv, mv = zp.numpy()[dst], m.numpy()
    acc = np.zeros((e, fe), F32)
    for h in range(heads):
        acc = _fma(pv[:, h, None], zpv[:, h, :], acc)
        acc = _fma(dsv[:, h, None], mv[None, :, h], acc)
    d_ef = np.zeros((tf.num_buckets, tf.cap, fe), F32)
    d_ef[b, c] = acc
    return ds, d_ef


def _ds_inputs(tf, heads, fh, fe, grid, seed, dtype=torch.float32):
    """x, zn (nodes, H, Fh), rp (nodes, H), g (B, H, C), ef_slot (B, C,
    Fe), zp (nodes, H, Fe), p (B, H, C), m (Fe, H) and the stored fe_s (B,
    C, H Fh) in ``dtype``.  On the grid x, zn, zp, ef and fe_s are
    multiples of 1/16 in [-1, 1], rp, g, p and m of 1/16 in [-1, 1] ([0,
    4] for p): every dot, ds and d(ef) is exact in f32."""
    rng = np.random.default_rng(seed)
    b, cap, n = tf.num_buckets, tf.cap, tf.num_src
    valid = tf.valid.numpy().reshape(b, cap)

    def q(shape, top=1, low=None):
        if grid:
            return _grid(rng, shape, 1 / 16, top, low)
        return rng.normal(size=shape).astype(F32)

    x, zn, zp = q((n, heads, fh)), q((n, heads, fh)), q((n, heads, fe))
    rp, m = q((n, heads)), q((fe, heads))
    g = q((b, heads, cap)) * valid[:, None, :]
    p = np.abs(q((b, heads, cap), 4, 0)) * valid[:, None, :]
    ef = q((b, cap, fe)) * valid[..., None]
    st = q((b, cap, heads * fh)) * valid[..., None]
    return [torch.from_numpy(a.astype(F32)) for a in (
        x, zn, rp, g, ef, zp, p, m)] + [torch.from_numpy(
            st.astype(F32)).to(dtype)]


DS_CASES = [(mode, heads, fh, fe) for heads, fh in SHAPES
            for mode, fe in ((1, 16), (2, 16), (2, 5), (3, 0), (4, 0))]


def _ds_case(tf, mode, heads, fh, fe, grid, seed):
    dtype = torch.bfloat16 if mode == 4 else torch.float32
    x, zn, rp, g, ef, zp, p, m, st = _ds_inputs(tf, heads, fh, max(fe, 1),
                                                grid, seed, dtype)
    if mode >= 3:
        got = _render_edge_ds(tf, x, zn, rp, g, fe_s=st)[0]
        return [got], [tgf.fe_ds_plain(tf, x, st, zn, rp, g).numpy()]
    extra = (p, m) if mode == 2 else ()
    got = _render_edge_ds(tf, x, zn, rp, g, ef, zp, *extra)
    want = tgf.edgegat_ds_plain(tf, x, zn, rp, g, ef, zp, *extra)
    return ([a for a in got if a is not None],
            [a.numpy() for a in want if a is not None])


@pytest.mark.parametrize("mode,heads,fh,fe", DS_CASES)
def test_edge_ds_rendering_exact_on_a_grid(tiled, mode, heads, fh, fe):
    got, want = _ds_case(tiled, mode, heads, fh, fe, True,
                         mode * 1000 + heads * 10 + fh)
    for a, b in zip(got, want):
        assert np.abs(b).max() > 0
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_edge_ds_rendering_matches_plain(tiled, mode):
    """Normal inputs at (4, 32) with 16 features (the stored rows rounded
    to bf16 in mode 4)."""
    got, want = _ds_case(tiled, mode, 4, 32, 16 if mode < 3 else 0, False,
                         mode)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", [2, 3])
def test_edge_ds_rendering_wider_than_a_launch(tiled, mode):
    """A head of 1,030 columns: the walk's plan takes two parts, added in
    order by the pass before the edge term (K10 v2) or with the stored
    row split between the parts' launches (K10 v1)."""
    heads, fh, fe = 2, 1030, 5
    plan, parts = tts._sddmm_plan(heads, 258)
    assert parts == 2
    got, want = _ds_case(tiled, mode, heads, fh, fe if mode == 2 else 0,
                         True, 11)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_d_ef_is_zero_at_padded_slots(tiled):
    x, zn, rp, g, ef, zp, p, m, _ = _ds_inputs(tiled, 4, 8, 5, True, 5)
    ds, d_ef = _render_edge_ds(tiled, x, zn, rp, g, ef, zp, p, m)
    pad = tiled.valid.reshape(tiled.num_buckets, tiled.cap).numpy() == 0
    assert pad.any() and (d_ef[pad] == 0).all()
    assert (ds.transpose(0, 2, 1)[pad] == 0).all()


# -- layouts, wrappers, the retired kernels and the probe -----------------

def test_layouts_and_unrolls_match_the_sources():
    """The slot walk's entries in flight, layout and the ds pass's d(ef)
    vectors are the sources'; the layout keeps at most 8 columns a lane."""
    with open(f"{CSRC}/row_agg.cu") as f:
        src = f.read()
    assert "static constexpr int value = VEC * CPL <= 4 ? 8 : 4;" in src
    assert f"constexpr int kDefVecs = {DEF_VECS};" in src
    a16 = torch.zeros(64)
    assert tts.slot_layout(128, (32, 128), a16) == (4, 1, 32, 1)
    assert tts.slot_layout(64, (16, 16), a16) == (4, 1, 16, 1)
    assert tts.slot_layout(41, (41, 41), a16) == (1, 2, 32, 1)
    assert tts.slot_layout(15, (5, 15), a16) == (1, 1, 16, 1)
    assert tts.slot_layout(256, (64, 256), a16) == (4, 2, 32, 1)
    assert tts.slot_layout(512, (128, 512), a16) == (4, 2, 32, 2)
    assert tts.slot_layout(128, (32, 128), a16[1:]) == (1, 4, 32, 1)
    # bf16 rows: 8-byte loads of 4 elements
    assert tts.slot_layout(128, (32, 128), a16.bfloat16()) == (4, 1, 32, 1)
    for f, cols in ((128, (32, 128)), (41, (41, 41)), (512, (128, 512))):
        vec, cpl, _, _ = tts.slot_layout(f, cols, a16)
        assert vec * cpl <= 8


def test_wrappers_on_cpu_take_the_plain_versions(tiled):
    """On CPU tensors each of the six wrappers returns its plain
    version's result and counts no launch."""
    x, zn, st, p, ef = _slot_inputs(tiled, 4, 8, torch.float32, True, 9)
    x2, zn2, rp, g, ef2, zp, p2, m, _ = _ds_inputs(tiled, 4, 8, 5, True, 9)
    wrappers = [tgf.fe_aggregate, tgf.dx_dfe, tgf.slot_vec_reduce,
                tgf.slot_feat_reduce, tgf.edgegat_ds, tgf.fe_ds]
    before = [w.launches for w in wrappers]
    pairs = [
        (tgf.fe_aggregate(tiled, x, st, p),
         tgf.fe_aggregate_plain(tiled, x, st, p)),
        (tgf.dx_dfe(tiled, zn, p)[1], tgf.dx_dfe_plain(tiled, zn, p)[1]),
        (tgf.slot_vec_reduce(tiled, st, "src"),
         tgf.slot_vec_reduce_plain(tiled, st, "src")),
        (tgf.slot_feat_reduce(tiled, p, ef),
         tgf.slot_feat_reduce_plain(tiled, p, ef)),
        (tgf.edgegat_ds(tiled, x2, zn2, rp, g, ef2, zp, p2, m)[1],
         tgf.edgegat_ds_plain(tiled, x2, zn2, rp, g, ef2, zp, p2, m)[1]),
        (tgf.fe_ds(tiled, x, st, zn, rp, g),
         tgf.fe_ds_plain(tiled, x, st, zn, rp, g))]
    for a, b in pairs:
        assert torch.equal(a, b)
    assert [w.launches for w in wrappers] == before


def test_edgegat_forwards_lay_p_out_once(tiled):
    """The EdgeGAT forwards take p's slot-major copy once: den, the
    numerator (K10 v1) or S (K10 v2) read it, and it is the p they
    return for the backward's dx."""
    heads, fh, fe = 4, 8, 5
    x, zn, st, _, ef = _slot_inputs(tiled, heads, fh, torch.float32, True,
                                    4, fe=fe)
    rng = np.random.default_rng(4)
    el, er = (torch.from_numpy(rng.normal(size=(600, heads)).astype(F32))
              for _ in range(2))
    ee = torch.zeros(tiled.num_buckets, heads, tiled.cap)
    slot_major = (tiled.cap * heads, 1, heads)
    with mock.patch.object(tgf, "fe_aggregate",
                           wraps=tgf.fe_aggregate) as num:
        p = tgf.edgegat_forward(tiled, el, er, ee, st, x, heads, fh, 0.2)[1]
    assert p.stride() == slot_major
    assert num.call_args.args[3].stride() == slot_major
    We = torch.from_numpy(rng.normal(size=(fe, heads * fh)).astype(F32))
    attn = torch.from_numpy(rng.normal(size=(heads, fh)).astype(F32))
    with mock.patch.object(tgf, "slot_feat_reduce",
                           wraps=tgf.slot_feat_reduce) as feat:
        p = tgf.edgegat_v2_forward(tiled, el, er, ef, We, attn, x, heads, fh,
                                   0.2)[1]
    assert p.stride() == slot_major
    assert feat.call_args.args[1].stride() == slot_major


def test_retired_kernels_left_the_package():
    """``src_agg_kernel`` and ``gat_ds_kernel`` are in the probe alone
    (``gat_fused.cu`` keeps the scores); no wrapper names their C
    functions, and the tiled walks' launch helpers left ``ops/``."""
    for path in tts.build.sources().values():
        with open(path) as f:
            src = f.read()
        for name in ("src_agg_kernel", "gat_ds_kernel"):
            assert not re.search(rf"\b{name}(<[^>]*>)?\s*(\(|<<<)", src), \
                (name, path)
        for fn in ("dgl_gat_ds(", "dgl_slot_agg(", "dgl_slot_feat_reduce("):
            assert fn not in src, (fn, path)
    with open(f"{CSRC}/gat_fused.cu") as f:
        assert re.search(r"\bgat_scores_kernel\(", f.read())
    for fn in ("dgl_gat_ds", "dgl_slot_agg", "dgl_slot_feat_reduce"):
        assert fn not in tgf._SIGNATURES
    ops = tts.__file__.rsplit("/", 2)[0]
    import glob
    for path in glob.glob(f"{ops}/**/*.py", recursive=True):
        with open(path) as f:
            src = f.read()
        for helper in ("_group", "_group_per_sm", "_splits"):
            assert not re.search(rf"\bdef {helper}\(", src), (helper, path)
    for helper in ("_group", "_group_per_sm", "_splits", "_DS_WARPS"):
        assert not hasattr(tgf, helper)
    with open(tsl.PROBE_SOURCE) as f:
        probe = f.read()
    assert re.search(r"\bsrc_agg_kernel\(", probe)
    assert re.search(r"\bgat_ds_kernel\(", probe)
    for fn in ("int dgl_gat_ds(", "int dgl_slot_agg(",
               "int dgl_slot_feat_reduce("):
        assert fn in probe


def test_probe_edits_apply():
    """``tools/perf_slot_walks.py``'s edit halves the slot walk's entries in
    flight, applied once; ``tools/perf_ds_fold.py``'s edit restoring
    ``gat_ds_kernel``'s mode 0 applies to the probe source, where the
    kernel now lives."""
    assert tsl.tiny_check() == ["retired", "half"]
    assert "VEC * CPL <= 4 ? 4 : 2;" in tsl.edited_sources()["half"]
    bucket, _ = tdf.edited_sources()
    with open(tsl.PROBE_SOURCE) as f:
        probe = f.read()
    assert bucket != probe and "case 0:" in bucket
    assert "return launch_ds<L, false, false, float, false>(DGL_DS_ARGS);" \
        in bucket
    assert tdf.tiny_check() == ["bucket_ds", "tiled_da"]
