"""Slot-space GAT and DotGat attention over the tiled format (K6, K8).

Counterpart of ``dgl_tpu/ops/pallas/gat_fused.py:1-659``.  Attention never
exists in canonical edge order: scores, weights and gradients live in the
tiled format's (B, H, C) slot space, and the softmax folds into a divide
per dst node.  For every slot of an edge src -> dst and head h:

    raw = el[src, h] + er[dst, h] (+ ee_slot[b, h, c])
    p   = exp(clip(lrelu(raw), +-40)),   g = p * (raw >= 0 ? 1 : slope)
    den[dst, h] = max(sum p, 1e-20),     out[dst] = sum p x[src] / den

Numerics contract of the JAX package (``gat_fused.py:19-21``,
``dgl_tpu/nn/conv/gatconv.py:23-35``): the logits are clipped to +-40
instead of subtracting each dst's max, so the result equals the softmax
while they stay inside +-40; a dst with no in-edge gets 0.  The gradient
is the JAX kernels' (``gat_backward``): g, and p for DotGat, ignore the
clip.  The backward, with zn = dZ / den and rp = <out, dZ> / den:

    ds = (<x[src, h], zn[dst, h]> - rp[dst, h]) * g
    der = sum_dst ds,  del = sum_src ds,  dx[src] = sum p zn[dst]

DotGat (K8, ``dot_gat_forward`` :515) takes p = exp(clip(<k[src],
q[dst]> / sqrt(D), +-40)) from K4's SDDMM and g = p; dq and dk are the
dst- and src-side aggregations of ds / sqrt(D).

Four kernels (``csrc/gat_fused.cu``), each with a plain PyTorch version
beside it that computes the same function, slot chunk by slot chunk:

* :func:`gat_scores` (``_scores_kernel``, ``_scores_bias_kernel``): p, g;
* :func:`slot_reduce` (``_den_kernel``, ``_der_kernel``, ``_del_kernel``):
  the sum of a (B, H, C) slot tensor per dst node or per src node;
* :func:`gat_ds` (``_ds_kernel``): ds;
* :func:`src_aggregate` (``_dx_kernel``): out[src, h] = sum w[b, h, c]
  z[dst, h] with (B, H, C) weights, for dx and K8's dk.

The dst-side weighted aggregation ``_agg_kernel`` computes exactly
``tiled_spmm_multihead``'s function, so the forward's numerator and K8's
dq go through K4's SpMM, and K8's scores through K4's SDDMM.  ``zn``,
``rp`` and the clamp of ``den`` stay plain PyTorch, as the JAX package
computes them outside its kernels.  The kernels take f32 and sum in f32,
where the TPU kernels cast their operands to bf16.

The public functions keep the JAX layouts (el/er (N, H), x (N, H, Fh),
slot tensors (B, H, C)) without the TPU's lane padding; ``den`` is
(num_dst, H), not the TPU's head-major (H, N) node blocks.  Unlike the JAX
forward, whose outputs on a dst tile with no bucket are never written, the
port writes 0 on such rows, and on src tiles with no bucket in the
backward.  A wrapper launches its kernel on CUDA tensors and raises if the
build or the launch fails; it takes the plain version only for CPU
tensors.  Each wrapper counts its launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build
from . import tiled_spmm as ts
from .dispatch import on_cuda

CLIP = 40.0          # logit clip before exp (gat_fused.py CLIP)
DEN_EPS = 1e-20      # denominator clamp

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    "dgl_gat_scores": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I,
                       ctypes.c_double, _P, _P, _I, _I, _P],
    "dgl_slot_reduce": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I,
                        _I, _P],
    "dgl_gat_ds": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I,
                   _P, _I, _I, _I, _P],
    "dgl_src_agg": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _I,
                    _P, _I, _I, _I, _I, _P],
}
_SCORES_THREADS = 256       # csrc/gat_fused.cu kScoresThreads
_DS_WARPS = 8               # csrc/gat_fused.cu kDsWarps


def _launch(fn: str, *args):
    lib = build.load("gat_fused", _SIGNATURES)
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {err}")


def _slot_shape(tf: ts.TiledFormat, heads: int):
    return (tf.num_buckets, heads, tf.cap)


def _check_slots(tf: ts.TiledFormat, t: torch.Tensor, heads: int, what: str):
    if tuple(t.shape) != _slot_shape(tf, heads):
        raise ValueError(f"{what} has shape {tuple(t.shape)}; the format "
                         f"needs {_slot_shape(tf, heads)}")


def _check_nodes(t: torch.Tensor, rows: int, heads: int, what: str):
    if t.ndim < 2 or t.shape[0] != rows or t.shape[1] != heads:
        raise ValueError(f"{what} has shape {tuple(t.shape)}; the format "
                         f"needs {rows} rows of {heads} heads")


def _require_src_first(tf: ts.TiledFormat):
    if tf.src_order is None or tf.src_ptr is None:
        raise ValueError("the format has no src_order / src_ptr: build it "
                         "with tf.with_src_first() (UnitGraph.tiled_format "
                         "does) before the src-side passes")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


# -- the plain PyTorch versions ---------------------------------------------

def gat_scores_plain(tf: ts.TiledFormat, el, er, slope: float,
                     ee_slot=None):
    """The scores' function: (p, g), each (B, H, C) f32, 0 at padded
    slots."""
    heads = el.shape[1]
    p = torch.zeros(_slot_shape(tf, heads), dtype=torch.float32,
                    device=el.device)
    g = torch.zeros_like(p)
    for b, c, src, dst in ts._slot_chunks(tf):
        raw = el[src].float() + er[dst].float()
        if ee_slot is not None:
            raw = raw + ee_slot[b, :, c].float()
        pos = raw >= 0
        pv = torch.exp(torch.clamp(torch.where(pos, raw, slope * raw),
                                   -CLIP, CLIP))
        p[b, :, c] = pv
        g[b, :, c] = pv * torch.where(pos, 1.0, slope)
    return p, g


def slot_reduce_plain(tf: ts.TiledFormat, vals, side: str = "dst"):
    """The slot reduce's function: (num_rows, H) f32, the sum of ``vals``
    (B, H, C) over the valid slots of each dst (or src) node."""
    rows = tf.num_dst if side == "dst" else tf.num_src
    out = torch.zeros(rows, vals.shape[1], dtype=torch.float32,
                      device=vals.device)
    for b, c, src, dst in ts._slot_chunks(tf):
        out.index_add_(0, dst if side == "dst" else src, vals[b, :, c].float())
    return out


def gat_ds_plain(tf: ts.TiledFormat, x3, zn, rp, g):
    """ds's function: (B, H, C) f32, (<x3[src, h], zn[dst, h]> -
    rp[dst, h]) * g at valid slots and 0 at padded ones."""
    ds = torch.zeros(_slot_shape(tf, x3.shape[1]), dtype=torch.float32,
                     device=x3.device)
    for b, c, src, dst in ts._slot_chunks(tf):
        dot = (x3[src].float() * zn[dst].float()).sum(-1)
        ds[b, :, c] = (dot - rp[dst].float()) * g[b, :, c].float()
    return ds


def src_aggregate_plain(tf: ts.TiledFormat, z3, w_slot):
    """The src-side aggregation's function: (num_src, H, F) f32,
    out[s, h] = sum over the valid slots with src s of w_slot[b, h, c] *
    z3[dst, h]."""
    out = torch.zeros((tf.num_src,) + tuple(z3.shape[1:]),
                      dtype=torch.float32, device=z3.device)
    for b, c, src, dst in ts._slot_chunks(tf):
        out.index_add_(0, src, z3[dst].float()
                       * w_slot[b, :, c].float().unsqueeze(-1))
    return out


# -- the kernel wrappers ------------------------------------------------------

def gat_scores(tf: ts.TiledFormat, el, er, slope: float, ee_slot=None):
    """K6 scores: (p, g), each (B, H, C) f32, from el (num_src, H), er
    (num_dst, H) and the optional per-slot bias ``ee_slot`` (B, H, C)."""
    heads = el.shape[1]
    _check_nodes(el, tf.num_src, heads, "el")
    _check_nodes(er, tf.num_dst, heads, "er")
    extra = ()
    if ee_slot is not None:
        _check_slots(tf, ee_slot, heads, "ee_slot")
        extra = (ee_slot,)
    if not on_cuda(el, er, tf.valid, *extra):
        return gat_scores_plain(tf, el, er, slope, ee_slot)
    b, cap = tf.num_buckets, tf.cap
    ts._check_int32(b * heads * cap, tf.num_src_tiles * tf.tile * heads,
                    tf.num_dst_tiles * tf.tile * heads)
    p = torch.empty(_slot_shape(tf, heads), dtype=torch.float32,
                    device=el.device)
    g = torch.empty_like(p)
    if heads == 0:
        return p, g
    el, er = _f32(el), _f32(er)
    ee = None if ee_slot is None else _f32(ee_slot)
    slots = b * cap
    blocks = max(1, min(-(-slots // _SCORES_THREADS),
                        32 * ts._sms(el.device)))
    _launch("dgl_gat_scores", tf.src_local.data_ptr(),
            tf.dst_local.data_ptr(), tf.valid.data_ptr(),
            tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(), slots, tf.tile,
            cap, el.data_ptr(), er.data_ptr(),
            0 if ee is None else ee.data_ptr(), heads, float(slope),
            p.data_ptr(), g.data_ptr(), blocks, el.device.index,
            ts._stream(el.device))
    gat_scores.launches += 1
    return p, g


gat_scores.launches = 0


def slot_reduce(tf: ts.TiledFormat, vals, side: str = "dst"):
    """K6 slot reduce: (num_rows, H) f32, the sum of ``vals`` (B, H, C)
    over the valid slots of each dst node (``side="dst"``: den, der) or
    src node (``side="src"``: del, walking ``src_order``)."""
    if side not in ("dst", "src"):
        raise ValueError(f"side must be 'dst' or 'src', got {side!r}")
    heads = vals.shape[1] if vals.ndim == 3 else -1
    _check_slots(tf, vals, heads, "vals")
    if side == "src":
        _require_src_first(tf)
    if not on_cuda(vals, tf.valid):
        return slot_reduce_plain(tf, vals, side)
    src = side == "src"
    rows = tf.num_src if src else tf.num_dst
    n_t = tf.num_src_tiles if src else tf.num_dst_tiles
    ts._check_int32(tf.num_buckets * heads * tf.cap, n_t * tf.tile * heads)
    if tf.tile * heads * 4 > ts._SMEM_PER_BLOCK:
        raise ValueError(f"tile {tf.tile} x {heads} heads is too large for "
                         "the slot reduce's shared-memory accumulator")
    splits = ts._splits(tf, n_t, 1, 2, vals.device)
    alloc = torch.zeros if splits > 1 else torch.empty
    out = alloc(rows, heads, dtype=torch.float32, device=vals.device)
    if n_t == 0 or heads == 0:
        return out.zero_()
    vals = _f32(vals)
    _launch("dgl_slot_reduce",
            (tf.src_local if src else tf.dst_local).data_ptr(),
            tf.valid.data_ptr(), vals.data_ptr(),
            tf.src_order.data_ptr() if src else 0,
            (tf.src_ptr if src else tf.dst_ptr).data_ptr(), n_t, tf.tile,
            tf.cap, heads, out.data_ptr(), rows, splits, int(src),
            vals.device.index, ts._stream(vals.device))
    slot_reduce.launches += 1
    return out


slot_reduce.launches = 0


def gat_ds(tf: ts.TiledFormat, x3, zn, rp, g):
    """K6 ds: (B, H, C) f32, (<x3[src, h], zn[dst, h]> - rp[dst, h]) * g
    at valid slots and 0 at padded ones.  ``x3`` (num_src, H, Fh), ``zn``
    (num_dst, H, Fh), ``rp`` (num_dst, H), ``g`` (B, H, C)."""
    heads, fh = x3.shape[1], x3.shape[2]
    ts._check_operand(tf, x3, tf.num_src, 3, "x3")
    ts._check_operand(tf, zn, tf.num_dst, 3, "zn")
    if tuple(zn.shape[1:]) != (heads, fh):
        raise ValueError(f"zn {tuple(zn.shape)} does not match x3 "
                         f"{tuple(x3.shape)}")
    _check_nodes(rp, tf.num_dst, heads, "rp")
    _check_slots(tf, g, heads, "g")
    if not on_cuda(x3, zn, rp, g, tf.valid):
        return gat_ds_plain(tf, x3, zn, rp, g)
    b = tf.num_buckets
    hf = heads * fh
    ts._check_int32(b * heads * tf.cap, tf.num_src_tiles * tf.tile * hf,
                    tf.num_dst_tiles * tf.tile * hf)
    ds = torch.empty(_slot_shape(tf, heads), dtype=torch.float32,
                     device=x3.device)
    if heads * fh == 0:
        return ds.zero_()
    x, z, r, gg = _f32(x3), _f32(zn), _f32(rp), _f32(g)
    chunks = b * tf.cap // 32
    blocks = max(1, min(-(-chunks // _DS_WARPS), 16 * ts._sms(x.device)))
    _launch("dgl_gat_ds", tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
            tf.valid.data_ptr(), tf.src_tile.data_ptr(),
            tf.dst_tile.data_ptr(), b, tf.tile, tf.cap, x.data_ptr(),
            z.data_ptr(), r.data_ptr(), gg.data_ptr(), heads, fh,
            ds.data_ptr(), ts._lanes_per_head(heads), blocks, x.device.index,
            ts._stream(x.device))
    gat_ds.launches += 1
    return ds


gat_ds.launches = 0


def src_aggregate(tf: ts.TiledFormat, z3, w_slot):
    """K6 src-side aggregation: (num_src, H, F) f32, out[s, h, :] = sum
    over the valid slots with src s of w_slot[b, h, c] * z3[dst, h, :].
    ``z3`` (num_dst, H, F), ``w_slot`` (B, H, C)."""
    _require_src_first(tf)
    ts._check_operand(tf, z3, tf.num_dst, 3, "z3")
    heads, fh = z3.shape[1], z3.shape[2]
    _check_slots(tf, w_slot, heads, "w_slot")
    if not on_cuda(z3, w_slot, tf.valid):
        return src_aggregate_plain(tf, z3, w_slot)
    f = heads * fh
    b = tf.num_buckets
    ts._check_int32(b * heads * tf.cap, tf.num_src_tiles * tf.tile * f,
                    tf.num_dst_tiles * tf.tile * f)
    g = ts._group(f, tf.tile)
    n_st = tf.num_src_tiles
    n_chunks = -(-f // g)
    splits = ts._splits(tf, n_st, n_chunks, ts._group_per_sm(g, tf.tile),
                        z3.device)
    alloc = torch.zeros if splits > 1 else torch.empty
    out = alloc(tf.num_src, heads, fh, dtype=torch.float32, device=z3.device)
    if n_st == 0 or f == 0:
        return out.zero_()
    z, w = _f32(z3), _f32(w_slot)
    _launch("dgl_src_agg", tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
            tf.valid.data_ptr(), w.data_ptr(), heads, fh,
            tf.dst_tile.data_ptr(), tf.src_order.data_ptr(),
            tf.src_ptr.data_ptr(), n_st, tf.tile, tf.cap, z.data_ptr(), f,
            out.data_ptr(), tf.num_src, g, splits, z.device.index,
            ts._stream(z.device))
    src_aggregate.launches += 1
    return out


src_aggregate.launches = 0


# -- forward and backward -----------------------------------------------------

def gat_forward(tf: ts.TiledFormat, el2, er2, x3, H: int, Fh: int,
                slope: float, ee_slot=None):
    """Returns (out (num_dst, H, Fh), p_slot, g_slot, den (num_dst, H)),
    ``den`` clamped at 1e-20.  ``ee_slot`` (B, H, C), optional: a per-slot
    additive edge bias (EGAT), 0 at padded slots."""
    p, g = gat_scores(tf, el2, er2, slope, ee_slot)
    den = slot_reduce(tf, p, "dst").clamp_(min=DEN_EPS)
    num = ts.tiled_spmm_multihead(tf, x3, p, H, Fh)
    return num / den.unsqueeze(-1), p, g, den


def _scales(out, dZ, den):
    """zn = dZ / den and rp = <out, dZ> / den (gat_fused.py:353-355)."""
    dZ = dZ.float()
    return dZ / den.unsqueeze(-1), (out * dZ).sum(-1) / den


def gat_backward(tf: ts.TiledFormat, x3, p_slot, g_slot, den, out, dZ,
                 H: int, Fh: int):
    """Returns (del (num_src, H), der (num_dst, H), dx (num_src, H, Fh),
    ds_slot (B, H, C)).  ``tf`` needs ``src_order`` (``with_src_first``)."""
    zn, rp = _scales(out, dZ, den)
    ds = gat_ds(tf, x3, zn, rp, g_slot)
    der = slot_reduce(tf, ds, "dst")
    dl = slot_reduce(tf, ds, "src")
    dx = src_aggregate(tf, zn, p_slot)
    return dl, der, dx, ds


def dot_gat_forward(tf: ts.TiledFormat, q3, k3, x3, H: int, D: int,
                    Fh: int):
    """Returns (out (num_dst, H, Fh), p_slot, den (num_dst, H)), with
    p = exp(clip(<k3[src], q3[dst]> / sqrt(D), +-40)) at valid slots."""
    b, cap = tf.num_buckets, tf.cap
    p = ts.tiled_sddmm_dot_multihead(tf, k3, q3, H, D)
    # in place: at Reddit scale each (B, H, C) tensor is 3 GB at H = 4
    p.mul_(1.0 / math.sqrt(D)).clamp_(-CLIP, CLIP).exp_()
    p.mul_(tf.valid.view(b, 1, cap))
    den = slot_reduce(tf, p, "dst").clamp_(min=DEN_EPS)
    num = ts.tiled_spmm_multihead(tf, x3, p, H, Fh)
    return num / den.unsqueeze(-1), p, den


def dot_gat_backward(tf: ts.TiledFormat, q3, k3, x3, p_slot, den, out, dZ,
                     H: int, D: int, Fh: int):
    """Returns (dq (num_dst, H, D), dk (num_src, H, D), dx (num_src, H,
    Fh)): ds = (<x[src], zn[dst]> - rp[dst]) * p, then dq[dst] = sum ds k
    / sqrt(D), dk[src] = sum ds q / sqrt(D), dx[src] = sum p zn."""
    zn, rp = _scales(out, dZ, den)
    ds = gat_ds(tf, x3, zn, rp, p_slot).mul_(1.0 / math.sqrt(D))
    dq = ts.tiled_spmm_multihead(tf, k3, ds, H, D)
    dk = src_aggregate(tf, q3, ds)
    del ds
    dx = src_aggregate(tf, zn, p_slot)
    return dq, dk, dx


# -- the differentiable ops ---------------------------------------------------

class _GatAttention(torch.autograd.Function):
    """Forward by the scores, slot reduce and K4 SpMM; backward by ds, two
    slot reduces and the src-side aggregation.  p and g are saved (each
    (B, H, C))."""

    @staticmethod
    def forward(ctx, el2, er2, ee_slot, x3, tf, H, Fh, slope):
        out, p, g, den = gat_forward(tf, el2, er2, x3, H, Fh, slope,
                                     ee_slot)
        ctx.save_for_backward(x3, p, g, den, out)
        ctx.tf, ctx.H, ctx.Fh = tf, H, Fh
        ctx.dtypes = (el2.dtype, er2.dtype, x3.dtype)
        return out

    @staticmethod
    def backward(ctx, dz):
        x3, p, g, den, out = ctx.saved_tensors
        dl, dr, dx, ds = gat_backward(ctx.tf, x3, p, g, den, out, dz, ctx.H,
                                      ctx.Fh)
        el_t, er_t, x_t = ctx.dtypes
        return (dl.to(el_t), dr.to(er_t),
                ds if ctx.needs_input_grad[2] else None, dx.to(x_t), None,
                None, None, None)


class _DotGatAttention(torch.autograd.Function):
    """Forward by K4's SDDMM, the slot reduce and K4's SpMM; backward by
    ds (g = p), K4's SpMM for dq and the src-side aggregation for dk and
    dx.  p is saved."""

    @staticmethod
    def forward(ctx, q3, k3, x3, tf, H, D, Fh):
        out, p, den = dot_gat_forward(tf, q3, k3, x3, H, D, Fh)
        ctx.save_for_backward(q3, k3, x3, p, den, out)
        ctx.tf, ctx.H, ctx.D, ctx.Fh = tf, H, D, Fh
        return out

    @staticmethod
    def backward(ctx, dz):
        q3, k3, x3, p, den, out = ctx.saved_tensors
        dq, dk, dx = dot_gat_backward(ctx.tf, q3, k3, x3, p, den, out, dz,
                                      ctx.H, ctx.D, ctx.Fh)
        return (dq.to(q3.dtype), dk.to(k3.dtype), dx.to(x3.dtype), None,
                None, None, None)


def gat_attention_aggregate(tf: ts.TiledFormat, el2, er2, x3, H: int,
                            Fh: int, negative_slope: float):
    """Fused GAT attention + aggregation (``gat_fused.py:462``).

    ``tf``: the forward tiled format with ``src_order``
    (``with_src_first``); ``el2`` (N_src, H) src logits, ``er2`` (N_dst,
    H) dst logits, ``x3`` (N_src, H, Fh) values.  Returns (N_dst, H, Fh)
    f32, the attention-weighted neighbour sum, differentiable in el2, er2
    and x3."""
    _require_src_first(tf)
    return _GatAttention.apply(el2, er2, None, x3, tf, int(H), int(Fh),
                               float(negative_slope))


def egat_attention_aggregate(tf: ts.TiledFormat, el2, er2, ee_slot, x3,
                             H: int, Fh: int, negative_slope: float):
    """:func:`gat_attention_aggregate` plus ``ee_slot`` (B, H, C), a
    per-slot additive edge bias in slot order, 0 at padded slots
    (``gat_fused.py:491``); its gradient is ds."""
    _require_src_first(tf)
    return _GatAttention.apply(el2, er2, ee_slot, x3, tf, int(H), int(Fh),
                               float(negative_slope))


def dot_gat_attention_aggregate(tf: ts.TiledFormat, q3, k3, x3, H: int,
                                D: int, Fh: int):
    """Fused dot-product attention + aggregation (``gat_fused.py:657``):
    e = <k3[src], q3[dst]> / sqrt(D), softmax over each dst under the
    +-40 clip, out[dst] = sum a x3[src].  ``q3`` (N_dst, H, D), ``k3``
    (N_src, H, D), ``x3`` (N_src, H, Fh); differentiable in all three."""
    _require_src_first(tf)
    return _DotGatAttention.apply(q3, k3, x3, tf, int(H), int(D), int(Fh))
