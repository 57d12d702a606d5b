"""Slot-space GAT, DotGat, EdgeGAT, GATv2 and EGATConv attention over the
tiled format (K6, K8, K10 v1 and v2, K9, K11 v1 and v2).

Counterpart of ``dgl_tpu/ops/pallas/gat_fused.py`` (all of it).  Attention
never exists in canonical edge order: scores, weights and gradients live in
the tiled format's (B, H, C) slot space, and the softmax folds into a
divide per dst node.  For every slot of an edge src -> dst and head h:

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
  the sum of a (B, H, C) slot tensor per dst node or per src node, in
  groups of heads that fit a block's shared memory, one launch a group;
* :func:`gat_ds` (``_ds_kernel``): ds;
* :func:`src_aggregate` (``_dx_kernel``): out[src, h] = sum w[b, h, c]
  z[dst, h] with (B, H, C) weights, for dx and K8's dk.

The dst-side weighted aggregation ``_agg_kernel`` computes exactly
``tiled_spmm_multihead``'s function, so the forward's numerator and K8's
dq go through K4's SpMM, and K8's scores through K4's SDDMM.  ``zn``,
``rp`` and the clamp of ``den`` stay plain PyTorch, as the JAX package
computes them outside its kernels.  The kernels take f32 and sum in f32,
where the TPU kernels cast their operands to bf16.

GATv2 (K9, ``gatv2_forward`` :761) and EGATConv v2 (K11 v2,
``egatc2_forward`` :2053) score with a vector: for every valid slot, head
h and column c = h * D + d,

    raw = U[src] + V[dst] (+ FE),  FE = ef_slot[b, c] . Wf (+ bias)
    p   = exp(clip(sum_d attn[h, d] * lrelu(raw)[h, d], +-40))

and take ds with g = p.  Three more kernels (``csrc/gatv2.cu``), each
with an edge-term variant, serve both:

* :func:`vattn_scores` (``_gatv2_scores_kernel``,
  ``_egatc2_scores_kernel``): p;
* :func:`vattn_slot_grad` (the da, d(ef) and dWf parts of
  ``_gatv2_dv_da_kernel``, ``_egatc2_dv_da_kernel``): with dW = ds[h] *
  attn * lrelu'(raw), da = sum ds[h] lrelu(raw), d(ef) = Wf dW per slot
  and dWf = sum ef (x) dW (the bias's gradient is its row);
* :func:`vattn_node_grad` (the dV part of those, ``_gatv2_du_kernel``,
  ``_egatc2_du_kernel``): dV[dst] = sum dW, dU[src] = sum dW.

EdgeGAT v2 (K10 v2, ``edgegat_v2_forward`` :1703) adds an edge message fe
= ef[slot] . We_h to every slot, in its logit (ee = <attn_e[h], fe>) and
its message (out = sum p (x[src] + fe) / den).  fe is never formed: with M
= We contracted with attn_e per head (Fe, H), S[v] = sum p ef per dst, Zp
= We_h . zn[v, h] per dst and Q = sum ds ef over every slot,

    ee = ef . M[:, h],  sum p fe = S . We_h,  ds += ef . Zp[dst, h]
    dWe_h = S_h^T zn_h + Q_h (x) attn_e[h],  d(attn_e)[h] = Q_h . We_h
    d(ef) = sum_h p Zp[dst, h] + ds M[:, h]

M, S . We, Zp and dWe are node-sized products outside the kernels.  Three
edge variants of the K6 kernels serve it: :func:`edgegat_scores` (p, g),
:func:`slot_feat_reduce` (S with w = p, and with w = ds for Q: the
src-side aggregation's walk by dst tile over the H * Fe columns) and
:func:`edgegat_ds` (ds and, when autograd asks for it, d(ef)); den, der,
del, the node numerator and dx are K6's reduce, K4's SpMM and K6's dx.

The v1 functions of EGATConv (K11 v1, ``egatconv_attention_aggregate``
:1253) and EdgeGAT (K10 v1, ``edgegat_attention_aggregate`` :1524) take
their edge terms stored per slot: FE (B, C, H * De) inside K11 v1's raw,
and K10 v1's logit ee_slot (B, H, C) and message fe (B, C, H * Fh), so
out = sum p (x[src] + fe) / den.  The stored tensors are f32 or bf16,
read and written by the kernels in their dtype at 64-bit offsets and
summed in f32; their gradients come back in their dtype.  Six more
kernels serve them: :func:`egatc_scores` (p) and :func:`egatc_slot_grad`
(da and dFE = dW per slot), stored-term variants of K9's in
``csrc/gatv2.cu``; :func:`slot_vec_reduce` (dFE summed per dst node for
dFNJ and per src node for dFNI), :func:`fe_aggregate` (K10 v1's
numerator), :func:`fe_ds` (its ds) and :func:`dx_dfe` (dx, writing dfe =
p zn[dst] per slot on the way), modes and variants of K6's kernels in
``csrc/gat_fused.cu``.  K10 v1's scores, den, der and del are K6's.

The edge features stay (B, C, Fe) in slot order (:func:`slot_edge_tensor`)
and Wf is (Fe, H * D), or (Fe + 1, H * D) with the bias as its last row;
FE is computed per slot and never stored.  The JAX package's transposed
(B, Fe_pad, C) bf16 layout (``slot_edge_tensor_t``), its lane padding
(``pad_We_heads``, ``_lane_pad``, which also pads the v1 functions' slot
tensors) and the head-block-diagonal ``Ra`` exist for the TPU and have
no counterpart.

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
    "dgl_gat_scores": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                       _I, _I, ctypes.c_double, _P, _P, _I, _I, _P],
    "dgl_slot_reduce": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I,
                        _I, _I, _I, _P],
    "dgl_gat_ds": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I,
                   _P, _P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P],
    "dgl_src_agg": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _I,
                    _P, _I, _I, _I, _I, _P],
    "dgl_slot_feat_reduce": [_P, _P, _P, _I, _I, _P, _I, _I, _I, _P, _P, _I,
                             _I, _I, _I, _P],
    "dgl_slot_agg": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P,
                     _P, _I, _I, _P, _I, _I, _I, _I, _I, _P],
}
_VATTN_SIGNATURES = {
    "dgl_vattn_scores": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, ctypes.c_double, _P, _I, _P, _I,
                         _I, _P],
    "dgl_vattn_slot_grad": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                            _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            ctypes.c_double, _P, _P, _P, _P, _P, _I, _I, _I,
                            _P],
    "dgl_vattn_node_grad": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                            _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            ctypes.c_double, _P, _I, _I, _I, _I, _I, _P],
}
_SCORES_THREADS = 256       # csrc/gat_fused.cu kScoresThreads
_DS_WARPS = 8               # csrc/gat_fused.cu kDsWarps
_VATTN_WARPS = 8            # csrc/gatv2.cu kWarps
MAX_FE_ROWS = 32            # edge-feature rows, bias included, of the kernels


def _launch(fn: str, *args, source: str = "gat_fused"):
    lib = build.load(source, _VATTN_SIGNATURES if source == "gatv2"
                     else _SIGNATURES)
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

def _scores_plain(tf: ts.TiledFormat, el, er, slope: float, term=None):
    """(p, g), each (B, H, C) f32, 0 at padded slots, of raw = el[src] +
    er[dst] (+ term(b, c), an (n, H) edge term of the chunk's slots)."""
    heads = el.shape[1]
    p = torch.zeros(_slot_shape(tf, heads), dtype=torch.float32,
                    device=el.device)
    g = torch.zeros_like(p)
    for b, c, src, dst in ts._slot_chunks(tf):
        raw = el[src].float() + er[dst].float()
        if term is not None:
            raw = raw + term(b, c)
        pos = raw >= 0
        pv = torch.exp(torch.clamp(torch.where(pos, raw, slope * raw),
                                   -CLIP, CLIP))
        p[b, :, c] = pv
        g[b, :, c] = pv * torch.where(pos, 1.0, slope)
    return p, g


def gat_scores_plain(tf: ts.TiledFormat, el, er, slope: float,
                     ee_slot=None):
    """The scores' function: (p, g), each (B, H, C) f32, 0 at padded
    slots."""
    return _scores_plain(tf, el, er, slope, None if ee_slot is None else
                         lambda b, c: ee_slot[b, :, c].float())


def edgegat_scores_plain(tf: ts.TiledFormat, el, er, ef_slot, m,
                         slope: float):
    """K10 v2 scores' function: :func:`gat_scores_plain` with the edge
    logit ee = ef_slot[b, c] . m[:, h] added to raw; ``ef_slot`` (B, C,
    Fe), ``m`` (Fe, H)."""
    return _scores_plain(tf, el, er, slope,
                         lambda b, c: ef_slot[b, c].float() @ m.float())


def slot_reduce_plain(tf: ts.TiledFormat, vals, side: str = "dst"):
    """The slot reduce's function: (num_rows, H) f32, the sum of ``vals``
    (B, H, C) over the valid slots of each dst (or src) node."""
    rows = tf.num_dst if side == "dst" else tf.num_src
    out = torch.zeros(rows, vals.shape[1], dtype=torch.float32,
                      device=vals.device)
    for b, c, src, dst in ts._slot_chunks(tf):
        out.index_add_(0, dst if side == "dst" else src, vals[b, :, c].float())
    return out


def _ds_plain(tf: ts.TiledFormat, x3, zn, rp, g, fe_slot=None):
    ds = torch.zeros(_slot_shape(tf, x3.shape[1]), dtype=torch.float32,
                     device=x3.device)
    for b, c, src, dst in ts._slot_chunks(tf):
        msg = x3[src].float()
        if fe_slot is not None:
            msg = msg + fe_slot[b, c].float().view(msg.shape)
        dot = (msg * zn[dst].float()).sum(-1)
        ds[b, :, c] = (dot - rp[dst].float()) * g[b, :, c].float()
    return ds


def gat_ds_plain(tf: ts.TiledFormat, x3, zn, rp, g):
    """ds's function: (B, H, C) f32, (<x3[src, h], zn[dst, h]> -
    rp[dst, h]) * g at valid slots and 0 at padded ones."""
    return _ds_plain(tf, x3, zn, rp, g)


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


def slot_feat_reduce_plain(tf: ts.TiledFormat, w_slot, ef_slot):
    """K10 v2 slot-feature reduce's function: (num_dst, H, Fe) f32,
    out[v, h, :] = sum over the valid slots with dst v of w_slot[b, h, c] *
    ef_slot[b, c, :]."""
    out = torch.zeros(tf.num_dst, w_slot.shape[1], ef_slot.shape[2],
                      dtype=torch.float32, device=w_slot.device)
    for b, c, src, dst in ts._slot_chunks(tf):
        out.index_add_(0, dst, w_slot[b, :, c].float().unsqueeze(-1)
                       * ef_slot[b, c].float().unsqueeze(1))
    return out


def edgegat_ds_plain(tf: ts.TiledFormat, x3, zn, rp, g, ef_slot, zp, p=None,
                     m=None):
    """K10 v2 ds's function: (ds (B, H, C), d_ef (B, C, Fe) or None), f32.
    ds = (<x3[src, h], zn[dst, h]> + ef_slot[b, c] . zp[dst, h] -
    rp[dst, h]) * g; with ``p`` (B, H, C) and ``m`` (Fe, H), d_ef[b, c] =
    sum_h p zp[dst, h] + ds m[:, h].  Both 0 at padded slots."""
    ds = torch.zeros(_slot_shape(tf, x3.shape[1]), dtype=torch.float32,
                     device=x3.device)
    d_ef = (None if p is None else
            torch.zeros(ef_slot.shape, dtype=torch.float32, device=x3.device))
    for b, c, src, dst in ts._slot_chunks(tf):
        zp_rows = zp[dst].float()
        dot = ((x3[src].float() * zn[dst].float()).sum(-1)
               + (ef_slot[b, c].float().unsqueeze(1) * zp_rows).sum(-1))
        ds_rows = (dot - rp[dst].float()) * g[b, :, c].float()
        ds[b, :, c] = ds_rows
        if p is not None:
            d_ef[b, c] = ((p[b, :, c].float().unsqueeze(-1) * zp_rows).sum(1)
                          + ds_rows @ m.float().t())
    return ds, d_ef


def _vattn_raw(U3, V3, src, dst, ef_rows=None, wf=None, fe_rows=None):
    """raw (n, H, D) f32 of n slots: U3[src] + V3[dst] (+ the edge term
    ef_rows (n, Fe) . wf[:Fe] + the bias row wf[Fe] when wf has one, or the
    stored term fe_rows (n, H * D))."""
    raw = U3[src].float() + V3[dst].float()
    if fe_rows is not None:
        raw = raw + fe_rows.float().view(raw.shape)
    if ef_rows is not None:
        fe = ef_rows.shape[1]
        term = ef_rows.float() @ wf[:fe].float()
        if wf.shape[0] > fe:
            term = term + wf[fe].float()
        raw = raw + term.view(raw.shape)
    return raw


def vattn_scores_plain(tf: ts.TiledFormat, U3, V3, attn, slope: float,
                       ef_slot=None, wf=None):
    """The vector scores' function: p (B, H, C) f32, exp(clip(sum_d
    attn[h, d] lrelu(raw)[h, d], +-40)) at valid slots and 0 at padded
    ones; ``ef_slot`` (B, C, Fe) and ``wf`` give the edge term."""
    heads = U3.shape[1]
    p = torch.zeros(_slot_shape(tf, heads), dtype=torch.float32,
                    device=U3.device)
    a = attn.float()
    for b, c, src, dst in ts._slot_chunks(tf):
        raw = _vattn_raw(U3, V3, src, dst,
                         None if ef_slot is None else ef_slot[b, c], wf)
        e = (torch.nn.functional.leaky_relu(raw, slope) * a).sum(-1)
        p[b, :, c] = torch.exp(torch.clamp(e, -CLIP, CLIP))
    return p


def _vattn_dw(raw, ds_rows, a, slope):
    """dW (n, H, D) = ds[h] * attn[h, d] * lrelu'(raw)."""
    return ds_rows.unsqueeze(-1) * a * torch.where(raw >= 0, 1.0, slope)


def vattn_slot_grad_plain(tf: ts.TiledFormat, U3, V3, attn, ds, slope: float,
                          ef_slot=None, wf=None, need_def: bool = True):
    """The slot gradient's function: (da (H, D), d_ef (B, C, Fe) or None,
    dwf like ``wf`` or None), all f32.  da = sum ds[h] lrelu(raw); with the
    edge term d_ef[slot] = wf[:Fe] dW (0 at padded slots; only with
    ``need_def``) and dwf = sum over the slots of [ef, 1] (x) dW."""
    a = attn.float()
    da = torch.zeros(a.shape, dtype=torch.float32, device=U3.device)
    d_ef = dwf = None
    if ef_slot is not None:
        fe = ef_slot.shape[2]
        dwf = torch.zeros(wf.shape, dtype=torch.float32, device=U3.device)
        if need_def:
            d_ef = torch.zeros(ef_slot.shape, dtype=torch.float32,
                               device=U3.device)
    for b, c, src, dst in ts._slot_chunks(tf):
        ef_rows = None if ef_slot is None else ef_slot[b, c].float()
        raw = _vattn_raw(U3, V3, src, dst, ef_rows, wf)
        ds_rows = ds[b, :, c].float()
        da += (ds_rows.unsqueeze(-1)
               * torch.nn.functional.leaky_relu(raw, slope)).sum(0)
        if ef_rows is None:
            continue
        dw = _vattn_dw(raw, ds_rows, a, slope).flatten(1)
        dwf[:fe] += ef_rows.t() @ dw
        if wf.shape[0] > fe:
            dwf[fe] += dw.sum(0)
        if need_def:
            d_ef[b, c] = dw @ wf[:fe].float().t()
    return da, d_ef, dwf


def vattn_node_grad_plain(tf: ts.TiledFormat, U3, V3, attn, ds, slope: float,
                          side: str = "dst", ef_slot=None, wf=None):
    """The node gradient's function: (num_rows, H, D) f32, the sum of dW
    over the valid slots of each dst node (dV) or src node (dU)."""
    rows = tf.num_dst if side == "dst" else tf.num_src
    out = torch.zeros((rows,) + tuple(U3.shape[1:]), dtype=torch.float32,
                      device=U3.device)
    a = attn.float()
    for b, c, src, dst in ts._slot_chunks(tf):
        raw = _vattn_raw(U3, V3, src, dst,
                         None if ef_slot is None else ef_slot[b, c], wf)
        out.index_add_(0, dst if side == "dst" else src,
                       _vattn_dw(raw, ds[b, :, c].float(), a, slope))
    return out



def egatc_scores_plain(tf: ts.TiledFormat, U3, V3, attn, fe_slot,
                       slope: float):
    """K11 v1 scores' function: p (B, H, C) f32, exp(clip(sum_d attn[h, d]
    lrelu(U3[src] + V3[dst] + fe_slot[b, c])[h, d], +-40)) at valid slots
    and 0 at padded ones; ``fe_slot`` (B, C, H * D)."""
    p = torch.zeros(_slot_shape(tf, U3.shape[1]), dtype=torch.float32,
                    device=U3.device)
    a = attn.float()
    for b, c, src, dst in ts._slot_chunks(tf):
        raw = _vattn_raw(U3, V3, src, dst, fe_rows=fe_slot[b, c])
        e = (torch.nn.functional.leaky_relu(raw, slope) * a).sum(-1)
        p[b, :, c] = torch.exp(torch.clamp(e, -CLIP, CLIP))
    return p


def egatc_slot_grad_plain(tf: ts.TiledFormat, U3, V3, attn, fe_slot, ds,
                          slope: float):
    """K11 v1 slot gradient's function: (da (H, D) f32, dfe like
    ``fe_slot``): da = sum ds[h] lrelu(raw) and dfe[b, c] = dW = ds[h] *
    attn * lrelu'(raw) at valid slots, 0 at padded ones."""
    a = attn.float()
    da = torch.zeros(a.shape, dtype=torch.float32, device=U3.device)
    dfe = torch.zeros_like(fe_slot)
    for b, c, src, dst in ts._slot_chunks(tf):
        raw = _vattn_raw(U3, V3, src, dst, fe_rows=fe_slot[b, c])
        ds_rows = ds[b, :, c].float()
        da += (ds_rows.unsqueeze(-1)
               * torch.nn.functional.leaky_relu(raw, slope)).sum(0)
        dfe[b, c] = _vattn_dw(raw, ds_rows, a, slope).flatten(1).to(
            dfe.dtype)
    return da, dfe


def slot_vec_reduce_plain(tf: ts.TiledFormat, t_slot, side: str = "dst"):
    """The slot vector sum's function: (num_rows, F) f32, the sum of the
    rows of ``t_slot`` (B, C, F) over the valid slots of each dst (or src)
    node."""
    rows = tf.num_dst if side == "dst" else tf.num_src
    out = torch.zeros(rows, t_slot.shape[2], dtype=torch.float32,
                      device=t_slot.device)
    for b, c, src, dst in ts._slot_chunks(tf):
        out.index_add_(0, dst if side == "dst" else src, t_slot[b, c].float())
    return out


def fe_aggregate_plain(tf: ts.TiledFormat, x3, fe_slot, p):
    """K10 v1 numerator's function: (num_dst, H, Fh) f32, the sum over the
    valid slots with dst v of p[b, h, c] * (x3[src, h] + fe_slot[b, c, h])
    with ``fe_slot`` (B, C, H * Fh)."""
    out = torch.zeros((tf.num_dst,) + tuple(x3.shape[1:]),
                      dtype=torch.float32, device=x3.device)
    for b, c, src, dst in ts._slot_chunks(tf):
        msg = x3[src].float() + fe_slot[b, c].float().view(-1, *x3.shape[1:])
        out.index_add_(0, dst, p[b, :, c].float().unsqueeze(-1) * msg)
    return out


def fe_ds_plain(tf: ts.TiledFormat, x3, fe_slot, zn, rp, g):
    """K10 v1 ds's function: (B, H, C) f32, (<x3[src, h] + fe_slot[b, c,
    h], zn[dst, h]> - rp[dst, h]) * g at valid slots, 0 at padded ones."""
    return _ds_plain(tf, x3, zn, rp, g, fe_slot)


def dx_dfe_plain(tf: ts.TiledFormat, zn, p, dtype=torch.float32):
    """K10 v1 dx's function: (dx (num_src, H, Fh) f32, dfe (B, C, H * Fh)
    of ``dtype``), dx[src] = sum p zn[dst] and dfe[b, c] = p[b, :, c] *
    zn[dst] at valid slots, 0 at padded ones."""
    heads, fh = zn.shape[1], zn.shape[2]
    dfe = torch.zeros(tf.num_buckets, tf.cap, heads * fh, dtype=dtype,
                      device=zn.device)
    for b, c, src, dst in ts._slot_chunks(tf):
        dfe[b, c] = (zn[dst].float() * p[b, :, c].float().unsqueeze(-1)
                     ).flatten(1).to(dtype)
    return src_aggregate_plain(tf, zn, p), dfe


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
            0 if ee is None else ee.data_ptr(), 0, 0, 0, heads, float(slope),
            p.data_ptr(), g.data_ptr(), blocks, el.device.index,
            ts._stream(el.device))
    gat_scores.launches += 1
    return p, g


gat_scores.launches = 0


def slot_reduce(tf: ts.TiledFormat, vals, side: str = "dst"):
    """K6 slot reduce: (num_rows, H) f32, the sum of ``vals`` (B, H, C)
    over the valid slots of each dst node (``side="dst"``: den, der) or
    src node (``side="src"``: del, walking ``src_order``).  Any head count:
    a block keeps a (tile, group) accumulator of as many heads as its
    shared memory holds, and each group of heads is one launch."""
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
    # heads whose (tile, group) f32 sums fit a block's shared memory; more
    # heads take one launch per group
    group = min(heads, ts._SMEM_PER_BLOCK // (4 * tf.tile))
    if group == 0 and heads:
        raise ValueError(f"tile {tf.tile} is too large for the slot "
                         "reduce's shared-memory accumulator")
    splits = ts._splits(tf, n_t, 1, 2, vals.device)
    alloc = torch.zeros if splits > 1 else torch.empty
    out = alloc(rows, heads, dtype=torch.float32, device=vals.device)
    if n_t == 0 or heads == 0:
        return out.zero_()
    vals = _f32(vals)
    for h0 in range(0, heads, group):
        _launch("dgl_slot_reduce",
                (tf.src_local if src else tf.dst_local).data_ptr(),
                tf.valid.data_ptr(), vals.data_ptr(),
                tf.src_order.data_ptr() if src else 0,
                (tf.src_ptr if src else tf.dst_ptr).data_ptr(), n_t, tf.tile,
                tf.cap, heads, h0, min(group, heads - h0), out.data_ptr(),
                rows, splits, int(src), vals.device.index,
                ts._stream(vals.device))
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
            z.data_ptr(), r.data_ptr(), gg.data_ptr(), heads, fh, 0, 0, 0, 0,
            0, 0, 0, 0, ds.data_ptr(), ts._lanes_per_head(heads), blocks,
            x.device.index, ts._stream(x.device))
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


def _check_edge(tf: ts.TiledFormat, ef_slot) -> int:
    """Fe of ``ef_slot``, which must be (B, C, Fe) in ``tf``'s slot
    order."""
    fe = ef_slot.shape[-1] if ef_slot.ndim == 3 else -1
    if tuple(ef_slot.shape) != (tf.num_buckets, tf.cap, fe):
        raise ValueError(f"ef_slot has shape {tuple(ef_slot.shape)}; the "
                         f"format needs ({tf.num_buckets}, {tf.cap}, Fe)")
    return fe


def edgegat_fits(heads: int, fe: int) -> bool:
    """True when K10 v2's scores kernel holds M, (Fe, H) f32, in a block's
    shared memory; the EdgeGATConv gate checks it."""
    return fe * heads * 4 <= ts._SMEM_PER_BLOCK


def edgegat_scores(tf: ts.TiledFormat, el, er, ef_slot, m, slope: float):
    """K10 v2 scores: (p, g), each (B, H, C) f32, from el (num_src, H), er
    (num_dst, H) and the edge logit ef_slot[b, c] . m[:, h], ``ef_slot``
    (B, C, Fe) in slot order and ``m`` (Fe, H)."""
    heads = el.shape[1]
    _check_nodes(el, tf.num_src, heads, "el")
    _check_nodes(er, tf.num_dst, heads, "er")
    fe = _check_edge(tf, ef_slot)
    if tuple(m.shape) != (fe, heads):
        raise ValueError(f"m has shape {tuple(m.shape)}, not ({fe}, {heads})")
    if not on_cuda(el, er, ef_slot, m, tf.valid):
        return edgegat_scores_plain(tf, el, er, ef_slot, m, slope)
    if not edgegat_fits(heads, fe):
        raise ValueError(f"M of {fe} x {heads} does not fit the scores "
                         "kernel's shared memory")
    b, cap = tf.num_buckets, tf.cap
    ts._check_int32(b * heads * cap, tf.num_src_tiles * tf.tile * heads,
                    tf.num_dst_tiles * tf.tile * heads, b * cap * max(fe, 1))
    p = torch.empty(_slot_shape(tf, heads), dtype=torch.float32,
                    device=el.device)
    g = torch.empty_like(p)
    if heads == 0:
        return p, g
    el, er, ef, mm = _f32(el), _f32(er), _f32(ef_slot), _f32(m)
    slots = b * cap
    blocks = max(1, min(-(-slots // _SCORES_THREADS),
                        32 * ts._sms(el.device)))
    _launch("dgl_gat_scores", tf.src_local.data_ptr(),
            tf.dst_local.data_ptr(), tf.valid.data_ptr(),
            tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(), slots, tf.tile,
            cap, el.data_ptr(), er.data_ptr(), 0, ef.data_ptr(),
            mm.data_ptr(), fe, heads, float(slope), p.data_ptr(),
            g.data_ptr(), blocks, el.device.index, ts._stream(el.device))
    edgegat_scores.launches += 1
    return p, g


edgegat_scores.launches = 0


def slot_feat_reduce(tf: ts.TiledFormat, w_slot, ef_slot):
    """K10 v2 slot-feature reduce: (num_dst, H, Fe) f32, out[v, h, :] = sum
    over the valid slots with dst v of w_slot[b, h, c] * ef_slot[b, c, :];
    ``w_slot`` (B, H, C), ``ef_slot`` (B, C, Fe).  The H * Fe columns are
    walked in chunks that fit a block's shared memory, as the src-side
    aggregation walks its columns."""
    heads = w_slot.shape[1] if w_slot.ndim == 3 else -1
    _check_slots(tf, w_slot, heads, "w_slot")
    fe = _check_edge(tf, ef_slot)
    if not on_cuda(w_slot, ef_slot, tf.valid):
        return slot_feat_reduce_plain(tf, w_slot, ef_slot)
    f = heads * fe
    b, n_dt = tf.num_buckets, tf.num_dst_tiles
    ts._check_int32(b * heads * tf.cap, b * tf.cap * max(fe, 1),
                    n_dt * tf.tile * f)
    g = ts._group(f, tf.tile)
    splits = ts._splits(tf, n_dt, -(-f // g), ts._group_per_sm(g, tf.tile),
                        w_slot.device)
    alloc = torch.zeros if splits > 1 else torch.empty
    out = alloc(tf.num_dst, heads, fe, dtype=torch.float32,
                device=w_slot.device)
    if n_dt == 0 or f == 0:
        return out.zero_()
    w, ef = _f32(w_slot), _f32(ef_slot)
    _launch("dgl_slot_feat_reduce", tf.dst_local.data_ptr(),
            tf.valid.data_ptr(), w.data_ptr(), heads, fe,
            tf.dst_ptr.data_ptr(), n_dt, tf.tile, tf.cap, ef.data_ptr(),
            out.data_ptr(), tf.num_dst, g, splits, w.device.index,
            ts._stream(w.device))
    slot_feat_reduce.launches += 1
    return out


slot_feat_reduce.launches = 0


def edgegat_ds(tf: ts.TiledFormat, x3, zn, rp, g, ef_slot, zp, p=None,
               m=None):
    """K10 v2 ds: (ds (B, H, C), d_ef (B, C, Fe) or None), f32.  ds =
    (<x3[src, h], zn[dst, h]> + ef_slot[b, c] . zp[dst, h] - rp[dst, h])
    * g at valid slots, 0 at padded ones; with ``p`` (B, H, C) and ``m``
    (Fe, H), also d_ef[b, c] = sum_h p zp[dst, h] + ds m[:, h] (0 at padded
    slots).  ``zp`` (num_dst, H, Fe)."""
    heads, fh = x3.shape[1], x3.shape[2]
    ts._check_operand(tf, x3, tf.num_src, 3, "x3")
    ts._check_operand(tf, zn, tf.num_dst, 3, "zn")
    if tuple(zn.shape[1:]) != (heads, fh):
        raise ValueError(f"zn {tuple(zn.shape)} does not match x3 "
                         f"{tuple(x3.shape)}")
    _check_nodes(rp, tf.num_dst, heads, "rp")
    _check_slots(tf, g, heads, "g")
    fe = _check_edge(tf, ef_slot)
    if tuple(zp.shape) != (tf.num_dst, heads, fe):
        raise ValueError(f"zp has shape {tuple(zp.shape)}, not "
                         f"({tf.num_dst}, {heads}, {fe})")
    if (p is None) != (m is None):
        raise ValueError("d(ef) needs both p and m")
    extra = ()
    if p is not None:
        _check_slots(tf, p, heads, "p")
        if tuple(m.shape) != (fe, heads):
            raise ValueError(f"m has shape {tuple(m.shape)}, not ({fe}, "
                             f"{heads})")
        extra = (p, m)
    if not on_cuda(x3, zn, rp, g, ef_slot, zp, tf.valid, *extra):
        return edgegat_ds_plain(tf, x3, zn, rp, g, ef_slot, zp, p, m)
    b = tf.num_buckets
    hf = heads * fh
    ts._check_int32(b * heads * tf.cap, tf.num_src_tiles * tf.tile * hf,
                    tf.num_dst_tiles * tf.tile * hf,
                    tf.num_dst_tiles * tf.tile * heads * fe,
                    b * tf.cap * max(fe, 1))
    dev = x3.device
    ds = torch.empty(_slot_shape(tf, heads), dtype=torch.float32, device=dev)
    d_ef = (None if p is None else
            torch.empty(ef_slot.shape, dtype=torch.float32, device=dev))
    if heads == 0:
        return ds, None if d_ef is None else d_ef.zero_()
    x, z, r, gg = _f32(x3), _f32(zn), _f32(rp), _f32(g)
    ef, zq = _f32(ef_slot), _f32(zp)
    pp, mm = (None, None) if p is None else (_f32(p), _f32(m))
    chunks = b * tf.cap // 32
    blocks = max(1, min(-(-chunks // _DS_WARPS), 16 * ts._sms(dev)))
    _launch("dgl_gat_ds", tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
            tf.valid.data_ptr(), tf.src_tile.data_ptr(),
            tf.dst_tile.data_ptr(), b, tf.tile, tf.cap, x.data_ptr(),
            z.data_ptr(), r.data_ptr(), gg.data_ptr(), heads, fh,
            ef.data_ptr(), zq.data_ptr(), fe,
            0 if pp is None else pp.data_ptr(),
            0 if mm is None else mm.data_ptr(),
            0 if d_ef is None else d_ef.data_ptr(), 0, 0, ds.data_ptr(),
            ts._lanes_per_head(heads), blocks, dev.index, ts._stream(dev))
    edgegat_ds.launches += 1
    return ds, d_ef


edgegat_ds.launches = 0


def _check_vattn(tf: ts.TiledFormat, U3, V3, attn, ef_slot, wf):
    """(H, D, Fe, Fe rows of wf): the shapes of a vector-attention call;
    Fe = rows = 0 without the edge term."""
    ts._check_operand(tf, U3, tf.num_src, 3, "U3")
    ts._check_operand(tf, V3, tf.num_dst, 3, "V3")
    heads, dim = U3.shape[1], U3.shape[2]
    if tuple(V3.shape[1:]) != (heads, dim) or tuple(attn.shape) != (heads,
                                                                     dim):
        raise ValueError(f"U3 {tuple(U3.shape)}, V3 {tuple(V3.shape)} and "
                         f"attn {tuple(attn.shape)} do not match")
    if (ef_slot is None) != (wf is None):
        raise ValueError("the edge term needs both ef_slot and wf")
    if ef_slot is None:
        return heads, dim, 0, 0
    fe = _check_edge(tf, ef_slot)
    if wf.ndim != 2 or wf.shape[1] != heads * dim or wf.shape[0] not in (
            fe, fe + 1):
        raise ValueError(f"wf has shape {tuple(wf.shape)}; it needs ({fe} "
                         f"or {fe + 1}, {heads * dim})")
    return heads, dim, fe, wf.shape[0]


def fe_rows_fit(rows: int) -> bool:
    """True when the K11 v2 kernels take ``rows`` edge-feature rows (the
    bias row included); the EGATConv gate checks it."""
    return rows <= MAX_FE_ROWS


def _fe_cap(rows: int) -> int:
    """The kernels' register width for ``rows`` edge-feature rows."""
    if not fe_rows_fit(rows):
        raise ValueError(f"{rows} edge-feature rows (bias included); the "
                         f"kernels take at most {MAX_FE_ROWS}")
    return 8 if rows <= 8 else 16 if rows <= 16 else 32


def _check_vattn_sizes(tf: ts.TiledFormat, heads, dim, fe, smem_floats):
    hd = heads * dim
    ts._check_int32(tf.num_buckets * max(heads, 1) * tf.cap,
                    tf.num_src_tiles * tf.tile * hd,
                    tf.num_dst_tiles * tf.tile * hd,
                    tf.num_buckets * tf.cap * max(fe, 1))
    if smem_floats * 4 > ts._SMEM_PER_BLOCK:
        raise ValueError(f"{heads} heads x {dim} with {fe} edge features "
                         "do not fit the kernel's shared memory")


def vattn_scores(tf: ts.TiledFormat, U3, V3, attn, slope: float,
                 ef_slot=None, wf=None):
    """K9 / K11 v2 scores: p (B, H, C) f32 from U3 (num_src, H, D), V3
    (num_dst, H, D) and attn (H, D); ``ef_slot`` (B, C, Fe) and ``wf``
    (Fe or Fe + 1, H * D) add the edge term."""
    heads, dim, fe, rows = _check_vattn(tf, U3, V3, attn, ef_slot, wf)
    edge = () if ef_slot is None else (ef_slot, wf)
    if not on_cuda(U3, V3, attn, tf.valid, *edge):
        return vattn_scores_plain(tf, U3, V3, attn, slope, ef_slot, wf)
    hd = heads * dim
    if edge:
        _fe_cap(rows)
    _check_vattn_sizes(tf, heads, dim, fe,
                       hd + rows * hd + _VATTN_WARPS * 32 * rows)
    b, cap = tf.num_buckets, tf.cap
    p = torch.empty(_slot_shape(tf, heads), dtype=torch.float32,
                    device=U3.device)
    if heads == 0:
        return p
    u, v, a = _f32(U3), _f32(V3), _f32(attn)
    ef_c, wf_c = (None, None) if not edge else (_f32(ef_slot), _f32(wf))
    blocks = max(1, min(-(-(b * cap // 32) // _VATTN_WARPS),
                        16 * ts._sms(u.device)))
    _launch("dgl_vattn_scores", tf.src_local.data_ptr(),
            tf.dst_local.data_ptr(), tf.valid.data_ptr(),
            tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(), b, tf.tile, cap,
            u.data_ptr(), v.data_ptr(), a.data_ptr(),
            0 if ef_c is None else ef_c.data_ptr(),
            0 if wf_c is None else wf_c.data_ptr(), fe, rows, heads, dim,
            ts._lanes_per_head(heads), float(slope), 0, 0, p.data_ptr(),
            blocks, u.device.index, ts._stream(u.device), source="gatv2")
    vattn_scores.launches += 1
    return p


vattn_scores.launches = 0


def vattn_slot_grad(tf: ts.TiledFormat, U3, V3, attn, ds, slope: float,
                    ef_slot=None, wf=None, need_def: bool = True):
    """K9 / K11 v2 slot gradient: (da (H, D), d_ef (B, C, Fe) or None,
    dwf (rows of wf, H * D) or None), f32, from ds (B, H, C).  ``d_ef`` is
    computed only with the edge term and ``need_def``."""
    heads, dim, fe, rows = _check_vattn(tf, U3, V3, attn, ef_slot, wf)
    _check_slots(tf, ds, heads, "ds")
    edge = () if ef_slot is None else (ef_slot, wf)
    if not on_cuda(U3, V3, attn, ds, tf.valid, *edge):
        return vattn_slot_grad_plain(tf, U3, V3, attn, ds, slope, ef_slot,
                                     wf, need_def)
    hd = heads * dim
    fe_cap = _fe_cap(rows) if edge else 0
    _check_vattn_sizes(tf, heads, dim, fe,
                       2 * hd + 2 * rows * hd + _VATTN_WARPS * 32 * rows)
    dev = U3.device
    da = torch.zeros(heads, dim, dtype=torch.float32, device=dev)
    dwf = (torch.zeros(rows, hd, dtype=torch.float32, device=dev) if edge
           else None)
    d_ef = (torch.empty(ef_slot.shape, dtype=torch.float32, device=dev)
            if edge and need_def else None)
    if hd == 0:
        return da, None if d_ef is None else d_ef.zero_(), dwf
    lanes = ts._lanes_per_head(heads)
    # columns of its head a lane keeps in registers at once: da and, with
    # the edge term, fe_cap rows of dWf each (and fe_cap d(ef) partial sums
    # a slot)
    cols, max_cols = 1, 2 if fe_cap == 32 and d_ef is not None else 4
    while cols < min(-(-dim // lanes), max_cols):
        cols *= 2
    u, v, a, g = _f32(U3), _f32(V3), _f32(attn), _f32(ds)
    ef_c, wf_c = (None, None) if not edge else (_f32(ef_slot), _f32(wf))
    b, cap = tf.num_buckets, tf.cap
    blocks = max(1, min(-(-(b * cap // 32) // _VATTN_WARPS),
                        4 * ts._sms(dev)))
    _launch("dgl_vattn_slot_grad", tf.src_local.data_ptr(),
            tf.dst_local.data_ptr(), tf.valid.data_ptr(),
            tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(), b, tf.tile, cap,
            u.data_ptr(), v.data_ptr(), a.data_ptr(), g.data_ptr(),
            0 if ef_c is None else ef_c.data_ptr(),
            0 if wf_c is None else wf_c.data_ptr(), fe, rows, heads, dim,
            lanes, cols, fe_cap, float(slope), da.data_ptr(),
            0 if d_ef is None else d_ef.data_ptr(),
            0 if dwf is None else dwf.data_ptr(), 0, 0, 0, blocks, dev.index,
            ts._stream(dev), source="gatv2")
    vattn_slot_grad.launches += 1
    return da, d_ef, dwf


vattn_slot_grad.launches = 0


def vattn_node_grad(tf: ts.TiledFormat, U3, V3, attn, ds, slope: float,
                    side: str = "dst", ef_slot=None, wf=None):
    """K9 / K11 v2 node gradient: (num_rows, H, D) f32, the sum of dW over
    the valid slots of each dst node (``side="dst"``: dV) or src node
    (``side="src"``: dU, walking ``src_order``)."""
    if side not in ("dst", "src"):
        raise ValueError(f"side must be 'dst' or 'src', got {side!r}")
    heads, dim, fe, rows = _check_vattn(tf, U3, V3, attn, ef_slot, wf)
    _check_slots(tf, ds, heads, "ds")
    src = side == "src"
    if src:
        _require_src_first(tf)
    edge = () if ef_slot is None else (ef_slot, wf)
    if not on_cuda(U3, V3, attn, ds, tf.valid, *edge):
        return vattn_node_grad_plain(tf, U3, V3, attn, ds, slope, side,
                                     ef_slot, wf)
    hd = heads * dim
    fe_cap = _fe_cap(rows) if edge else 0
    _check_vattn_sizes(tf, heads, dim, fe, 0)
    n_rows = tf.num_src if src else tf.num_dst
    n_t = tf.num_src_tiles if src else tf.num_dst_tiles
    dev = U3.device
    g = ts._group(hd, tf.tile)
    splits = ts._splits(tf, n_t, -(-hd // g), ts._group_per_sm(g, tf.tile),
                        dev)
    alloc = torch.zeros if splits > 1 else torch.empty
    out = alloc(n_rows, heads, dim, dtype=torch.float32, device=dev)
    if n_t == 0 or hd == 0:
        return out.zero_()
    u, v, a, d = _f32(U3), _f32(V3), _f32(attn), _f32(ds)
    ef_c, wf_c = (None, None) if not edge else (_f32(ef_slot), _f32(wf))
    _launch("dgl_vattn_node_grad", tf.src_local.data_ptr(),
            tf.dst_local.data_ptr(), tf.valid.data_ptr(),
            tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(),
            tf.src_order.data_ptr() if src else 0,
            (tf.src_ptr if src else tf.dst_ptr).data_ptr(), n_t, tf.tile,
            tf.cap, u.data_ptr(), v.data_ptr(), a.data_ptr(), d.data_ptr(),
            0 if ef_c is None else ef_c.data_ptr(),
            0 if wf_c is None else wf_c.data_ptr(), fe, rows - fe, fe_cap,
            heads, dim, float(slope), out.data_ptr(), n_rows, g, splits,
            int(src), dev.index, ts._stream(dev), source="gatv2")
    vattn_node_grad.launches += 1
    return out


vattn_node_grad.launches = 0


# what csrc/gat_fused.cu's dgl_slot_agg sums (its AggMode)
_AGG_FE, _AGG_DX_DFE, _AGG_VEC_DST, _AGG_VEC_SRC = 2, 3, 4, 5
_STORE_CODES = {torch.float32: 1, torch.bfloat16: 2}


def _check_stored(tf: ts.TiledFormat, t, width: int, what: str):
    """``t`` as the kernels read a stored slot tensor: (B, C, width), f32
    or bf16, contiguous."""
    if tuple(t.shape) != (tf.num_buckets, tf.cap, width):
        raise ValueError(f"{what} has shape {tuple(t.shape)}; the format "
                         f"needs ({tf.num_buckets}, {tf.cap}, {width})")
    if t.dtype not in _STORE_CODES:
        raise ValueError(f"{what} is {t.dtype}; the kernels take float32 "
                         "and bfloat16")
    return t.contiguous()


def _slot_agg(tf: ts.TiledFormat, mode: int, t, heads: int, head_cols: int,
              w=None, z=None):
    """Launch the src-side aggregation's walk in ``mode`` over the stored
    slot tensor ``t`` (B, C, heads * head_cols): (rows, heads * head_cols)
    f32, rows the src nodes (by src tile) or the dst nodes (by dst tile)."""
    src = mode in (_AGG_DX_DFE, _AGG_VEC_SRC)
    if src:
        _require_src_first(tf)
    f = heads * head_cols
    rows = tf.num_src if src else tf.num_dst
    n_t = tf.num_src_tiles if src else tf.num_dst_tiles
    ts._check_int32(tf.num_buckets * heads * tf.cap,
                    tf.num_src_tiles * tf.tile * f,
                    tf.num_dst_tiles * tf.tile * f)
    dev = t.device
    g = ts._group(f, tf.tile)
    splits = ts._splits(tf, n_t, -(-f // g), ts._group_per_sm(g, tf.tile),
                        dev)
    alloc = torch.zeros if splits > 1 else torch.empty
    out = alloc(rows, f, dtype=torch.float32, device=dev)
    if n_t == 0 or f == 0:
        if mode == _AGG_DX_DFE:
            t.zero_()
        return out.zero_()
    _launch("dgl_slot_agg", tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
            tf.valid.data_ptr(), 0 if w is None else w.data_ptr(), heads,
            head_cols, tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(),
            tf.src_order.data_ptr() if src else 0,
            (tf.src_ptr if src else tf.dst_ptr).data_ptr(), n_t, tf.tile,
            tf.cap, 0 if z is None else z.data_ptr(), t.data_ptr(),
            _STORE_CODES[t.dtype], f, out.data_ptr(), rows, g, splits, mode,
            dev.index, ts._stream(dev))
    return out


def egatc_scores(tf: ts.TiledFormat, U3, V3, attn, fe_slot, slope: float):
    """K11 v1 scores: p (B, H, C) f32 from U3 (num_src, H, D), V3 (num_dst,
    H, D), attn (H, D) and the stored edge term ``fe_slot`` (B, C, H * D),
    f32 or bf16."""
    heads, dim, _, _ = _check_vattn(tf, U3, V3, attn, None, None)
    fe_s = _check_stored(tf, fe_slot, heads * dim, "fe_slot")
    if not on_cuda(U3, V3, attn, fe_slot, tf.valid):
        return egatc_scores_plain(tf, U3, V3, attn, fe_slot, slope)
    _check_vattn_sizes(tf, heads, dim, 0, heads * dim)
    b, cap = tf.num_buckets, tf.cap
    p = torch.empty(_slot_shape(tf, heads), dtype=torch.float32,
                    device=U3.device)
    if heads == 0:
        return p
    u, v, a = _f32(U3), _f32(V3), _f32(attn)
    blocks = max(1, min(-(-(b * cap // 32) // _VATTN_WARPS),
                        16 * ts._sms(u.device)))
    _launch("dgl_vattn_scores", tf.src_local.data_ptr(),
            tf.dst_local.data_ptr(), tf.valid.data_ptr(),
            tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(), b, tf.tile, cap,
            u.data_ptr(), v.data_ptr(), a.data_ptr(), 0, 0, 0, 0, heads, dim,
            ts._lanes_per_head(heads), float(slope), fe_s.data_ptr(),
            _STORE_CODES[fe_s.dtype], p.data_ptr(), blocks, u.device.index,
            ts._stream(u.device), source="gatv2")
    egatc_scores.launches += 1
    return p


egatc_scores.launches = 0


def egatc_slot_grad(tf: ts.TiledFormat, U3, V3, attn, fe_slot, ds,
                    slope: float):
    """K11 v1 slot gradient: (da (H, D) f32, dfe (B, C, H * D) in
    ``fe_slot``'s dtype), dfe = dW = ds[h] * attn * lrelu'(raw) per slot
    (0 at padded ones), from ds (B, H, C)."""
    heads, dim, _, _ = _check_vattn(tf, U3, V3, attn, None, None)
    fe_s = _check_stored(tf, fe_slot, heads * dim, "fe_slot")
    _check_slots(tf, ds, heads, "ds")
    if not on_cuda(U3, V3, attn, fe_slot, ds, tf.valid):
        return egatc_slot_grad_plain(tf, U3, V3, attn, fe_slot, ds, slope)
    hd = heads * dim
    _check_vattn_sizes(tf, heads, dim, 0, 2 * hd)
    dev = U3.device
    da = torch.zeros(heads, dim, dtype=torch.float32, device=dev)
    dfe = torch.empty_like(fe_s)
    if hd == 0:
        return da, dfe
    lanes = ts._lanes_per_head(heads)
    cols = 1      # columns of its head a lane keeps in registers at once
    while cols < min(-(-dim // lanes), 4):
        cols *= 2
    u, v, a, g = _f32(U3), _f32(V3), _f32(attn), _f32(ds)
    b, cap = tf.num_buckets, tf.cap
    blocks = max(1, min(-(-(b * cap // 32) // _VATTN_WARPS),
                        4 * ts._sms(dev)))
    _launch("dgl_vattn_slot_grad", tf.src_local.data_ptr(),
            tf.dst_local.data_ptr(), tf.valid.data_ptr(),
            tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(), b, tf.tile, cap,
            u.data_ptr(), v.data_ptr(), a.data_ptr(), g.data_ptr(), 0, 0, 0,
            0, heads, dim, lanes, cols, 0, float(slope), da.data_ptr(), 0, 0,
            fe_s.data_ptr(), dfe.data_ptr(), _STORE_CODES[fe_s.dtype], blocks,
            dev.index, ts._stream(dev), source="gatv2")
    egatc_slot_grad.launches += 1
    return da, dfe


egatc_slot_grad.launches = 0


def slot_vec_reduce(tf: ts.TiledFormat, t_slot, side: str = "dst"):
    """K11 v1 slot vector sum: (num_rows, F) f32, the sum of the rows of
    ``t_slot`` (B, C, F), f32 or bf16, over the valid slots of each dst
    node (``side="dst"``: dFNJ) or src node (``side="src"``: dFNI, walking
    ``src_order``)."""
    if side not in ("dst", "src"):
        raise ValueError(f"side must be 'dst' or 'src', got {side!r}")
    width = t_slot.shape[-1] if t_slot.ndim == 3 else -1
    t = _check_stored(tf, t_slot, width, "t_slot")
    if side == "src":
        _require_src_first(tf)
    if not on_cuda(t_slot, tf.valid):
        return slot_vec_reduce_plain(tf, t_slot, side)
    out = _slot_agg(tf, _AGG_VEC_SRC if side == "src" else _AGG_VEC_DST, t,
                    1, width)
    slot_vec_reduce.launches += 1
    return out


slot_vec_reduce.launches = 0


def fe_aggregate(tf: ts.TiledFormat, x3, fe_slot, p):
    """K10 v1 numerator: (num_dst, H, Fh) f32, out[v, h] = sum over the
    valid slots with dst v of p[b, h, c] * (x3[src, h] + fe_slot[b, c, h]);
    ``x3`` (num_src, H, Fh), ``fe_slot`` (B, C, H * Fh), f32 or bf16, and
    ``p`` (B, H, C)."""
    ts._check_operand(tf, x3, tf.num_src, 3, "x3")
    heads, fh = x3.shape[1], x3.shape[2]
    fe_s = _check_stored(tf, fe_slot, heads * fh, "fe_slot")
    _check_slots(tf, p, heads, "p")
    if not on_cuda(x3, fe_slot, p, tf.valid):
        return fe_aggregate_plain(tf, x3, fe_slot, p)
    out = _slot_agg(tf, _AGG_FE, fe_s, heads, fh, _f32(p), _f32(x3))
    fe_aggregate.launches += 1
    return out.view(tf.num_dst, heads, fh)


fe_aggregate.launches = 0


def fe_ds(tf: ts.TiledFormat, x3, fe_slot, zn, rp, g):
    """K10 v1 ds: (B, H, C) f32, (<x3[src, h] + fe_slot[b, c, h], zn[dst,
    h]> - rp[dst, h]) * g at valid slots and 0 at padded ones; ``fe_slot``
    (B, C, H * Fh), f32 or bf16."""
    heads, fh = x3.shape[1], x3.shape[2]
    ts._check_operand(tf, x3, tf.num_src, 3, "x3")
    ts._check_operand(tf, zn, tf.num_dst, 3, "zn")
    if tuple(zn.shape[1:]) != (heads, fh):
        raise ValueError(f"zn {tuple(zn.shape)} does not match x3 "
                         f"{tuple(x3.shape)}")
    _check_nodes(rp, tf.num_dst, heads, "rp")
    _check_slots(tf, g, heads, "g")
    fe_s = _check_stored(tf, fe_slot, heads * fh, "fe_slot")
    if not on_cuda(x3, fe_slot, zn, rp, g, tf.valid):
        return fe_ds_plain(tf, x3, fe_slot, zn, rp, g)
    b = tf.num_buckets
    hf = heads * fh
    ts._check_int32(b * heads * tf.cap, tf.num_src_tiles * tf.tile * hf,
                    tf.num_dst_tiles * tf.tile * hf)
    ds = torch.empty(_slot_shape(tf, heads), dtype=torch.float32,
                     device=x3.device)
    if hf == 0:
        return ds.zero_()
    x, z, r, gg = _f32(x3), _f32(zn), _f32(rp), _f32(g)
    blocks = max(1, min(-(-(b * tf.cap // 32) // _DS_WARPS),
                        16 * ts._sms(x.device)))
    _launch("dgl_gat_ds", tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
            tf.valid.data_ptr(), tf.src_tile.data_ptr(),
            tf.dst_tile.data_ptr(), b, tf.tile, tf.cap, x.data_ptr(),
            z.data_ptr(), r.data_ptr(), gg.data_ptr(), heads, fh, 0, 0, 0, 0,
            0, 0, fe_s.data_ptr(), _STORE_CODES[fe_s.dtype], ds.data_ptr(),
            ts._lanes_per_head(heads), blocks, x.device.index,
            ts._stream(x.device))
    fe_ds.launches += 1
    return ds


fe_ds.launches = 0


def dx_dfe(tf: ts.TiledFormat, zn, p, dtype=torch.float32):
    """K10 v1 dx: (dx (num_src, H, Fh) f32, dfe (B, C, H * Fh) of
    ``dtype``, f32 or bf16): dx[src] = sum p zn[dst] and, on the same
    walk, dfe[b, c] = p[b, :, c] * zn[dst] (0 at padded slots)."""
    _require_src_first(tf)
    ts._check_operand(tf, zn, tf.num_dst, 3, "zn")
    heads, fh = zn.shape[1], zn.shape[2]
    _check_slots(tf, p, heads, "p")
    if dtype not in _STORE_CODES:
        raise ValueError(f"dfe can be float32 or bfloat16, not {dtype}")
    if not on_cuda(zn, p, tf.valid):
        return dx_dfe_plain(tf, zn, p, dtype)
    dfe = torch.empty(tf.num_buckets, tf.cap, heads * fh, dtype=dtype,
                      device=zn.device)
    dx = _slot_agg(tf, _AGG_DX_DFE, dfe, heads, fh, _f32(p), _f32(zn))
    dx_dfe.launches += 1
    return dx.view(tf.num_src, heads, fh), dfe


dx_dfe.launches = 0


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


def vattn_forward(tf: ts.TiledFormat, U3, V3, x3, attn, H: int, Fh: int,
                  slope: float, ef_slot=None, wf=None):
    """GATv2 / EGATConv v2 forward (``gatv2_forward`` :761,
    ``egatc2_forward`` :2053): (out (num_dst, H, Fh), p_slot, den
    (num_dst, H)), ``den`` clamped at 1e-20."""
    p = vattn_scores(tf, U3, V3, attn, slope, ef_slot, wf)
    den = slot_reduce(tf, p, "dst").clamp_(min=DEN_EPS)
    num = ts.tiled_spmm_multihead(tf, x3, p, H, Fh)
    return num / den.unsqueeze(-1), p, den


def vattn_backward(tf: ts.TiledFormat, U3, V3, x3, attn, p_slot, den, out,
                   dZ, slope: float, ef_slot=None, wf=None,
                   need_def: bool = True):
    """GATv2 / EGATConv v2 backward (``_gatv2_bwd`` :836,
    ``egatc2_backward`` :2118): (dU, dV, dx, da, d_ef, dwf), with ds =
    (<x[src], zn[dst]> - rp[dst]) * p; ``d_ef`` and ``dwf`` are None
    without the edge term.  ``tf`` needs ``src_order``."""
    zn, rp = _scales(out, dZ, den)
    ds = gat_ds(tf, x3, zn, rp, p_slot)
    da, d_ef, dwf = vattn_slot_grad(tf, U3, V3, attn, ds, slope, ef_slot,
                                    wf, need_def)
    dV = vattn_node_grad(tf, U3, V3, attn, ds, slope, "dst", ef_slot, wf)
    dU = vattn_node_grad(tf, U3, V3, attn, ds, slope, "src", ef_slot, wf)
    del ds
    dx = src_aggregate(tf, zn, p_slot)
    return dU, dV, dx, da, d_ef, dwf


def _edge_mats(We, attn_e, H: int, Fh: int):
    """(We viewed (Fe, H, Fh) f32, M (Fe, H) = We contracted with attn_e
    per head): the edge logit is ef . M[:, h]."""
    w3 = We.float().reshape(We.shape[0], H, Fh)
    return w3, torch.einsum("fhd,hd->fh", w3, attn_e.float())


def edgegat_v2_forward(tf: ts.TiledFormat, el2, er2, ef_slot, We, attn_e,
                       x3, H: int, Fh: int, slope: float):
    """EdgeGAT v2 forward (``edgegat_v2_forward`` :1703): (out (num_dst, H,
    Fh), p_slot, g_slot, den (num_dst, H), S (num_dst, H, Fe)), ``den``
    clamped at 1e-20.  The edge message fe = ef . We_h of each slot is
    never formed: its logit is ef . M and its share of the numerator S .
    We_h, with S = sum p ef per dst."""
    w3, m = _edge_mats(We, attn_e, H, Fh)
    p, g = edgegat_scores(tf, el2, er2, ef_slot, m, slope)
    den = slot_reduce(tf, p, "dst").clamp_(min=DEN_EPS)
    num = ts.tiled_spmm_multihead(tf, x3, p, H, Fh)
    s = slot_feat_reduce(tf, p, ef_slot)
    num = num + torch.einsum("vhf,fhd->vhd", s, w3)
    return num / den.unsqueeze(-1), p, g, den, s


def edgegat_v2_backward(tf: ts.TiledFormat, ef_slot, We, attn_e, x3, p_slot,
                        g_slot, den, s, out, dZ, H: int, Fh: int,
                        need_def: bool = True):
    """EdgeGAT v2 backward (``edgegat_v2_backward`` :1764): (del (num_src,
    H), der (num_dst, H), dx (num_src, H, Fh), d_ef (B, C, Fe) or None, dWe
    (Fe, H * Fh), d_attn_e (H, Fh)).  With Zp = We_h . zn per dst and Q =
    sum ds ef over every slot: ds gains ef . Zp[dst], dWe_h = S_h^T zn_h +
    Q_h (x) attn_e[h], d(attn_e)[h] = Q_h . We_h, and d_ef = sum_h p
    Zp[dst, h] + ds M[:, h] (only with ``need_def``).  ``tf`` needs
    ``src_order``."""
    zn, rp = _scales(out, dZ, den)
    w3, m = _edge_mats(We, attn_e, H, Fh)
    zp = torch.einsum("vhd,fhd->vhf", zn, w3)
    ds, d_ef = edgegat_ds(tf, x3, zn, rp, g_slot, ef_slot, zp,
                          p_slot if need_def else None,
                          m if need_def else None)
    del zp
    der = slot_reduce(tf, ds, "dst")
    dl = slot_reduce(tf, ds, "src")
    q = slot_feat_reduce(tf, ds, ef_slot).sum(0)            # (H, Fe)
    del ds
    dx = src_aggregate(tf, zn, p_slot)
    a = attn_e.float()
    dwe = (torch.einsum("vhf,vhd->fhd", s, zn)
           + torch.einsum("hf,hd->fhd", q, a))
    d_attn = torch.einsum("hf,fhd->hd", q, w3)
    return dl, der, dx, d_ef, dwe.reshape(We.shape[0], H * Fh), d_attn



def egatc_forward(tf: ts.TiledFormat, fni3, fnj3, fe_slot, attn, x3, H: int,
                  De: int, Fh: int, slope: float):
    """EGATConv v1 forward (``egatc_forward`` :1069): (out (num_dst, H,
    Fh), p_slot, den (num_dst, H)), ``den`` clamped at 1e-20; the edge
    term is the stored ``fe_slot`` (B, C, H * De)."""
    p = egatc_scores(tf, fni3, fnj3, attn, fe_slot, slope)
    den = slot_reduce(tf, p, "dst").clamp_(min=DEN_EPS)
    num = ts.tiled_spmm_multihead(tf, x3, p, H, Fh)
    return num / den.unsqueeze(-1), p, den


def egatc_backward(tf: ts.TiledFormat, fni3, fnj3, fe_slot, attn, x3, p_slot,
                   den, out, dZ, slope: float):
    """EGATConv v1 backward (``_egatc_bwd`` :1147): (dFNI (num_src, H, De),
    dFNJ (num_dst, H, De), dFE (B, C, H * De) in ``fe_slot``'s dtype, dattn
    (H, De), dx (num_src, H, Fh)), with ds = (<x[src], zn[dst]> - rp[dst])
    * p and dFE = dW per slot; dFNJ and dFNI are dFE's sums per dst and per
    src node.  ``tf`` needs ``src_order``."""
    zn, rp = _scales(out, dZ, den)
    ds = gat_ds(tf, x3, zn, rp, p_slot)
    da, dfe = egatc_slot_grad(tf, fni3, fnj3, attn, fe_slot, ds, slope)
    del ds
    heads, dim = fni3.shape[1], fni3.shape[2]
    dv = slot_vec_reduce(tf, dfe, "dst").view(tf.num_dst, heads, dim)
    du = slot_vec_reduce(tf, dfe, "src").view(tf.num_src, heads, dim)
    dx = src_aggregate(tf, zn, p_slot)
    return du, dv, dfe, da, dx


def edgegat_forward(tf: ts.TiledFormat, el2, er2, ee_slot, fe_slot, x3,
                    H: int, Fh: int, slope: float):
    """EdgeGAT v1 forward (``edgegat_forward`` :1345): (out (num_dst, H,
    Fh), p_slot, g_slot, den (num_dst, H)), ``den`` clamped at 1e-20; raw =
    el2[src] + er2[dst] + ee_slot, and each slot's message is x3[src] plus
    its stored ``fe_slot`` (B, C, H * Fh) row."""
    p, g = gat_scores(tf, el2, er2, slope, ee_slot)
    den = slot_reduce(tf, p, "dst").clamp_(min=DEN_EPS)
    num = fe_aggregate(tf, x3, fe_slot, p)
    return num / den.unsqueeze(-1), p, g, den


def edgegat_backward(tf: ts.TiledFormat, x3, fe_slot, p_slot, g_slot, den,
                     out, dZ, H: int, Fh: int):
    """EdgeGAT v1 backward (``edgegat_backward`` :1408): (del (num_src, H),
    der (num_dst, H), ds_slot (B, H, C) = dee, dfe (B, C, H * Fh) in
    ``fe_slot``'s dtype, dx (num_src, H, Fh)), with ds = (<x[src] + fe,
    zn[dst]> - rp[dst]) * g and dfe = p zn[dst] per slot.  ``tf`` needs
    ``src_order``."""
    zn, rp = _scales(out, dZ, den)
    ds = fe_ds(tf, x3, fe_slot, zn, rp, g_slot)
    der = slot_reduce(tf, ds, "dst")
    dl = slot_reduce(tf, ds, "src")
    dx, dfe = dx_dfe(tf, zn, p_slot, fe_slot.dtype)
    return dl, der, ds, dfe, dx


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


class _VectorAttention(torch.autograd.Function):
    """GATv2 and EGATConv v2: forward by the vector scores, the slot reduce
    and K4's SpMM; backward by ds (g = p), the slot gradient, the node
    gradient on both sides and the src-side aggregation.  p is saved, and
    raw is recomputed in every backward pass."""

    @staticmethod
    def forward(ctx, U3, V3, ef_slot, wf, attn, x3, tf, H, Fh, slope):
        out, p, den = vattn_forward(tf, U3, V3, x3, attn, H, Fh, slope,
                                    ef_slot, wf)
        ctx.save_for_backward(U3, V3, ef_slot, wf, attn, x3, p, den, out)
        ctx.tf, ctx.slope = tf, slope
        return out

    @staticmethod
    def backward(ctx, dz):
        U3, V3, ef_slot, wf, attn, x3, p, den, out = ctx.saved_tensors
        # at Reddit scale d(ef) is as large as the edge features: only
        # when someone wants it
        dU, dV, dx, da, d_ef, dwf = vattn_backward(
            ctx.tf, U3, V3, x3, attn, p, den, out, dz, ctx.slope, ef_slot,
            wf, need_def=ctx.needs_input_grad[2])
        return (dU.to(U3.dtype), dV.to(V3.dtype),
                None if d_ef is None else d_ef.to(ef_slot.dtype),
                None if dwf is None else dwf.to(wf.dtype), da.to(attn.dtype),
                dx.to(x3.dtype), None, None, None, None)


class _EdgeGatAttention(torch.autograd.Function):
    """EdgeGAT v2: forward by the edge scores, the slot reduce, K4's SpMM
    and the slot-feature reduce; backward by the edge ds, two slot reduces,
    the slot-feature reduce and the src-side aggregation.  p, g and S are
    saved."""

    @staticmethod
    def forward(ctx, el2, er2, ef_slot, We, attn_e, x3, tf, H, Fh, slope):
        out, p, g, den, s = edgegat_v2_forward(tf, el2, er2, ef_slot, We,
                                               attn_e, x3, H, Fh, slope)
        ctx.save_for_backward(ef_slot, We, attn_e, x3, p, g, den, s, out)
        ctx.tf, ctx.H, ctx.Fh = tf, H, Fh
        ctx.dtypes = (el2.dtype, er2.dtype)
        return out

    @staticmethod
    def backward(ctx, dz):
        ef_slot, We, attn_e, x3, p, g, den, s, out = ctx.saved_tensors
        # d(ef) is as large as the edge features: only when someone wants it
        dl, dr, dx, d_ef, dwe, d_attn = edgegat_v2_backward(
            ctx.tf, ef_slot, We, attn_e, x3, p, g, den, s, out, dz, ctx.H,
            ctx.Fh, need_def=ctx.needs_input_grad[2])
        el_t, er_t = ctx.dtypes
        return (dl.to(el_t), dr.to(er_t),
                None if d_ef is None else d_ef.to(ef_slot.dtype),
                dwe.to(We.dtype), d_attn.to(attn_e.dtype), dx.to(x3.dtype),
                None, None, None, None)



class _EgatcAttention(torch.autograd.Function):
    """EGATConv v1: forward by the stored-term scores, the slot reduce and
    K4's SpMM; backward by ds (g = p), the stored-term slot gradient (da
    and dFE), dFE's sums per dst and src node and the src-side
    aggregation.  p is saved."""

    @staticmethod
    def forward(ctx, fni3, fnj3, fe_slot, attn, x3, tf, H, De, Fh, slope):
        out, p, den = egatc_forward(tf, fni3, fnj3, fe_slot, attn, x3, H, De,
                                    Fh, slope)
        ctx.save_for_backward(fni3, fnj3, fe_slot, attn, x3, p, den, out)
        ctx.tf, ctx.slope = tf, slope
        return out

    @staticmethod
    def backward(ctx, dz):
        fni3, fnj3, fe_slot, attn, x3, p, den, out = ctx.saved_tensors
        du, dv, dfe, da, dx = egatc_backward(ctx.tf, fni3, fnj3, fe_slot,
                                             attn, x3, p, den, out, dz,
                                             ctx.slope)
        return (du.to(fni3.dtype), dv.to(fnj3.dtype), dfe, da.to(attn.dtype),
                dx.to(x3.dtype), None, None, None, None, None)


class _EdgeGatV1Attention(torch.autograd.Function):
    """EdgeGAT v1: forward by K6's scores with the slot bias, the slot
    reduce and the stored-message numerator; backward by the stored-message
    ds, two slot reduces and dx with dfe.  p and g are saved."""

    @staticmethod
    def forward(ctx, el2, er2, ee_slot, fe_slot, x3, tf, H, Fh, slope):
        out, p, g, den = edgegat_forward(tf, el2, er2, ee_slot, fe_slot, x3,
                                         H, Fh, slope)
        ctx.save_for_backward(x3, fe_slot, p, g, den, out)
        ctx.tf, ctx.H, ctx.Fh = tf, H, Fh
        ctx.dtypes = (el2.dtype, er2.dtype, ee_slot.dtype)
        return out

    @staticmethod
    def backward(ctx, dz):
        x3, fe_slot, p, g, den, out = ctx.saved_tensors
        dl, dr, ds, dfe, dx = edgegat_backward(ctx.tf, x3, fe_slot, p, g, den,
                                               out, dz, ctx.H, ctx.Fh)
        el_t, er_t, ee_t = ctx.dtypes
        return (dl.to(el_t), dr.to(er_t), ds.to(ee_t), dfe, dx.to(x3.dtype),
                None, None, None, None)


def _check_dims(what, t, heads, dim):
    if t.ndim != 3 or tuple(t.shape[1:]) != (heads, dim):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, not (N, {heads},"
                         f" {dim})")


def gatv2_attention_aggregate(tf: ts.TiledFormat, U3, V3, x3, attn, H: int,
                              D: int, Fh: int, negative_slope: float):
    """Fused GATv2 attention + aggregation (``gat_fused.py:943``): e =
    attn . lrelu(U3[src] + V3[dst]) per head, softmax over each dst under
    the +-40 clip, out[dst] = sum a x3[src].  ``tf``: the forward tiled
    format with ``src_order``; ``U3`` (N_src, H, D), ``V3`` (N_dst, H, D),
    ``x3`` (N_src, H, Fh), ``attn`` (H, D).  Returns (N_dst, H, Fh) f32,
    differentiable in U3, V3, x3 and attn."""
    _require_src_first(tf)
    _check_dims("U3", U3, H, D)
    return _VectorAttention.apply(U3, V3, None, None, attn, x3, tf, int(H),
                                  int(Fh), float(negative_slope))


def egatconv_attention_aggregate_v2(tf: ts.TiledFormat, fni3, fnj3, ef_slot,
                                    wf, attn, x3, H: int, De: int, Fh: int,
                                    negative_slope: float):
    """Fused EGATConv attention + aggregation with the edge transform in
    the kernels (``gat_fused.py:2259``): e = attn . lrelu(fni3[src] +
    fnj3[dst] + ef_slot . wf), the bias riding as wf's last row when wf has
    Fe + 1 rows.  ``ef_slot`` (B, C, Fe) slot-order edge features
    (:func:`slot_edge_tensor`), ``wf`` (Fe or Fe + 1, H * De), ``attn``
    (H, De), ``x3`` (N_src, H, Fh).  Differentiable in fni3, fnj3, ef_slot,
    wf, attn and x3; nothing (B, C, H * De)-sized is stored."""
    _require_src_first(tf)
    _check_dims("fni3", fni3, H, De)
    return _VectorAttention.apply(fni3, fnj3, ef_slot, wf, attn, x3, tf,
                                  int(H), int(Fh), float(negative_slope))


def edgegat_attention_aggregate_v2(tf: ts.TiledFormat, el2, er2, ef_slot, We,
                                   attn_e, x3, H: int, Fh: int,
                                   negative_slope: float):
    """Fused EdgeGATConv attention + aggregation with the edge transform
    folded into the kernels (``gat_fused.py:1901``): per slot of an edge
    u -> v and head h, fe = ef_slot[b, c] . We_h, raw = el2[u] + er2[v] +
    <attn_e[h], fe>, p = exp(clip(lrelu(raw), +-40)) and out[v] = sum p
    (x3[u] + fe) / max(sum p, 1e-20).  ``tf``: the forward tiled format
    with ``src_order``; ``ef_slot`` (B, C, Fe) slot-order edge features
    (:func:`slot_edge_tensor`), ``We`` (Fe, H * Fh), ``attn_e`` (H, Fh),
    ``x3`` (N_src, H, Fh).  Returns (N_dst, H, Fh) f32, differentiable in
    el2, er2, ef_slot, We, attn_e and x3; nothing (B, C, H * Fh)-sized is
    formed."""
    _require_src_first(tf)
    _check_dims("x3", x3, H, Fh)
    fe = _check_edge(tf, ef_slot)
    if tuple(We.shape) != (fe, H * Fh) or tuple(attn_e.shape) != (H, Fh):
        raise ValueError(f"We {tuple(We.shape)} or attn_e "
                         f"{tuple(attn_e.shape)} do not match Fe={fe}, "
                         f"H={H}, Fh={Fh}")
    return _EdgeGatAttention.apply(el2, er2, ef_slot, We, attn_e, x3, tf,
                                   int(H), int(Fh), float(negative_slope))



def egatconv_attention_aggregate(tf: ts.TiledFormat, fni3, fnj3, fe_slot,
                                 attn, x3, H: int, De: int, Fh: int,
                                 negative_slope: float):
    """Fused EGATConv attention + aggregation with the edge term stored per
    slot (``gat_fused.py:1253``): e = attn . lrelu(fni3[src] + fnj3[dst] +
    fe_slot[b, c]) per head, softmax over each dst under the +-40 clip,
    out[dst] = sum a x3[src] / max(sum a, 1e-20).  ``tf``: the forward
    tiled format with ``src_order``; ``fni3`` (N_src, H, De), ``fnj3``
    (N_dst, H, De), ``fe_slot`` (B, C, H * De) f32 or bf16 in slot order
    (:func:`slot_edge_tensor`; no lane padding), ``attn`` (H, De), ``x3``
    (N_src, H, Fh).  Returns (N_dst, H, Fh) f32, differentiable in fni3,
    fnj3, fe_slot (its gradient in its dtype, 0 at padded slots), attn and
    x3."""
    _require_src_first(tf)
    _check_dims("fni3", fni3, H, De)
    _check_dims("x3", x3, H, Fh)
    _check_stored(tf, fe_slot, H * De, "fe_slot")
    return _EgatcAttention.apply(fni3, fnj3, fe_slot, attn, x3, tf, int(H),
                                 int(De), int(Fh), float(negative_slope))


def edgegat_attention_aggregate(tf: ts.TiledFormat, el2, er2, ee_slot,
                                fe_slot, x3, H: int, Fh: int,
                                negative_slope: float):
    """Fused EdgeGATConv attention + aggregation with the edge terms stored
    per slot (``gat_fused.py:1524``): raw = el2[src] + er2[dst] +
    ee_slot[b, h, c], p = exp(clip(lrelu(raw), +-40)) and out[dst] = sum p
    (x3[src] + fe_slot[b, c, h]) / max(sum p, 1e-20).  ``tf``: the forward
    tiled format with ``src_order``; ``ee_slot`` (B, H, C), ``fe_slot`` (B,
    C, H * Fh) f32 or bf16 in slot order (no lane padding), ``x3`` (N_src,
    H, Fh).  Returns (N_dst, H, Fh) f32, differentiable in el2, er2, ee_slot
    (its gradient is ds), fe_slot (its gradient in its dtype) and x3."""
    _require_src_first(tf)
    _check_dims("x3", x3, H, Fh)
    _check_slots(tf, ee_slot, H, "ee_slot")
    _check_stored(tf, fe_slot, H * Fh, "fe_slot")
    return _EdgeGatV1Attention.apply(el2, er2, ee_slot, fe_slot, x3, tf,
                                     int(H), int(Fh), float(negative_slope))


# (E, Fe) edge features in slot order, beside the kernels that read them
slot_edge_tensor = ts.slot_edge_tensor
unslot_edge_tensor = ts.unslot_edge_tensor


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
