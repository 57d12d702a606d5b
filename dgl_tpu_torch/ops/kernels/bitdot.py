"""Bit-masked dot-product attention over the bitmask format (K7).

Counterpart of ``dgl_tpu/ops/pallas/bitdot.py``: DotGat's attention,
where the projected src features z serve as both key and value.  For
every edge s -> d of the bitmask and every head h, with q (N_dst, H, D),
z (N_src, H, D) and isd = 1 / sqrt(D):

    e = (z[s, h] . q[d, h]) * isd,   p = exp(clip(e, -40, 40))
    l[d, h]      = sum_s p
    out[d, h, :] = sum_s p * z[s, h, :] / max(l, 1e-20)

Numerics contract of the JAX package (``bitdot.py:34-38``): no per-dst
max pass; the clip at +-40 keeps exp finite, its gradient is 0 at
saturated scores, and a dst with no in-edge gets 0.  The backward, given
g = dL/dout, linv = 1 / max(l, 1e-20) and rho = sum_c g * out:

    alpha = p * linv[d],   u = g[d, h] . z[s, h],   de = alpha * (u - rho[d])
    draw  = isd * de where -40 < e < 40, else 0
    dz[s] += draw * q[d] + alpha * g[d]       (dK and dV in one sum)
    dq[d] += draw * z[s]

Three kernels (``csrc/bitdot.cu``), each with a plain PyTorch version
beside it that computes the same function from the same inputs:

* :func:`bitdot_fwd` (``_fwd_call``): out and l from ``packed`` (rows =
  dst), by the listed walk by dst (``bitdot_fwd_list_kernel``: the dq
  walk's lanes, layout and rows, claimed in ``bitgat.fwd_claim_order``);
* :func:`bitdot_bwd_dz` (``_bwdA_call``): dz from ``packed_rev`` (rows =
  src), by the listed walk by src (``bitdot_dz_list_kernel``: K5's
  backward's walk, its rows claimed in ``bitgat.bwd_claim_order``, a group
  of lanes an entry at :func:`dz_layout`, K5's layout);
* :func:`bitdot_bwd_dq` (``_bwdB_call``): dq from ``packed`` (rows =
  dst), by the listed walk by dst (``bitdot_dq_list_kernel``: the dz
  walk's lanes and layout over the other packing, its rows claimed in
  ``bitgat.fwd_claim_order``).

The plain versions list the set bits of a block of rows as edges
(``bitgat.bit_edges``, ``bitgat.PLAIN_WORDS`` words at a time, so no call
holds an (E, H, D) tensor) and compute the formulas above with gathers
and ``index_add_``.  A wrapper launches its kernel on CUDA tensors and
raises if the build or the launch fails; it takes the plain version only
for CPU tensors.  Each wrapper counts its launches in its ``launches``
attribute.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .bitgat import (DEN_EPS, _pad_heads, backward_scales, bit_edges,
                     bwd_claim_order, claim_order, fwd_claim_order,
                     list_layout)
from .bitmm import BitFormat
from .dispatch import on_cuda

CLIP = 40.0    # score clip before exp
MAX_HD = 128   # H * D: 4 columns per lane of one warp


def _scores(z_src, q_dst, isd: float):
    """(e, p) of a block of edges: (E, H) f32 scores and exp(clip(e))."""
    e = (z_src * q_dst).sum(-1) * isd
    return e, torch.exp(e.clamp(-CLIP, CLIP))


def _edge_grads(z_src, q_dst, g_dst, linv_dst, rho_dst, isd: float):
    """(alpha, draw) of a block of edges, (E, H) each."""
    e, p = _scores(z_src, q_dst, isd)
    alpha = p * linv_dst
    de = alpha * ((g_dst * z_src).sum(-1) - rho_dst)
    draw = torch.where((e > -CLIP) & (e < CLIP), de * isd,
                       torch.zeros_like(de))
    return alpha, draw


# -- the plain PyTorch versions ---------------------------------------------

def bitdot_fwd_plain(packed, q, z, isd: float):
    """K7 forward's function from ``packed`` (rows = dst): out (N_dst, H,
    D) and l (N_dst, H), both f32."""
    q, z = q.float(), z.float()
    num_dst = q.shape[0]
    l = q.new_zeros(q.shape[:2])
    num = torch.zeros_like(q)
    for dst, src in bit_edges(packed, num_dst):
        zs = z[src]
        p = _scores(zs, q[dst], isd)[1]
        l.index_add_(0, dst, p)
        num.index_add_(0, dst, p.unsqueeze(-1) * zs)
    return num / l.clamp(min=DEN_EPS).unsqueeze(-1), l


def bitdot_bwd_dz_plain(packed_rev, q, z, g, linv, rho, isd: float):
    """K7's dz from ``packed_rev`` (rows = src): (N_src, H, D) f32,
    sum over each src's edges of draw * q[d] + alpha * g[d]."""
    q, z, g = q.float(), z.float(), g.float()
    dz = torch.zeros_like(z)
    for src, dst in bit_edges(packed_rev, z.shape[0]):
        qd, gd = q[dst], g[dst]
        alpha, draw = _edge_grads(z[src], qd, gd, linv[dst], rho[dst], isd)
        dz.index_add_(0, src, draw.unsqueeze(-1) * qd
                      + alpha.unsqueeze(-1) * gd)
    return dz


def bitdot_bwd_dq_plain(packed, q, z, g, linv, rho, isd: float):
    """K7's dq from ``packed`` (rows = dst): (N_dst, H, D) f32, sum over
    each dst's edges of draw * z[s]."""
    q, z, g = q.float(), z.float(), g.float()
    dq = torch.zeros_like(q)
    for dst, src in bit_edges(packed, q.shape[0]):
        zs = z[src]
        draw = _edge_grads(zs, q[dst], g[dst], linv[dst], rho[dst], isd)[1]
        dq.index_add_(0, dst, draw.unsqueeze(-1) * zs)
    return dq


# -- the kernel wrappers ------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    "dgl_bitdot_fwd_list": [_P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I, _F,
                            _P, _P, _P, _I, _P],
    "dgl_bitdot_bwd_dz_list": [_P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I,
                               _I, _I, _F, _P, _P, _I, _P],
    "dgl_bitdot_bwd_dq_list": [_P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I,
                               _I, _I, _F, _P, _P, _I, _P],
    "dgl_bitdot_dz_attrs": [_I, _I, _I, _P],
    "dgl_bitdot_dq_attrs": [_I, _I, _I, _P],
    "dgl_bitdot_fwd_attrs": [_I, _I, _I, _P],
}


def _check(packed, q, z, num_rows, num_cols):
    """q (N_dst, H, D) and z (N_src, H, D) agree, H * D <= MAX_HD, and the
    packing holds ``num_rows`` rows and ``num_cols`` bit columns."""
    if packed.dtype != torch.int32 or packed.ndim != 2:
        raise ValueError("packed must be a 2-D int32 tensor")
    if q.ndim != 3 or z.ndim != 3 or q.shape[1:] != z.shape[1:]:
        raise ValueError(f"q {tuple(q.shape)} and z {tuple(z.shape)} must "
                         f"be (N, H, D) with the same H and D")
    if z.shape[1] * z.shape[2] > MAX_HD:
        raise ValueError(f"bitdot takes H * D <= {MAX_HD}, got "
                         f"{z.shape[1]} x {z.shape[2]}")
    if packed.shape[0] < num_rows or packed.shape[1] * 32 < num_cols:
        raise ValueError(f"the packing {tuple(packed.shape)} is too small "
                         f"for {num_rows} rows and {num_cols} columns")


def _check_bwd(q, g, linv, rho):
    if g.shape != q.shape or linv.shape != q.shape[:2] or \
            rho.shape != q.shape[:2]:
        raise ValueError(f"g {tuple(g.shape)}, linv {tuple(linv.shape)} or "
                         f"rho {tuple(rho.shape)} do not match q "
                         f"{tuple(q.shape)}")


def _stream(t):
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def _aligned(t):
    """``t``, or a copy of it, whose data starts on a 16-byte boundary."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_fwd(packed, q, z, isd: float, order=None, layout=None, fn=None):
    """Launch K7's forward kernel, the listed walk by dst, on CUDA
    operands: (out (N_dst, H, D), l (N_dst, H)) f32.  ``order``: the dst
    rows' claim order (``bitgat.claim_order`` of the packing's first N_dst
    rows, built here when None); ``layout``: (dp, lpe, cpl),
    :func:`dz_layout` when None; ``fn``: the C function, the package's
    ``dgl_bitdot_fwd_list`` when None (a probe passes an edit's)."""
    rows, (heads, dim) = q.shape[0], z.shape[1:]
    num_src, dev = z.shape[0], q.device
    out = torch.empty(q.shape, dtype=torch.float32, device=dev)
    l = torch.empty(q.shape[:2], dtype=torch.float32, device=dev)
    if rows == 0 or heads * dim == 0:
        return out.zero_(), l.zero_()
    if rows >= 2**31 or num_src >= 2**31:
        raise ValueError("the listed walk takes fewer than 2^31 nodes")
    if order is None:
        order = claim_order(packed, rows)
    if order.shape != (rows,) or order.dtype != torch.int32:
        raise ValueError(f"order must be ({rows},) int32")
    dp, lpe, cpl = dz_layout(heads, dim) if layout is None else layout
    qp, zp = (_aligned(_pad_heads(t, dp)) for t in (q, z))
    packed = packed.contiguous()
    wide = out if dp == dim else torch.empty(rows, heads, dp,
                                             dtype=torch.float32, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    if fn is None:
        fn = build.load("bitdot", _SIGNATURES).dgl_bitdot_fwd_list
    err = fn(packed.data_ptr(), packed.shape[1], order.data_ptr(), rows,
             num_src, qp.data_ptr(), zp.data_ptr(), heads, dp, lpe, cpl, isd,
             wide.data_ptr(), l.data_ptr(), counter.data_ptr(), *_stream(q))
    if err != 0:
        raise RuntimeError(f"the forward walk failed to launch: CUDA error "
                           f"{err}")
    if wide is not out:
        out.copy_(wide[..., :dim])
    return out, l


def bitdot_fwd(packed, q, z, isd: float, order=None):
    """K7 forward: (out (N_dst, H, D), l (N_dst, H)) f32 from ``packed``,
    the bits of A (rows = dst).  ``order``: the dst rows' claim order
    (``bitgat.fwd_claim_order`` of the format; built anew for each call
    when None)."""
    num_dst, num_src = q.shape[0], z.shape[0]
    _check(packed, q, z, num_dst, num_src)
    if not on_cuda(packed, q, z):
        return bitdot_fwd_plain(packed, q, z, isd)
    out, l = launch_fwd(packed, q, z, isd, order)
    if num_dst and q.shape[1] * q.shape[2]:
        bitdot_fwd.launches += 1
    return out, l


bitdot_fwd.launches = 0


def _nvec(linv, rho):
    """(N_dst, 2, H) f32: one row per dst, linv and rho on a cache line."""
    return torch.stack([linv.float(), rho.float()], 1)


def dz_layout(heads: int, dim: int, lanes=None):
    """(dp, lpe, cpl) of the dz and dq walks: ``bitgat.list_layout``'s
    (heads padded to whole 16-byte vectors, a power of two of them a head
    where H > 1; lanes an entry leaving a lane at most 4 vectors with one
    head, 2 with several), or at ``lanes`` lanes an entry where given."""
    if lanes is None:
        return list_layout(heads, dim)
    dp = list_layout(heads, dim)[0]
    return dp, lanes, -(-(heads * dp // 4) // lanes)


def _walk_attrs(fn: str, heads: int, dim: int, lanes, device):
    cpl = dz_layout(heads, dim, lanes)[2]
    device = torch.device("cuda") if device is None else torch.device(device)
    out = (ctypes.c_int * 3)()
    lib = build.load("bitdot", _SIGNATURES)
    err = getattr(lib, fn)(cpl, int(heads == 1), device.index or 0,
                           ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err}")
    return out[0], out[1], out[2] * 8


def dz_kernel_attrs(heads: int, dim: int, lanes=None, device=None):
    """(registers a thread, local memory bytes a thread, resident warps an
    SM) of the dz walk's instance for ``heads`` x ``dim`` (at ``lanes``
    lanes an entry where given), from ``cudaFuncGetAttributes`` and the
    occupancy calculator."""
    return _walk_attrs("dgl_bitdot_dz_attrs", heads, dim, lanes, device)


def dq_kernel_attrs(heads: int, dim: int, lanes=None, device=None):
    """The same of the dq walk's instance."""
    return _walk_attrs("dgl_bitdot_dq_attrs", heads, dim, lanes, device)


def fwd_kernel_attrs(heads: int, dim: int, lanes=None, device=None):
    """The same of the forward's instance."""
    return _walk_attrs("dgl_bitdot_fwd_attrs", heads, dim, lanes, device)


def _launch_walk(fn, what, packed, q, z, g, linv, rho, isd: float, rows,
                 num_cols, order, layout):
    """One listed walk over the first ``rows`` rows of ``packed``, the
    entries its bit columns below ``num_cols``: (rows, H, D) f32.  The
    two walks take one argument list (q, z, g and nvec as the formulas
    name them, whichever side the rows are)."""
    heads, dim = z.shape[1:]
    dev = z.device
    if rows == 0 or heads * dim == 0:
        return torch.zeros(rows, heads, dim, dtype=torch.float32, device=dev)
    if rows >= 2**31 or num_cols >= 2**31:
        raise ValueError("the listed walk takes fewer than 2^31 nodes")
    if order is None:
        order = claim_order(packed, rows)
    if order.shape != (rows,) or order.dtype != torch.int32:
        raise ValueError(f"order must be ({rows},) int32")
    dp, lpe, cpl = dz_layout(heads, dim) if layout is None else layout
    qp, zp, gp = (_pad_heads(t, dp) for t in (q, z, g))
    nvec = _nvec(linv, rho)
    packed = packed.contiguous()
    out = torch.empty(rows, heads, dp, dtype=torch.float32, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    if not callable(fn):
        fn = getattr(build.load("bitdot", _SIGNATURES), fn)
    err = fn(packed.data_ptr(), packed.shape[1], order.data_ptr(), rows,
             num_cols, qp.data_ptr(), zp.data_ptr(), gp.data_ptr(),
             nvec.data_ptr(), heads, dp, lpe, cpl, isd, out.data_ptr(),
             counter.data_ptr(), dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"the {what} walk failed to launch: CUDA error "
                           f"{err}")
    return out if dp == dim else out[..., :dim].contiguous()


def launch_dz(packed_rev, q, z, g, linv, rho, isd: float, order=None,
              layout=None, fn=None):
    """Launch K7's dz kernel, the listed walk by src, on CUDA operands: dz
    (N_src, H, D) f32.  ``order``: the src rows' claim order
    (``bitgat.claim_order`` of the packing's first N_src rows, built here
    when None); ``layout``: (dp, lpe, cpl), :func:`dz_layout` when None;
    ``fn``: the C function, the package's ``dgl_bitdot_bwd_dz_list`` when
    None (a probe passes an edit's)."""
    return _launch_walk(fn or "dgl_bitdot_bwd_dz_list", "dz", packed_rev, q,
                        z, g, linv, rho, isd, z.shape[0], q.shape[0], order,
                        layout)


def launch_dq(packed, q, z, g, linv, rho, isd: float, order=None,
              layout=None, fn=None):
    """Launch K7's dq kernel, the listed walk by dst, on CUDA operands: dq
    (N_dst, H, D) f32.  ``order``: the dst rows' claim order
    (``bitgat.claim_order`` of the packing's first N_dst rows, built here
    when None); ``layout`` and ``fn`` (``dgl_bitdot_bwd_dq_list`` when
    None) as :func:`launch_dz`'s."""
    return _launch_walk(fn or "dgl_bitdot_bwd_dq_list", "dq", packed, q, z,
                        g, linv, rho, isd, q.shape[0], z.shape[0], order,
                        layout)


def bitdot_bwd_dz(packed_rev, q, z, g, linv, rho, isd: float, order=None):
    """K7's dz (N_src, H, D) f32 from ``packed_rev``, the bits of A^T
    (rows = src).  ``order``: the src rows' claim order
    (``bitgat.bwd_claim_order`` of the format; built anew for each call
    when None)."""
    _check(packed_rev, q, z, z.shape[0], q.shape[0])
    _check_bwd(q, g, linv, rho)
    if not on_cuda(packed_rev, q, z, g, linv, rho):
        return bitdot_bwd_dz_plain(packed_rev, q, z, g, linv, rho, isd)
    dz = launch_dz(packed_rev, q, z, g, linv, rho, isd, order)
    if z.shape[0] and z.shape[1] * z.shape[2]:
        bitdot_bwd_dz.launches += 1
    return dz


bitdot_bwd_dz.launches = 0


def bitdot_bwd_dq(packed, q, z, g, linv, rho, isd: float, order=None):
    """K7's dq (N_dst, H, D) f32 from ``packed``, the bits of A (rows =
    dst).  ``order``: the dst rows' claim order
    (``bitgat.fwd_claim_order`` of the format; built anew for each call
    when None)."""
    _check(packed, q, z, q.shape[0], z.shape[0])
    _check_bwd(q, g, linv, rho)
    if not on_cuda(packed, q, z, g, linv, rho):
        return bitdot_bwd_dq_plain(packed, q, z, g, linv, rho, isd)
    dq = launch_dq(packed, q, z, g, linv, rho, isd, order)
    if q.shape[0] and q.shape[1] * q.shape[2]:
        bitdot_bwd_dq.launches += 1
    return dq


bitdot_bwd_dq.launches = 0


# -- the differentiable op ---------------------------------------------------

class _BitDot(torch.autograd.Function):
    """Forward by K7's forward kernel; backward by its dz and dq kernels,
    which recompute p from q and z (nothing edge-shaped is stored); each
    walk claims its rows in the format's kept order."""

    @staticmethod
    def forward(ctx, q, z, bf, isd):
        # the plain version on the CPU needs no claim order
        order = fwd_claim_order(bf) if q.is_cuda else None
        out, l = bitdot_fwd(bf.packed, q, z, isd, order)
        ctx.save_for_backward(q, z, out, l)
        ctx.bf, ctx.isd = bf, isd
        return out

    @staticmethod
    def backward(ctx, g):
        q, z, out, l = ctx.saved_tensors
        g = g.float()
        linv, rho = backward_scales(g, out, l, None)
        bf, isd = ctx.bf, ctx.isd
        dq = dz = None
        # the plain versions on the CPU need no claim order
        if ctx.needs_input_grad[1]:
            order = bwd_claim_order(bf) if g.is_cuda else None
            dz = bitdot_bwd_dz(bf.packed_rev, q, z, g, linv, rho, isd,
                               order).to(z.dtype)
        if ctx.needs_input_grad[0]:
            order = fwd_claim_order(bf) if g.is_cuda else None
            dq = bitdot_bwd_dq(bf.packed, q, z, g, linv, rho, isd,
                               order).to(q.dtype)
        return dq, dz, None, None


def bitdot_attention_aggregate(bf: BitFormat, q, z):
    """DotGat attention + aggregation over the bitmask format.

    ``q`` (N_dst, H, D) projected destination features and ``z`` (N_src,
    H, D) projected source features, serving as both key and value ->
    (N_dst, H, D) f32, softmax((z . q) / sqrt(D))-weighted sums of z,
    differentiable in q and z.

    Requires a simple graph (``bf.rem_src`` empty): multi-edges cannot
    ride the bitmask's COO remainder through a softmax.
    """
    if bf.rem_src.shape[0]:
        raise ValueError(
            "bitdot requires a simple graph (BitFormat has a multi-edge "
            "remainder); use the slot-space or gather attention path")
    if q.shape[0] != bf.num_dst or z.shape[0] != bf.num_src:
        raise ValueError(f"q {tuple(q.shape)} and z {tuple(z.shape)} do not "
                         f"match the bit format's {bf.num_dst} dst and "
                         f"{bf.num_src} src nodes")
    return _BitDot.apply(q, z, bf, 1.0 / math.sqrt(z.shape[2]))
