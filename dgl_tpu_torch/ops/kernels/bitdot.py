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
  dst);
* :func:`bitdot_bwd_dz` (``_bwdA_call``): dz from ``packed_rev`` (rows =
  src);
* :func:`bitdot_bwd_dq` (``_bwdB_call``): dq from ``packed``.

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
from .bitgat import DEN_EPS, backward_scales, bit_edges
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
_BWD = [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _F, _P, _I, _P]
_SIGNATURES = {
    "dgl_bitdot_fwd": [_P, _I, _I, _I, _P, _P, _I, _I, _F, _P, _P, _I, _P],
    "dgl_bitdot_bwd_dz": _BWD,
    "dgl_bitdot_bwd_dq": _BWD,
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


def _launch(fn: str, *args):
    lib = build.load("bitdot", _SIGNATURES)
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {err}")


def _f32(t):
    return t.float().contiguous()


def _stream(t):
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def bitdot_fwd(packed, q, z, isd: float):
    """K7 forward: (out (N_dst, H, D), l (N_dst, H)) f32 from ``packed``,
    the bits of A (rows = dst)."""
    num_dst, num_src = q.shape[0], z.shape[0]
    _check(packed, q, z, num_dst, num_src)
    if not on_cuda(packed, q, z):
        return bitdot_fwd_plain(packed, q, z, isd)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    l = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    if num_dst == 0 or q.shape[1] * q.shape[2] == 0:
        return out.zero_(), l.zero_()
    q, z, packed = _f32(q), _f32(z), packed.contiguous()
    _launch("dgl_bitdot_fwd", packed.data_ptr(), packed.shape[1], num_src,
            num_dst, q.data_ptr(), z.data_ptr(), q.shape[1], q.shape[2],
            isd, out.data_ptr(), l.data_ptr(), *_stream(q))
    bitdot_fwd.launches += 1
    return out, l


bitdot_fwd.launches = 0


def _bwd(fn, packed, q, z, g, linv, rho, isd, out_like):
    """Launch one backward kernel into a new tensor shaped ``out_like``."""
    out = torch.empty(out_like.shape, dtype=torch.float32,
                      device=out_like.device)
    if out.numel() == 0:
        return out
    # one (N_dst, 2, H) row per dst: linv and rho share a cache line
    nvec = torch.stack([linv.float(), rho.float()], 1)
    q, z, g, packed = _f32(q), _f32(z), _f32(g), packed.contiguous()
    _launch(fn, packed.data_ptr(), packed.shape[1], z.shape[0], q.shape[0],
            q.data_ptr(), z.data_ptr(), g.data_ptr(), nvec.data_ptr(),
            q.shape[1], q.shape[2], isd, out.data_ptr(), *_stream(q))
    return out


def bitdot_bwd_dz(packed_rev, q, z, g, linv, rho, isd: float):
    """K7's dz (N_src, H, D) f32 from ``packed_rev``, the bits of A^T
    (rows = src)."""
    _check(packed_rev, q, z, z.shape[0], q.shape[0])
    _check_bwd(q, g, linv, rho)
    if not on_cuda(packed_rev, q, z, g, linv, rho):
        return bitdot_bwd_dz_plain(packed_rev, q, z, g, linv, rho, isd)
    dz = _bwd("dgl_bitdot_bwd_dz", packed_rev, q, z, g, linv, rho, isd, z)
    bitdot_bwd_dz.launches += 1
    return dz


bitdot_bwd_dz.launches = 0


def bitdot_bwd_dq(packed, q, z, g, linv, rho, isd: float):
    """K7's dq (N_dst, H, D) f32 from ``packed``, the bits of A (rows =
    dst)."""
    _check(packed, q, z, q.shape[0], z.shape[0])
    _check_bwd(q, g, linv, rho)
    if not on_cuda(packed, q, z, g, linv, rho):
        return bitdot_bwd_dq_plain(packed, q, z, g, linv, rho, isd)
    dq = _bwd("dgl_bitdot_bwd_dq", packed, q, z, g, linv, rho, isd, q)
    bitdot_bwd_dq.launches += 1
    return dq


bitdot_bwd_dq.launches = 0


# -- the differentiable op ---------------------------------------------------

class _BitDot(torch.autograd.Function):
    """Forward by K7's forward kernel; backward by its dz and dq kernels,
    which recompute p from q and z (nothing edge-shaped is stored)."""

    @staticmethod
    def forward(ctx, q, z, bf, isd):
        out, l = bitdot_fwd(bf.packed, q, z, isd)
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
        if ctx.needs_input_grad[1]:
            dz = bitdot_bwd_dz(bf.packed_rev, q, z, g, linv, rho,
                               isd).to(z.dtype)
        if ctx.needs_input_grad[0]:
            dq = bitdot_bwd_dq(bf.packed, q, z, g, linv, rho,
                               isd).to(q.dtype)
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
