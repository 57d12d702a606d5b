"""Bit-masked GAT attention over the bitmask format (K5).

Counterpart of ``dgl_tpu/ops/pallas/bitgat.py``.  For every edge s -> d
of the bitmask and every head h, with el (N_src, H), er (N_dst, H) and
z (N_src, H, D):

    raw = el[s, h] + er[d, h]
    p   = exp(max(raw, slope * raw))                    (LeakyReLU)
    l[d, h]      = sum_s p                               (all edges)
    out[d, h, :] = sum_s p * keep(s, d, h) * z[s, h, :] / (max(l, 1e-20) kp)

Numerics contract of the JAX package (``bitgat.py:22-29``): no per-dst
max pass; el and er are clipped to +-20 before the kernels, so raw lies
in [-40, 40] and exp cannot overflow in f32; a dst with no in-edge gets
0.  Attention dropout drops the normalized weights: the denominator runs
over all edges, the numerator over the survivors, scaled by 1/kp with
kp = thresh / 2^15, the probability the quantized mask really keeps.

The keep bit is a counter-based hash of the global (src, dst) ids and the
seed, bit for bit the JAX package's (``bitgat.py:144-178``), in 32-bit
wrapping arithmetic:

    x0 = (s * C1) ^ seed ^ (d * C2)
    keep(s, d, h) = ((x0 * M_h) >> 17) < thresh           (unsigned)

Three kernels (``csrc/bitgat.cu``), each with a plain PyTorch version
beside it that computes the same function from the same inputs:

* :func:`bitgat_fwd` (``_fwd_call``): out and l from ``packed`` (rows =
  dst);
* :func:`bitgat_fwd_t` (``_fwd_call`` in its own, src-major orientation):
  out and l from ``packed_t`` (rows = src), without dropout; the
  mesh-sharded GAT (``parallel/bitgat_spmd.py``) runs it on a device's
  column shard of the A^T packing;
* :func:`bitgat_bwd` (``_bwd_call``): the gradients of el, er and z from
  ``packed_rev`` (rows = src), given g = dL/dout,
  linv = 1 / (max(l, 1e-20) kp) and rho = kp * sum_c g * out.

The plain versions list the set bits of a block of rows as edges and
compute the formulas above on them with gathers and ``index_add_``.  A
wrapper launches its kernel on CUDA tensors and raises if the build or
the launch fails; it takes the plain version only for CPU tensors.  Each
wrapper counts its launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .bitmm import BitFormat
from .dispatch import on_cuda

CLIP = 20.0           # per-operand logit clip
DEN_EPS = 1e-20       # denominator clamp
MAX_HD = 128          # H * D: 4 columns per lane of one warp
PLAIN_WORDS = 1 << 23  # bit words a plain version lists at a time

_DROP_RES = 1 << 15
_M32 = 0xFFFFFFFF
_DC1 = 0x9E3779B1
_DC2 = 0x85EBCA6B
_HEAD_MULTS = (0xC2B2AE35, 0x27D4EB2F, 0x165667B1, 0x9E3779B9,
               0x85EBCA77, 0xC2B2AE3D, 0x2545F491, 0x94D049BB)


def drop_thresh(attn_drop: float):
    """Keep threshold for ``attn_drop``: max(1, round((1 - p) 2^15)), or
    None for no dropout."""
    if attn_drop <= 0.0:
        return None
    if not attn_drop < 1.0:
        raise ValueError(f"attn_drop must be in [0, 1), got {attn_drop}")
    return max(1, int(round((1.0 - attn_drop) * _DROP_RES)))


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) and a 32-bit
    constant ``c``, in halves of 16 bits so that no int64 product
    overflows."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _keep(src: torch.Tensor, dst: torch.Tensor, heads: int, seed,
          thresh: int) -> torch.Tensor:
    """(E, heads) bool keep mask of the edges (src, dst), int64 ids."""
    seed = torch.as_tensor(seed, dtype=torch.int64).to(src.device)
    x0 = _mul32(src & _M32, _DC1) ^ (seed & _M32) ^ _mul32(dst & _M32, _DC2)
    return torch.stack([(_mul32(x0, _HEAD_MULTS[h]) >> 17) < thresh
                        for h in range(heads)], dim=-1)


def dropout_keep_reference(src_ids, dst_ids, heads: int, seed,
                           attn_drop: float) -> torch.Tensor:
    """The kernels' mask: (E,) global id arrays -> (E, heads) bool."""
    src = torch.as_tensor(src_ids).to(torch.int64)
    dst = torch.as_tensor(dst_ids).to(device=src.device, dtype=torch.int64)
    thresh = drop_thresh(attn_drop)
    if thresh is None:
        return torch.ones(src.shape + (heads,), dtype=torch.bool,
                          device=src.device)
    if heads > len(_HEAD_MULTS):
        raise ValueError(f"the dropout hash has {len(_HEAD_MULTS)} heads")
    return _keep(src, dst, heads, seed, thresh)


def _keep_prob(thresh) -> float:
    return 1.0 if thresh is None else thresh / _DROP_RES


def backward_scales(g, out, l, thresh):
    """(linv, rho) of the backward from g = dL/dout and the forward's out
    and l: linv = 1 / (max(l, 1e-20) kp) and rho = kp * sum_c g * out.
    rho from the (dropout-)forward output is the softmax VJP's dot for the
    masked weights; alpha rides linv / kp and the rho term rho * kp, so
    the kernel's dropout VJP is a mask of alpha alone."""
    kp = _keep_prob(thresh)
    return 1.0 / l.clamp(min=DEN_EPS) / kp, (g * out).sum(-1) * kp


# -- the plain PyTorch versions ---------------------------------------------

def bit_edges(packed: torch.Tensor, num_rows: int):
    """Yield (row, col) int64 of the set bits of ``packed``'s first
    ``num_rows`` rows, PLAIN_WORDS words at a time: bit b of word j in
    row r is the entry (r, b * N32 + j)."""
    n32 = packed.shape[1]
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    step = max(1, PLAIN_WORDS // max(n32, 1))
    for r0 in range(0, num_rows, step):
        words = packed[r0:min(r0 + step, num_rows)]
        wr, wj = torch.nonzero(words, as_tuple=True)
        bits = (words[wr, wj].unsqueeze(1) >> shifts) & 1
        k, b = torch.nonzero(bits, as_tuple=True)
        yield r0 + wr[k], b.to(torch.int64) * n32 + wj[k]


def _lrelu_exp(raw, slope):
    """exp(lrelu(raw)) in f32, the exponential taken in f64: the first f32
    ``torch.exp`` of a CPU process with several threads sometimes returns
    one thread's share of the elements off by up to 1.5e-4 of their value
    (torch 2.13), and the f64 path does not."""
    return torch.exp(torch.maximum(raw, slope * raw).double()).to(raw.dtype)


def bitgat_fwd_plain(packed, el, er, z, num_dst: int, slope: float,
                     thresh=None, seed=0):
    """K5 forward's function from ``packed`` (rows = dst): out
    (num_dst, H, D) and l (num_dst, H), both f32."""
    heads, dim = z.shape[1], z.shape[2]
    el, er, z = el.float(), er.float(), z.float()
    l = el.new_zeros(num_dst, heads)
    num = el.new_zeros(num_dst, heads, dim)
    for dst, src in bit_edges(packed, num_dst):
        p = _lrelu_exp(el[src] + er[dst], slope)
        l.index_add_(0, dst, p)
        if thresh is not None:
            p = p * _keep(src, dst, heads, seed, thresh)
        num.index_add_(0, dst, p.unsqueeze(-1) * z[src])
    den = l.clamp(min=DEN_EPS) * _keep_prob(thresh)
    return num / den.unsqueeze(-1), l


def bitgat_fwd_t_plain(packed_t, el, er, z, num_dst: int, slope: float):
    """``bitgat_fwd_t``'s function from ``packed_t`` (rows = src): out
    (num_dst, H, D) and l (num_dst, H), both f32, without dropout."""
    heads, dim = z.shape[1], z.shape[2]
    el, er, z = el.float(), er.float(), z.float()
    l = el.new_zeros(num_dst, heads)
    num = el.new_zeros(num_dst, heads, dim)
    for src, dst in bit_edges(packed_t, z.shape[0]):
        p = _lrelu_exp(el[src] + er[dst], slope)
        l.index_add_(0, dst, p)
        num.index_add_(0, dst, p.unsqueeze(-1) * z[src])
    return num / l.clamp(min=DEN_EPS).unsqueeze(-1), l


def bitgat_bwd_plain(packed_rev, el, er, z, g, linv, rho, num_dst: int,
                     slope: float, thresh=None, seed=0):
    """K5 backward's function from ``packed_rev`` (rows = src): (del
    (N_src, H), der (num_dst, H), dz (N_src, H, D)), all f32, by the
    explicit formulas: for every edge and head

        alpha = p * linv[d];  u = g[d] . z[s];  alpha_m = keep ? alpha : 0
        de = alpha_m * u - alpha * rho[d];  draw = raw > 0 ? de : slope de
        dz[s] += alpha_m * g[d];  del[s] += draw;  der[d] += draw
    """
    num_src, heads, _ = z.shape
    el, er, z, g = el.float(), er.float(), z.float(), g.float()
    d_el = el.new_zeros(num_src, heads)
    d_er = el.new_zeros(num_dst, heads)
    dz = torch.zeros_like(z)
    for src, dst in bit_edges(packed_rev, num_src):
        raw = el[src] + er[dst]
        alpha = _lrelu_exp(raw, slope) * linv[dst]
        gd = g[dst]
        u = (gd * z[src]).sum(-1)
        alpha_m = (alpha if thresh is None
                   else alpha * _keep(src, dst, heads, seed, thresh))
        de = alpha_m * u - alpha * rho[dst]
        draw = torch.where(raw > 0, de, slope * de)
        dz.index_add_(0, src, alpha_m.unsqueeze(-1) * gd)
        d_el.index_add_(0, src, draw)
        d_er.index_add_(0, dst, draw)
    return d_el, d_er, dz


# -- the kernel wrappers ------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    "dgl_bitgat_fwd": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _F, _I, _P, _P,
                       _P, _I, _P],
    "dgl_bitgat_bwd": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _F, _I, _P,
                       _P, _P, _P, _I, _P],
    "dgl_bitgat_fwd_t": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _F, _I, _P,
                         _P, _P, _I, _P],
}


def _check(packed, el, er, z, num_rows, num_cols, num_dst):
    """el (N_src, H), er (num_dst, H) and z (N_src, H, D) agree, and the
    packing holds ``num_rows`` rows and ``num_cols`` bit columns."""
    if packed.dtype != torch.int32 or packed.ndim != 2:
        raise ValueError("packed must be a 2-D int32 tensor")
    if z.ndim != 3 or el.shape != z.shape[:2] or \
            er.shape != (num_dst, z.shape[1]):
        raise ValueError(f"shapes do not agree: el {tuple(el.shape)}, er "
                         f"{tuple(er.shape)}, z {tuple(z.shape)}, num_dst "
                         f"{num_dst}")
    if z.shape[1] * z.shape[2] > MAX_HD:
        raise ValueError(f"bitgat takes H * D <= {MAX_HD}, got "
                         f"{z.shape[1]} x {z.shape[2]}")
    if packed.shape[0] < num_rows or packed.shape[1] * 32 < num_cols:
        raise ValueError(f"the packing {tuple(packed.shape)} is too small "
                         f"for {z.shape[0]} src and {num_dst} dst nodes")


def _launch(fn: str, *args):
    lib = build.load("bitgat", _SIGNATURES)
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {err}")


def _f32(t):
    return t.float().contiguous()


def _seed_ptr(seed, device):
    """The seed as a one-element int64 tensor on the card (the kernels
    read its low 32 bits), so a seed drawn on the card is never copied to
    the host."""
    return torch.as_tensor(seed, dtype=torch.int64).to(device).reshape(1)


def bitgat_fwd(packed, el, er, z, num_dst: int, slope: float, thresh=None,
               seed=0):
    """K5 forward: (out (num_dst, H, D), l (num_dst, H)) f32 from
    ``packed``, the bits of A (rows = dst)."""
    num_src = z.shape[0]
    _check(packed, el, er, z, num_dst, num_src, num_dst)
    if not on_cuda(packed, el, er, z):
        return bitgat_fwd_plain(packed, el, er, z, num_dst, slope, thresh,
                                seed)
    heads, dim = z.shape[1], z.shape[2]
    out = torch.empty(num_dst, heads, dim, dtype=torch.float32,
                      device=z.device)
    l = torch.empty(num_dst, heads, dtype=torch.float32, device=z.device)
    if num_dst == 0 or heads * dim == 0:
        return out, l
    el, er, z = _f32(el), _f32(er), _f32(z)
    packed = packed.contiguous()
    seed_t = _seed_ptr(seed, z.device)
    _launch("dgl_bitgat_fwd", packed.data_ptr(), packed.shape[1], num_src,
            num_dst, el.data_ptr(), er.data_ptr(), z.data_ptr(), heads, dim,
            slope, thresh or 0, seed_t.data_ptr(), out.data_ptr(),
            l.data_ptr(), z.device.index,
            torch.cuda.current_stream(z.device).cuda_stream)
    bitgat_fwd.launches += 1
    return out, l


bitgat_fwd.launches = 0


def bitgat_fwd_t(packed_t, el, er, z, num_dst: int, slope: float):
    """K5's forward over the A^T packing: (out (num_dst, H, D), l
    (num_dst, H)) f32 from ``packed_t``, the bits of A^T (rows = the rows
    of el and z, bit columns = dst), without dropout."""
    num_src = z.shape[0]
    _check(packed_t, el, er, z, num_src, num_dst, num_dst)
    if not on_cuda(packed_t, el, er, z):
        return bitgat_fwd_t_plain(packed_t, el, er, z, num_dst, slope)
    heads, dim = z.shape[1], z.shape[2]
    out = torch.zeros(num_dst, heads, dim, dtype=torch.float32,
                      device=z.device)
    l = torch.zeros(num_dst, heads, dtype=torch.float32, device=z.device)
    if num_dst == 0 or num_src == 0 or heads * dim == 0:
        return out, l
    el, er, z = _f32(el), _f32(er), _f32(z)
    packed_t = packed_t.contiguous()
    # the kernel's sums: rows padded to 4 floats, for 16-byte adds
    ostride = -(-heads * dim // 4) * 4
    acc = torch.zeros(num_dst, ostride, dtype=torch.float32, device=z.device)
    _launch("dgl_bitgat_fwd_t", packed_t.data_ptr(), packed_t.shape[1],
            num_src, num_dst, el.data_ptr(), er.data_ptr(), z.data_ptr(),
            heads, dim, slope, ostride, acc.data_ptr(), out.data_ptr(),
            l.data_ptr(), z.device.index,
            torch.cuda.current_stream(z.device).cuda_stream)
    bitgat_fwd_t.launches += 1
    return out, l


bitgat_fwd_t.launches = 0


def check_bwd(packed_rev, el, er, z, g, linv, rho, num_dst: int):
    """The backward's operands agree with each other and the packing."""
    _check(packed_rev, el, er, z, z.shape[0], num_dst, num_dst)
    if g.shape != (num_dst,) + z.shape[1:] or linv.shape != er.shape \
            or rho.shape != er.shape:
        raise ValueError(f"g {tuple(g.shape)}, linv {tuple(linv.shape)} or "
                         f"rho {tuple(rho.shape)} do not match er and z")


def launch_bwd(packed_rev, el, er, z, g, linv, rho, num_dst: int,
               slope: float, thresh=None, seed=0):
    """Launch K5's backward kernel on CUDA operands: (del, der, dz)."""
    num_src, heads, dim = z.shape
    d_el = torch.zeros(num_src, heads, dtype=torch.float32, device=z.device)
    d_er = torch.zeros(num_dst, heads, dtype=torch.float32, device=z.device)
    dz = torch.zeros(num_src, heads, dim, dtype=torch.float32,
                     device=z.device)
    if num_src == 0 or heads * dim == 0:
        return d_el, d_er, dz
    # one (num_dst, 3, H) row per dst: er, linv and rho share a cache line
    nvec = torch.stack([er.float(), linv.float(), rho.float()], 1)
    el, z, g = _f32(el), _f32(z), _f32(g)
    packed_rev = packed_rev.contiguous()
    seed_t = _seed_ptr(seed, z.device)
    _launch("dgl_bitgat_bwd", packed_rev.data_ptr(), packed_rev.shape[1],
            num_src, num_dst, el.data_ptr(), nvec.data_ptr(), z.data_ptr(),
            g.data_ptr(), heads, dim, slope, thresh or 0, seed_t.data_ptr(),
            dz.data_ptr(), d_el.data_ptr(), d_er.data_ptr(), z.device.index,
            torch.cuda.current_stream(z.device).cuda_stream)
    return d_el, d_er, dz


def bitgat_bwd(packed_rev, el, er, z, g, linv, rho, num_dst: int,
               slope: float, thresh=None, seed=0):
    """K5 backward: (del (N_src, H), der (num_dst, H), dz (N_src, H, D))
    f32 from ``packed_rev``, the bits of A^T (rows = src)."""
    check_bwd(packed_rev, el, er, z, g, linv, rho, num_dst)
    if not on_cuda(packed_rev, el, er, z, g, linv, rho):
        return bitgat_bwd_plain(packed_rev, el, er, z, g, linv, rho, num_dst,
                                slope, thresh, seed)
    out = launch_bwd(packed_rev, el, er, z, g, linv, rho, num_dst, slope,
                     thresh, seed)
    if z.shape[0] and z.shape[1] * z.shape[2]:
        bitgat_bwd.launches += 1
    return out


bitgat_bwd.launches = 0


# -- the differentiable op ---------------------------------------------------

class _BitGAT(torch.autograd.Function):
    """Forward by K5's forward kernel; backward by its backward kernel,
    which recomputes p from el and er (nothing edge-shaped is stored)."""

    @staticmethod
    def forward(ctx, el, er, z, bf, slope, thresh, seed):
        out, l = bitgat_fwd(bf.packed, el, er, z, bf.num_dst, slope, thresh,
                            seed)
        ctx.save_for_backward(el, er, z, l, out)
        ctx.bf, ctx.slope, ctx.thresh, ctx.seed = bf, slope, thresh, seed
        return out

    @staticmethod
    def backward(ctx, g):
        el, er, z, l, out = ctx.saved_tensors
        g = g.float()
        linv, rho = backward_scales(g, out, l, ctx.thresh)
        bf = ctx.bf
        d_el, d_er, dz = bitgat_bwd(bf.packed_rev, el, er, z, g, linv, rho,
                                    bf.num_dst, ctx.slope, ctx.thresh,
                                    ctx.seed)
        return (d_el.to(el.dtype), d_er.to(er.dtype), dz.to(z.dtype), None,
                None, None, None)


def bitgat_attention_aggregate(bf: BitFormat, el, er, z,
                               negative_slope: float = 0.2,
                               attn_drop: float = 0.0, dropout_seed=None):
    """GAT attention + aggregation over the bitmask format.

    ``el``/``er`` (N_src, H)/(N_dst, H) attention logits and ``z``
    (N_src, H, D) projected source features -> (N_dst, H, D) f32, the
    softmax-weighted aggregation, differentiable in el, er and z.

    ``attn_drop`` > 0 applies the reference's attention dropout inside
    the kernels, from a hash of (src, dst, head, ``dropout_seed``): an
    int, or an integer tensor of one element (it may lie on the card).

    Requires a simple graph (``bf.rem_src`` empty): multi-edges cannot
    ride the bitmask's COO remainder through a softmax.
    """
    if bf.rem_src.shape[0]:
        raise ValueError(
            "bitgat requires a simple graph (BitFormat has a multi-edge "
            "remainder); use the edge chain")
    thresh = drop_thresh(attn_drop)
    if thresh is not None and z.shape[1] > len(_HEAD_MULTS):
        raise ValueError(
            f"bitgat in-kernel dropout supports up to {len(_HEAD_MULTS)} "
            f"heads, got {z.shape[1]}")
    if thresh is not None and dropout_seed is None:
        raise ValueError("attn_drop > 0 requires dropout_seed")
    seed = dropout_seed if thresh is not None else 0
    # the +-40 raw-logit contract.  As jnp.clip's, the gradient is 0 past
    # a bound and 1/2 at it (minimum and maximum split a tie); torch.clamp
    # would pass all of it there
    el, er = (torch.minimum(torch.maximum(t, t.new_tensor(-CLIP)),
                            t.new_tensor(CLIP)) for t in (el, er))
    return _BitGAT.apply(el, er, z, bf, float(negative_slope), thresh, seed)
