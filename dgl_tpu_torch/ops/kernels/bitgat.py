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

Two kernels (``csrc/bitgat.cu``), listed-bit walks whose persistent
warps claim the rows of a packing in :func:`claim_order` (hub rows
first), list each row's set bits and work through them with a group of
lanes an entry (:func:`list_layout`), behind three wrappers, each with a
plain PyTorch version beside it that computes the same function from the
same inputs:

* :func:`bitgat_fwd` (``_fwd_call``): out and l from ``packed`` (rows =
  dst), by the walk by dst (``bitgat_fwd_list_kernel``);
* :func:`bitgat_fwd_t` (``_fwd_call`` over the bits of A^T): out and l
  from ``packed_t`` (rows = src), without dropout, by the same walk on the
  dst-major bit transpose of ``packed_t`` (:func:`transpose_bits`); the
  mesh-sharded GAT (``parallel/bitgat_spmd.py``) runs it on a device's
  column shard of the A^T packing, its transpose kept on the format;
* :func:`bitgat_bwd` (``_bwd_call``): the gradients of el, er and z from
  ``packed_rev`` (rows = src), given g = dL/dout,
  linv = 1 / (max(l, 1e-20) kp) and rho = kp * sum_c g * out, by the walk
  by src (``bitgat_bwd_list_kernel``).

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
from .tiled_spmm import hub_first_order

CLIP = 20.0           # per-operand logit clip
DEN_EPS = 1e-20       # denominator clamp
MAX_HD = 128          # H * D: the JAX contract, at most 4 vectors a lane
PLAIN_WORDS = 1 << 23  # bit words a plain version lists at a time
COUNT_WORDS = 1 << 24  # bit words counted at a time for a claim order
MAX_LIST_CPL = 4       # the listed walk's 16-byte vectors a lane
_WARPS = 8             # csrc/bitgat.cu kWarps: warps a block

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
    "dgl_bitgat_fwd_list": [_P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                            _I, _F, _I, _P, _P, _P, _P, _I, _P],
    "dgl_bitgat_bwd_list": [_P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                            _I, _F, _I, _P, _P, _P, _P, _P, _I, _P],
    "dgl_bitgat_list_attrs": [_I, _I, _I, _I, _I, _P],
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


def check_bwd(packed_rev, el, er, z, g, linv, rho, num_dst: int):
    """The backward's operands agree with each other and the packing."""
    _check(packed_rev, el, er, z, z.shape[0], num_dst, num_dst)
    if g.shape != (num_dst,) + z.shape[1:] or linv.shape != er.shape \
            or rho.shape != er.shape:
        raise ValueError(f"g {tuple(g.shape)}, linv {tuple(linv.shape)} or "
                         f"rho {tuple(rho.shape)} do not match er and z")


def row_counts(packed: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows,) int64: the set bits of each of ``packed``'s first ``rows``
    rows, counted on its device COUNT_WORDS words at a time."""
    n32 = packed.shape[1]
    out = torch.empty(rows, dtype=torch.int64, device=packed.device)
    step = max(1, COUNT_WORDS // max(n32, 1))
    for r0 in range(0, rows, step):
        # a popcount of each int32 word in halves, nibbles and bytes; the
        # arithmetic shifts are masked, so they act as unsigned ones
        v = packed[r0:min(r0 + step, rows)]
        v = v - ((v >> 1) & 0x55555555)
        v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
        v = (v + (v >> 4)) & 0x0F0F0F0F
        v = v + (v >> 8)
        v = (v + (v >> 16)) & 0x3F
        out[r0:r0 + v.shape[0]] = v.sum(1)
    return out


def claim_order(packed: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows,) int32: the order in which the listed walk's warps claim the
    first ``rows`` rows of ``packed``: the hub rows (over
    ``tiled_spmm.HUB_DEGREE`` times the mean count of set bits) by count,
    largest first, so that none starts late and holds up the end of the
    launch; then the other rows by id."""
    return hub_first_order(row_counts(packed, rows))


def bwd_claim_order(bf: BitFormat) -> torch.Tensor:
    """:func:`claim_order` of ``bf.packed_rev``'s src rows, built at first
    use and kept on ``bf``."""
    if bf._bwd_order is None:
        bf._bwd_order = claim_order(bf.packed_rev, bf.num_src)
    return bf._bwd_order


def fwd_claim_order(bf: BitFormat) -> torch.Tensor:
    """:func:`claim_order` of ``bf.packed``'s dst rows, built at first use
    and kept on ``bf`` (the backward's, where the format is symmetric and
    square: the same rows of the same words)."""
    if bf._fwd_order is None:
        bf._fwd_order = (bwd_claim_order(bf) if bf.symmetric
                         and bf.num_src == bf.num_dst
                         else claim_order(bf.packed, bf.num_dst))
    return bf._fwd_order


def transpose_bits(packed_t: torch.Tensor, num_rows: int,
                   num_cols: int) -> torch.Tensor:
    """(num_cols, ceil(num_rows / 32)) int32: the bit transpose of the first
    ``num_rows`` rows of ``packed_t`` in the same plane-major packing: bit
    b of word j of row c is set where row b * n32 + j of ``packed_t`` has
    column c (n32 = ceil(num_rows / 32)).  Built on ``packed_t``'s device
    from its set bits, PLAIN_WORDS words at a time, by an integer
    scatter-add: the bits of one word are distinct, so add == OR."""
    n32 = -(-num_rows // 32)
    out = torch.zeros(num_cols * n32, dtype=torch.int32,
                      device=packed_t.device)
    for row, col in bit_edges(packed_t, num_rows):
        keep = col < num_cols
        row, col = row[keep], col[keep]
        plane = row // n32
        # 1 << 31 is made in int64 and wrapped to the int32 sign bit
        val = torch.bitwise_left_shift(torch.ones_like(plane), plane)
        val = torch.where(val >= 2**31, val - 2**32, val).to(torch.int32)
        out.index_add_(0, col * n32 + row % n32, val)
    return out.view(num_cols, n32)


def list_layout(heads: int, dim: int):
    """(dp, lpe, cpl): the listed walks' padded head width, lanes an entry
    and 16-byte vectors a lane.  A head's columns are padded to dp, a
    multiple of 4 (a power of two times 4 when H > 1, so that a head's
    vectors fill aligned blocks of lanes); lpe is the smallest power of
    two that leaves a lane at most MAX_LIST_CPL of the row's H dp / 4
    vectors with one head, at most 2 with several (at least a head's
    vectors, and 4 where 32 lanes hold more).  With several heads a lane
    keeps a scalar chain for each of its vectors, and 4 vectors a lane
    spill registers (``dgl_tpu_torch/tools/perf_bwd_walks.py`` times the
    backward at other lanes an entry)."""
    if heads == 1:
        dp = -(-dim // 4) * 4
    else:
        vph = 1
        while 4 * vph < dim:
            vph *= 2
        dp = 4 * vph
    nv = heads * dp // 4
    want = MAX_LIST_CPL if heads == 1 else 2
    lpe = 1
    while lpe < 32 and -(-nv // lpe) > want:
        lpe *= 2
    if heads > 1:
        lpe = max(lpe, dp // 4)
    return dp, lpe, -(-nv // lpe)


def _pad_heads(t: torch.Tensor, dp: int) -> torch.Tensor:
    """(N, H, D) as (N, H, dp) f32 contiguous, each head zero-padded."""
    if t.shape[2] == dp:
        return _f32(t)
    out = t.new_zeros(t.shape[:2] + (dp,), dtype=torch.float32)
    out[..., :t.shape[2]] = t
    return out


def list_kernel_attrs(walk: str, heads: int, dim: int, drop: bool,
                      device=None):
    """(registers a thread, resident warps an SM) of a listed walk's
    instance (``walk`` "fwd" or "bwd") for ``heads`` x ``dim`` with or
    without dropout, from ``cudaFuncGetAttributes`` and the occupancy
    calculator."""
    _, _, cpl = list_layout(heads, dim)
    device = torch.device("cuda") if device is None else torch.device(device)
    out = (ctypes.c_int * 2)()
    lib = build.load("bitgat", _SIGNATURES)
    err = lib.dgl_bitgat_list_attrs(int(walk == "fwd"), cpl, int(heads == 1),
                                    int(drop), device.index or 0,
                                    ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"dgl_bitgat_list_attrs: CUDA error {err}")
    return out[0], out[1] * _WARPS


def _check_order(order, rows):
    if order.shape != (rows,) or order.dtype != torch.int32:
        raise ValueError(f"order must be ({rows},) int32")


def fwd_list_args(packed, el, er, z, num_dst: int, slope: float, thresh,
                  seed, order, layout):
    """(the arguments of ``dgl_bitgat_fwd_list`` up to the device, (out,
    l), the tensors the arguments point into, to be kept alive until the
    launch) for the walk by dst on CUDA operands at ``layout`` (dp, lpe,
    cpl)."""
    num_src, heads, dim = z.shape
    dev = z.device
    if num_dst >= 2**31 or num_src >= 2**31:
        raise ValueError("the listed walk takes fewer than 2^31 nodes")
    _check_order(order, num_dst)
    dp, lpe, cpl = layout
    el, er = _f32(el), _f32(er)
    packed = packed.contiguous()
    zp = _pad_heads(z, dp)
    out = torch.empty(num_dst, heads, dim, dtype=torch.float32, device=dev)
    l = torch.empty(num_dst, heads, dtype=torch.float32, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    seed_t = _seed_ptr(seed, dev)
    keep = (packed, order, el, er, zp, seed_t, counter)
    args = (packed.data_ptr(), packed.shape[1], order.data_ptr(), num_dst,
            num_src, el.data_ptr(), er.data_ptr(), zp.data_ptr(), heads, dim,
            dp, lpe, cpl, slope, thresh or 0, seed_t.data_ptr(),
            out.data_ptr(), l.data_ptr(), counter.data_ptr())
    return args, (out, l), keep


def launch_fwd(packed, el, er, z, num_dst: int, slope: float, thresh=None,
               seed=0, order=None):
    """Launch K5's forward kernel, the listed walk by dst, on CUDA
    operands: (out, l).  ``order``: the dst rows' claim order
    (:func:`claim_order` of the packing's first num_dst rows, built here
    when None)."""
    heads, dim = z.shape[1:]
    dev = z.device
    if num_dst == 0 or heads * dim == 0:
        return (torch.zeros(num_dst, heads, dim, dtype=torch.float32,
                            device=dev),
                torch.zeros(num_dst, heads, dtype=torch.float32, device=dev))
    if order is None:
        order = claim_order(packed, num_dst)
    args, out, keep = fwd_list_args(packed, el, er, z, num_dst, slope,
                                    thresh, seed, order,
                                    list_layout(heads, dim))
    _launch("dgl_bitgat_fwd_list", *args, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    del keep
    return out


def bitgat_fwd(packed, el, er, z, num_dst: int, slope: float, thresh=None,
               seed=0, order=None):
    """K5 forward: (out (num_dst, H, D), l (num_dst, H)) f32 from
    ``packed``, the bits of A (rows = dst).  ``order``: the dst rows'
    claim order (:func:`fwd_claim_order` of the format; built anew for
    each call when None)."""
    num_src = z.shape[0]
    _check(packed, el, er, z, num_dst, num_src, num_dst)
    if not on_cuda(packed, el, er, z):
        return bitgat_fwd_plain(packed, el, er, z, num_dst, slope, thresh,
                                seed)
    out = launch_fwd(packed, el, er, z, num_dst, slope, thresh, seed, order)
    if num_dst and z.shape[1] * z.shape[2]:
        bitgat_fwd.launches += 1
    return out


bitgat_fwd.launches = 0


def bitgat_fwd_t(packed_t, el, er, z, num_dst: int, slope: float,
                 rows=None, order=None):
    """K5's forward over the A^T packing: (out (num_dst, H, D), l
    (num_dst, H)) f32 from ``packed_t``, the bits of A^T (rows = the rows
    of el and z, bit columns = dst), without dropout, by the walk by dst
    on ``rows``, the dst-major view of ``packed_t``
    (:func:`transpose_bits`), and ``order``, that view's claim order; each
    is built anew for the call when None.  On the CPU: the plain version
    of ``packed_t``, or of ``rows`` where given."""
    num_src = z.shape[0]
    _check(packed_t, el, er, z, num_src, num_dst, num_dst)
    if rows is not None:
        _check(rows, el, er, z, num_dst, num_src, num_dst)
    if not on_cuda(packed_t, el, er, z,
                   *(() if rows is None else (rows,))):
        if rows is not None:
            return bitgat_fwd_plain(rows, el, er, z, num_dst, slope)
        return bitgat_fwd_t_plain(packed_t, el, er, z, num_dst, slope)
    if rows is None:
        rows = transpose_bits(packed_t, num_src, num_dst)
    out = launch_fwd(rows, el, er, z, num_dst, slope, order=order)
    if num_dst and z.shape[1] * z.shape[2]:
        bitgat_fwd_t.launches += 1
    return out


bitgat_fwd_t.launches = 0


def bwd_list_args(packed_rev, el, er, z, g, linv, rho, num_dst: int,
                  slope: float, thresh, seed, order, layout):
    """(the arguments of ``dgl_bitgat_bwd_list`` up to the device, (del,
    der, dz), the tensors the arguments point into, to be kept alive until
    the launch) for the listed walk on CUDA operands at ``layout`` (dp,
    lpe, cpl); dz is (N_src, H, dp), each head's padding included."""
    num_src, heads, _ = z.shape
    dev = z.device
    if num_dst >= 2**31 or num_src >= 2**31:
        raise ValueError("the listed walk takes fewer than 2^31 nodes")
    _check_order(order, num_src)
    dp, lpe, cpl = layout
    # one (num_dst, 3, H) row per dst: er, linv and rho share a cache line
    nvec = torch.stack([er.float(), linv.float(), rho.float()], 1)
    el = _f32(el)
    packed_rev = packed_rev.contiguous()
    zp, gp = _pad_heads(z, dp), _pad_heads(g, dp)
    d_el = torch.empty(num_src, heads, dtype=torch.float32, device=dev)
    d_er = torch.zeros(num_dst, heads, dtype=torch.float32, device=dev)
    dz = torch.empty(num_src, heads, dp, dtype=torch.float32, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    seed_t = _seed_ptr(seed, dev)
    keep = (packed_rev, order, el, nvec, zp, gp, seed_t, counter)
    args = (packed_rev.data_ptr(), packed_rev.shape[1], order.data_ptr(),
            num_src, num_dst, el.data_ptr(), nvec.data_ptr(), zp.data_ptr(),
            gp.data_ptr(), heads, dp, lpe, cpl, slope, thresh or 0,
            seed_t.data_ptr(), dz.data_ptr(), d_el.data_ptr(),
            d_er.data_ptr(), counter.data_ptr())
    return args, (d_el, d_er, dz), keep


def launch_bwd(packed_rev, el, er, z, g, linv, rho, num_dst: int,
               slope: float, thresh=None, seed=0, order=None):
    """Launch K5's backward kernel, the listed walk, on CUDA operands:
    (del, der, dz).  ``order``: the rows' claim order (:func:`claim_order`
    of the packing's first num_src rows, built here when None)."""
    num_src, heads, dim = z.shape
    dev = z.device
    if num_src == 0 or heads * dim == 0:
        return (torch.zeros(num_src, heads, dtype=torch.float32, device=dev),
                torch.zeros(num_dst, heads, dtype=torch.float32, device=dev),
                torch.zeros(num_src, heads, dim, dtype=torch.float32,
                            device=dev))
    if order is None:
        order = claim_order(packed_rev, num_src)
    args, (d_el, d_er, dz), keep = bwd_list_args(
        packed_rev, el, er, z, g, linv, rho, num_dst, slope, thresh, seed,
        order, list_layout(heads, dim))
    _launch("dgl_bitgat_bwd_list", *args, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    del keep
    return d_el, d_er, (dz if dz.shape[2] == dim
                        else dz[..., :dim].contiguous())


def bitgat_bwd(packed_rev, el, er, z, g, linv, rho, num_dst: int,
               slope: float, thresh=None, seed=0, order=None):
    """K5 backward: (del (N_src, H), der (num_dst, H), dz (N_src, H, D))
    f32 from ``packed_rev``, the bits of A^T (rows = src).  ``order``: the
    rows' claim order (:func:`bwd_claim_order` of the format; built anew
    for each call when None)."""
    check_bwd(packed_rev, el, er, z, g, linv, rho, num_dst)
    if not on_cuda(packed_rev, el, er, z, g, linv, rho):
        return bitgat_bwd_plain(packed_rev, el, er, z, g, linv, rho, num_dst,
                                slope, thresh, seed)
    out = launch_bwd(packed_rev, el, er, z, g, linv, rho, num_dst, slope,
                     thresh, seed, order)
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
        # the plain version on the CPU needs no claim order
        out, l = bitgat_fwd(bf.packed, el, er, z, bf.num_dst, slope, thresh,
                            seed, fwd_claim_order(bf) if z.is_cuda else None)
        ctx.save_for_backward(el, er, z, l, out)
        ctx.bf, ctx.slope, ctx.thresh, ctx.seed = bf, slope, thresh, seed
        return out

    @staticmethod
    def backward(ctx, g):
        el, er, z, l, out = ctx.saved_tensors
        g = g.float()
        linv, rho = backward_scales(g, out, l, ctx.thresh)
        bf = ctx.bf
        # the plain version on the CPU needs no claim order
        order = bwd_claim_order(bf) if g.is_cuda else None
        d_el, d_er, dz = bitgat_bwd(bf.packed_rev, el, er, z, g, linv, rho,
                                    bf.num_dst, ctx.slope, ctx.thresh,
                                    ctx.seed, order)
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
