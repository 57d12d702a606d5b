"""Bit-packed dense SpMM: the whole adjacency as a 1-bit matrix.

Counterpart of ``dgl_tpu/ops/pallas/bitmm.py``.  At Reddit scale
(N = 233k) the full boolean adjacency takes K_pad * N_pad / 8 =
6,933,184,512 bytes (``chip_smoke.py`` prints it), which fits on an
80 GB card beside the features, so an SpMM can stream it:

    out[k, f] = sum_n A[k, n] * x[n, f]

Packing layout (plane-major, the same arrays as the TPU package): with
``N32 = N_pad // 32``,

    packed[k, j] bit b   <->   A[k, b * N32 + j]

``packed`` holds the bits of A (rows = dst) and ``packed_rev`` those of
A^T (rows = src); they are one tensor when the graph is symmetric.  Bit 31
is the int32 sign bit.  Multi-edges: the bitmask holds ``count >= 1`` and
the excess multiplicities ride a small COO remainder, added with a
gather + ``index_add_``.

Two kernels (``csrc/bitmm.cu``), each with a plain PyTorch version beside
it that computes the same function:

* :func:`bit_matmul_t` (K1, for F <= 96) computes A @ x from the bits of
  A^T, the route of ``_bit_matmul_t``: persistent blocks stream slabs of
  its words by TMA, list their set bits and add the listed x rows into
  out by reductions in L2 (:func:`k1_plan` is how the blocks share the
  words);
* :func:`bit_matmul` (K2, for F > 96) computes A @ x from the bits of A,
  the route of ``_bit_matmul``.

Both take x in f32 and sum in f32.  A wrapper launches its kernel on CUDA
tensors and raises if the build or the launch fails; it takes the plain
version only for CPU tensors.  Each wrapper counts its launches in its
``launches`` attribute.

Gradients: d/dx (A x) = A^T dZ, the same kernels with the two packings and
the remainder's src/dst swapped (:class:`_BitSpMM`).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import build
from .dispatch import on_cuda
from ...utils import resolve_device, unique_counts

BN = 8192          # src padding: N_pad is a multiple of this
K_ALIGN = 1024     # dst padding: K_pad is a multiple of this
T_MAX_F = 96       # route F <= this through K1 (bit_matmul_t)
REM_CHUNK = 1_048_576   # COO-remainder rows gathered per step
PLAIN_ROWS = 1024  # rows a plain version unpacks at a time
SLAB_WORDS = (8, 16, 32)   # K1's slab widths, in words of packed_t
# K1's default: a TMA box reads 128-byte runs of each row (narrower slabs
# read shorter runs and stream slower; perf_bitmm_variants sweeps them)
T_SLAB_WORDS = 32
T_TILE_ROWS = 128  # K1: rows of packed_t in a stage (a TMA box)


@dataclasses.dataclass
class BitFormat:
    """Bit-packed adjacency (+ its transpose for the backward) + COO
    remainder."""
    packed: torch.Tensor       # (K_pad, N_pad//32) int32, bits of A
    packed_rev: torch.Tensor   # bits of A^T (is ``packed`` if symmetric)
    rem_src: torch.Tensor      # (R,) int64, multi-edge excess
    rem_dst: torch.Tensor
    rem_w: torch.Tensor        # (R,) f32, excess multiplicity
    num_src: int
    num_dst: int
    symmetric: bool = False
    # (num_src,) int32 order in which K5's backward claims the rows of
    # packed_rev, and (num_dst,) the order in which its forward claims the
    # rows of packed, built at first use (bitgat.bwd_claim_order,
    # bitgat.fwd_claim_order)
    _bwd_order: Optional[torch.Tensor] = None
    _fwd_order: Optional[torch.Tensor] = None

    @property
    def nbytes(self) -> int:
        b = self.packed.numel() * 4
        return b if self.symmetric else 2 * b


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_shape(num_src: int, num_dst: int):
    """(K_pad, N32) of the packing of a num_dst x num_src matrix."""
    return (_pad_to(max(num_dst, 1), K_ALIGN),
            _pad_to(max(num_src, 1), BN) // 32)


def pack_bits(row: np.ndarray, col: np.ndarray, num_src: int,
              num_dst: int) -> tuple:
    """Host: (packed int32 (K_pad, N_pad//32), rem_dst, rem_src, rem_w).

    ``packed[d, j]`` bit ``b`` is set iff the edge (src = b*N32 + j) ->
    (dst = d) exists; occurrences beyond the first go to the remainder,
    one entry per (dst, src) pair with weight count - 1."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    k_pad, n32 = padded_shape(num_src, num_dst)
    key = col * num_src + row
    uk, cnt = unique_counts(key)
    d = uk // num_src
    s = uk % num_src
    b = (s // n32).astype(np.uint32)
    idx = d * n32 + s % n32
    order = np.argsort(idx, kind="stable")
    idx_s = idx[order]
    bits_s = np.uint32(1) << b[order]
    # segment-OR per distinct word
    starts = np.flatnonzero(np.r_[True, idx_s[1:] != idx_s[:-1]])
    packed = np.zeros(k_pad * n32, np.uint32)
    if len(idx_s):
        packed[idx_s[starts]] = np.bitwise_or.reduceat(bits_s, starts)
    packed = packed.reshape(k_pad, n32).view(np.int32)
    multi = cnt > 1
    return (packed, d[multi].astype(np.int32), s[multi].astype(np.int32),
            (cnt[multi] - 1).astype(np.float32))


def _format(packed, packed_rev, rs, rd, rw, num_src, num_dst, symmetric,
            device) -> BitFormat:
    def put(a, dtype):
        return torch.as_tensor(a, dtype=dtype).to(device)
    pk = put(packed, torch.int32)
    pr = pk if symmetric else put(packed_rev, torch.int32)
    return BitFormat(pk, pr, put(rs, torch.int64), put(rd, torch.int64),
                     put(rw, torch.float32), num_src, num_dst, symmetric)


def build_bit_format(row, col, num_src: int, num_dst: int,
                     symmetric: bool = False, device="cuda") -> BitFormat:
    """Pack on the host (numpy) and move the format to ``device``."""
    device = resolve_device(device)
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    packed, rd, rs, rw = pack_bits(row, col, num_src, num_dst)
    if symmetric:
        if num_src != num_dst:
            raise ValueError("symmetric bitmask needs a square adjacency")
        packed_rev = packed
    else:
        packed_rev = pack_bits(col, row, num_dst, num_src)[0]
    return _format(packed, packed_rev, rs, rd, rw, num_src, num_dst,
                   symmetric, device)


def _scatter_pack(r, c, num_src, num_dst):
    """Bits of the (num_dst x num_src) matrix with a 1 at each (c, r),
    by a scatter-add on r's device: for a simple graph every src landing
    in one word carries a distinct bit, so integer add == bitwise OR."""
    k_pad, n32 = padded_shape(num_src, num_dst)
    # 1 << 31 is made in int64 and wrapped to the int32 sign bit
    val = torch.bitwise_left_shift(torch.ones_like(r), r // n32)
    val = torch.where(val >= 2**31, val - 2**32, val).to(torch.int32)
    packed = torch.zeros(k_pad * n32, dtype=torch.int32, device=r.device)
    packed.index_add_(0, c * n32 + r % n32, val)
    return packed.view(k_pad, n32)


def build_bit_format_device(row, col, num_src: int, num_dst: int,
                            symmetric: bool = False,
                            assume_simple: bool = False,
                            device="cuda") -> BitFormat:
    """Pack on ``device`` with a scatter-add from the COO edge list.

    Duplicate edges would corrupt words (add != OR), so with
    ``assume_simple=False`` they are found on the host (a sort on
    (dst, src)) and routed to the COO remainder as the host builder does;
    ``assume_simple=True`` skips that O(E log E) pass for graphs that are
    simple by construction.  Indices are int64 throughout, so the flat
    word index cannot wrap."""
    device = resolve_device(device)
    rd = np.zeros(0, np.int64)
    rs = np.zeros(0, np.int64)
    rw = np.zeros(0, np.float32)
    if not assume_simple:
        row_h = np.asarray(torch.as_tensor(row).cpu(), np.int64)
        col_h = np.asarray(torch.as_tensor(col).cpu(), np.int64)
        uk, cnt = unique_counts(col_h * num_src + row_h)
        if len(uk) != len(row_h):
            multi = cnt > 1
            rd, rs = uk[multi] // num_src, uk[multi] % num_src
            rw = (cnt[multi] - 1).astype(np.float32)
            col, row = uk // num_src, uk % num_src
    row = torch.as_tensor(row).to(device=device, dtype=torch.int64)
    col = torch.as_tensor(col).to(device=device, dtype=torch.int64)
    pk = _scatter_pack(row, col, num_src, num_dst)
    if symmetric:
        if num_src != num_dst:
            raise ValueError("symmetric bitmask needs a square adjacency")
        pr = pk
    else:
        pr = _scatter_pack(col, row, num_dst, num_src)
    return _format(pk, pr, rs, rd, rw, num_src, num_dst, symmetric, device)


# -- the plain PyTorch versions ---------------------------------------------

def _unpack_rows(words: torch.Tensor) -> torch.Tensor:
    """(r, N32) int32 words -> (r, 32*N32) f32 0/1, column b*N32 + j from
    bit b of word j (an arithmetic shift followed by ``& 1`` reads the
    sign bit right)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(1) >> shifts.view(1, 32, 1)) & 1
    return bits.reshape(words.shape[0], -1).to(torch.float32)


def bit_matmul_t_plain(packed_t: torch.Tensor, x: torch.Tensor,
                       num_dst: int) -> torch.Tensor:
    """K1's function: A @ x (num_dst, F) f32 from ``packed_t``, the bits of
    A^T (row s = src s), unpacking PLAIN_ROWS rows at a time."""
    rows, f = x.shape
    out = torch.zeros(packed_t.shape[1] * 32, f, dtype=torch.float32,
                      device=x.device)
    for r0 in range(0, rows, PLAIN_ROWS):
        r1 = min(r0 + PLAIN_ROWS, rows)
        out.addmm_(_unpack_rows(packed_t[r0:r1]).T, x[r0:r1].float())
    return out[:num_dst]


def bit_matmul_plain(packed: torch.Tensor, x: torch.Tensor,
                     num_dst: int) -> torch.Tensor:
    """K2's function: A @ x (num_dst, F) f32 from ``packed``, the bits of A
    (row d = dst d), unpacking PLAIN_ROWS rows at a time."""
    f = x.shape[1]
    xp = x.new_zeros((packed.shape[1] * 32, f), dtype=torch.float32)
    xp[: x.shape[0]] = x
    out = torch.empty(num_dst, f, dtype=torch.float32, device=x.device)
    for r0 in range(0, num_dst, PLAIN_ROWS):
        r1 = min(r0 + PLAIN_ROWS, num_dst)
        torch.mm(_unpack_rows(packed[r0:r1]), xp, out=out[r0:r1])
    return out


# -- the kernel wrappers ------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    "dgl_bit_matmul_t": [_P, _I, _P, _I, _I, _P, _I, _I, _I, _I, _I, _P],
    "dgl_bit_matmul": [_P, _I, _P, _I, _I, _P, _I, _I, _I, _I, _P],
}


def _check(packed: torch.Tensor, x: torch.Tensor, num_dst: int,
           max_rows: int, max_dst: int):
    if packed.dtype != torch.int32 or packed.ndim != 2:
        raise ValueError("packed must be a 2-D int32 tensor")
    if packed.device != x.device:
        raise ValueError(f"packed lies on {packed.device}, x on {x.device}")
    if x.ndim != 2 or x.shape[0] > max_rows or num_dst > max_dst:
        raise ValueError(f"shapes do not match the packing: x "
                         f"{tuple(x.shape)}, num_dst {num_dst}, packed "
                         f"{tuple(packed.shape)}")


def _k1_vec(f: int, x: torch.Tensor, out: torch.Tensor) -> int:
    """Floats K1 reads of x and adds into out at a time: 4, 2 or 1, the
    widest that divides F and both tensors' alignment."""
    vec = 4
    while vec > 1 and (f % vec or x.data_ptr() % (4 * vec)
                       or out.data_ptr() % (4 * vec)):
        vec //= 2
    return vec


def k1_plan(rows: int, n32: int, w: int, blocks: int):
    """K1's work, one list a block: (slab, first row, end row) segments.
    The (slab, row) units, slab-major (a slab is w words of every row),
    are cut into ``blocks`` equal runs (block c takes units
    c T / blocks .. (c + 1) T / blocks - 1); each segment is walked in
    tiles of ``T_TILE_ROWS`` rows.  ``bit_matmul_t_kernel`` computes the
    same runs."""
    total = -(-n32 // w) * rows
    plan = []
    for c in range(blocks):
        u, hi, segs = c * total // blocks, (c + 1) * total // blocks, []
        while u < hi:
            slab, r0 = divmod(u, rows)
            r1 = min(rows, r0 + hi - u)
            segs.append((slab, r0, r1))
            u += r1 - r0
        plan.append(segs)
    return plan


def _k2_layout(f: int, x: torch.Tensor):
    """(vec, cpl) of K2 over F = ``f`` columns: floats a load (4, 2 or 1,
    the widest that divides F and x's alignment) and column vectors a
    lane (the row's vectors over 32 lanes rounded up to a power of two, at
    most 4: up to 512 columns a warp; a wider row takes more column
    blocks, each re-reading the row's bits)."""
    vec = 4
    while vec > 1 and (f % vec or x.data_ptr() % (4 * vec)):
        vec //= 2
    cpl = 1
    while cpl < 4 and 32 * cpl * vec < f:
        cpl *= 2
    return vec, cpl


def _launch(fn: str, *args):
    lib = build.load("bitmm", _SIGNATURES)
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {err}")


def bit_matmul_t(packed_t: torch.Tensor, x: torch.Tensor,
                 num_dst: int, slab_words=None) -> torch.Tensor:
    """K1: A @ x (num_dst, F) f32 from ``packed_t``, the bits of A^T
    (rows = the rows of x), for F <= 96.  ``slab_words``: the words of each
    row a block's slab spans, 8, 16 or 32 (``T_SLAB_WORDS`` by default;
    the slab-width sweep, ``dgl_tpu_torch.tools.perf_bitmm_variants``,
    sets it).  On the card the rows must be a multiple of 4 words (TMA
    reads them 16-byte aligned): every bitmask of the port is (N_pad a
    multiple of 8,192, shards of 4,096 dst nodes)."""
    _check(packed_t, x, num_dst, packed_t.shape[0], packed_t.shape[1] * 32)
    f = x.shape[1]
    if f > T_MAX_F:
        raise ValueError(f"bit_matmul_t takes F <= {T_MAX_F}")
    w = T_SLAB_WORDS if slab_words is None else slab_words
    if w not in SLAB_WORDS:
        raise ValueError(f"slab_words must be one of {SLAB_WORDS}, got {w}")
    if not on_cuda(packed_t, x):
        return bit_matmul_t_plain(packed_t, x, num_dst)
    rows = x.shape[0]
    n32 = packed_t.shape[1]
    out = torch.zeros(num_dst, f, dtype=torch.float32, device=x.device)
    if rows == 0 or f == 0 or num_dst == 0:
        return out
    if n32 % 4:
        raise ValueError(f"packed_t's rows of {n32} words are not a "
                         "multiple of 4")
    x = x.float().contiguous()
    packed_t = packed_t.contiguous()
    if packed_t.data_ptr() % 16:
        raise ValueError("packed_t's storage is not 16-byte aligned")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = min(sms, -(-n32 // w) * rows)
    _launch("dgl_bit_matmul_t", packed_t.data_ptr(), n32, x.data_ptr(),
            rows, f, out.data_ptr(), num_dst, w, _k1_vec(f, x, out), blocks,
            x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    bit_matmul_t.launches += 1
    return out


bit_matmul_t.launches = 0


def bit_matmul(packed: torch.Tensor, x: torch.Tensor,
               num_dst: int) -> torch.Tensor:
    """K2: A @ x (num_dst, F) f32 from ``packed``, the bits of A
    (rows = dst)."""
    _check(packed, x, num_dst, packed.shape[1] * 32, packed.shape[0])
    if not on_cuda(packed, x):
        return bit_matmul_plain(packed, x, num_dst)
    num_src, f = x.shape
    if num_dst == 0 or f == 0:
        return torch.zeros(num_dst, f, dtype=torch.float32, device=x.device)
    out = torch.empty(num_dst, f, dtype=torch.float32, device=x.device)
    x = x.float().contiguous()
    packed = packed.contiguous()
    vec, cpl = _k2_layout(f, x)
    _launch("dgl_bit_matmul", packed.data_ptr(), packed.shape[1],
            x.data_ptr(), num_src, f, out.data_ptr(), num_dst, vec, cpl,
            x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    bit_matmul.launches += 1
    return out


bit_matmul.launches = 0


# -- the SpMM with its remainder and gradient ---------------------------------

def add_remainder(out, x, rem_src, rem_dst, rem_w):
    """out += the COO remainder's sum (x[rem_src] * rem_w into rem_dst), in
    chunks of REM_CHUNK rows; returns out."""
    for r0 in range(0, rem_src.shape[0], REM_CHUNK):
        sl = slice(r0, r0 + REM_CHUNK)
        out.index_add_(0, rem_dst[sl],
                       x[rem_src[sl]].float() * rem_w[sl, None])
    return out


def _apply(packed, packed_t, rem_src, rem_dst, rem_w, num_dst, x):
    if x.shape[1] <= T_MAX_F:
        out = bit_matmul_t(packed_t, x, num_dst)
    else:
        out = bit_matmul(packed, x, num_dst)
    return add_remainder(out, x, rem_src, rem_dst, rem_w)


class _BitSpMM(torch.autograd.Function):
    """A @ x with the backward A^T dZ: the forward's route with the two
    packings and the remainder's src/dst swapped."""

    @staticmethod
    def forward(ctx, x, bf):
        ctx.bf = bf
        ctx.x_dtype = x.dtype
        return _apply(bf.packed, bf.packed_rev, bf.rem_src, bf.rem_dst,
                      bf.rem_w, bf.num_dst, x)

    @staticmethod
    def backward(ctx, dz):
        bf = ctx.bf
        dx = _apply(bf.packed_rev, bf.packed, bf.rem_dst, bf.rem_src,
                    bf.rem_w, bf.num_src, dz)
        return dx.to(ctx.x_dtype), None


def bit_spmm(bf: BitFormat, x: torch.Tensor) -> torch.Tensor:
    """out (num_dst, F) f32 = A @ x via the bitmask kernels + remainder."""
    return _BitSpMM.apply(x, bf)
