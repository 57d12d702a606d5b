"""Int8 hub-block matmul (K12): the dense half of the hybrid SpMM.

Counterpart of ``dgl_tpu/ops/pallas/int8mm.py``.  The hybrid format's
dense block A (``hybrid.py``) is a (k, N_pad) int8 matrix of edge
multiplicities (0..127) from every src node into each hub dst, row-major,
with N_pad the src count rounded up to a multiple of 128.  Two products
over it:

    out[i, f] = sum_n A[i, n] x[n, f]    :func:`int8_matmul_rows`  (k, F)
    out[n, f] = sum_i A[i, n] z[i, f]    :func:`int8_matmul_cols`  (N_pad, F)

Both are kernels of ``csrc/int8mm.cu`` that stream A once and sum in f32
in a fixed order (no atomics).  A is used as the builder made it: the
TPU's (1024, 2048) block padding and 128-lane F padding are not carried.
x and z are taken in f32, where the TPU kernel rounds them to bf16.  The
column product runs on the tensor cores: A reaches shared memory by TMA
and is turned into bf16 there (exact), z is cut into three bf16 parts
whose sum is z (:func:`split_bf16x3`), and each part's product is summed
in f32 by ``mma.sync``; :func:`cols_plan` is how its blocks share the
output.

A wrapper checks dtypes, shapes and contiguity and raises on a mismatch.
It launches its kernel on CUDA tensors, and raises if the build or the
launch fails; it takes the plain version only for CPU tensors.  Each
wrapper counts its launches in its ``launches`` attribute.

The plain versions (:func:`dense_rows`, :func:`dense_cols_t`) widen A to
f32 a few hundred rows at a time, so no f32 or bf16 copy of the whole
block (7.6 GB of int8 at Reddit scale) is ever held.  They take a float
block as well: the hybrid format's bf16 block (static weights, or
multiplicities over 127) goes through them on every device, as the JAX
package computes that product with XLA's dot outside any Pallas kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .dispatch import on_cuda

PLAIN_ELEMS = 1 << 26    # block elements a plain version widens at a time
ROW_ALIGN = 16           # N_pad must be a multiple (16-byte row loads)
COL_UNIT = 16            # output rows in a unit of a column block's share
COL_PASS_UNITS = 32      # units a column block takes in one pass (512 rows)
COL_ROWS = 64            # rows of A in a stage of the column kernel
COL_CTAS_PER_SM = 2      # column blocks an SM holds


def _row_chunk(n_pad: int) -> int:
    return max(1, PLAIN_ELEMS // max(n_pad, 1))


def dense_rows(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(k, F) f32 = A[:, :N] @ x for x (N, F), N <= N_pad, in f32 on the
    widened block, a chunk of rows at a time."""
    k = a.shape[0]
    n = x.shape[0]
    xf = x.float()
    out = torch.empty(k, x.shape[1], dtype=torch.float32, device=x.device)
    step = _row_chunk(a.shape[1])
    for r0 in range(0, k, step):
        out[r0:r0 + step] = a[r0:r0 + step, :n].float() @ xf
    return out


def dense_cols_t(a: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """(N_pad, F) f32 = A^T @ z for z (k, F), in f32 on the widened block,
    a chunk of rows (of the contraction) at a time."""
    k, n_pad = a.shape
    zf = z.float()
    out = torch.zeros(n_pad, z.shape[1], dtype=torch.float32,
                      device=z.device)
    step = _row_chunk(n_pad)
    for r0 in range(0, k, step):
        out += a[r0:r0 + step].float().T @ zf[r0:r0 + step]
    return out


int8_matmul_rows_plain = dense_rows
int8_matmul_cols_plain = dense_cols_t


def split_bf16x3(z: torch.Tensor):
    """(hi, mid, lo) bf16 with hi + mid + lo == z (f32): each part is the
    top 16 bits of what the parts before it leave, so each subtraction is
    exact, and the sum is z bit for bit for 0 and every normal f32 of
    magnitude at least 2^-110 (lo's last bit then lies within bf16's
    range).  Where z is exact in bf16, mid and lo are 0.  The column
    kernel's ``split_z_kernel`` computes the same parts."""
    top = -65536   # 0xFFFF0000 as an int32
    z = z.float().contiguous()
    hi = (z.view(torch.int32) & top).view(torch.float32)
    r1 = z - hi
    mid = (r1.view(torch.int32) & top).view(torch.float32)
    lo = r1 - mid
    return hi.bfloat16(), mid.bfloat16(), lo.bfloat16()


def col_tiles(f: int) -> int:
    """mma n-tiles of 8 columns a column pass covers: 1 at F <= 8, else 2
    (16 columns; a wider F takes more groups, each streaming A again)."""
    return 1 if f <= 8 else 2


def cols_scratch_words(k: int, f: int) -> int:
    """8-byte words of the column kernel's z parts: for each group of
    8 ``col_tiles(f)`` columns, each 16 of the k rows rounded up to a
    stage (``COL_ROWS``) and each n-tile, 3 parts x 32 lanes."""
    nt = col_tiles(f)
    groups = -(-f // (8 * nt))
    return groups * (-(-k // COL_ROWS) * COL_ROWS // 16) * nt * 3 * 32


def cols_plan(n_pad: int, f: int, ctas: int):
    """The column kernel's passes, one list a block: (group, first output
    row, rows).  The n_pad / 16 units of 16 rows of each group of
    ``col_tiles(f)`` n-tiles, group-major, are cut into ``ctas`` equal
    runs (block c takes units c T / ctas .. (c + 1) T / ctas - 1); a block
    walks its run in passes of up to 512 rows within one group, each over
    the whole of k.  ``int8_cols_kernel`` computes the same runs."""
    units = n_pad // COL_UNIT
    groups = -(-f // (8 * col_tiles(f)))
    total = units * groups
    plan = []
    for c in range(ctas):
        u, hi, passes = c * total // ctas, (c + 1) * total // ctas, []
        while u < hi:
            grp = u // units
            n = min(hi, (grp + 1) * units, u + COL_PASS_UNITS) - u
            passes.append((grp, (u - grp * units) * COL_UNIT, n * COL_UNIT))
            u += n
        plan.append(passes)
    return plan


# -- the kernel wrappers ------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    "dgl_int8_rows": [_P, _I, _I, _P, _I, _I, _P, _I, _P],
    "dgl_int8_cols": [_P, _I, _I, _P, _I, _P, _P, _I, _I, _P],
}


def _check(a: torch.Tensor, x: torch.Tensor, what: str):
    if a.dtype != torch.int8 or a.ndim != 2:
        raise ValueError(f"the block must be a 2-D int8 tensor, got "
                         f"{a.dtype} of {a.ndim} dims")
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"{what} must be a 2-D float32 tensor, got "
                         f"{x.dtype} of {x.ndim} dims")
    if x.device != a.device:
        raise ValueError(f"{what} lies on {x.device}, the block on "
                         f"{a.device}")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"the block and {what} must be contiguous")
    if a.shape[1] % ROW_ALIGN:
        raise ValueError(f"the block's {a.shape[1]} columns are not a "
                         f"multiple of {ROW_ALIGN}")


def _launch(fn: str, *args):
    lib = build.load("int8mm", _SIGNATURES)
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {err}")


def _check_aligned(a: torch.Tensor):
    if a.data_ptr() % ROW_ALIGN:
        raise ValueError("the block's storage is not 16-byte aligned")


def int8_matmul_rows(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K12, ``_mm_kernel``: (k, F) f32 = A @ x for the int8 block A
    (k, N_pad) and x (N, F) f32, N <= N_pad (rows past N count as 0)."""
    _check(a, x, "x")
    if x.shape[0] > a.shape[1]:
        raise ValueError(f"x has {x.shape[0]} rows, the block "
                         f"{a.shape[1]} columns")
    if not on_cuda(a, x):
        return int8_matmul_rows_plain(a, x)
    k, n_pad = a.shape
    f = x.shape[1]
    out = torch.empty(k, f, dtype=torch.float32, device=x.device)
    if k == 0 or f == 0:
        return out
    _check_aligned(a)
    _launch("dgl_int8_rows", a.data_ptr(), k, n_pad, x.data_ptr(),
            x.shape[0], f, out.data_ptr(), x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream)
    int8_matmul_rows.launches += 1
    return out


int8_matmul_rows.launches = 0


def int8_matmul_cols(a: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """K12, ``_mm_t_kernel``: (N_pad, F) f32 = A^T @ z for the int8 block
    A (k, N_pad) and z (k, F) f32.  On the card: the parts of z
    (``split_z_kernel``) into a scratch, then ``int8_cols_kernel`` on
    ``COL_CTAS_PER_SM`` blocks an SM; one count a call."""
    _check(a, z, "z")
    if z.shape[0] != a.shape[0]:
        raise ValueError(f"z has {z.shape[0]} rows, the block "
                         f"{a.shape[0]}")
    if not on_cuda(a, z):
        return int8_matmul_cols_plain(a, z)
    k, n_pad = a.shape
    f = z.shape[1]
    if k == 0:
        return torch.zeros(n_pad, f, dtype=torch.float32, device=z.device)
    out = torch.empty(n_pad, f, dtype=torch.float32, device=z.device)
    if n_pad == 0 or f == 0:
        return out
    _check_aligned(a)
    zf = torch.empty(cols_scratch_words(k, f), dtype=torch.int64,
                     device=z.device)
    sms = torch.cuda.get_device_properties(z.device).multi_processor_count
    groups = -(-f // (8 * col_tiles(f)))
    ctas = min(COL_CTAS_PER_SM * sms, n_pad // COL_UNIT * groups)
    _launch("dgl_int8_cols", a.data_ptr(), k, n_pad, z.data_ptr(), f,
            out.data_ptr(), zf.data_ptr(), ctas, z.device.index,
            torch.cuda.current_stream(z.device).cuda_stream)
    int8_matmul_cols.launches += 1
    return out


int8_matmul_cols.launches = 0


def int8_matmul(a: torch.Tensor, x: torch.Tensor,
                contract_rows: bool = False) -> torch.Tensor:
    """``int8_matmul`` of the JAX package without its padding: A @ x (k, F)
    f32, or with ``contract_rows`` A^T @ x (N_pad, F) f32 for x (k, F)."""
    if contract_rows:
        return int8_matmul_cols(a, x)
    return int8_matmul_rows(a, x)
