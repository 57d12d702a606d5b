"""Mesh-sharded bit-packed dense SpMM (full-graph training over several
devices).

Counterpart of ``dgl_tpu/parallel/bitspmd.py``.  The packed adjacency is
sharded by DESTINATION: device ``p`` stores the bit columns of the A^T
packing that belong to its contiguous node range, N^2 / (8 P) bytes, and
computes its own output rows with one local K1 launch
(``ops/kernels/bitmm.py`` ``bit_matmul_t``) after an all-gather of the
feature rows (``comm.all_gather_rows``).

Layout contract, the JAX package's: nodes go to devices in contiguous
ranges of the natural order, ``npp = 32 W`` rows a device (``W`` packed
words a device, a multiple of 128); features enter and leave row-sharded,
padded to ``P * npp`` rows by :func:`pad_nodes`.  Device ``p``'s shard
holds the bit of edge (src s -> dst u = p npp + t) at row ``s``, word
``t % W``, plane ``t // W``: K1's own packing, so its output is in natural
node order and the TPU's plane scaling and unplaning have no counterpart
here.  Multi-edges: the excess multiplicities ride per-owner COO lists
(src global into the gathered features, dst local), padded to the
largest owner's count with dummy entries (dst ``npp``, weight 0).

Gradients: d/dx (A x) = A^T dZ.  The backward runs the same path on
``shards_rev`` (the A packing sharded by src) and the transposed
remainder lists; a symmetric graph's ``shards_rev`` is ``shards``.

A rank holds its own view, :func:`shard_format`: the (1, ...) slices of
every per-device array, as the JAX local view inside ``shard_map`` sees
them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.kernels import bitmm
from ..utils import resolve_device, unique_counts
from . import comm

LANE_WORDS = 128    # W is a multiple of this
KP_ALIGN = 1024     # contraction rows: the real src nodes, padded


@dataclasses.dataclass
class BitShardedFormat:
    """Per-device column shards of the packed adjacency.

    shards:     (P, kp, W) int32 -- device p's slice of the A^T packing
                (rows = ALL src nodes, bit columns = p's dst range)
    shards_rev: the same for the A packing (dst rows as contraction), for
                the backward; is ``shards`` when symmetric
    rem_src_g / rem_dst_l / rem_w: (P, R) multi-edge excess per owner
                (src GLOBAL into the gathered features, dst LOCAL)
    brem_*:     the transposed remainder lists for the backward
    """
    shards: torch.Tensor
    shards_rev: torch.Tensor
    rem_src_g: torch.Tensor
    rem_dst_l: torch.Tensor
    rem_w: torch.Tensor
    brem_src_g: torch.Tensor
    brem_dst_l: torch.Tensor
    brem_w: torch.Tensor
    num_nodes: int
    num_parts: int
    npp: int          # nodes per device = 32 * W
    kp: int           # padded contraction rows (>= num_nodes, 1024-multiple)
    symmetric: bool = False
    has_remainder: bool = True
    # K13's claim orders of this format's shards' rows, by the shard's
    # device, address and shape, built at first use
    # (bitgat_spmd.shard_claim_order); a rank's view keeps its own
    _claim_orders: Optional[dict] = None
    # the forward's dst-major views of the shards and their claim orders,
    # (view, order) by the shard's device, address and shape, built at
    # first use (bitgat_spmd.shard_fwd_view); a rank's view keeps its own
    _fwd_views: Optional[dict] = None

    @property
    def bytes_per_device(self) -> int:
        b = self.shards[0].numel() * 4
        return b if self.symmetric else 2 * b


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _sizes(num_nodes: int, num_parts: int):
    """(npp, kp): npp = 32 W with W a multiple of LANE_WORDS; kp covers
    the real src nodes (bits past num_nodes are never set)."""
    npp = _pad_to(-(-num_nodes // num_parts), 32 * LANE_WORDS)
    return npp, _pad_to(num_nodes, KP_ALIGN)


def _bucket_remainder(md, ms, mw, num_parts, npp):
    """Multi-edge excess bucketed by owner p = dst // npp and padded to
    the largest count (at least 1) with dummy slots (dst npp, weight 0):
    (src global, dst local, weight), each (P, R)."""
    mp = md // npp
    counts = np.bincount(mp, minlength=num_parts)
    r_max = max(int(counts.max()) if counts.size else 0, 1)
    rsg = np.zeros((num_parts, r_max), np.int32)
    rdl = np.full((num_parts, r_max), npp, np.int32)
    rw = np.zeros((num_parts, r_max), np.float32)
    order = np.argsort(mp, kind="stable")
    start = 0
    for q in range(num_parts):
        c = counts[q]
        sel = order[start:start + c]
        start += c
        rsg[q, :c] = ms[sel]
        rdl[q, :c] = md[sel] - q * npp
        rw[q, :c] = mw[sel]
    return rsg, rdl, rw


def _edge_keys(row, col, n):
    """Distinct (dst, src) pairs and their counts, sorted by dst * n + src
    (one pass of ``unique_counts``; numpy 2.3's hash ``np.unique`` is far
    slower on large int64 keys)."""
    uk, cnt = unique_counts(col.astype(np.int64) * n + row.astype(np.int64))
    return uk // n, uk % n, cnt


def _flat_words(d, s, npp, kp):
    """(flat word index into the (P * kp, W) shards, bit plane) of the
    edges s -> d."""
    w = npp // 32
    p, t = d // npp, d % npp
    return (p * kp + s) * w + t % w, t // w


def _pack_shards(row, col, n, num_parts, npp, kp):
    """Host packing: (shards (P, kp, W) int32, rem lists bucketed per
    owner) -- the JAX builder's arrays."""
    w = npp // 32
    d, s, cnt = _edge_keys(row, col, n)
    flat, plane = _flat_words(d, s, npp, kp)
    order = np.argsort(flat, kind="stable")
    flat_s = flat[order]
    bits_s = np.uint32(1) << plane[order].astype(np.uint32)
    shards = np.zeros(num_parts * kp * w, np.uint32)
    if len(flat_s):
        starts = np.flatnonzero(np.r_[True, flat_s[1:] != flat_s[:-1]])
        shards[flat_s[starts]] = np.bitwise_or.reduceat(bits_s, starts)
    shards = shards.reshape(num_parts, kp, w).view(np.int32)
    multi = cnt > 1
    rem = _bucket_remainder(d[multi], s[multi],
                            (cnt[multi] - 1).astype(np.float32), num_parts,
                            npp)
    return (shards,) + rem


def _format(shards, shards_rev, rem, brem, n, num_parts, npp, kp,
            symmetric, device) -> BitShardedFormat:
    def put(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype).to(device)
    sh = put(shards, torch.int32)
    sr = sh if symmetric else put(shards_rev, torch.int32)
    return BitShardedFormat(
        sh, sr, *(put(a) for a in rem), *(put(a) for a in brem),
        num_nodes=n, num_parts=num_parts, npp=npp, kp=kp,
        symmetric=symmetric,
        has_remainder=bool(np.any(rem[2])) or bool(np.any(brem[2])))


def build_bit_sharded_format(row, col, num_nodes: int, num_parts: int,
                             symmetric: bool = False,
                             device="cuda") -> BitShardedFormat:
    """Pack on the host (numpy) and move every shard to ``device``."""
    device = resolve_device(device)
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    npp, kp = _sizes(num_nodes, num_parts)
    shards, *rem = _pack_shards(row, col, num_nodes, num_parts, npp, kp)
    if symmetric:
        shards_rev, brem = shards, rem
    else:
        shards_rev, *brem = _pack_shards(col, row, num_nodes, num_parts,
                                         npp, kp)
    return _format(shards, shards_rev, rem, brem, num_nodes, num_parts, npp,
                   kp, symmetric, device)


def _scatter_shards(r, c, num_parts, npp, kp):
    """Bits of the (P, kp, W) shards with a 1 for each edge r -> c, by a
    scatter-add on r's device: for distinct edges every bit in a word is
    distinct, so integer add == bitwise OR."""
    w = npp // 32
    flat, plane = _flat_words(c, r, npp, kp)
    del r, c
    # 1 << 31 is made in int64 and wrapped to the int32 sign bit
    val = torch.bitwise_left_shift(torch.ones_like(plane), plane)
    del plane
    val = torch.where(val >= 2**31, val - 2**32, val).to(torch.int32)
    shards = torch.zeros(num_parts * kp * w, dtype=torch.int32,
                         device=val.device)
    shards.index_add_(0, flat, val)
    return shards.view(num_parts, kp, w)


def build_bit_sharded_format_device(row, col, num_nodes: int,
                                    num_parts: int, symmetric: bool = False,
                                    assume_simple: bool = False,
                                    device="cuda") -> BitShardedFormat:
    """Pack on ``device`` with a scatter-add from the COO edge list: the
    same arrays as :func:`build_bit_sharded_format` without a host array
    of the shards' size.

    Duplicate edges would corrupt words (add != OR), so with
    ``assume_simple=False`` they are found on the host (a sort on
    (dst, src)) and routed to the remainder lists as the host builder
    does; ``assume_simple=True`` skips that pass for graphs that are
    simple by construction.  Indices are int64 throughout."""
    device = resolve_device(device)
    npp, kp = _sizes(num_nodes, num_parts)
    empty = (np.zeros(0, np.int64),) * 2 + (np.zeros(0, np.float32),)
    md, ms, mw = empty
    if not assume_simple:
        row_h = np.asarray(torch.as_tensor(row).cpu(), np.int64)
        col_h = np.asarray(torch.as_tensor(col).cpu(), np.int64)
        d, s, cnt = _edge_keys(row_h, col_h, num_nodes)
        if len(d) != len(row_h):
            multi = cnt > 1
            md, ms = d[multi], s[multi]
            mw = (cnt[multi] - 1).astype(np.float32)
            row, col = s, d
    rem = _bucket_remainder(md, ms, mw, num_parts, npp)
    # the transposed lists in the host builder's order, by src * n + dst
    order = np.argsort(ms * num_nodes + md, kind="stable")
    brem = (rem if symmetric
            else _bucket_remainder(ms[order], md[order], mw[order],
                                   num_parts, npp))
    row = torch.as_tensor(row).to(device=device, dtype=torch.int64)
    col = torch.as_tensor(col).to(device=device, dtype=torch.int64)
    shards = _scatter_shards(row, col, num_parts, npp, kp)
    shards_rev = (shards if symmetric
                  else _scatter_shards(col, row, num_parts, npp, kp))
    return _format(shards, shards_rev, rem, brem, num_nodes, num_parts, npp,
                   kp, symmetric, device)


def shard_format(fmt: BitShardedFormat, rank: int,
                 device="cuda") -> BitShardedFormat:
    """Rank ``rank``'s view on ``device``: the (1, ...) slice of every
    per-device array (no copy where it lies there already)."""
    device = resolve_device(device)

    def part(a):
        return a[rank:rank + 1].to(device)
    sh = part(fmt.shards)
    return dataclasses.replace(
        fmt, shards=sh,
        shards_rev=sh if fmt.symmetric else part(fmt.shards_rev),
        rem_src_g=part(fmt.rem_src_g), rem_dst_l=part(fmt.rem_dst_l),
        rem_w=part(fmt.rem_w), brem_src_g=part(fmt.brem_src_g),
        brem_dst_l=part(fmt.brem_dst_l), brem_w=part(fmt.brem_w),
        _claim_orders=None, _fwd_views=None)


def pad_nodes(fmt: BitShardedFormat, x: torch.Tensor) -> torch.Tensor:
    """Pad (num_nodes, ...) rows with zeros to the sharded (P npp, ...)
    layout."""
    pad = fmt.num_parts * fmt.npp - x.shape[0]
    if pad > 0:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x


def local_rows(fmt: BitShardedFormat, x: torch.Tensor,
               rank: int) -> torch.Tensor:
    """Rank ``rank``'s npp rows of padded (P npp, ...) rows."""
    return x[rank * fmt.npp:(rank + 1) * fmt.npp]


def sharded_in_degrees(fmt: BitShardedFormat, row, col,
                       device="cuda") -> torch.Tensor:
    """(P npp,) f32 in-degrees in the sharded layout, multi-edges counted,
    on ``device`` (a bincount of ``col`` where it lies)."""
    device = resolve_device(device)
    col = torch.as_tensor(col).to(torch.int64)
    deg = torch.bincount(col, minlength=fmt.num_parts * fmt.npp)
    return deg.to(device=device, dtype=torch.float32)


def local_view(fmt: BitShardedFormat, arr: torch.Tensor, group):
    """This rank's slice of a per-device array: the only one of a rank's
    own view, else the rank's row of the full (P, ...) array."""
    world = dist.get_world_size(group)
    if world != fmt.num_parts:
        raise ValueError(f"the format has {fmt.num_parts} parts, the group "
                         f"{world} ranks")
    return arr[0] if arr.shape[0] == 1 else arr[dist.get_rank(group)]


def _local_apply(fmt, shard, rsg, rdl, rw, x_local, group):
    """One rank's output rows: all-gather the features, one K1 launch per
    96 columns on the shard, plus the multi-edge excess."""
    xg = comm.all_gather_rows(x_local, group)
    xs = xg[:fmt.kp]
    f = xs.shape[1]
    if f <= bitmm.T_MAX_F:
        out = bitmm.bit_matmul_t(shard, xs, fmt.npp)
    else:
        out = torch.cat([bitmm.bit_matmul_t(shard, xs[:, c:c + bitmm.T_MAX_F]
                                            .contiguous(), fmt.npp)
                         for c in range(0, f, bitmm.T_MAX_F)], 1)
    real = rdl < fmt.npp            # the dummy slots carry dst npp
    return bitmm.add_remainder(out, xg, rsg[real].long(), rdl[real].long(),
                               rw[real])


class _BitShardedSpMM(torch.autograd.Function):
    """A @ x over the ranks; backward A^T dZ on ``shards_rev``."""

    @staticmethod
    def forward(ctx, x_local, fmt, group):
        ctx.fmt, ctx.group, ctx.x_dtype = fmt, group, x_local.dtype
        lv = lambda a: local_view(fmt, a, group)  # noqa: E731
        return _local_apply(fmt, lv(fmt.shards), lv(fmt.rem_src_g),
                            lv(fmt.rem_dst_l), lv(fmt.rem_w), x_local, group)

    @staticmethod
    def backward(ctx, dz):
        fmt, group = ctx.fmt, ctx.group
        lv = lambda a: local_view(fmt, a, group)  # noqa: E731
        dx = _local_apply(fmt, lv(fmt.shards_rev), lv(fmt.brem_src_g),
                          lv(fmt.brem_dst_l), lv(fmt.brem_w),
                          dz.contiguous(), group)
        return dx.to(ctx.x_dtype), None, None


def bit_sharded_spmm(fmt: BitShardedFormat, x_local: torch.Tensor,
                     group=None) -> torch.Tensor:
    """copy_u/sum SpMM over the ranks of ``group`` on the bitmask shards.

    ``x_local``: this rank's (npp, F) rows of the padded (P npp, F)
    features (:func:`pad_nodes`, :func:`local_rows`); returns this rank's
    (npp, F) f32 output rows.  Rows past ``num_nodes`` are zero.  Every
    rank must call it, and its backward, together."""
    if x_local.ndim != 2 or x_local.shape[0] != fmt.npp:
        raise ValueError(f"x_local must be ({fmt.npp}, F), got "
                         f"{tuple(x_local.shape)}")
    return _BitShardedSpMM.apply(x_local, fmt, group)
