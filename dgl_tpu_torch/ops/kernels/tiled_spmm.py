"""Tile-bucketed SpMM and SDDMM over the tiled format (K3, K4).

Counterpart of ``dgl_tpu/ops/pallas/tiled_spmm.py``.  Edges are bucketed
by (dst tile, src tile) pairs of ``tile`` nodes; a pair with more than
``cap`` edges is split into several buckets.  Every bucket has ``cap``
slots:

    src_local[b, c]  src id within src tile ``src_tile[b]``     (int32)
    dst_local[b, c]  dst id within dst tile ``dst_tile[b]``     (int32)
    eid[b * cap + c] canonical edge id, -1 at a padded slot      (int32)
    valid[b, c]      1.0 for a real edge, 0.0 at a padded slot   (f32)

The slot arrays keep the JAX package's (B, cap // 128, 128) layout, so
``cap`` is a multiple of 128, and the builders here emit the JAX
builder's arrays exactly.  ``dst_tile`` never decreases, so the buckets of
one dst tile are contiguous: ``dst_ptr`` (num_dst_tiles + 1,) holds their
ranges, computed once per format for the CUDA kernels.  The src-side
passes of the slot-space GAT kernels (``gat_fused.py``) walk the buckets
of one src tile: ``with_src_first`` adds ``src_order``, the buckets
sorted by src tile (stable, the JAX format's), and ``src_ptr``
(num_src_tiles + 1,), each src tile's range in it.  Padded slots have
``src_local = dst_local = 0`` and so alias row 0 of their tile: every
kernel and every plain version masks them by ``valid``.

The JAX format's ``chunk_ranges`` is not carried: it splits the buckets
across several ``pallas_call``s for the TPU's 1 MiB scalar-prefetch
limit, and a CUDA grid takes every bucket in one launch.

Three kernels (``csrc/tiled_spmm.cu``), each with a plain PyTorch version
beside it that computes the same function:

* :func:`tiled_spmm` (K3, ``_spmm_one_call``): out[d] = sum w_e x[src_e];
* :func:`tiled_spmm_multihead` (K4): out[d, h, :] = sum w[e, h]
  x[src_e, h, :] with (B, H, C) slot weights;
* :func:`tiled_sddmm_dot_multihead` (K4): e[b, h, c] =
  <x[src, h, :], z[dst, h, :]> for every slot, 0 at padded slots (the
  TPU kernel leaves whatever its one-hot products give there).

The kernels take f32 and sum in f32, where the TPU kernels take bf16
operands.  A wrapper launches its kernel on CUDA tensors and raises if the
build or the launch fails; it takes the plain version only for CPU
tensors.  Each wrapper counts its launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import build
from .dispatch import on_cuda
from ...utils import resolve_device

DEFAULT_TILE = 1024    # dst/src tile size (nodes)
DEFAULT_CAP = 512      # bucket capacity (edges)
LANES = 128            # the slot arrays' last axis; cap is a multiple
PLAIN_SLOTS = 1 << 22  # slots a plain version gathers at a time
_INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class TiledFormat:
    """Tile-bucketed edge format; every tensor lies on one device."""
    src_local: torch.Tensor    # (B, C//128, 128) int32
    dst_local: torch.Tensor    # (B, C//128, 128) int32
    eid: torch.Tensor          # (B*C,) int32, -1 at padded slots
    valid: torch.Tensor        # (B, C//128, 128) f32
    src_tile: torch.Tensor     # (B,) int32
    dst_tile: torch.Tensor     # (B,) int32, non-decreasing
    num_src: int
    num_dst: int
    tile: int
    cap: int
    # (B,) int32 bucket order by src tile (stable), as the JAX format's;
    # set by with_src_first, with src_ptr, for the src-side passes of
    # gat_fused.py (UnitGraph.tiled_format sets both at build)
    src_order: Optional[torch.Tensor] = None
    # (num_dst_tiles + 1,) int32: dst tile t owns buckets
    # [dst_ptr[t], dst_ptr[t + 1])
    dst_ptr: Optional[torch.Tensor] = None
    # (num_src_tiles + 1,) int32: src tile t owns buckets
    # src_order[src_ptr[t]:src_ptr[t + 1]]
    src_ptr: Optional[torch.Tensor] = None
    # (num_edges,) int32 slot of each canonical edge, built at first use
    _edge_slot: Optional[torch.Tensor] = None

    def with_src_first(self) -> "TiledFormat":
        """This format with ``src_order`` and ``src_ptr``, computed on its
        device (once: a format that has them is returned as it is)."""
        if self.src_order is not None:
            return self
        order = torch.argsort(self.src_tile, stable=True).to(torch.int32)
        return dataclasses.replace(self, src_order=order,
                                   src_ptr=_tile_ptr(self.src_tile,
                                                     self.num_src_tiles))

    @property
    def num_buckets(self) -> int:
        return self.src_local.shape[0]

    @property
    def num_src_tiles(self) -> int:
        return -(-self.num_src // self.tile)

    @property
    def num_dst_tiles(self) -> int:
        return -(-self.num_dst // self.tile)

    @property
    def device(self) -> torch.device:
        return self.valid.device

    @property
    def covered_mask(self) -> Optional[torch.Tensor]:
        """(num_dst_tiles * tile,) f32 row mask, 0 on dst tiles with no
        bucket; None when every tile has one.  The JAX format's mask,
        computed on demand: the kernels write zeros on such tiles
        themselves."""
        covered = self.dst_ptr[1:] > self.dst_ptr[:-1]
        if bool(covered.all()):
            return None
        return covered.repeat_interleave(self.tile).to(torch.float32)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.src_local, self.dst_local, self.eid, self.valid,
            self.src_tile, self.dst_tile))

    def edge_slot(self) -> torch.Tensor:
        """(num_edges,) int32: the flat slot b * cap + c of each edge."""
        if self._edge_slot is None:
            slots = torch.nonzero(self.eid >= 0).reshape(-1)
            inv = torch.empty(slots.shape[0], dtype=torch.int32,
                              device=self.device)
            inv[self.eid[slots].long()] = slots.to(torch.int32)
            self._edge_slot = inv
        return self._edge_slot


def _tile_ptr(tiles: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """(n_tiles + 1,) int32 offsets of each tile's run in ``tiles`` sorted."""
    counts = torch.bincount(tiles.long(), minlength=n_tiles)[:n_tiles]
    ptr = torch.zeros(n_tiles + 1, dtype=torch.int64, device=tiles.device)
    ptr[1:] = torch.cumsum(counts, 0)
    return ptr.to(torch.int32)


def _finish(tf: TiledFormat) -> TiledFormat:
    """Attach ``dst_ptr`` (from ``dst_tile``)."""
    return dataclasses.replace(tf, dst_ptr=_tile_ptr(tf.dst_tile,
                                                     tf.num_dst_tiles))


def _check_cap(cap: int):
    if cap <= 0 or cap % LANES:
        raise ValueError(f"cap must be a positive multiple of {LANES}, "
                         f"got {cap}")


def tiled_from_host(h: dict, device="cuda") -> TiledFormat:
    """A TiledFormat on ``device`` from host numpy arrays.

    ``h`` keys: src_local, dst_local, valid and eid (B * C slots, flat or
    (B, C)), src_tile/dst_tile (B,), num_src, num_dst, tile, cap."""
    device = resolve_device(device)
    cap = int(h["cap"])
    _check_cap(cap)
    shape3 = (-1, cap // LANES, LANES)

    def put(name, dtype, shape):
        a = np.ascontiguousarray(np.asarray(h[name]).reshape(shape))
        return torch.as_tensor(a, dtype=dtype).to(device)

    return _finish(TiledFormat(
        src_local=put("src_local", torch.int32, shape3),
        dst_local=put("dst_local", torch.int32, shape3),
        eid=put("eid", torch.int32, (-1,)),
        valid=put("valid", torch.float32, shape3),
        src_tile=put("src_tile", torch.int32, (-1,)),
        dst_tile=put("dst_tile", torch.int32, (-1,)),
        num_src=int(h["num_src"]), num_dst=int(h["num_dst"]),
        tile=int(h["tile"]), cap=cap))


def build_tiled_format(row, col, num_src: int, num_dst: int,
                       tile: int = DEFAULT_TILE, cap: int = DEFAULT_CAP,
                       device="cuda", host_out: dict = None) -> TiledFormat:
    """Bucket edges by (dst_tile, src_tile) on the host (numpy) and move
    the format to ``device``; buckets split at ``cap``.

    A stable sort by key ``dst_tile * num_src_tiles + src_tile`` orders
    the edges; a bucket starts at every ``cap``-th edge of a pair's run.
    ``host_out``, when given, receives the host arrays as the JAX builder
    gives them (slot arrays (B, cap)), for a disk cache."""
    _check_cap(cap)
    row = np.asarray(row).astype(np.int64)
    col = np.asarray(col).astype(np.int64)
    e = len(row)
    n_st = -(-num_src // tile)
    key = (col // tile) * n_st + row // tile
    order = np.argsort(key, kind="stable")
    b = 0
    if e:
        key_s = key[order]
        idx = np.arange(e)
        new_pair = np.r_[True, key_s[1:] != key_s[:-1]]
        run_start = np.maximum.accumulate(np.where(new_pair, idx, 0))
        slot = (idx - run_start) % cap
        first = slot == 0                 # a bucket starts here
        bucket = np.cumsum(first) - 1
        b = int(bucket[-1]) + 1
    nb = max(b, 1)
    src_local = np.zeros(nb * cap, np.int32)
    dst_local = np.zeros(nb * cap, np.int32)
    eid = np.full(nb * cap, -1, np.int32)
    valid = np.zeros(nb * cap, np.float32)
    src_tile = np.zeros(nb, np.int32)
    dst_tile = np.zeros(nb, np.int32)
    if e:
        flat = bucket * cap + slot
        r, c = row[order], col[order]
        src_local[flat] = r % tile
        dst_local[flat] = c % tile
        eid[flat] = order
        valid[flat] = 1.0
        # every edge of a bucket has the bucket's key: read its first one
        src_tile[:] = r[first] // tile
        dst_tile[:] = c[first] // tile
    h = dict(src_local=src_local.reshape(nb, cap),
             dst_local=dst_local.reshape(nb, cap), eid=eid.reshape(nb, cap),
             valid=valid.reshape(nb, cap), src_tile=src_tile,
             dst_tile=dst_tile, num_src=int(num_src), num_dst=int(num_dst),
             tile=int(tile), cap=int(cap))
    if host_out is not None:
        host_out.update(h)
    return tiled_from_host(h, device)


def build_tiled_format_device(row, col, num_src: int, num_dst: int,
                              tile: int = DEFAULT_TILE,
                              cap: int = DEFAULT_CAP,
                              device="cuda") -> TiledFormat:
    """The same format as :func:`build_tiled_format`, built with
    ``torch.sort(stable=True)`` and scatters on ``device``: at Reddit scale
    this avoids a host sort of 115M keys and the copy of 3 GB of slots."""
    device = resolve_device(device)
    _check_cap(cap)
    row = torch.as_tensor(row).to(device=device, dtype=torch.int64)
    col = torch.as_tensor(col).to(device=device, dtype=torch.int64)
    e = row.shape[0]
    n_st = -(-num_src // tile)
    key = (col // tile) * n_st + row // tile
    key_s, order = torch.sort(key, stable=True)
    del key
    b = 0
    if e:
        idx = torch.arange(e, device=device)
        new_pair = torch.ones(e, dtype=torch.bool, device=device)
        new_pair[1:] = key_s[1:] != key_s[:-1]
        del key_s
        run_start = torch.cummax(torch.where(new_pair, idx, 0), 0).values
        del new_pair
        slot = (idx - run_start) % cap
        del idx, run_start
        first = slot == 0
        flat = torch.cumsum(first, 0) - 1
        b = int(flat[-1]) + 1
        flat = flat * cap + slot
        del slot
    nb = max(b, 1)

    def fill(value, dtype):
        return torch.full((nb * cap,), value, dtype=dtype, device=device)

    src_local, dst_local = fill(0, torch.int32), fill(0, torch.int32)
    eid, valid = fill(-1, torch.int32), fill(0, torch.float32)
    src_tile = torch.zeros(nb, dtype=torch.int32, device=device)
    dst_tile = torch.zeros(nb, dtype=torch.int32, device=device)
    if e:
        r = row[order]
        src_local[flat] = (r % tile).to(torch.int32)
        src_tile[:] = (r[first] // tile).to(torch.int32)
        del r
        c = col[order]
        dst_local[flat] = (c % tile).to(torch.int32)
        dst_tile[:] = (c[first] // tile).to(torch.int32)
        del c
        eid[flat] = order.to(torch.int32)
        valid[flat] = 1.0
    shape3 = (nb, cap // LANES, LANES)
    return _finish(TiledFormat(
        src_local=src_local.view(shape3), dst_local=dst_local.view(shape3),
        eid=eid, valid=valid.view(shape3), src_tile=src_tile,
        dst_tile=dst_tile, num_src=int(num_src), num_dst=int(num_dst),
        tile=int(tile), cap=int(cap)))


def slot_edge_weights(tf: TiledFormat, edge_weights) -> torch.Tensor:
    """Canonical-order (E,) edge weights in the (B, C//128, 128) slot
    layout of ``tf``, 0 at padded slots.  For weights that stay fixed
    across steps, ``UnitGraph.cache_edge_weights`` computes this once."""
    ew = torch.as_tensor(edge_weights).reshape(-1, 1).to(torch.float32)
    return slot_edge_tensor(tf, ew).view(tf.valid.shape)


def slot_edge_tensor(tf: TiledFormat, efeat) -> torch.Tensor:
    """Canonical (E, F) edge features in the (B, C, F) slot order of
    ``tf``, 0 at padded slots (``gat_fused.py:1037``): one gather on the
    format's device, to be done once at set-up."""
    ef = torch.as_tensor(efeat).to(tf.device)
    ef = ef.reshape(ef.shape[0], -1)
    if ef.shape[0] == 0:           # no edge: every slot is padding
        return ef.new_zeros(tf.num_buckets, tf.cap, ef.shape[1])
    rows = torch.index_select(ef, 0, tf.eid.clamp(min=0))
    return (rows * tf.valid.view(-1, 1)).view(tf.num_buckets, tf.cap, -1)



def unslot_edge_tensor(tf: TiledFormat, slot_tensor) -> torch.Tensor:
    """The inverse of :func:`slot_edge_tensor`: a (B, C, F) slot tensor
    back in canonical (E, F) edge order, E the largest edge id plus one
    (``gat_fused.py:1057``)."""
    flat = slot_tensor.reshape(tf.num_buckets * tf.cap, -1)
    live = torch.nonzero(tf.eid >= 0).reshape(-1)
    eid = tf.eid[live].long()
    n = int(eid.max()) + 1 if eid.numel() else 0
    out = flat.new_zeros(n, flat.shape[1])
    out[eid] = flat[live]
    return out


# -- the plain PyTorch versions ---------------------------------------------

def _slot_chunks(tf: TiledFormat):
    """Yield (b, c, src, dst) for the valid slots of PLAIN_SLOTS-slot
    chunks of buckets: bucket and slot indices and the global src and dst
    node ids, all int64."""
    c_all, t = tf.cap, tf.tile
    step = max(1, PLAIN_SLOTS // c_all)
    for b0 in range(0, tf.num_buckets, step):
        b1 = min(b0 + step, tf.num_buckets)
        keep = tf.valid[b0:b1].reshape(b1 - b0, c_all) > 0
        bb, cc = torch.nonzero(keep, as_tuple=True)
        src = (tf.src_tile[b0:b1].long()[bb] * t
               + tf.src_local[b0:b1].reshape(-1, c_all)[bb, cc])
        dst = (tf.dst_tile[b0:b1].long()[bb] * t
               + tf.dst_local[b0:b1].reshape(-1, c_all)[bb, cc])
        yield b0 + bb, cc, src, dst


def tiled_spmm_plain(tf: TiledFormat, x: torch.Tensor,
                     w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3's function: (num_dst, F) f32, out[d] = sum over valid slots of
    w * x[src] (w = 1 when None), ``w`` in the slot layout."""
    out = torch.zeros(tf.num_dst, x.shape[1], dtype=torch.float32,
                      device=x.device)
    wf = None if w is None else w.reshape(tf.num_buckets, tf.cap)
    for b, c, src, dst in _slot_chunks(tf):
        v = x[src].float()
        if wf is not None:
            v = v * wf[b, c].unsqueeze(1)
        out.index_add_(0, dst, v)
    return out


def tiled_spmm_multihead_plain(tf: TiledFormat, x3: torch.Tensor,
                               w_slot: torch.Tensor) -> torch.Tensor:
    """K4 SpMM's function: (num_dst, H, Fh) f32, out[d, h] = sum over
    valid slots of w_slot[b, h, c] * x3[src, h]."""
    out = torch.zeros((tf.num_dst,) + tuple(x3.shape[1:]),
                      dtype=torch.float32, device=x3.device)
    for b, c, src, dst in _slot_chunks(tf):
        out.index_add_(0, dst, x3[src].float() * w_slot[b, :, c]
                       .unsqueeze(-1))
    return out


def tiled_sddmm_dot_multihead_plain(tf: TiledFormat, x3: torch.Tensor,
                                    z3: torch.Tensor) -> torch.Tensor:
    """K4 SDDMM's function: (B, H, C) f32, e[b, h, c] =
    <x3[src, h], z3[dst, h]> at valid slots and 0 at padded ones."""
    out = torch.zeros(tf.num_buckets, x3.shape[1], tf.cap,
                      dtype=torch.float32, device=x3.device)
    for b, c, src, dst in _slot_chunks(tf):
        out[b, :, c] = (x3[src].float() * z3[dst].float()).sum(-1)
    return out


# -- the kernel wrappers ------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    "dgl_tiled_spmm": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _P,
                       _I, _P, _I, _I, _I, _I, _I, _P],
    "dgl_tiled_sddmm_mh": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I,
                           _P, _I, _I, _I, _P],
}
_SMEM_PER_BLOCK = 232_448   # shared memory a block may use on Hopper
_SPMM_WARPS = 16            # csrc/tiled_spmm.cu kSpmmWarps
_SDDMM_WARPS = 8            # csrc/tiled_spmm.cu kSddmmWarps


def _launch(fn: str, *args):
    lib = build.load("tiled_spmm", _SIGNATURES)
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {err}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _check_operand(tf: TiledFormat, x: torch.Tensor, rows: int, ndim: int,
                   what: str):
    if x.ndim != ndim or x.shape[0] != rows:
        raise ValueError(f"{what} has shape {tuple(x.shape)}; the format "
                         f"needs {ndim} dims and {rows} rows")
    if x.device != tf.device:
        raise ValueError(f"{what} lies on {x.device}, the format on "
                         f"{tf.device}")


def _check_int32(*sizes):
    """The kernels index with int32: every flat size must fit."""
    if max(sizes) > _INT32_MAX:
        raise ValueError(f"a flat size of {max(sizes)} does not fit the "
                         f"kernels' int32 indexing")


def _group(f: int, tile: int) -> int:
    """Columns one block keeps per dst row (lanes per slot): the
    narrowest of 8, 16, 32 that covers F, within the shared memory of a
    (tile, group) f32 block."""
    g = 8 if f <= 8 else 16 if f <= 16 else 32
    while g > 8 and tile * g * 4 > _SMEM_PER_BLOCK:
        g //= 2
    if tile * g * 4 > _SMEM_PER_BLOCK:
        raise ValueError(f"tile {tile} is too large for the kernels' "
                         "shared-memory accumulator")
    return g


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _splits(tf: TiledFormat, n_tiles: int, blocks_per_tile: int,
            per_sm: int, device) -> int:
    """Splits of each tile's buckets over blocks: about two waves of the
    ``per_sm`` blocks that fit an SM at once, each split keeping about 4
    buckets or more of its tile."""
    want = -(-2 * _sms(device) * per_sm // max(n_tiles * blocks_per_tile,
                                               1))
    return max(1, min(want, tf.num_buckets // max(4 * n_tiles, 1), 65535))


def _group_per_sm(g: int, tile: int) -> int:
    """Blocks of a (tile, g) shared-memory accumulator that fit an SM at
    once, with the registers of 512 threads at g = 32."""
    return max(1, min(2 if g <= 16 else 1, _SMEM_PER_BLOCK // (tile * g * 4)))


def _spmm_launch(tf: TiledFormat, x: torch.Tensor, w, w_bucket_stride: int,
                 w_head_stride: int, head_cols: int, wrapper):
    """out (num_dst, F) f32 from one launch of csrc ``tiled_spmm_kernel``
    over x viewed as (num_src, F); counts the launch on ``wrapper``."""
    f = x.shape[1]
    b = tf.num_buckets
    _check_int32(b * tf.cap, tf.num_src_tiles * tf.tile * f,
                 tf.num_dst_tiles * tf.tile * f,
                 b * max(w_bucket_stride, tf.cap))
    g = _group(f, tf.tile)
    n_dt = tf.num_dst_tiles
    n_chunks = -(-f // g)
    splits = _splits(tf, n_dt, n_chunks, _group_per_sm(g, tf.tile), x.device)
    alloc = torch.zeros if splits > 1 else torch.empty
    out = alloc(tf.num_dst, f, dtype=torch.float32, device=x.device)
    if n_dt == 0 or f == 0:
        return out
    _launch("dgl_tiled_spmm", tf.src_local.data_ptr(),
            tf.dst_local.data_ptr(), tf.valid.data_ptr(),
            0 if w is None else w.data_ptr(), w_bucket_stride,
            w_head_stride, head_cols, tf.src_tile.data_ptr(),
            tf.dst_ptr.data_ptr(), n_dt, tf.tile, tf.cap, x.data_ptr(), f,
            out.data_ptr(), tf.num_dst, g, splits,
            int(wrapper is tiled_spmm_multihead), x.device.index,
            _stream(x.device))
    wrapper.launches += 1
    return out


def tiled_spmm(tf: TiledFormat, x: torch.Tensor, edge_weights=None,
               slot_weights=None) -> torch.Tensor:
    """K3: out[d] = sum_{e: dst(e) = d} w_e * x[src(e)], (num_dst, F) f32.

    ``edge_weights``: (num_edges,) per-edge scalars in canonical order, or
    None for a plain sum.  ``slot_weights``: the same already in the slot
    layout (:func:`slot_edge_weights`); it overrides ``edge_weights``."""
    _check_operand(tf, x, tf.num_src, 2, "x")
    w = slot_weights
    if w is None and edge_weights is not None:
        w = slot_edge_weights(tf, edge_weights)
    if w is not None and tuple(w.shape) != tuple(tf.valid.shape):
        raise ValueError(f"slot weights have shape {tuple(w.shape)}, the "
                         f"format {tuple(tf.valid.shape)}")
    if not on_cuda(x, tf.valid, *(() if w is None else (w,))):
        return tiled_spmm_plain(tf, x, w)
    x = x.float().contiguous()
    w = None if w is None else w.float().contiguous()
    return _spmm_launch(tf, x, w, tf.cap, 0, 1, tiled_spmm)


tiled_spmm.launches = 0


def tiled_spmm_multihead(tf: TiledFormat, x3: torch.Tensor,
                         w_slot: torch.Tensor, H: int, Fh: int):
    """K4 SpMM: out[d, h, f] = sum_e w[e, h] x3[src_e, h, f].

    ``x3``: (num_src, H, Fh); ``w_slot``: (B, H, C) per-slot weights.
    Returns (num_dst, H, Fh) f32."""
    _check_operand(tf, x3, tf.num_src, 3, "x3")
    if tuple(x3.shape[1:]) != (H, Fh) or tuple(w_slot.shape) != (
            tf.num_buckets, H, tf.cap):
        raise ValueError(f"x3 {tuple(x3.shape)} or w_slot "
                         f"{tuple(w_slot.shape)} do not match H={H}, "
                         f"Fh={Fh} and the format")
    if not on_cuda(x3, w_slot, tf.valid):
        return tiled_spmm_multihead_plain(tf, x3, w_slot)
    x = x3.float().contiguous().view(tf.num_src, H * Fh)
    w = w_slot.float().contiguous()
    out = _spmm_launch(tf, x, w, H * tf.cap, tf.cap, Fh,
                       tiled_spmm_multihead)
    return out.view(tf.num_dst, H, Fh)


tiled_spmm_multihead.launches = 0


def _lanes_per_head(heads: int) -> int:
    """Lanes of a warp that share one head's dot product: 32 over the
    heads rounded up to a power of two, at least 1."""
    p = 1
    while p < min(heads, 32):
        p *= 2
    return 32 // p


def tiled_sddmm_dot_multihead(tf: TiledFormat, x3: torch.Tensor,
                              z3: torch.Tensor, H: int, Fh: int):
    """K4 SDDMM: e[b, h, c] = <x3[src, h, :], z3[dst, h, :]> for every
    slot, 0 at padded slots.  ``x3`` (num_src, H, Fh), ``z3``
    (num_dst, H, Fh).  Returns (B, H, C) f32 in slot order."""
    _check_operand(tf, x3, tf.num_src, 3, "x3")
    _check_operand(tf, z3, tf.num_dst, 3, "z3")
    if tuple(x3.shape[1:]) != (H, Fh) or tuple(z3.shape[1:]) != (H, Fh):
        raise ValueError(f"x3 {tuple(x3.shape)} or z3 {tuple(z3.shape)} do "
                         f"not match H={H}, Fh={Fh}")
    if not on_cuda(x3, z3, tf.valid):
        return tiled_sddmm_dot_multihead_plain(tf, x3, z3)
    b = tf.num_buckets
    _check_int32(b * H * tf.cap, tf.num_src_tiles * tf.tile * H * Fh,
                 tf.num_dst_tiles * tf.tile * H * Fh)
    out = torch.empty(b, H, tf.cap, dtype=torch.float32, device=x3.device)
    if H * Fh == 0:
        return out.zero_()
    x = x3.float().contiguous()
    z = z3.float().contiguous()
    chunks = b * tf.cap // 32
    blocks = max(1, min(-(-chunks // _SDDMM_WARPS), 16 * _sms(x.device)))
    _launch("dgl_tiled_sddmm_mh", tf.src_local.data_ptr(),
            tf.dst_local.data_ptr(), tf.valid.data_ptr(),
            tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(), b, tf.tile,
            tf.cap, x.data_ptr(), z.data_ptr(), H, Fh, out.data_ptr(),
            _lanes_per_head(H), blocks, x.device.index, _stream(x.device))
    tiled_sddmm_dot_multihead.launches += 1
    return out


tiled_sddmm_dot_multihead.launches = 0
