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

Three kernels, each with a plain PyTorch version beside it that computes
the same function:

* :func:`tiled_spmm` (K3, ``_spmm_one_call``; ``csrc/row_agg.cu``):
  out[d] = sum w_e x[src_e], the row walk by dst (below) at one head, its
  weightless instance for a plain sum;
* :func:`tiled_spmm_multihead` (K4; ``csrc/row_agg.cu``): out[d, h, :] =
  sum w[e, h] x[src_e, h, :] with (B, H, C) slot weights, a walk of the
  format's row view by dst (below), which ``gat_fused.src_aggregate``
  takes by src;
* :func:`tiled_sddmm_dot_multihead` (K4; ``csrc/row_agg.cu``):
  e[b, h, c] = <x[src, h, :], z[dst, h, :]> for every slot, 0 at padded
  slots (the TPU kernel leaves whatever its one-hot products give there),
  a walk of the row view by dst that keeps z[dst] in registers and
  gathers x[src] (:func:`sddmm_walk`); its scores mode (:func:`sddmm_dots`
  with ``attn``) serves ``gat_fused.vattn_scores`` (K9).

The same row views serve K6's slot reduce (``gat_fused.slot_reduce``):
:func:`row_reduce` sums a (B, H, C) slot tensor over each row's entries
(csrc ``row_reduce_kernel``); the slot walk (:func:`slot_walk`, csrc
``row_slot_kernel``) sums rows read at each entry's slot (K10 v1's
numerator and dx with dfe, K11 v1's node sums, K10 v2's slot-feature
reduce); and the dot-product walk with K10 v1's stored row read at the
entry's slot (:func:`sddmm_store_dots`) gives its ds.

The row view (:class:`RowView`, ``TiledFormat.row_view``) lists the valid
slots of one side's rows: per row, ascending slot id, the flat slot and
the global id of the node at the other end, with each row's range and the
order in which the walk claims the rows (hubs first, then by id).  It is
built on the format's device at first use and cached: 8 B an edge and 8 B
a row a side (about 0.92 GB a side at Reddit's 115M edges); K4's SDDMM
adds the dst view's slot -> entry map (:meth:`RowView.entries`, 4 B a
slot, 0.75 GB at Reddit's 187M slots).  Carrying the
neighbour's id doubles it but saves the row walk a dependent 4-byte read
of ``src_local`` or ``dst_local`` at a random slot, which costs a 32-byte
sector.

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
class RowView:
    """The valid slots of a TiledFormat grouped by the rows of one side
    (dst or src), all int32 on the format's device: row r owns entries
    [ptr[r], ptr[r + 1]) of ``slot`` (the flat slot b * cap + c,
    ascending within a row) and ``nbr`` (the global id of the node at the
    slot's other end); ``order`` is the order in which the row walk claims
    the rows: the hub rows by degree, largest first, then the rest by id
    (``_build_row_view``)."""
    ptr: torch.Tensor      # (rows + 1,)
    slot: torch.Tensor     # (E,)
    nbr: torch.Tensor      # (E,)
    order: torch.Tensor    # (rows,)
    # (slots,) int32 entry of each slot, -1 where none, built at first use
    _entries: Optional[torch.Tensor] = None

    @property
    def rows(self) -> int:
        return self.order.shape[0]

    def entries(self, slots: int) -> torch.Tensor:
        """(slots,) int32: the entry k of each flat slot in this view
        (slot[k] = s), -1 at a slot the view does not list; built on the
        view's device at first use and cached (4 B a slot)."""
        if self._entries is None:
            e = torch.full((slots,), -1, dtype=torch.int32,
                           device=self.slot.device)
            e[self.slot.long()] = torch.arange(
                self.slot.numel(), dtype=torch.int32, device=e.device)
            self._entries = e
        return self._entries

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.ptr, self.slot, self.nbr, self.order))


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
    # the row views by dst and by src, each built at first use
    _rows_dst: Optional[RowView] = None
    _rows_src: Optional[RowView] = None

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

    def row_view(self, side: str = "dst") -> RowView:
        """The :class:`RowView` of ``side`` ("dst" or "src"), built on the
        format's device at first use and cached."""
        if side not in ("dst", "src"):
            raise ValueError(f"side must be 'dst' or 'src', got {side!r}")
        name = f"_rows_{side}"
        if getattr(self, name) is None:
            setattr(self, name, _build_row_view(self, side))
        return getattr(self, name)


HUB_DEGREE = 4   # rows above this many times the mean degree go first


def _build_row_view(tf: TiledFormat, side: str,
                    hub_degree: float = HUB_DEGREE) -> RowView:
    """The row view of ``side``: a stable sort of the valid slots (in slot
    order) by their row's global id.  The claim order lists the hub rows,
    of more than ``hub_degree`` times the mean degree, by degree, largest
    first, so that none starts late and holds up the end of a launch; then
    the other rows by id, so that the rows walked at once share buckets
    (and their weights' sectors) and neighbours in L2.  ``hub_degree`` 0
    claims every row with a slot by degree, ``inf`` every row by id."""
    flat = torch.nonzero(tf.valid.reshape(-1) > 0).reshape(-1).to(
        torch.int32)
    b = flat.div(tf.cap, rounding_mode="floor")
    src = (tf.src_tile[b] * tf.tile
           + tf.src_local.reshape(-1)[flat]).to(torch.int32)
    dst = (tf.dst_tile[b] * tf.tile
           + tf.dst_local.reshape(-1)[flat]).to(torch.int32)
    del b
    row, nbr, n = ((dst, src, tf.num_dst) if side == "dst"
                   else (src, dst, tf.num_src))
    row, perm = torch.sort(row, stable=True)
    counts = torch.bincount(row, minlength=n)
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=flat.device)
    ptr[1:] = torch.cumsum(counts, 0)
    return RowView(ptr=ptr.to(torch.int32), slot=flat[perm],
                   nbr=nbr[perm], order=hub_first_order(counts, hub_degree))


def hub_first_order(counts: torch.Tensor,
                    hub_degree: float = HUB_DEGREE) -> torch.Tensor:
    """(rows,) int32: the order in which a row walk claims rows of
    ``counts`` entries: the hub rows, of more than ``hub_degree`` times the
    mean count, by count, largest first, then the other rows by id."""
    n = counts.shape[0]
    hub = counts * n > hub_degree * counts.sum()
    hubs = torch.nonzero(hub).reshape(-1)
    hubs = hubs[torch.sort(counts[hubs], descending=True, stable=True)
                .indices]
    return torch.cat([hubs, torch.nonzero(~hub).reshape(-1)]).to(
        torch.int32)


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
    "row_agg": {
        "dgl_row_agg": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P,
                        _I, _P, _P, _I, _I, _I, _I, _I, _P],
        "dgl_row_node_grad": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                              _P, _I, _P, _P, _I, _I, _I, _I, _P, _P,
                              ctypes.c_float, _P, _I, _P],
        "dgl_row_node_grad_attrs": [_I, _I, _I, _I, _P],
        "dgl_row_fe_grad": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P,
                            _I, _P, _P, _I, _I, _I, _I, _P, _P,
                            ctypes.c_float, _P, _I, _P, _I, _P, _I, _I, _P],
        "dgl_row_fe_grad_attrs": [_I, _I, _I, _I, _P],
        "dgl_row_sddmm": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _P, _I, _P, _I, _I, _P],
        "dgl_row_vattn": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _P, _I, _P, _I, _P, ctypes.c_float, _I, _P],
        "dgl_slot_finish": [_P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I,
                            _P],
        "dgl_ds_finish": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                          ctypes.c_double, _P, _I, _I, _I, _I, _P],
        "dgl_ds_finish_edge": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                               _P, ctypes.c_double, _P, _I, _I, _P, _I, _I,
                               _I, _P, _P, _I, _I, _P, _P, _I, _I, _P],
        "dgl_row_sddmm_store": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I,
                                _I, _I, _I, _P],
        "dgl_row_vattn_store": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I,
                                _I, _I, _P, ctypes.c_float, _I, _P],
        "dgl_row_sddmm_store_attrs": [_I, _I, _I, _I, _P],
        "dgl_row_vattn_fe": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                             _P, _I, _P, _P, ctypes.c_float, _P, _P, _I, _P,
                             _I, _P, _I, _I, _P],
        "dgl_row_vattn_fe_attrs": [_I, _I, _P],
        "dgl_row_slot": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P,
                         _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I,
                         _I, _P],
        "dgl_row_slot_attrs": [_I, _I, _I, _I, _I, _P],
        "dgl_row_slot_grad": [_P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I,
                              _I, _I, _P, _P, _P, ctypes.c_float, _P, _P,
                              _I, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                              _I, _P, _I, _I, _I, _P],
        "dgl_row_slot_grad_attrs": [_I, _I, _I, _I, _P],
        "dgl_row_reduce": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P,
                           _I, _I, _I, _I, _I, _I, _P],
        "dgl_row_reduce_attrs": [_I, _I, _I, _P]},
}


def _launch(fn: str, *args, source: str = "row_agg"):
    lib = build.load(source, _SIGNATURES[source])
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


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


FOLD_CPL = 4   # vectors a lane of the node-gradient walk with da folded in


def _row_layout(f: int, head_cols: int, *rows: torch.Tensor, max_cpl=8):
    """(vec, cpl, lpr, n_chunks) of the row walk over F = ``f`` columns of
    ``head_cols`` a head: floats a load (4 where a head's width and the
    addresses of the tensors whose ``rows`` it loads allow 16-byte loads,
    else 2 or 1), vectors a lane, lanes a row (the F / vec vectors rounded
    up to a power of two, at most 32) and the column chunks, each walking
    the row once (one up to 32 * ``max_cpl`` vectors; the walk with da
    folded in keeps at most FOLD_CPL)."""
    vec = 4
    while vec > 1 and (head_cols % vec or any(t.data_ptr() % (4 * vec)
                                              for t in rows)):
        vec //= 2
    nv = f // vec
    lpr = 1
    while lpr < min(nv, 32):
        lpr *= 2
    cpl = 1
    while cpl < max_cpl and lpr * cpl < nv:
        cpl *= 2
    return vec, cpl, lpr, -(-nv // (lpr * cpl))


FE_MIN_LANES = 8     # csrc/row_agg.cu kFeMinLanes: lanes a row, at least
FE_LANE_FLOATS = 4   # columns a lane of the walk with the edge term


def fe_kf(fe: int) -> int:
    """The rows of wf a lane of the walk with the edge term holds (KF) for
    ``fe`` edge features, padded to whole 16-byte vectors: 8, 16 or 32."""
    fe4 = -(-fe // 4) * 4
    for kf in (8, 16, 32):
        if fe4 <= kf:
            return kf
    raise ValueError(f"the node-gradient walk takes at most 32 edge "
                     f"features, got {fe}")


def fe_layout(f: int, head_cols: int, *rows: torch.Tensor,
              lane_floats: int = FE_LANE_FLOATS):
    """(vec, cpl, lpr, n_chunks) of the node-gradient walk with the edge
    term: :func:`_row_layout`'s loads, at most ``lane_floats`` columns a
    lane (a lane keeps its columns of wf in registers) and at least
    FE_MIN_LANES lanes a row (a warp's groups share its shared memory)."""
    vec = min(_row_layout(f, head_cols, *rows)[0], lane_floats)
    nv = f // vec
    lpr = FE_MIN_LANES
    while lpr < min(nv, 32):
        lpr *= 2
    cpl = 1
    while cpl * vec < lane_floats and lpr * cpl < nv:
        cpl *= 2
    return vec, cpl, lpr, -(-nv // (lpr * cpl))


def row_walk(view: RowView, cap: int, y: torch.Tensor, w: torch.Tensor,
             out: torch.Tensor, fn=None, grad=None, edge=None, layout=None):
    """One launch of csrc ``row_agg_kernel`` over the rows of
    ``view.order``: out[r, h] = sum over row r's entries k of w[b, h, c] *
    y[nbr[k], h], slot[k] = b * cap + c, in slot order, 0 at a row with no
    entry.  CUDA tensors, f32: ``y`` (neighbours, H, D) contiguous, ``w``
    (B, H, cap) in any strides, read in place, or None for weights of 1
    (the weightless instance, which reads neither w nor ``view.slot``);
    ``out`` (rows, H, D) contiguous.  ``fn``: the C function to launch, by
    default
    ``dgl_row_agg`` of ``csrc/row_agg.cu``.  ``grad`` = (own (rows, H, D)
    contiguous, attn (H, D) contiguous, slope): K9's node gradient instead
    (``dgl_row_node_grad``), out[r, h, d] = attn[h, d] * the sum of w[b,
    h, c] * (own[r, h, d] + y[nbr[k], h, d] >= 0 ? 1 : slope); with a
    fourth, da (H * D,) zeroed, its da folded in too: da[h * D + d] += the
    sum over every row's entries of w[b, h, c] * lrelu(own[r, h, d] +
    y[nbr[k], h, d]).  ``edge`` = (ef (slots, 4 fq) contiguous and zero
    past fe, fq, wf (fe, H * D) contiguous, fe, bias (H * D,) or None,
    kf): with ``grad``, K11 v2's node gradient (``dgl_row_fe_grad``), the
    edge term ef[slot] . wf + bias added to raw; ``layout`` (vec, cpl,
    lpr, n_chunks) in place of :func:`fe_layout`'s, and ``fn`` in place of
    ``dgl_row_fe_grad``.  Counts nothing."""
    heads, hc = y.shape[1], y.shape[2]
    f = heads * hc
    w_strides = (0, 0, 0) if w is None else tuple(w.stride())
    _check_int32(y.numel(), out.numel(),
                 0 if w is None else sum((n - 1) * st for n, st in
                                         zip(w.shape, w.stride())))
    if edge is not None:
        own, attn, slope = grad
        ef, fq, wf, fe, bias, kf = edge
        _check_int32(ef.numel(), wf.numel())
        vec, cpl, lpr, n_chunks = (fe_layout(f, hc, y, own) if layout is None
                                   else layout)
        _check_int32(view.rows * n_chunks + 2048 * _sms(y.device))
        counter = torch.zeros(1, dtype=torch.int32, device=y.device)
        args = (view.ptr.data_ptr(), view.slot.data_ptr(),
                view.nbr.data_ptr(), view.order.data_ptr(), view.rows,
                w.data_ptr(), cap, *w_strides, hc, y.data_ptr(), f,
                out.data_ptr(), counter.data_ptr(), vec, cpl, lpr, n_chunks,
                own.data_ptr(), attn.data_ptr(), slope, ef.data_ptr(), fq,
                wf.data_ptr(), fe, None if bias is None else bias.data_ptr(),
                kf, y.device.index, _stream(y.device))
        if fn is None:
            _launch("dgl_row_fe_grad", *args)
        elif fn(*args) != 0:
            raise RuntimeError("dgl_row_fe_grad failed to launch")
        return
    fold = grad is not None and len(grad) > 3
    vec, cpl, lpr, n_chunks = _row_layout(
        f, hc, y, *(() if grad is None else grad[:1] + grad[3:]),
        max_cpl=FOLD_CPL if fold else 8)
    # the claim counter passes rows * n_chunks by at most a lane an SM
    _check_int32(view.rows * n_chunks + 2048 * _sms(y.device))
    counter = torch.zeros(1, dtype=torch.int32, device=y.device)
    args = (view.ptr.data_ptr(), view.slot.data_ptr(), view.nbr.data_ptr(),
            view.order.data_ptr(), view.rows,
            None if w is None else w.data_ptr(), cap, *w_strides, heads, hc,
            y.data_ptr(), f, out.data_ptr(),
            counter.data_ptr(), vec, cpl, lpr, n_chunks, y.device.index,
            _stream(y.device))
    if grad is not None:
        own, attn, slope = grad[:3]
        _launch("dgl_row_node_grad", *args[:-2], own.data_ptr(),
                attn.data_ptr(), slope, grad[3].data_ptr() if fold else None,
                *args[-2:], source="row_agg")
    elif fn is None:
        _launch("dgl_row_agg", *args, source="row_agg")
    elif fn(*args) != 0:
        raise RuntimeError("dgl_row_agg failed to launch")


def node_grad_kernel_attrs(vec: int, cpl: int, fold: bool, device=None):
    """(registers a thread, local-memory bytes a thread) of the
    node-gradient walk's instance ``row_agg_kernel<vec, cpl, true, fold>``
    (``fold``: da folded in), from ``cudaFuncGetAttributes``: local bytes
    above 0 are a stack frame or spills."""
    device = torch.device("cuda") if device is None else torch.device(device)
    out = (ctypes.c_int * 2)()
    lib = build.load("row_agg", _SIGNATURES["row_agg"])
    err = lib.dgl_row_node_grad_attrs(vec, cpl, int(fold), device.index or 0,
                                      ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"dgl_row_node_grad_attrs: CUDA error {err}")
    return out[0], out[1]


def fe_grad_kernel_attrs(vec: int, cpl: int, kf: int, device=None):
    """(registers a thread, local-memory bytes a thread, resident blocks an
    SM) of the node-gradient walk with the edge term at ``vec``, ``cpl``
    and ``kf`` (``row_fe_grad_kernel<vec, cpl, kf>``), from
    ``cudaFuncGetAttributes`` and the occupancy calculator."""
    device = torch.device("cuda") if device is None else torch.device(device)
    out = (ctypes.c_int * 3)()
    lib = build.load("row_agg", _SIGNATURES["row_agg"])
    err = lib.dgl_row_fe_grad_attrs(vec, cpl, kf, device.index or 0,
                                    ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"dgl_row_fe_grad_attrs: CUDA error {err}")
    return out[0], out[1], out[2]


def padded_width(hc: int) -> int:
    """The row walk's head width for ``hc`` columns: the next multiple of
    4 where that adds at most an eighth, else ``hc``."""
    hp = -(-hc // 4) * 4
    return hc if (hp - hc) * 8 > hc else hp


def pad_heads(t: torch.Tensor, hp: int) -> torch.Tensor:
    """(n, H, hc) as (n, H, hp) f32, contiguous, each head zero-padded."""
    if t.shape[2] == hp:
        return t.float().contiguous()
    p = torch.zeros(t.shape[0], t.shape[1], hp, dtype=torch.float32,
                    device=t.device)
    p[..., :t.shape[2]] = t
    return p


def edge_rows(ef_slot):
    """(ef (slots, 4 fq) f32 in slot order, each row padded with zeros to
    whole 16-byte vectors (a copy unless it is so already), fq): the edge
    features as the walks read them, a 16-byte vector at a time."""
    fe = ef_slot.shape[2]
    fq = -(-fe // 4)
    ef = ef_slot.float().reshape(-1, fe)
    if fe % 4 or ef.data_ptr() % 16:
        ef = torch.nn.functional.pad(ef, (0, 4 * fq - fe))
    else:
        ef = ef.contiguous()
    return ef, fq


def edge_operands(ef_slot, wf, heads: int, hp: int):
    """The edge term as the node-gradient walk takes it (``row_walk``'s
    ``edge``): ef and fq (:func:`edge_rows`); wf's first Fe rows and the
    bias row (or None) with each head's columns padded to ``hp``; Fe; and
    :func:`fe_kf`."""
    fe = ef_slot.shape[2]
    ef, fq = edge_rows(ef_slot)
    wf = wf.float().reshape(wf.shape[0], heads, -1)
    # a copy of its own: the walk loads it as own's rows, aligned alike
    bias = (pad_heads(wf[fe:], hp).reshape(-1).clone() if wf.shape[0] > fe
            else None)
    return ef, fq, pad_heads(wf[:fe], hp).reshape(fe, -1), fe, bias, \
        fe_kf(fe)


def row_aggregate(tf: TiledFormat, side: str, y3: torch.Tensor,
                  w_slot: torch.Tensor, wrapper, grad=None, with_da=False,
                  edge=None, layout=None, fn=None):
    """:func:`row_walk` over every row of ``side`` (dst: the dst nodes,
    neighbours the srcs; src: the reverse) on CUDA tensors: (rows, H, D)
    f32, out[r, h] = sum over the valid slots of row r of w_slot[b, h, c]
    * y3[nbr, h].  ``y3`` (neighbours, H, D), ``w_slot`` (B, H, C), or None
    for weights of 1 (K3's plain sum); counts the launch on ``wrapper``.
    ``grad`` = (own3 (rows, H, D), attn (H, D), slope): K9's node gradient
    instead (:func:`row_walk`); with ``with_da`` its da folded in, and
    (out, da (H, D)) returned; with ``edge`` = (ef_slot (B, C, Fe), wf (Fe
    or Fe + 1 with the bias row, H * D)) as well, K11 v2's, the edge term
    formed per entry (``layout`` and ``fn`` as :func:`row_walk` takes
    them: a probe's).

    A head width that is not a multiple of 4 is padded to one (y copied
    into zeroed rows, out sliced), so that the walk takes 16-byte loads,
    where the pad adds at most an eighth to the row: at (1, 41) the
    scalar loads of 164-byte rows held the walk back
    (``dgl_tpu_torch/tools/perf_row_walk.py``)."""
    heads, hc = y3.shape[1], y3.shape[2]
    rows = tf.num_dst if side == "dst" else tf.num_src
    out = torch.empty(rows, heads, hc, dtype=torch.float32,
                      device=y3.device)
    if heads * hc == 0 or rows == 0:
        if with_da:
            return out.zero_(), torch.zeros(heads, hc, dtype=torch.float32,
                                            device=y3.device)
        return out.zero_()
    # slot-major weights (a copy unless already so laid out): a slot's H
    # weights then share a sector; read in the (B, H, C) layout they lie
    # in H sectors, and at H > 1 the walk took longer than the copy and the
    # walk on it together (dgl_tpu_torch/tools/perf_row_walk.py)
    w = (None if w_slot is None else
         w_slot.float().transpose(1, 2).contiguous().transpose(1, 2))
    hp = padded_width(hc)
    da = None
    if grad is not None:
        own, attn, slope = grad
        grad = (pad_heads(own, hp), pad_heads(attn.reshape(1, heads, hc), hp),
                slope)
        if with_da:
            da = torch.zeros(heads * hp, dtype=torch.float32,
                             device=y3.device)
            grad += (da,)
    if edge is not None:
        edge = edge_operands(*edge, heads, hp)
    wide = out if hp == hc else torch.empty(rows, heads, hp,
                                            dtype=torch.float32,
                                            device=y3.device)
    row_walk(tf.row_view(side), tf.cap, pad_heads(y3, hp), w, wide, fn=fn,
             grad=grad, edge=edge, layout=layout)
    if wide is not out:
        out.copy_(wide[..., :hc])
    wrapper.launches += 1
    if with_da:
        return out, da.view(heads, hp)[:, :hc].contiguous()
    return out


# the slot walk's modes (csrc/row_agg.cu dgl_row_slot), each with the side
# whose rows it sums
SLOT_FEAT, SLOT_FE, SLOT_DX_DFE, SLOT_VEC_DST, SLOT_VEC_SRC = 1, 2, 3, 4, 5
SLOT_SIDES = {SLOT_FEAT: "dst", SLOT_FE: "dst", SLOT_DX_DFE: "src",
              SLOT_VEC_DST: "dst", SLOT_VEC_SRC: "src"}
STORED_DTYPES = {torch.float32: 1, torch.bfloat16: 2}


def slot_layout(f: int, cols, *aligned: torch.Tensor):
    """(vec, cpl, lpr, n_chunks) of the slot walk over ``f`` columns: 4
    floats a load where every width of ``cols`` (the head's columns, the
    stored row's) is a multiple of 4 and each tensor of ``aligned`` allows
    it (its rows' loads 4 elements wide), else 1; lanes a row (the f / vec
    vectors rounded up to a power of two, at most 32); vectors a lane (at
    most 2 of 4 floats or 4 of 1: 8 columns, each entry in flight keeping
    a weight and two vectors) and the column chunks."""
    vec = 4 if all(c % 4 == 0 for c in cols) and all(
        t.data_ptr() % (4 * t.element_size()) == 0 for t in aligned) else 1
    nv = f // vec
    lpr = 1
    while lpr < min(nv, 32):
        lpr *= 2
    cpl, max_cpl = 1, 2 if vec == 4 else 4
    while cpl < max_cpl and lpr * cpl < nv:
        cpl *= 2
    return vec, cpl, lpr, -(-nv // (lpr * cpl))


def slot_walk(tf: TiledFormat, mode: int, t: torch.Tensor, out: torch.Tensor,
              w: torch.Tensor = None, node: torch.Tensor = None,
              head_cols: int = None, fn=None):
    """One slot walk (csrc ``row_slot_kernel``) over the rows of the
    mode's side (SLOT_SIDES): out (rows, f) f32 contiguous, out[r, j] =
    the sum over row r's entries (slot s, neighbour n), in slot order, of
    w[b, h, c] * t[s, j % t_cols] (SLOT_FEAT), w[b, h, c] * (node[n, j] +
    t[s, j]) (SLOT_FE), w[b, h, c] * node[n, j], also written at t[s, j]
    with t's rows at the padded slots set to 0 (SLOT_DX_DFE), or t[s, j]
    (SLOT_VEC_*), h = j // ``head_cols``.  CUDA tensors: ``t`` (slots,
    t_cols) f32 or bf16 (SLOT_FEAT: f32) contiguous; ``w`` (B, H, cap) f32
    in any strides, read in place (one sector a slot where slot-major);
    ``node`` (neighbours, f) f32 contiguous.  ``fn``: the C function to
    launch in place of ``dgl_row_slot`` (a probe's).  Counts nothing."""
    view = tf.row_view(SLOT_SIDES[mode])
    f, t_cols = out.shape[1], t.shape[1]
    head_cols = f if head_cols is None else head_cols
    slots = tf.num_buckets * tf.cap
    vec, cpl, lpr, n_chunks = slot_layout(
        f, (head_cols, t_cols), t, *(() if node is None else (node,)))
    w_strides = (0, 0, 0) if w is None else tuple(w.stride())
    _check_int32(out.numel(), 0 if node is None else node.numel(),
                 0 if w is None else sum((n - 1) * st for n, st in
                                         zip(w.shape, w.stride())),
                 view.rows * n_chunks + 2048 * _sms(out.device))
    counter = torch.zeros(1, dtype=torch.int32, device=out.device)
    args = (view.ptr.data_ptr(), view.slot.data_ptr(), view.nbr.data_ptr(),
            view.order.data_ptr(), view.rows,
            None if w is None else w.data_ptr(), tf.cap, *w_strides,
            head_cols, None if node is None else node.data_ptr(),
            t.data_ptr(), STORED_DTYPES[t.dtype], t_cols, f, out.data_ptr(),
            counter.data_ptr(), vec, cpl, lpr, n_chunks, mode,
            tf.valid.data_ptr(), slots, finish_blocks(slots, out.device),
            out.device.index, _stream(out.device))
    if fn is None:
        _launch("dgl_row_slot", *args)
    elif fn(*args) != 0:
        raise RuntimeError("dgl_row_slot failed to launch")


def slot_kernel_attrs(mode: int, dtype, vec: int, cpl: int, device=None):
    """(registers a thread, local-memory bytes a thread, resident blocks an
    SM) of the slot walk's instance for ``mode`` over a stored tensor of
    ``dtype`` at ``vec`` and ``cpl``, from ``cudaFuncGetAttributes`` and
    the occupancy calculator."""
    device = torch.device("cuda") if device is None else torch.device(device)
    out = (ctypes.c_int * 3)()
    lib = build.load("row_agg", _SIGNATURES["row_agg"])
    err = lib.dgl_row_slot_attrs(mode, STORED_DTYPES[dtype], vec, cpl,
                                 device.index or 0, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"dgl_row_slot_attrs: CUDA error {err}")
    return out[0], out[1], out[2]


SLOT_GRAD_RANGE_ROWS = 8   # rows of the claim order a range of da holds
SLOT_GRAD_SEGMENTS = 64    # segments of the ranges da's first sum takes


def slot_grad_walk(tf: TiledFormat, fe: torch.Tensor, dfe: torch.Tensor,
                   dfnj: torch.Tensor, da: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor, attn: torch.Tensor, ds: torch.Tensor,
                   slope: float, head_cols: int, fn=None):
    """K11 v1's slot gradient by the slot walk by dst (csrc
    ``row_slot_grad_kernel``, then the zero pass and the two range sums):
    for each valid slot s (b, c) of an edge src -> dst and column j of
    head h = j // ``head_cols``, raw = (u[src, j] + v[dst, j]) + fe[s, j]
    and dfe[s, j] = ds[b, h, c] * attn[j] * (raw >= 0 ? 1 : slope) in
    ``fe``'s dtype (0 at padded slots); dfnj[dst] = the sum of its slots'
    dfe rows as stored, in the dst view's slot order; da[j] = the sum of
    ds * lrelu(raw) over every slot, by ranges of SLOT_GRAD_RANGE_ROWS rows
    of the claim order added in a fixed order.  CUDA tensors: ``fe`` and
    ``dfe`` (slots, f) f32 or bf16 contiguous; ``dfnj`` (num_dst, f), ``da``
    (f,), ``u`` (num_src, f), ``v`` (num_dst, f) and ``attn`` (f,) f32
    contiguous; ``ds`` (B, H, cap) f32 in any strides, read in place (one
    sector a slot where slot-major).  ``fn``: the C function to launch in
    place of ``dgl_row_slot_grad`` (a probe's).  Counts nothing."""
    view = tf.row_view("dst")
    f = dfnj.shape[1]
    slots = tf.num_buckets * tf.cap
    vec, cpl, lpr, n_chunks = slot_layout(f, (head_cols,), fe, dfe, dfnj,
                                          u, v, attn)
    rows = view.rows
    n_ranges = -(-rows // SLOT_GRAD_RANGE_ROWS)
    segs = SLOT_GRAD_SEGMENTS
    _check_int32(dfnj.numel(), u.numel(), n_ranges * f,
                 sum((n - 1) * st for n, st in zip(ds.shape, ds.stride())))
    part = torch.empty(n_ranges, f, dtype=torch.float32, device=fe.device)
    part2 = torch.empty(segs, f, dtype=torch.float32, device=fe.device)
    counter = torch.zeros(1, dtype=torch.int32, device=fe.device)
    args = (view.ptr.data_ptr(), view.slot.data_ptr(), view.nbr.data_ptr(),
            view.order.data_ptr(), rows, SLOT_GRAD_RANGE_ROWS, n_ranges,
            ds.data_ptr(), tf.cap, *ds.stride(), head_cols, u.data_ptr(),
            v.data_ptr(), attn.data_ptr(), slope, fe.data_ptr(),
            dfe.data_ptr(), STORED_DTYPES[fe.dtype], f, dfnj.data_ptr(),
            part.data_ptr(), segs, part2.data_ptr(), da.data_ptr(),
            counter.data_ptr(), vec, cpl, lpr, n_chunks,
            tf.valid.data_ptr(), slots, finish_blocks(slots, fe.device),
            fe.device.index, _stream(fe.device))
    if fn is None:
        _launch("dgl_row_slot_grad", *args)
    elif fn(*args) != 0:
        raise RuntimeError("dgl_row_slot_grad failed to launch")


def slot_grad_kernel_attrs(dtype, vec: int, cpl: int, device=None):
    """(registers a thread, local-memory bytes a thread, resident blocks an
    SM) of the slot-gradient walk's instance over stored rows of ``dtype``
    at ``vec`` and ``cpl``, from ``cudaFuncGetAttributes`` and the
    occupancy calculator."""
    device = torch.device("cuda") if device is None else torch.device(device)
    out = (ctypes.c_int * 3)()
    lib = build.load("row_agg", _SIGNATURES["row_agg"])
    err = lib.dgl_row_slot_grad_attrs(STORED_DTYPES[dtype], vec, cpl,
                                      device.index or 0,
                                      ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"dgl_row_slot_grad_attrs: CUDA error {err}")
    return out[0], out[1], out[2]


def reduce_layout(heads: int, vec: int, degree: float):
    """(cpl, lps, lpr, n_chunks) of the row reduce over ``heads`` heads
    read ``vec`` at a time, on rows of ``degree`` entries on average:
    vectors a lane (a power of two up to 8), lanes a slot (the H / vec
    vectors rounded up to a power of two, at most 32), lanes a row (enough
    that a lane keeps its slots in flight on a mean row: lps times the
    mean degree over 8, a power of two in [lps, 32]) and column chunks."""
    nv = heads // vec
    lps = _pow2(min(nv, 32))
    cpl = 1
    while cpl < 8 and lps * cpl < nv:
        cpl *= 2
    lpr = lps
    while lpr < 32 and lpr * 8 < lps * degree:
        lpr *= 2
    return cpl, lps, lpr, -(-nv // (lps * cpl))


def reduce_vec(vals: torch.Tensor) -> int:
    """Floats a load of the row reduce over ``vals`` (B, H, C): 4 where it
    is slot-major (a slot's H values contiguous, strides (C H, 1, H)), H
    is a multiple of 4 and it is 16-byte aligned, else 1."""
    heads = vals.shape[1]
    bs, hs, cs = vals.stride()
    return 4 if (heads % 4 == 0 and hs == 1 and bs % 4 == 0 and cs % 4 == 0
                 and vals.data_ptr() % 16 == 0) else 1


def row_reduce(view: RowView, cap: int, vals: torch.Tensor,
               out: torch.Tensor, lpr: int = None, fn=None):
    """One launch of csrc ``row_reduce_kernel`` over the rows of
    ``view.order``: out[r, h] = the sum over row r's entries k of vals[b,
    h, c], slot[k] = b * cap + c, each lane's entries in entry order, then
    the lanes of a head in a fixed order; 0 at a row with no entry.  CUDA
    tensors, f32: ``vals`` (B, H, cap) in any strides, read in place
    (16-byte loads where it is slot-major, :func:`reduce_vec`); ``out``
    (rows, H) contiguous.  ``lpr``: lanes a row in place of
    :func:`reduce_layout`'s.  ``fn``: the C function to launch, by default
    ``dgl_row_reduce``.  Counts nothing."""
    heads = vals.shape[1]
    vec = reduce_vec(vals)
    cpl, lps, auto, n_chunks = reduce_layout(
        heads, vec, view.slot.numel() / max(view.rows, 1))
    lpr = auto if lpr is None else max(lpr, lps)
    _check_int32(out.numel(), sum((n - 1) * st for n, st in
                                  zip(vals.shape, vals.stride())),
                 view.rows * n_chunks + 2048 * _sms(vals.device))
    counter = torch.zeros(1, dtype=torch.int32, device=vals.device)
    args = (view.ptr.data_ptr(), view.slot.data_ptr(), view.order.data_ptr(),
            view.rows, vals.data_ptr(), cap, *vals.stride(), heads,
            out.data_ptr(), counter.data_ptr(), vec, cpl, lps, lpr, n_chunks,
            vals.device.index, _stream(vals.device))
    if fn is None:
        _launch("dgl_row_reduce", *args)
    elif fn(*args) != 0:
        raise RuntimeError("dgl_row_reduce failed to launch")


def reduce_kernel_attrs(vec: int, cpl: int, device=None):
    """(registers a thread, local-memory bytes a thread) of the row
    reduce's instance ``row_reduce_kernel<vec, cpl>``, from
    ``cudaFuncGetAttributes``: local bytes above 0 are a stack frame or
    spills."""
    device = torch.device("cuda") if device is None else torch.device(device)
    out = (ctypes.c_int * 2)()
    lib = build.load("row_agg", _SIGNATURES["row_agg"])
    err = lib.dgl_row_reduce_attrs(vec, cpl, device.index or 0,
                                   ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"dgl_row_reduce_attrs: CUDA error {err}")
    return out[0], out[1]


def tiled_spmm(tf: TiledFormat, x: torch.Tensor, edge_weights=None,
               slot_weights=None) -> torch.Tensor:
    """K3: out[d] = sum_{e: dst(e) = d} w_e * x[src(e)], (num_dst, F) f32.

    ``edge_weights``: (num_edges,) per-edge scalars in canonical order, or
    None for a plain sum.  ``slot_weights``: the same already in the slot
    layout (:func:`slot_edge_weights`); it overrides ``edge_weights``.  On
    CUDA tensors the row walk by dst at H = 1 (:func:`row_aggregate`, x
    as (N, 1, F), the weights as (B, 1, C)); a plain sum takes its
    weightless instance, which reads no weights and no slot ids."""
    _check_operand(tf, x, tf.num_src, 2, "x")
    w = slot_weights
    if w is None and edge_weights is not None:
        w = slot_edge_weights(tf, edge_weights)
    if w is not None and tuple(w.shape) != tuple(tf.valid.shape):
        raise ValueError(f"slot weights have shape {tuple(w.shape)}, the "
                         f"format {tuple(tf.valid.shape)}")
    if not on_cuda(x, tf.valid, *(() if w is None else (w,))):
        return tiled_spmm_plain(tf, x, w)
    f = x.shape[1]
    w3 = None if w is None else w.reshape(tf.num_buckets, 1, tf.cap)
    return row_aggregate(tf, "dst", x.view(tf.num_src, 1, f), w3,
                         tiled_spmm).view(tf.num_dst, f)


tiled_spmm.launches = 0


def tiled_spmm_multihead(tf: TiledFormat, x3: torch.Tensor,
                         w_slot: torch.Tensor, H: int, Fh: int):
    """K4 SpMM: out[d, h, f] = sum_e w[e, h] x3[src_e, h, f], the row walk
    by dst on CUDA tensors (:func:`row_aggregate`).

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
    return row_aggregate(tf, "dst", x3, w_slot, tiled_spmm_multihead)


tiled_spmm_multihead.launches = 0


def _lanes_per_head(heads: int) -> int:
    """Lanes of a warp that share one head's dot product in the slot-space
    kernels of ``gat_fused.py``: 32 over the heads rounded up to a power of
    two, at least 1."""
    return 32 // _pow2(min(heads, 32))


def _pow2(n: int) -> int:
    """The least power of two at or above ``n`` (1 for n <= 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


def _sddmm_cpl(heads: int, hv: int):
    """(lph, cph, lpr, cpl) of the dot-product walk over ``heads`` heads of
    ``hv`` 4-float vectors each: lanes a head (hv rounded up to a power of
    two, at most 32), vectors a lane and head (a power of two: the lane
    sums a head's vectors in a tree of pairs, which must not reach into
    the next head's), lanes a row (lph times the heads rounded up to a
    power of two, at most 32) and vectors a lane (a power of two)."""
    lph = _pow2(min(hv, 32))
    cph = _pow2(-(-hv // lph))
    lpr = min(32, lph * _pow2(heads))
    return lph, cph, lpr, _pow2(cph * -(-heads // (lpr // lph)))


def _sddmm_layout(heads: int, hv: int, max_cpl: int = 8):
    """:func:`_sddmm_cpl` for one launch of the walk, which keeps at most
    ``max_cpl`` vectors a lane (8: up to 1,024 columns a row; K11 v2's
    scores walk keeps 1, FE_SCORE_CPL), :func:`_sddmm_plan` splitting
    wider rows."""
    layout = _sddmm_cpl(heads, hv)
    if layout[3] > max_cpl:
        raise ValueError(f"{heads} heads of {4 * hv} columns are more than "
                         "the SDDMM walk keeps in a row's registers "
                         f"({128 * max_cpl:,})")
    return layout


_SDDMM_CHUNK = 256     # a head's vectors one launch takes (cph <= 8)
FE_SCORE_CPL = 1       # vectors a lane of K11 v2's scores walk


def _sddmm_plan(heads: int, hv: int, max_cpl: int = 8):
    """(launches, parts): the walk's launches over rows of ``heads`` heads
    of ``hv`` 4-float vectors, each (h0, nh, v0, nv, part): heads h0 ..
    h0 + nh - 1, vectors v0 .. v0 + nv - 1 of each, written into scratch
    part ``part``.  A head's vectors come in ``parts`` chunks of up to 32
    ``max_cpl`` (256 at the walk's 8 vectors a lane: 1,024 columns), each
    chunk a part of its own; the heads in the fewest equal groups that one
    launch holds (``max_cpl`` vectors a lane).  One launch where the row
    fits."""
    parts = max(1, -(-hv // (_SDDMM_CHUNK * max_cpl // 8)))
    cw = -(-hv // parts)
    g = heads
    while g > 1 and _sddmm_cpl(g, cw)[3] > max_cpl:
        g -= 1
    g = -(-heads // -(-heads // g))          # the groups made equal
    return [(h0, min(g, heads - h0), v0, min(cw, hv - v0), part)
            for part, v0 in enumerate(range(0, hv, cw))
            for h0 in range(0, heads, g)], parts


def _vec4_rows(t: torch.Tensor, hp: int) -> torch.Tensor:
    """``t`` (n, H, D) as f32 (n, H, hp) rows, hp >= D a multiple of 4,
    contiguous and 16-byte aligned, zero past D (a copy unless ``t`` is
    so already): the walk's 16-byte loads; the pad leaves every dot as it
    is."""
    if (t.shape[2] == hp and t.dtype == torch.float32 and t.is_contiguous()
            and t.data_ptr() % 16 == 0):
        return t
    alloc = torch.empty if t.shape[2] == hp else torch.zeros
    out = alloc(t.shape[0], t.shape[1], hp, dtype=torch.float32,
                device=t.device)
    out[..., :t.shape[2]] = t
    return out


def _sddmm_args(view: RowView, nbr: torch.Tensor, x: torch.Tensor,
                z: torch.Tensor, out: torch.Tensor, ostride: int,
                counter: torch.Tensor, launch):
    """The arguments of ``dgl_row_sddmm`` (``csrc/row_agg.cu``) for one
    launch (h0, nh, v0, nv, part) of :func:`_sddmm_plan` over the rows of
    ``view.order``, neighbours ``nbr``: it writes entry k's dot of head h0
    + h at out[k * ostride + h0 + h] (``out`` a scratch part).  ``x``
    (neighbours, H, hp) and ``z`` (rows, H, hp) f32, contiguous, 16-byte
    aligned, hp a multiple of 4 (:func:`_vec4_rows`); ``counter`` one
    zeroed int32."""
    h0, nh, v0, nv, _ = launch
    hp = x.shape[2]
    lph, cph, lpr, cpl = _sddmm_layout(nh, nv)
    off = 4 * (h0 * hp + 4 * v0)                   # bytes to the first float
    return (view.ptr.data_ptr(), nbr.data_ptr(), view.order.data_ptr(),
            view.rows, x.data_ptr() + off, z.data_ptr() + off,
            x.shape[1] * hp, hp // 4, nh, nv, lph, cph, lpr,
            out.data_ptr() + 4 * h0, ostride, counter.data_ptr(), cpl,
            x.device.index, _stream(x.device))


def sddmm_dots(view: RowView, x: torch.Tensor, z: torch.Tensor,
               attn: torch.Tensor = None, slope: float = 0.0):
    """(sm, parts): the launches of :func:`_sddmm_plan` over the rows of
    ``view`` on CUDA tensors, each entry's dots written into an (E, H)
    scratch a part, at the entry (sm[part, k * H + h] = the part's share
    of <x[nbr[k], h], z[r, h]>), where a round's stores fill whole
    sectors; ``sm`` (parts, E * H) f32, zeros where hp is 0.  ``x``, ``z``
    as :func:`_sddmm_args` takes them.  With ``attn`` (1, H, hp) f32,
    contiguous and 16-byte aligned, zero past the head width: K9's
    scores instead (``dgl_row_vattn``), the part's share of sum_d attn[h,
    d] lrelu(x[nbr[k], h, d] + z[r, h, d]) with ``slope``, x = U and z =
    V.  Counts nothing."""
    heads, hp = x.shape[1], x.shape[2]
    if hp % 4 or z.shape[1:] != x.shape[1:]:
        raise ValueError(f"x {tuple(x.shape)} and z {tuple(z.shape)} need "
                         "one (H, hp) with hp a multiple of 4")
    if attn is not None and tuple(attn.shape) != (1, heads, hp):
        raise ValueError(f"attn {tuple(attn.shape)} does not match x "
                         f"{tuple(x.shape)}")
    e = view.slot.numel()
    if hp == 0 or heads == 0:
        return torch.zeros(1, e * heads, dtype=torch.float32,
                           device=x.device), 1
    plan, parts = _sddmm_plan(heads, hp // 4)
    _check_int32(x.numel(), z.numel(), e * heads,
                 view.rows + 2048 * _sms(x.device))
    sm = torch.empty(parts, e * heads, dtype=torch.float32, device=x.device)
    if e == 0:
        return sm, parts
    counters = torch.zeros(len(plan), dtype=torch.int32, device=x.device)
    for i, launch in enumerate(plan):
        args = _sddmm_args(view, view.nbr, x, z, sm[launch[4]], heads,
                           counters[i], launch)
        if attn is None:
            _launch("dgl_row_sddmm", *args, source="row_agg")
        else:       # attn at the launch's first head and column, as z
            off = 4 * (launch[0] * hp + 4 * launch[2])
            _launch("dgl_row_vattn", *args[:-2], attn.data_ptr() + off,
                    float(slope), *args[-2:], source="row_agg")
    return sm, parts


def sddmm_store_dots(view: RowView, x: torch.Tensor, z: torch.Tensor,
                     fe_s: torch.Tensor, dim: int, attn: torch.Tensor = None,
                     slope: float = 0.0):
    """(sm, parts): :func:`sddmm_dots` with K10 v1's stored message added to
    x, by ``dgl_row_sddmm_store``, the walk also reading each entry's
    slot: x[nbr, h, d] gains fe_s[slot, h * dim + d] for d < ``dim``,
    ``fe_s`` (slots, H * dim) f32 or bf16 contiguous.  ``x``, ``z`` as
    :func:`_sddmm_args` takes them.  With ``attn`` (as :func:`sddmm_dots`
    takes it): K11 v1's scores instead (``dgl_row_vattn_store``), the
    part's share of sum_d attn[h, d] lrelu(x[nbr, h, d] + fe_s[slot, h *
    dim + d] + z[r, h, d]), x = U, z = V.  Counts nothing."""
    heads, hp = x.shape[1], x.shape[2]
    if hp % 4 or z.shape[1:] != x.shape[1:] or fe_s.shape[1] != heads * dim:
        raise ValueError(f"x {tuple(x.shape)}, z {tuple(z.shape)} and fe_s "
                         f"{tuple(fe_s.shape)} need one (H, hp), hp a "
                         "multiple of 4, and H * dim stored columns")
    if attn is not None and tuple(attn.shape) != (1, heads, hp):
        raise ValueError(f"attn {tuple(attn.shape)} does not match x "
                         f"{tuple(x.shape)}")
    e = view.slot.numel()
    plan, parts = _sddmm_plan(heads, hp // 4)
    _check_int32(x.numel(), z.numel(), e * heads,
                 view.rows + 2048 * _sms(x.device))
    sm = torch.empty(parts, e * heads, dtype=torch.float32, device=x.device)
    if e == 0:
        return sm, parts
    es = fe_s.element_size()
    fs_vec = int(dim % 4 == 0 and fe_s.data_ptr() % (4 * es) == 0)
    counters = torch.zeros(len(plan), dtype=torch.int32, device=x.device)
    for i, launch in enumerate(plan):
        h0, _, v0, _, _ = launch
        args = _sddmm_args(view, view.nbr, x, z, sm[launch[4]], heads,
                           counters[i], launch)
        args = (*args[:-2], view.slot.data_ptr(),
                fe_s.data_ptr() + es * (h0 * dim + 4 * v0),
                STORED_DTYPES[fe_s.dtype], heads * dim, dim, dim - 4 * v0,
                fs_vec)
        if attn is None:
            _launch("dgl_row_sddmm_store", *args, x.device.index,
                    _stream(x.device))
        else:       # attn at the launch's first head and column, as z
            off = 4 * (h0 * hp + 4 * v0)
            _launch("dgl_row_vattn_store", *args, attn.data_ptr() + off,
                    float(slope), x.device.index, _stream(x.device))
    return sm, parts


def vattn_fe_dots(view: RowView, u: torch.Tensor, v: torch.Tensor,
                  attn: torch.Tensor, slope: float, edge, fn=None):
    """(sm, parts): K11 v2's scores by ``dgl_row_vattn_fe``, the launches
    of :func:`_sddmm_plan` at one vector a lane (FE_SCORE_CPL) over the
    rows of ``view``, each entry's part of sum_d attn[h, d] lrelu((v[r, h,
    d] + bias[h, d]) + u[nbr, h, d] + ef[slot] . wf[:, h, d]) written into
    the entry-major scratch as :func:`sddmm_dots` writes it.  ``u``, ``v``
    and ``attn`` as :func:`sddmm_dots` takes them (u = U, v = V, each head
    padded to hp, a multiple of 4); ``edge`` = :func:`edge_operands` at
    that hp (ef (slots, 4 fq), fq, wf (Fe, H hp), Fe, bias (H hp,) or None,
    kf).  ``fn``: the C function, ``dgl_row_vattn_fe`` when None (a probe
    passes an edit's).  Counts nothing."""
    heads, hp = u.shape[1], u.shape[2]
    ef, fq, wf, fe, bias, kf = edge
    if hp % 4 or v.shape[1:] != u.shape[1:] or \
            tuple(attn.shape) != (1, heads, hp) or \
            tuple(wf.shape) != (fe, heads * hp) or \
            (bias is not None and tuple(bias.shape) != (heads * hp,)):
        raise ValueError(f"u {tuple(u.shape)}, v {tuple(v.shape)}, attn "
                         f"{tuple(attn.shape)} and wf {tuple(wf.shape)} need "
                         "one (H, hp), hp a multiple of 4")
    e = view.slot.numel()
    plan, parts = _sddmm_plan(heads, hp // 4, FE_SCORE_CPL)
    _check_int32(u.numel(), v.numel(), e * heads, ef.numel(), wf.numel(),
                 view.rows + 2048 * _sms(u.device))
    sm = torch.empty(parts, e * heads, dtype=torch.float32, device=u.device)
    if e == 0:
        return sm, parts
    counters = torch.zeros(len(plan), dtype=torch.int32, device=u.device)
    if fn is None:
        fn = build.load("row_agg", _SIGNATURES["row_agg"]).dgl_row_vattn_fe
    for i, launch in enumerate(plan):
        h0, nh, v0, nv, part = launch
        lph, _, lpr, _ = _sddmm_layout(nh, nv, FE_SCORE_CPL)
        off = 4 * (h0 * hp + 4 * v0)      # bytes to the launch's first float
        err = fn(view.ptr.data_ptr(), view.nbr.data_ptr(),
                 view.order.data_ptr(), view.rows, u.data_ptr() + off,
                 v.data_ptr() + off, heads * hp, hp // 4, nh, nv, lph,
                 max(lpr, FE_MIN_LANES), sm[part].data_ptr() + 4 * h0, heads,
                 counters[i].data_ptr(), attn.data_ptr() + off, float(slope),
                 view.slot.data_ptr(), ef.data_ptr(), fq,
                 wf.data_ptr() + off, fe,
                 None if bias is None else bias.data_ptr() + off, kf,
                 u.device.index, _stream(u.device))
        if err != 0:
            raise RuntimeError(f"dgl_row_vattn_fe failed to launch: CUDA "
                               f"error {err}")
    return sm, parts


def vattn_fe_kernel_attrs(kf: int, device=None):
    """(registers a thread, local-memory bytes a thread, resident blocks an
    SM) of K11 v2's scores walk for ``kf`` rows of wf
    (``row_vattn_fe_kernel<kf>``), from ``cudaFuncGetAttributes`` and the
    occupancy calculator."""
    device = torch.device("cuda") if device is None else torch.device(device)
    out = (ctypes.c_int * 3)()
    lib = build.load("row_agg", _SIGNATURES["row_agg"])
    err = lib.dgl_row_vattn_fe_attrs(kf, device.index or 0,
                                     ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"dgl_row_vattn_fe_attrs: CUDA error {err}")
    return tuple(out)


def store_kernel_attrs(cpl: int, dtype, vattn: bool, device=None):
    """The same of the dot-product walk's instance with a stored row,
    ``row_sddmm_kernel<cpl, vattn, true, T>`` (T of ``dtype``, f32 or bf16:
    K11 v1's scores where ``vattn``, else K10 v1's ds)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    out = (ctypes.c_int * 3)()
    lib = build.load("row_agg", _SIGNATURES["row_agg"])
    err = lib.dgl_row_sddmm_store_attrs(cpl, STORED_DTYPES[dtype],
                                        int(vattn), device.index or 0,
                                        ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"dgl_row_sddmm_store_attrs: CUDA error {err}")
    return tuple(out)


def finish_blocks(slots: int, device) -> int:
    """Blocks of 256 threads of a finishing pass over ``slots`` slots, a
    thread a slot, grid-stride: at most 32 an SM."""
    return max(1, min(-(-slots // 256), 32 * _sms(device)))


def finish_vec(heads: int, *tensors) -> int:
    """Heads a thread of a finishing pass takes at a time: 4 (16-byte
    loads and stores) where H is a multiple of 4 and every tensor the pass
    reads or writes in vectors is 16-byte aligned, else 1."""
    return 4 if heads % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors) else 1


def sddmm_walk(view: RowView, num_buckets: int, cap: int, x: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """K4's SDDMM by the dot-product walk on CUDA tensors: (num_buckets, H,
    cap) f32, e[b, h, c] = <x[nbr[k], h], z[r, h]> at the entry k of row r
    with slot[k] = b * cap + c, 0 at every slot the view does not list.
    :func:`sddmm_dots` writes the entry-major scratch; then csrc
    ``slot_finish_kernel`` gathers its parts into (B, H, C) through
    ``view.entries``, adds them in order and writes the zeros.  Counts
    nothing."""
    heads = x.shape[1]
    out = torch.empty(num_buckets, heads, cap, dtype=torch.float32,
                      device=x.device)
    e = view.slot.numel()
    if out.numel() == 0 or x.shape[2] == 0 or e == 0:   # every slot is 0
        return out.zero_()
    sm, parts = sddmm_dots(view, x, z)
    slots = num_buckets * cap
    _launch("dgl_slot_finish", sm.data_ptr(), view.entries(slots).data_ptr(),
            slots, heads, parts, e * heads, cap, out.data_ptr(),
            finish_vec(heads, sm), 0, finish_blocks(slots, x.device),
            x.device.index, _stream(x.device), source="row_agg")
    return out


def tiled_sddmm_dot_multihead(tf: TiledFormat, x3: torch.Tensor,
                              z3: torch.Tensor, H: int, Fh: int):
    """K4 SDDMM: e[b, h, c] = <x3[src, h, :], z3[dst, h, :]> for every
    slot, 0 at padded slots.  ``x3`` (num_src, H, Fh), ``z3``
    (num_dst, H, Fh).  Returns (B, H, C) f32 in slot order: on CUDA
    tensors the walk by dst (:func:`sddmm_walk`), with x3 and z3 padded to
    a multiple of 4 columns where Fh is not one; any H * Fh (a row wider
    than one launch holds takes several)."""
    _check_operand(tf, x3, tf.num_src, 3, "x3")
    _check_operand(tf, z3, tf.num_dst, 3, "z3")
    if tuple(x3.shape[1:]) != (H, Fh) or tuple(z3.shape[1:]) != (H, Fh):
        raise ValueError(f"x3 {tuple(x3.shape)} or z3 {tuple(z3.shape)} do "
                         f"not match H={H}, Fh={Fh}")
    if not on_cuda(x3, z3, tf.valid):
        return tiled_sddmm_dot_multihead_plain(tf, x3, z3)
    hp = -(-Fh // 4) * 4
    out = sddmm_walk(tf.row_view("dst"), tf.num_buckets, tf.cap,
                     _vec4_rows(x3, hp), _vec4_rows(z3, hp))
    tiled_sddmm_dot_multihead.launches += 1
    return out


tiled_sddmm_dot_multihead.launches = 0
