"""Probe of K10's and K11 v1's slot walks and K10's edge ds, each timed
beside the bucket walk it replaced, in one run on the card:

* the slot walk (``csrc/row_agg.cu`` ``row_slot_kernel``: K10 v1's
  numerator ``fe_aggregate`` and dx with dfe ``dx_dfe``, K11 v1's node sums
  ``slot_vec_reduce``, K10 v2's slot-feature reduce ``slot_feat_reduce``)
  beside
  - the tiled walk it replaced, ``src_agg_kernel`` (``slot_walks_probe.cu``
    beside this file: a block per (tile, chunk of G columns, split), the
    tile's rows in shared memory, a float atomicAdd a slot and column),
    launched as the package launched it (:func:`tiled_slot_agg`,
    :func:`tiled_feat_reduce`);
  - the edit ``half`` of ``row_agg.cu``: half the entries a lane keeps in
    flight (``SlotUnroll``);
* K10's edge ds (``edgegat_ds`` with and without d(ef), ``fe_ds``): the
  dot-product walk by dst and its finishing pass (``row_sddmm_kernel``,
  for K10 v1 with the stored row added; ``ds_finish_kernel``, for K10 v2
  with the edge dot and d(ef)) beside the bucket walk it replaced,
  ``gat_ds_kernel``'s modes 1-4
  (``slot_walks_probe.cu``: a warp a 32-slot chunk of a bucket, both node
  rows gathered with scalar loads at every slot), :func:`bucket_ds`.

The probe source and the edited ``row_agg.cu`` are built with the
package's ``nvcc`` flags into its build directory (``tools.build_edited``),
side by side, at the first call of :func:`build_probe`, which
``chip_smoke.py`` starts beside the package's build.  Each variant's
output is held to the package kernel's by the caller (``chip_smoke.py``'s
yardsticks, phases 27 and 40).  The probe is not a main path: nothing here
counts launches.

Usage: ``python -m dgl_tpu_torch.tools.perf_slot_walks tiny`` (the CPU
check: the edit applies once).
"""
from __future__ import annotations

import ctypes
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from . import build_edited, edited_source
from . import tile_group, tile_group_per_sm, tile_splits
from ..ops.kernels import tiled_spmm as tts

PROBE_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "slot_walks_probe.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int64
# the C functions the retired kernels had in csrc/gat_fused.cu
RETIRED_SIGNATURES = {
    "dgl_gat_ds": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I,
                   _P, _P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P],
    "dgl_slot_feat_reduce": [_P, _P, _P, _I, _I, _P, _I, _I, _I, _P, _P, _I,
                             _I, _I, _I, _P],
    "dgl_slot_agg": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P,
                     _P, _I, _I, _P, _I, _I, _I, _I, _I, _P],
}
DS_WARPS = 8   # slot_walks_probe.cu kDsWarps: warps a bucket-ds block
SLOT_SIGNATURES = {"dgl_row_slot": tts._SIGNATURES["row_agg"]["dgl_row_slot"]}
# edits of csrc/row_agg.cu, each old text found exactly once.  "half": the
# slot walk keeps half its entries in flight
EDITS = {
    "half": [("static constexpr int value = VEC * CPL <= 4 ? 8 : 4;",
              "static constexpr int value = VEC * CPL <= 4 ? 4 : 2;")],
}

_BUILT = {}
_LOCK = threading.Lock()


def edited_sources():
    """{name: ``csrc/row_agg.cu`` with EDITS[name]}."""
    return {name: edited_source("row_agg", edits, name)
            for name, edits in EDITS.items()}


def build_probe():
    """{"retired": the probe source's C functions, EDITS' names: each
    edit's ``dgl_row_slot``}, the sources built side by side at the first
    call (a caller in another thread waits for it)."""
    with _LOCK:
        if _BUILT:
            return _BUILT
        with open(PROBE_SOURCE) as f:
            own = f.read()
        with ThreadPoolExecutor(2) as pool:
            jobs = [pool.submit(build_edited, "slot_walks_probe",
                                {"retired": own}, RETIRED_SIGNATURES),
                    pool.submit(build_edited, "row_agg", edited_sources(),
                                SLOT_SIGNATURES)]
            retired, edits = (j.result() for j in jobs)
        _BUILT["retired"] = retired["retired"]
        for name, fns in edits.items():
            _BUILT[name] = fns["dgl_row_slot"]
        return _BUILT


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {err}")


def tiled_slot_agg(tf, mode: int, t, heads: int, head_cols: int, w=None,
                   z=None):
    """The tiled walk's (rows, heads * head_cols) f32 in ``mode`` (2: K10
    v1's numerator, z = x; 3: dx with dfe written into ``t``, z = zn; 4, 5:
    the node sums by dst, by src) over the stored ``t`` (B, C, heads *
    head_cols), launched as the package launched it; ``w`` (B, H, C)."""
    src = mode in (tts.SLOT_DX_DFE, tts.SLOT_VEC_SRC)
    f = heads * head_cols
    rows = tf.num_src if src else tf.num_dst
    n_t = tf.num_src_tiles if src else tf.num_dst_tiles
    dev = t.device
    g = tile_group(f, tf.tile)
    splits = tile_splits(tf, n_t, -(-f // g), tile_group_per_sm(g, tf.tile),
                         dev)
    out = (torch.zeros if splits > 1 else torch.empty)(
        rows, f, dtype=torch.float32, device=dev)
    w = None if w is None else w.float().contiguous()
    z = None if z is None else z.float().contiguous()
    _check(build_probe()["retired"]["dgl_slot_agg"](
        tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
        tf.valid.data_ptr(), 0 if w is None else w.data_ptr(), heads,
        head_cols, tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(),
        tf.src_order.data_ptr() if src else 0,
        (tf.src_ptr if src else tf.dst_ptr).data_ptr(), n_t, tf.tile, tf.cap,
        0 if z is None else z.data_ptr(), t.data_ptr(),
        tts.STORED_DTYPES[t.dtype], f, out.data_ptr(), rows, g, splits, mode,
        dev.index, tts._stream(dev)), "the tiled slot walk")
    return out


def tiled_feat_reduce(tf, w, ef_slot):
    """K10 v2's slot-feature reduce (num_dst, H, Fe) by the tiled walk."""
    heads, fe = w.shape[1], ef_slot.shape[2]
    f = heads * fe
    dev = w.device
    g = tile_group(f, tf.tile)
    splits = tile_splits(tf, tf.num_dst_tiles, -(-f // g),
                         tile_group_per_sm(g, tf.tile), dev)
    out = (torch.zeros if splits > 1 else torch.empty)(
        tf.num_dst, heads, fe, dtype=torch.float32, device=dev)
    wc, ef = w.float().contiguous(), ef_slot.float().contiguous()
    _check(build_probe()["retired"]["dgl_slot_feat_reduce"](
        tf.dst_local.data_ptr(), tf.valid.data_ptr(), wc.data_ptr(), heads,
        fe, tf.dst_ptr.data_ptr(), tf.num_dst_tiles, tf.tile, tf.cap,
        ef.data_ptr(), out.data_ptr(), tf.num_dst, g, splits, dev.index,
        tts._stream(dev)), "the tiled slot-feature reduce")
    return out


def bucket_ds(tf, x3, zn, rp, g, ef_slot=None, zp=None, p=None, m=None,
              fe_s=None):
    """K10's ds (B, H, C) by the bucket walk, and d(ef) (B, C, Fe) with
    ``p`` and ``m`` (else None): modes 1 and 2 (``ef_slot``, ``zp``) or 3
    and 4 (``fe_s`` (B, C, H * Fh), f32 or bf16)."""
    heads, fh = x3.shape[1:]
    b = tf.num_buckets
    dev = x3.device
    ds = torch.empty(b, heads, tf.cap, dtype=torch.float32, device=dev)
    d_ef = None if p is None else torch.empty(ef_slot.shape,
                                              dtype=torch.float32, device=dev)
    x, z, r, gg = (t.float().contiguous() for t in (x3, zn, rp, g))
    ef = zq = pp = mm = None
    if ef_slot is not None:
        ef, zq = ef_slot.float().contiguous(), zp.float().contiguous()
    if p is not None:
        pp, mm = p.float().contiguous(), m.float().contiguous()
    blocks = max(1, min(-(-(b * tf.cap // 32) // DS_WARPS),
                        16 * tts._sms(dev)))

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    _check(build_probe()["retired"]["dgl_gat_ds"](
        tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
        tf.valid.data_ptr(), tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(),
        b, tf.tile, tf.cap, x.data_ptr(), z.data_ptr(), r.data_ptr(),
        gg.data_ptr(), heads, fh, ptr(ef), ptr(zq),
        0 if ef is None else ef.shape[2], ptr(pp), ptr(mm), ptr(d_ef),
        ptr(fe_s), 0 if fe_s is None else tts.STORED_DTYPES[fe_s.dtype],
        ds.data_ptr(), tts._lanes_per_head(heads), blocks, dev.index,
        tts._stream(dev)), "the bucket ds walk")
    return ds, d_ef


def slot_edit(name, tf, mode: int, t, out, w=None, node=None,
              head_cols=None):
    """``tiled_spmm.slot_walk`` from the edit ``name``'s build."""
    tts.slot_walk(tf, mode, t, out, w=w, node=node, head_cols=head_cols,
                  fn=build_probe()[name])


def tiny_check():
    """On the CPU: the edit applies once to its source, and the probe
    source holds the retired kernels.  Returns the probe's variants'
    names."""
    if "VEC * CPL <= 4 ? 4 : 2;" not in edited_sources()["half"]:
        raise AssertionError("the edit did not apply")
    with open(PROBE_SOURCE) as f:
        probe = f.read()
    for name in ("src_agg_kernel(", "gat_ds_kernel(", "int dgl_gat_ds(",
                 "int dgl_slot_agg(", "int dgl_slot_feat_reduce("):
        if name not in probe:
            raise AssertionError(f"the probe source lacks {name}")
    return ["retired"] + sorted(EDITS)


def main():
    if sys.argv[1:] != ["tiny"]:
        raise SystemExit("usage: python -m dgl_tpu_torch.tools."
                         "perf_slot_walks tiny (on the card, chip_smoke.py's "
                         "yardsticks run the probe on their graphs)")
    print(f"tiny check: {tiny_check()} apply")


if __name__ == "__main__":
    main()
