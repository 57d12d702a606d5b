"""Probe of the two kernels that K6's slot reduce and K3 left, each timed
beside the row walk that replaced it, in one run on the card:

* K6's slot reduce (``slot_reduce``): the row reduce over the side's row
  view (``csrc/row_agg.cu`` ``row_reduce_kernel``), beside the tiled
  reduce it replaced, ``slot_reduce_kernel<kSrc>`` (``reduce_k3_probe.cu``
  beside this file): a block a tile and split of its buckets, the tile's
  (tile, H) sums in shared memory, a float atomicAdd a slot and head,
  heads in groups that fit a block, splits met with global atomics;
* K3 (``tiled_spmm``): the row walk by dst at one head
  (``row_agg_kernel``, weightless for a plain sum), beside the tiled walk
  it replaced, ``tiled_spmm_kernel<G, kCopy>`` (the same file): a block a
  dst tile, column chunk and split, the tile's rows in shared memory, a
  float atomicAdd a slot and column;
* three edits of ``row_agg.cu`` (VARIANTS), each timed beside the
  package's: a K3 row of fewer lanes than U slots in flight taking U
  entries a step (at F = 16: 8 slots in flight a lane, where the walk
  keeps lpr = 4), one head's weights read in rounds and shuffled (as the
  walk reads several heads'; the package reads each itself), and the row
  reduce on every block that fits an SM (the package takes 4).

The probe's source and the edited ``row_agg.cu``s are built with the
package's ``nvcc`` flags into its build directory (``tools.build_edited``),
side by side, at the first call of :func:`build_probe`, which
``chip_smoke.py`` starts beside the package's build.  Each retired
kernel's output is held to the package kernel's by the caller's check
(``chip_smoke.py``'s yardsticks, phases 16, 20 and 24).  The probe is not
a main path: nothing here counts launches.

Usage: ``python -m dgl_tpu_torch.tools.perf_reduce_k3 tiny`` (the CPU
check: the edits apply once, the probe's source has its C functions).
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
from ..ops.kernels import gat_fused as tgf
from ..ops.kernels import tiled_spmm as tts

PROBE_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "reduce_k3_probe.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int64
RETIRED_SIGNATURES = {
    "dgl_probe_tiled_spmm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P,
                             _I, _I, _I, _I, _P],
    "dgl_probe_slot_reduce": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                              _I, _I, _I, _I, _P]}
# edits of csrc/row_agg.cu, each old text found once.  "narrow": a row of
# fewer lanes than U takes U entries a step, each lane reading their ids
# itself; "rounds": one head's weights read in rounds and shuffled, as
# the walk reads several heads'; "nocap": the row reduce on every block
# that fits an SM, not kReduceBlocksPerSm
VARIANTS = {
    "narrow": [
        ("    for (int pb = p0; pb < p1; pb += lpr) {  // uniform in the "
         "group\n      const int n = min(lpr, p1 - pb);\n"
         "      int my_nbr = 0, my_wb = 0;",
         "    const bool narrow = lpr < U;\n"
         "    const int step = narrow ? U : lpr;\n"
         "    for (int pb = p0; pb < p1; pb += step) {\n"
         "      const int n = min(step, p1 - pb);\n"
         "      int my_nbr = 0, my_wb = 0;"),
        ("          const int nb = __shfl_sync(gmask, my_nbr, u0 + u, lpr);\n"
         "          const bool live = u0 + u < n;\n          const V* yr",
         "          const bool live = u0 + u < n;\n"
         "          const int nb =\n"
         "              narrow ? (live ? __ldg(nbr + pb + u) : 0)\n"
         "                     : __shfl_sync(gmask, my_nbr, u0 + u, lpr);\n"
         "          const V* yr"),
        ("          const int wb = __shfl_sync(gmask, my_wb, u0 + u, lpr);\n"
         "          const float wv = k < U * heads",
         "          int wb = 0;\n          if (!narrow) {\n"
         "            wb = __shfl_sync(gmask, my_wb, u0 + u, lpr);\n"
         "          } else if (k < U * heads && u < n) {\n"
         "            const int s = __ldg(slot + pb + u);\n"
         "            const int b = s / cap;\n"
         "            wb = b * w_bs + (s - b * cap) * w_cs;\n          }\n"
         "          const float wv = k < U * heads"),
        ("        if (!kOnes && heads == 1) {",
         "        if (!kOnes && heads == 1 && !narrow) {"),
        ("!kOnes && heads > 1 && k0 < U * heads;",
         "!kOnes && (heads > 1 || narrow) && k0 < U * heads;")],
    "rounds": [
        ("        if (!kOnes && heads == 1) {", "        if (false) {"),
        ("!kOnes && heads > 1 && k0 < U * heads;",
         "!kOnes && k0 < U * heads;")],
    "nocap": [("      &blocks, kReduceBlocksPerSm);", "      &blocks);")],
}
WALK_SIGNATURES = {
    fn: tts._SIGNATURES["row_agg"][fn] for fn in ("dgl_row_agg",
                                                 "dgl_row_reduce")}

_BUILT = {}
_LOCK = threading.Lock()


def variant_sources() -> dict:
    """{name: ``csrc/row_agg.cu`` with the edits of VARIANTS[name]}."""
    return {name: edited_source("row_agg", edits, name)
            for name, edits in VARIANTS.items()}


def build_probe():
    """{"retired": {fn: the probe's C functions}, and for each name of
    VARIANTS, {fn: that edited ``row_agg.cu``'s C functions}}, built side
    by side at the first call (a caller in another thread waits for
    it)."""
    with _LOCK:
        if _BUILT:
            return _BUILT
        with open(PROBE_SOURCE) as f:
            own = f.read()
        with ThreadPoolExecutor(2) as pool:
            retired = pool.submit(build_edited, "reduce_k3_probe",
                                  {"retired": own}, RETIRED_SIGNATURES)
            walks = pool.submit(build_edited, "row_agg", variant_sources(),
                                WALK_SIGNATURES)
            _BUILT["retired"] = retired.result()["retired"]
            _BUILT.update(walks.result())
        return _BUILT


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {err}")


def _tail(dev):
    return dev.index, torch.cuda.current_stream(dev).cuda_stream


def tiled_reduce(tf, vals, side: str = "dst"):
    """(num_rows, H) f32, the sum of ``vals`` (B, H, C) over each dst (or
    src) node's valid slots by the tiled reduce that the row reduce
    replaced, on CUDA operands, launched as ``slot_reduce`` launched it: a
    launch a group of heads, the splits of ``tools.tile_splits``."""
    src = side == "src"
    heads = vals.shape[1]
    dev = vals.device
    rows = tf.num_src if src else tf.num_dst
    n_t = tf.num_src_tiles if src else tf.num_dst_tiles
    group = min(heads, tgf._SMEM_PER_BLOCK // (4 * tf.tile))
    splits = tile_splits(tf, n_t, 1, 2, dev)
    out = (torch.zeros if splits > 1 else torch.empty)(
        rows, heads, dtype=torch.float32, device=dev)
    v = vals.float().contiguous()
    fn = build_probe()["retired"]["dgl_probe_slot_reduce"]
    for h0 in range(0, heads, group):
        _check(fn((tf.src_local if src else tf.dst_local).data_ptr(),
                  tf.valid.data_ptr(), v.data_ptr(),
                  tf.src_order.data_ptr() if src else 0,
                  (tf.src_ptr if src else tf.dst_ptr).data_ptr(), n_t,
                  tf.tile, tf.cap, heads, h0, min(group, heads - h0),
                  out.data_ptr(), rows, splits, int(src), *_tail(dev)),
               "the tiled reduce")
    return out


def tiled_k3(tf, x, w=None):
    """(num_dst, F) f32 = K3 by the tiled walk that the row walk replaced,
    on CUDA operands (``w`` slot weights in the format's slot layout, or
    None for a plain sum), launched as ``tiled_spmm`` launched it."""
    f = x.shape[1]
    dev = x.device
    g = tile_group(f, tf.tile)
    n_dt = tf.num_dst_tiles
    splits = tile_splits(tf, n_dt, -(-f // g), tile_group_per_sm(g, tf.tile),
                         dev)
    out = (torch.zeros if splits > 1 else torch.empty)(
        tf.num_dst, f, dtype=torch.float32, device=dev)
    xc = x.float().contiguous()
    wc = None if w is None else w.float().contiguous()
    _check(build_probe()["retired"]["dgl_probe_tiled_spmm"](
        tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
        tf.valid.data_ptr(), 0 if wc is None else wc.data_ptr(),
        tf.src_tile.data_ptr(), tf.dst_ptr.data_ptr(), n_dt, tf.tile, tf.cap,
        xc.data_ptr(), f, out.data_ptr(), tf.num_dst, g, splits,
        *_tail(dev)), "the tiled K3 walk")
    return out


def variant_k3(name, tf, x, w=None):
    """K3 by the row walk of variant ``name`` ("narrow" or "rounds"), on
    CUDA operands, at the head width the wrapper gives it."""
    f = x.shape[1]
    out = torch.empty(tf.num_dst, 1, f, dtype=torch.float32,
                      device=x.device)
    w3 = None if w is None else w.reshape(tf.num_buckets, 1, tf.cap).float()
    tts.row_walk(tf.row_view("dst"), tf.cap,
                 x.float().contiguous().view(-1, 1, f), w3, out,
                 fn=build_probe()[name]["dgl_row_agg"])
    return out.view(tf.num_dst, f)


def nocap_reduce(tf, vals, side: str = "dst"):
    """``slot_reduce``'s row reduce with every block that fits an SM (the
    edit "nocap"), on CUDA operands."""
    rows = tf.num_src if side == "src" else tf.num_dst
    out = torch.empty(rows, vals.shape[1], dtype=torch.float32,
                      device=vals.device)
    tts.row_reduce(tf.row_view(side), tf.cap, vals.float(), out,
                   fn=build_probe()["nocap"]["dgl_row_reduce"])
    return out


def tiny_check():
    """On the CPU: the edit applies once, and the probe's source has its C
    functions.  Returns the probe's variants' names."""
    srcs = variant_sources()
    if srcs["narrow"].count("const bool narrow = lpr < U;") != 1:
        raise AssertionError("the edit did not add the narrow step")
    with open(PROBE_SOURCE) as f:
        own = f.read()
    for fn in RETIRED_SIGNATURES:
        if f"int {fn}(" not in own:
            raise AssertionError(f"{PROBE_SOURCE} lacks {fn}")
    return ["tiled_reduce", "tiled_k3", *srcs]


def main():
    if sys.argv[1:] != ["tiny"]:
        raise SystemExit("usage: python -m dgl_tpu_torch.tools."
                         "perf_reduce_k3 tiny (on the card, chip_smoke.py's "
                         "yardsticks run the probe on their inputs)")
    print(f"tiny check: {tiny_check()} apply")


if __name__ == "__main__":
    main()
