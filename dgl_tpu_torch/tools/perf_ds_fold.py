"""Probe of the two kernels that K6's ds and K9's slot gradient left, each
timed beside the design that replaced it, in one run on the card:

* K6's ds (``gat_ds``): the dot-product walk by dst with its epilogue in
  the finishing pass (``csrc/row_agg.cu`` ``row_sddmm_kernel``,
  ``ds_finish_kernel``) beside the bucket walk it replaced,
  ``gat_ds_kernel`` without an edge term (its mode 0, instantiated again
  by the edit ``BUCKET_DS`` of ``tools/slot_walks_probe.cu``, where the
  kernel's edge modes went when K10's ds left it): a warp a 32-slot chunk
  of a bucket, x[src] and zn[dst] gathered with scalar loads, the epilogue
  per slot;
* K9's da (``vattn_slot_grad`` without the edge term): the node-gradient
  walk by dst with da folded in (``row_agg_kernel<VEC, CPL, true, true>``)
  beside the tiled walk it replaced, ``vattn_slot_grad_kernel<C, float,
  false>`` (instantiated again by the edit ``TILED_DA`` of
  ``tools/slot_grad_scores_probe.cu``, where the kernel went when K11 v1's
  slot gradient left it): a warp a 32-slot chunk, both node rows of every
  slot gathered with scalar loads, da met in shared-memory atomics.

Both edited sources are built with the package's ``nvcc`` flags into its
build directory (``tools.build_edited``), side by side, at the first call
of :func:`build_probe`, which ``chip_smoke.py`` starts beside the
package's build.  Each retired kernel's output is held to the package
kernel's by the caller's check (``chip_smoke.py``'s yardsticks, phases
20, 24 and 27).  The probe is not a main path: nothing here counts
launches.

Usage: ``python -m dgl_tpu_torch.tools.perf_ds_fold tiny`` (the CPU
check: every edit applies once).
"""
from __future__ import annotations

import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from . import build_edited, edited_source
from . import perf_slot_grad_scores as tsg
from . import perf_slot_walks as tsl
from ..ops.kernels import tiled_spmm as tts

# tools/slot_walks_probe.cu with gat_ds_kernel's instance without an edge
# term (mode 0) back in its switch
BUCKET_DS = [("  switch (mode) {\n    case 1:\n"
              "      return launch_ds<L, true, false, float, false>",
              "  switch (mode) {\n    case 0:\n"
              "      return launch_ds<L, false, false, float, false>"
              "(DGL_DS_ARGS);\n    case 1:\n"
              "      return launch_ds<L, true, false, float, false>")]
# tools/slot_grad_scores_probe.cu with vattn_slot_grad_kernel's instances
# without a stored term (K9's da) back in its dispatch
TILED_DA = [("    return cudaErrorInvalidValue;  // K9's da: csrc/row_agg.cu's fold\n",
             "    if (cols == 1) return launch_slot_grad<1, float, false>("
             "DGL_GRAD_ARGS);\n"
             "    if (cols == 2) return launch_slot_grad<2, float, false>("
             "DGL_GRAD_ARGS);\n"
             "    if (cols == 4) return launch_slot_grad<4, float, false>("
             "DGL_GRAD_ARGS);\n"
             "    return cudaErrorInvalidValue;\n")]

_BUILT = {}
_LOCK = threading.Lock()


def edited_sources():
    """(``tools/slot_walks_probe.cu`` with BUCKET_DS,
    ``tools/slot_grad_scores_probe.cu`` with TILED_DA)."""
    return (edited_source("slot_walks_probe", BUCKET_DS, "bucket_ds",
                          path=tsl.PROBE_SOURCE),
            edited_source("slot_grad_scores_probe", TILED_DA, "tiled_da",
                          path=tsg.PROBE_SOURCE))


def build_probe():
    """{"bucket_ds": the edited probe source's ``dgl_gat_ds``,
    "tiled_da": the edited slot-gradient probe's ``dgl_vattn_slot_grad``},
    the two
    built side by side at the first call (a caller in another thread waits
    for it)."""
    with _LOCK:
        if _BUILT:
            return _BUILT
        ds_src, da_src = edited_sources()
        with ThreadPoolExecutor(2) as pool:
            ds = pool.submit(build_edited, "slot_walks_probe",
                             {"bucket_ds": ds_src},
                             {"dgl_gat_ds":
                              tsl.RETIRED_SIGNATURES["dgl_gat_ds"]})
            da = pool.submit(build_edited, "slot_grad_scores_probe",
                             {"tiled_da": da_src},
                             {"dgl_vattn_slot_grad":
                              tsg.RETIRED_SIGNATURES["dgl_vattn_slot_grad"]})
            _BUILT["bucket_ds"] = ds.result()["bucket_ds"]["dgl_gat_ds"]
            _BUILT["tiled_da"] = (
                da.result()["tiled_da"]["dgl_vattn_slot_grad"])
        return _BUILT


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {err}")


def bucket_ds(tf, x3, zn, rp, g):
    """K6's ds (B, H, C) by the bucket walk that the dot-product walk
    replaced, on CUDA operands."""
    heads, fh = x3.shape[1:]
    b = tf.num_buckets
    dev = x3.device
    ds = torch.empty(b, heads, tf.cap, dtype=torch.float32, device=dev)
    x, z, r, gg = (t.float().contiguous() for t in (x3, zn, rp, g))
    blocks = max(1, min(-(-(b * tf.cap // 32) // tsl.DS_WARPS),
                        16 * tts._sms(dev)))
    _check(build_probe()["bucket_ds"](
        tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
        tf.valid.data_ptr(), tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(),
        b, tf.tile, tf.cap, x.data_ptr(), z.data_ptr(), r.data_ptr(),
        gg.data_ptr(), heads, fh, 0, 0, 0, 0, 0, 0, 0, 0, ds.data_ptr(),
        tts._lanes_per_head(heads), blocks, dev.index, tts._stream(dev)),
        "the bucket ds walk")
    return ds


def tiled_da(tf, U3, V3, attn, ds, slope: float):
    """K9's da (H, D) by the tiled walk that the fold replaced, on CUDA
    operands; ``ds`` (B, H, C)."""
    heads, dim = U3.shape[1:]
    dev = U3.device
    lanes = tts._lanes_per_head(heads)
    cols = 1
    while cols < min(-(-dim // lanes), 4):
        cols *= 2
    da = torch.zeros(heads, dim, dtype=torch.float32, device=dev)
    u, v, a, d = (t.float().contiguous() for t in (U3, V3, attn, ds))
    b, cap = tf.num_buckets, tf.cap
    blocks = max(1, min(-(-(b * cap // 32) // tsg._BUCKET_WARPS),
                        4 * tts._sms(dev)))
    _check(build_probe()["tiled_da"](
        tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
        tf.valid.data_ptr(), tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(),
        b, tf.tile, cap, u.data_ptr(), v.data_ptr(), a.data_ptr(),
        d.data_ptr(), heads, dim, lanes, cols, float(slope), da.data_ptr(),
        0, 0, 0, blocks, dev.index, tts._stream(dev)),
        "the tiled da walk")
    return da


def tiny_check():
    """On the CPU: both edits apply once to their sources.  Returns the
    probe's variants' names."""
    ds_src, da_src = edited_sources()
    if "case 0:" not in ds_src or \
            "launch_slot_grad<4, float, false>" not in da_src:
        raise AssertionError("an edit did not restore its instance")
    return ["bucket_ds", "tiled_da"]


def main():
    if sys.argv[1:] != ["tiny"]:
        raise SystemExit("usage: python -m dgl_tpu_torch.tools.perf_ds_fold "
                         "tiny (on the card, chip_smoke.py's yardsticks run "
                         "the probe on their graphs)")
    print(f"tiny check: {tiny_check()} apply")


if __name__ == "__main__":
    main()
