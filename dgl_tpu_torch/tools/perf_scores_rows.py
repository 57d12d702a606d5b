"""Probe of the two kernels that K9's scores and K12's row product left, each
timed beside the design that replaced it, in one run on the card:

* K9's scores (``vattn_scores`` without an edge term): the dot-product walk
  by dst in its scores mode, the exp in the finishing pass
  (``csrc/row_agg.cu`` ``row_sddmm_kernel<CPL, true>``,
  ``slot_finish_kernel<VEC, true>``), beside the bucket walk it replaced,
  ``vattn_scores_kernel<false, float, false>``, once ``csrc/gatv2.cu``'s
  and now in ``fwd_scores_probe.cu`` beside this file (that instance
  built again by the edit ``BUCKET_SCORES`` of the probe's source): a warp
  a 32-slot chunk of a bucket, U[src] and V[dst] gathered with scalar
  loads at every slot, the padded slots visited;
* K12's row product (``int8_matmul_rows``): the tensor-core product
  (``csrc/int8mm.cu`` ``split_z_kernel<true>``, ``int8_rows_mma_kernel``)
  beside the f32-FMA walk it replaced (``rows_probe.cu`` beside this file:
  ``int8_rows_kernel``, x staged in shared memory a 512-column chunk at a
  time).

The edited sources and the probe's own are built with the package's
``nvcc`` flags into its build directory (``tools.build_edited``), side by
side, at the first call of :func:`build_probe`, which ``chip_smoke.py``
starts beside the package's build.  Each retired kernel's output is held
to the package kernel's by the caller's check (``chip_smoke.py``'s
yardsticks, phases 24 and 33).  The probe is not a main path: nothing here
counts launches.

Usage: ``python -m dgl_tpu_torch.tools.perf_scores_rows tiny`` (the CPU
check: the edit applies once, the probe's source has its C function).
"""
from __future__ import annotations

import ctypes
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from . import build_edited, edited_source
from . import perf_fwd_scores as tfs
from ..ops.kernels import gat_fused as tgf
from ..ops.kernels import tiled_spmm as tts

PROBE_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "rows_probe.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int64
RETIRED_SIGNATURES = {
    "dgl_probe_int8_rows_fma": [_P, _I, _I, _P, _I, _I, _P, _I, _P]}
# the bucket walk's source (tools/fwd_scores_probe.cu) with
# vattn_scores_kernel's instance without an edge or a stored term (K9's
# scores) back in dgl_vattn_scores
BUCKET_SCORES = [("    return cudaErrorInvalidValue;  // K9's scores: "
                  "csrc/row_agg.cu's walk\n",
                  "    DGL_SCORES_LAUNCH(false, float, false)\n")]

_BUILT = {}
_LOCK = threading.Lock()


def edited_scores_source() -> str:
    """``tools/fwd_scores_probe.cu`` with BUCKET_SCORES."""
    return edited_source("fwd_scores_probe", BUCKET_SCORES, "bucket_scores",
                         tfs.PROBE_SOURCE)


def build_probe():
    """{"bucket_scores": the edited probe source's ``dgl_vattn_scores``,
    "fma_rows": ``rows_probe.cu``'s ``dgl_probe_int8_rows_fma``}, built
    side by side at the first call (a caller in another thread waits for
    it)."""
    with _LOCK:
        if _BUILT:
            return _BUILT
        with open(PROBE_SOURCE) as f:
            own = f.read()
        with ThreadPoolExecutor(2) as pool:
            scores = pool.submit(
                build_edited, "fwd_scores_probe",
                {"bucket_scores": edited_scores_source()},
                {"dgl_vattn_scores":
                 tfs.RETIRED_SIGNATURES["dgl_vattn_scores"]})
            rows = pool.submit(build_edited, "rows_probe", {"retired": own},
                               RETIRED_SIGNATURES)
            _BUILT["bucket_scores"] = (
                scores.result()["bucket_scores"]["dgl_vattn_scores"])
            _BUILT["fma_rows"] = (
                rows.result()["retired"]["dgl_probe_int8_rows_fma"])
        return _BUILT


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {err}")


def _tail(dev):
    return dev.index, torch.cuda.current_stream(dev).cuda_stream


def bucket_scores(tf, U3, V3, attn, slope: float):
    """K9's p (B, H, C) by the bucket walk that the walk by dst replaced, on
    CUDA operands."""
    heads, dim = U3.shape[1:]
    dev = U3.device
    b, cap = tf.num_buckets, tf.cap
    p = torch.empty(b, heads, cap, dtype=torch.float32, device=dev)
    u, v, a = (t.float().contiguous() for t in (U3, V3, attn))
    blocks = max(1, min(-(-(b * cap // 32) // tgf._VATTN_WARPS),
                        16 * tts._sms(dev)))
    _check(build_probe()["bucket_scores"](
        tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
        tf.valid.data_ptr(), tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(),
        b, tf.tile, cap, u.data_ptr(), v.data_ptr(), a.data_ptr(), 0, 0, 0,
        0, heads, dim, tts._lanes_per_head(heads), float(slope), 0, 0,
        p.data_ptr(), blocks, *_tail(dev)), "the bucket scores walk")
    return p


def fma_rows(a, x):
    """(k, F) f32 = A @ x by the f32-FMA walk that the tensor-core product
    replaced, on CUDA operands (``int8_matmul_rows``'s)."""
    k, n_pad = a.shape
    x = x.float().contiguous()
    out = torch.empty(k, x.shape[1], dtype=torch.float32, device=x.device)
    _check(build_probe()["fma_rows"](
        a.data_ptr(), k, n_pad, x.data_ptr(), x.shape[0], x.shape[1],
        out.data_ptr(), *_tail(x.device)), "the f32-FMA rows walk")
    return out


def tiny_check():
    """On the CPU: the edit applies once to the bucket walk's source (it
    restores K9's instance), and the probe's source has its C function.
    Returns the probe's variants' names."""
    src = edited_scores_source()
    if src.count("DGL_SCORES_LAUNCH(false, float, false)") != 1:
        raise AssertionError("the edit did not restore K9's instance")
    with open(PROBE_SOURCE) as f:
        own = f.read()
    for fn in RETIRED_SIGNATURES:
        if f"int {fn}(" not in own:
            raise AssertionError(f"{PROBE_SOURCE} lacks {fn}")
    return ["bucket_scores", "fma_rows"]


def main():
    if sys.argv[1:] != ["tiny"]:
        raise SystemExit("usage: python -m dgl_tpu_torch.tools."
                         "perf_scores_rows tiny (on the card, chip_smoke.py's "
                         "yardsticks run the probe on their inputs)")
    print(f"tiny check: {tiny_check()} apply")


if __name__ == "__main__":
    main()
