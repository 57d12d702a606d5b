"""Probe of K11 v1's slot gradient and K10 v2's scores, each timed beside the
kernel it replaced and beside another design of its own, in one run on the
card:

* K11 v1's slot gradient (``egatc_slot_grad``): the slot walk by dst
  (``csrc/row_agg.cu`` ``row_slot_grad_kernel``, dFNJ summed on the walk)
  beside
  - the bucket walk it replaced, ``vattn_slot_grad_kernel<C, T, true>``
    (``slot_grad_scores_probe.cu`` beside this file: a warp a 32-slot
    chunk, U[src], V[dst] and FE read with scalar loads a slot at a time,
    da met in shared and global atomics), whose dFE then took
    ``slot_vec_reduce`` by dst for dFNJ;
  - the edit ``unfolded`` of ``row_agg.cu``: the same walk without the
    dFNJ sum (``kSlotGradFold`` false), which ``slot_vec_reduce`` by dst
    then follows;
  - the edits ``vec1_unroll4`` and ``vec1_unroll2`` of ``row_agg.cu``: 4
    (the first design's count, which spilled) or 2 entries in flight a
    lane (``SlotGradUnroll``; the package keeps 1) at one float a load,
    the instances taken where a head's width is not a multiple of 4;
* K10 v2's scores (``edgegat_scores``): ``csrc/gat_fused.cu``
  ``edge_scores_kernel`` (a thread a slot loads its own edge-feature row,
  16 bytes at a time) beside
  - the kernel it replaced, ``gat_scores_kernel<false, true>`` (the probe
    source: a thread a slot, its row read with scalar loads once per
    head), whose K6 and K10 v1 instances are also held to the package's
    ``gat_scores_kernel<kBias>`` bit for bit;
  - the staged design (the probe source's ``edge_scores_staged_kernel``: a
    warp's 32 slots' rows copied into shared memory by cp.async, each
    lane reading its row there), which lost to the package's on the card.

Every probe library is built with the package's ``nvcc`` flags into its
build directory (``tools.build_edited``), the two sources side by side,
at the first call of :func:`build_probe`, which ``chip_smoke.py`` starts
beside the package's build.  Each variant's output is held to the package
kernel's by the caller (``chip_smoke.py``'s yardsticks, phases 27 and
40).  The probe is not a main path: nothing here counts launches.
``tools/perf_ds_fold.py`` builds K9's instances of the bucket walk from an
edit of this probe's source.

Usage: ``python -m dgl_tpu_torch.tools.perf_slot_grad_scores tiny`` (the
CPU check: every edit applies once, the probe's source has its C
functions), or ``... attrs`` on the card (the registers and local memory
of the new instances in the package and in each edit).
"""
from __future__ import annotations

import ctypes
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from . import build_edited, edited_source
from ..ops.kernels import gat_fused as tgf
from ..ops.kernels import tiled_spmm as tts

PROBE_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "slot_grad_scores_probe.cu")
_P, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
RETIRED_SIGNATURES = {
    "dgl_vattn_slot_grad": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                            _I, _I, _I, _I, _D, _P, _P, _P, _I, _I, _I, _P],
    "dgl_gat_scores_thread": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                              _P, _I, _I, _D, _P, _P, _I, _I, _P],
    "dgl_edge_scores_staged": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                               _P, _I, _I, _D, _P, _P, _I, _I, _I, _I, _P],
    "dgl_edge_scores_staged_attrs": [_I, _I, _I, _I, _I, _P],
}
GRAD_SIGNATURES = {
    name: tts._SIGNATURES["row_agg"][name]
    for name in ("dgl_row_slot_grad", "dgl_row_slot_grad_attrs")}
# edits of csrc/row_agg.cu, each old text found exactly once.
# "unfolded": the slot-gradient walk without dFNJ; "vec1_unroll<U>": U
# entries in flight a lane at one float a load
_UNROLL = ("  static constexpr int value = VEC == 1 ? 1 : VEC * CPL <= 4 ? 4 : "
           "2;")
GRAD_EDITS = {
    "unfolded": [("constexpr bool kSlotGradFold = true;",
                  "constexpr bool kSlotGradFold = false;")],
    **{f"vec1_unroll{u}": [(_UNROLL, "  static constexpr int value = "
                                     f"VEC == 1 ? {u} : VEC * CPL <= 4 ? 4 "
                                     ": 2;")] for u in (4, 2)},
}
_BUCKET_WARPS = 8   # the bucket walk's warps a block (its kWarps)
_THREADS = 256      # the retired scores' threads a block (kScoresThreads)
_STAGED_WARPS = 8   # the staged scores' warps a block, at most (kEdgeWarps)
_CHUNK = 32         # slots a warp of the staged scores stages at once

_BUILT = {}
_LOCK = threading.Lock()


def edited_sources():
    """{name: ``csrc/row_agg.cu`` with GRAD_EDITS[name]}."""
    return {name: edited_source("row_agg", edits, name)
            for name, edits in GRAD_EDITS.items()}


def build_probe():
    """{"retired": the probe source's C functions, "grad_" before each name
    of GRAD_EDITS: that edit's C functions}, the sources built side by
    side at the first call (a caller in another thread waits for it)."""
    with _LOCK:
        if _BUILT:
            return _BUILT
        with open(PROBE_SOURCE) as f:
            own = f.read()
        with ThreadPoolExecutor(2) as pool:
            jobs = [pool.submit(build_edited, "slot_grad_scores_probe",
                                {"retired": own}, RETIRED_SIGNATURES),
                    pool.submit(build_edited, "row_agg", edited_sources(),
                                GRAD_SIGNATURES)]
            retired, grad_fns = (j.result() for j in jobs)
        _BUILT["retired"] = retired["retired"]
        _BUILT.update({f"grad_{n}": fns for n, fns in grad_fns.items()})
        return _BUILT


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {err}")


def _tail(dev):
    return dev.index, torch.cuda.current_stream(dev).cuda_stream


def bucket_slot_grad(tf, U3, V3, attn, fe_slot, ds, slope: float):
    """K11 v1's (da (H, D), dfe like ``fe_slot``) by the bucket walk the
    slot walk replaced, on CUDA operands, launched as the package launched
    it (da zeroed first: the walk adds into it with atomics)."""
    heads, dim = U3.shape[1], U3.shape[2]
    dev = U3.device
    da = torch.zeros(heads, dim, dtype=torch.float32, device=dev)
    fe_s = fe_slot.contiguous()
    dfe = torch.empty_like(fe_s)
    lanes = tts._lanes_per_head(heads)
    cols = 1      # columns of its head a lane keeps in registers at once
    while cols < min(-(-dim // lanes), 4):
        cols *= 2
    u, v, a, g = (t.float().contiguous() for t in (U3, V3, attn, ds))
    b, cap = tf.num_buckets, tf.cap
    blocks = max(1, min(-(-(b * cap // 32) // _BUCKET_WARPS),
                        4 * tts._sms(dev)))
    _check(build_probe()["retired"]["dgl_vattn_slot_grad"](
        tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
        tf.valid.data_ptr(), tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(),
        b, tf.tile, cap, u.data_ptr(), v.data_ptr(), a.data_ptr(),
        g.data_ptr(), heads, dim, lanes, cols, float(slope), da.data_ptr(),
        fe_s.data_ptr(), dfe.data_ptr(), tts.STORED_DTYPES[fe_s.dtype],
        blocks, *_tail(dev)), "the bucket slot-gradient walk")
    return da, dfe


def grad_edit(name, tf, U3, V3, attn, fe_slot, ds, slope: float):
    """K11 v1's (da (H, D), dfe, dfnj) by the edit ``name`` of the slot
    walk, at the package's layout (the edit ``unfolded`` leaves dFNJ
    0)."""
    heads, dim = U3.shape[1], U3.shape[2]
    hd = heads * dim
    dev = U3.device
    fe_s = fe_slot.contiguous()
    da = torch.zeros(hd, dtype=torch.float32, device=dev)
    dfe = torch.empty_like(fe_s)
    dfnj = torch.zeros(tf.num_dst, hd, dtype=torch.float32, device=dev)
    tts.slot_grad_walk(tf, fe_s.view(-1, hd), dfe.view(-1, hd), dfnj, da,
                       U3.float().contiguous().view(-1, hd),
                       V3.float().contiguous().view(-1, hd),
                       attn.float().contiguous().view(hd), ds.float(),
                       float(slope), dim,
                       fn=build_probe()[f"grad_{name}"]["dgl_row_slot_grad"])
    return da.view(heads, dim), dfe, dfnj


def grad_attrs(dtype, vec: int, cpl: int, variant=None):
    """(registers a thread, local memory bytes a thread, resident blocks an
    SM) of the slot-gradient walk's instance in the package's build or the
    edit ``variant``'s."""
    if variant is None:
        return tts.slot_grad_kernel_attrs(dtype, vec, cpl)
    out = (ctypes.c_int * 3)()
    _check(build_probe()[f"grad_{variant}"]["dgl_row_slot_grad_attrs"](
        tts.STORED_DTYPES[dtype], vec, cpl, 0, ctypes.addressof(out)),
        f"the attributes of {variant}")
    return tuple(out)


def thread_scores(tf, el, er, slope: float, ee_slot=None, ef_slot=None,
                  m=None):
    """(p, g) by the retired ``gat_scores_kernel<kBias, kEdge>``, a thread a
    slot, launched as the package launched it: K10 v2's instance with
    ``ef_slot`` and ``m``, K10 v1's with ``ee_slot``, K6's with neither."""
    heads = el.shape[1]
    dev = el.device
    b, cap = tf.num_buckets, tf.cap
    p = torch.empty(b, heads, cap, dtype=torch.float32, device=dev)
    g = torch.empty_like(p)
    e1, e2 = el.float().contiguous(), er.float().contiguous()
    ee = None if ee_slot is None else ee_slot.float().contiguous()
    ef = None if ef_slot is None else ef_slot.float().contiguous()
    mm = None if m is None else m.float().contiguous()
    fe = 0 if ef is None else ef.shape[-1]
    slots = b * cap
    blocks = max(1, min(-(-slots // _THREADS), 32 * tts._sms(dev)))
    _check(build_probe()["retired"]["dgl_gat_scores_thread"](
        tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
        tf.valid.data_ptr(), tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(),
        slots, tf.tile, cap, e1.data_ptr(), e2.data_ptr(),
        0 if ee is None else ee.data_ptr(),
        0 if ef is None else ef.data_ptr(),
        0 if mm is None else mm.data_ptr(), fe, heads, float(slope),
        p.data_ptr(), g.data_ptr(), blocks, *_tail(dev)),
        "the retired scores kernel")
    return p, g


def edge_row_floats(fe: int, vec16: bool) -> int:
    """The floats a staged edge-feature row takes in the staged scores'
    shared memory (the probe source's ``edge_row_floats``): Fe, padded so
    that the lanes' reads of their own rows meet no bank conflict (16-byte
    reads where ``vec16``, else 4-byte)."""
    if vec16:
        return fe if (fe // 4) % 2 == 1 else fe + 4
    return fe | 1


def staged_scores_smem(fe: int, heads: int, warps: int, vec16: bool) -> int:
    """The staged scores' dynamic shared memory bytes at ``warps`` warps a
    block: M (Fe, H) f32, then each warp's 32 staged rows."""
    return 4 * (-(-fe * heads // 4) * 4
                + warps * 32 * edge_row_floats(fe, vec16))


def staged_scores_warps(fe: int, heads: int, vec16: bool) -> int:
    """Warps a block of the staged scores: the most, up to 8, whose staged
    rows fit a block's shared memory beside M; 0 where one warp's do
    not."""
    for warps in range(_STAGED_WARPS, 0, -1):
        if staged_scores_smem(fe, heads, warps, vec16) <= tgf._SMEM_PER_BLOCK:
            return warps
    return 0


def staged_scores(tf, el, er, ef_slot, m, slope: float):
    """K10 v2's (p, g) by the staged design (the probe source's
    ``edge_scores_staged_kernel``), launched as the package launched it
    when it was the package's: 16-byte copies where Fe is a multiple of 4
    and the rows are 16-byte aligned, the most warps a block that fit."""
    heads, fe = el.shape[1], ef_slot.shape[-1]
    dev = el.device
    b, cap = tf.num_buckets, tf.cap
    p = torch.empty(b, heads, cap, dtype=torch.float32, device=dev)
    g = torch.empty_like(p)
    e1, e2, ef, mm = (t.float().contiguous() for t in (el, er, ef_slot, m))
    vec16 = fe % 4 == 0 and ef.data_ptr() % 16 == 0
    warps = staged_scores_warps(fe, heads, vec16)
    if warps == 0:
        raise ValueError(f"the staged rows of {fe} features do not fit")
    chunks = b * cap // _CHUNK
    blocks = max(1, min(-(-chunks // warps), 32 * tts._sms(dev)))
    _check(build_probe()["retired"]["dgl_edge_scores_staged"](
        tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
        tf.valid.data_ptr(), tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(),
        b * cap, tf.tile, cap, e1.data_ptr(), e2.data_ptr(), ef.data_ptr(),
        mm.data_ptr(), fe, heads, float(slope), p.data_ptr(), g.data_ptr(),
        blocks, warps, int(vec16), *_tail(dev)), "the staged edge scores")
    return p, g


def scores_attrs(fe: int, heads: int, staged: bool = False):
    """(registers a thread, local memory bytes a thread, resident blocks an
    SM, threads a block) of the edge scores' instance for ``fe`` features
    at ``heads`` heads in the package, or (``staged``) of the staged
    design's (16-byte stage where Fe is a multiple of 4)."""
    if not staged:
        return (*tgf.edge_scores_kernel_attrs(fe, heads), _THREADS)
    vec16 = fe % 4 == 0
    warps = staged_scores_warps(fe, heads, vec16)
    out = (ctypes.c_int * 3)()
    _check(build_probe()["retired"]["dgl_edge_scores_staged_attrs"](
        fe, heads, warps, int(vec16), 0, ctypes.addressof(out)),
        "the attributes of the staged scores")
    return out[0], out[1], out[2], 32 * warps


def tiny_check():
    """On the CPU: every edit applies once to its source, and the probe's
    source has its C functions.  Returns the probe's variants' names."""
    grad = edited_sources()
    if "kSlotGradFold = false;" not in grad["unfolded"] or any(
            f"VEC == 1 ? {u} :" not in grad[f"vec1_unroll{u}"]
            for u in (4, 2)):
        raise AssertionError("an edit did not apply")
    with open(PROBE_SOURCE) as f:
        own = f.read()
    for fn in RETIRED_SIGNATURES:
        if f"int {fn}(" not in own:
            raise AssertionError(f"{PROBE_SOURCE} lacks {fn}")
    return ["retired"] + [f"grad_{n}" for n in sorted(grad)]


def main():
    if sys.argv[1:] == ["attrs"]:
        # on the card: the new instances at the EGATConv v1 and
        # EdgeGATConv widths, in the package and in each edit
        for dtype in (torch.float32, torch.bfloat16):
            for vec, cpl in ((4, 1), (4, 2), (1, 1), (1, 2), (1, 4)):
                for variant in (None, *GRAD_EDITS):
                    print(f"row_slot_grad_kernel<{vec}, {cpl}, {dtype}> "
                          f"({variant or 'package'}): registers, local "
                          f"bytes, blocks an SM "
                          f"{grad_attrs(dtype, vec, cpl, variant)}")
        for fe in (5, 16, 31):
            for staged in (False, True):
                name = "staged" if staged else "package"
                print(f"edge scores Fe={fe} H=4 ({name}): registers, local "
                      f"bytes, blocks an SM, threads a block "
                      f"{scores_attrs(fe, 4, staged)}")
        return
    if sys.argv[1:] != ["tiny"]:
        raise SystemExit("usage: python -m dgl_tpu_torch.tools."
                         "perf_slot_grad_scores tiny | attrs (on the card, "
                         "chip_smoke.py's yardsticks run the probe on their "
                         "graphs)")
    print(f"tiny check: {tiny_check()} apply")


if __name__ == "__main__":
    main()
