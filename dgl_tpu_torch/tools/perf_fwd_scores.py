"""Probe of K7's forward and K11's scores, each timed beside the kernel it
replaced and beside an edit of its own design, in one run on the card:

* K7's forward (``bitdot_fwd``): the listed walk by dst (``csrc/bitdot.cu``
  ``bitdot_fwd_list_kernel``) beside
  - the warp walk it replaced, ``bitdot_fwd_kernel`` (``fwd_scores_probe.cu``
    beside this file: a warp a dst row, its set bits one at a time);
  - the edit ``u2x`` of ``bitdot.cu``: twice the entries a group keeps in
    flight (``FwdUnroll``: 16, 8 and 4 where the walk keeps 8, 4 and 2);
* K11's scores (``vattn_scores`` with the edge term, ``egatc_scores``):
  the dot-product walk by dst in its scores mode (``csrc/row_agg.cu``
  ``row_vattn_fe_kernel`` and ``row_sddmm_kernel<CPL, true, true, T>``,
  then the exp pass) beside
  - the bucket walk they replaced, ``vattn_scores_kernel``
    (``fwd_scores_probe.cu``: a warp a 32-slot chunk, U[src] and V[dst]
    gathered with scalar loads at every slot, wf read from shared memory
    once an FMA), in its two instances;
  - the edit ``u2x`` of ``row_agg.cu``: twice the entries a group of K11
    v2's walk keeps in flight (``FeScoreUnroll``).

Every probe library is built with the package's ``nvcc`` flags into its
build directory (``tools.build_edited``), the three sources side by side,
at the first call of :func:`build_probe`, which ``chip_smoke.py`` starts
beside the package's build.  Each variant's output is held to the package
kernel's by the caller (``chip_smoke.py``'s yardsticks, phases 24, 30 and
40).  The probe is not a main path: nothing here counts launches.
``tools/perf_scores_rows.py`` builds K9's instance of the bucket walk from
an edit of this probe's source.

Usage: ``python -m dgl_tpu_torch.tools.perf_fwd_scores tiny`` (the CPU
check: every edit applies once, the probe's source has its C functions),
or ``... attrs`` on the card (the registers and local memory of the new
instances in the package and in each edit).
"""
from __future__ import annotations

import ctypes
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from . import build_edited, edited_source
from ..ops.kernels import bitdot as tbd
from ..ops.kernels import gat_fused as tgf
from ..ops.kernels import tiled_spmm as tts

PROBE_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fwd_scores_probe.cu")
_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, \
    ctypes.c_double
RETIRED_SIGNATURES = {
    "dgl_bitdot_fwd": [_P, _I, _I, _I, _P, _P, _I, _I, _F, _P, _P, _I, _P],
    "dgl_vattn_scores": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _D, _P, _I, _P, _I, _I, _P],
}
FWD_SIGNATURES = {
    name: tbd._SIGNATURES[name]
    for name in ("dgl_bitdot_fwd_list", "dgl_bitdot_fwd_attrs")}
SCORES_SIGNATURES = {
    name: tts._SIGNATURES["row_agg"][name]
    for name in ("dgl_row_vattn_fe", "dgl_row_vattn_fe_attrs")}
# edits, each old text found exactly once in its source.  "u2x": the
# forward, and K11 v2's scores walk, keep twice their entries in flight
FWD_EDITS = {
    "u2x": [("value = CPL == 1 ? 8 : CPL == 2 ? 4 : 2;",
             "value = CPL == 1 ? 16 : CPL == 2 ? 8 : 4;")],
}
SCORES_EDITS = {
    "u2x": [("static constexpr int value = KF <= 16 ? 4 : 2;",
             "static constexpr int value = KF <= 16 ? 8 : 4;")],
}
_BUCKET_WARPS = 8   # the bucket walk's warps a block (its kWarps)

_BUILT = {}
_LOCK = threading.Lock()


def edited_sources():
    """({name: ``csrc/bitdot.cu`` with FWD_EDITS[name]}, {name:
    ``csrc/row_agg.cu`` with SCORES_EDITS[name]})."""
    return ({name: edited_source("bitdot", edits, name)
             for name, edits in FWD_EDITS.items()},
            {name: edited_source("row_agg", edits, name)
             for name, edits in SCORES_EDITS.items()})


def build_probe():
    """{"retired": the probe source's C functions, "fwd_" and "scores_"
    before each name of FWD_EDITS and SCORES_EDITS: that edit's C
    functions}, the three sources built side by side at the first call (a
    caller in another thread waits for it)."""
    with _LOCK:
        if _BUILT:
            return _BUILT
        with open(PROBE_SOURCE) as f:
            own = f.read()
        fwd, scores = edited_sources()
        with ThreadPoolExecutor(3) as pool:
            jobs = [pool.submit(build_edited, "fwd_scores_probe",
                                {"retired": own}, RETIRED_SIGNATURES),
                    pool.submit(build_edited, "bitdot", fwd, FWD_SIGNATURES),
                    pool.submit(build_edited, "row_agg", scores,
                                SCORES_SIGNATURES)]
            retired, fwd_fns, scores_fns = (j.result() for j in jobs)
        _BUILT["retired"] = retired["retired"]
        _BUILT.update({f"fwd_{n}": fns for n, fns in fwd_fns.items()})
        _BUILT.update({f"scores_{n}": fns for n, fns in scores_fns.items()})
        return _BUILT


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {err}")


def _tail(dev):
    return dev.index, torch.cuda.current_stream(dev).cuda_stream


def warp_fwd(packed, q, z, isd: float):
    """K7's (out, l) by the warp walk the listed walk replaced, on CUDA
    operands, launched as the package launched it."""
    num_dst, heads, dim = q.shape
    dev = q.device
    out = torch.empty(q.shape, dtype=torch.float32, device=dev)
    l = torch.empty(q.shape[:2], dtype=torch.float32, device=dev)
    qc, zc = (t.float().contiguous() for t in (q, z))
    packed = packed.contiguous()
    _check(build_probe()["retired"]["dgl_bitdot_fwd"](
        packed.data_ptr(), packed.shape[1], z.shape[0], num_dst,
        qc.data_ptr(), zc.data_ptr(), heads, dim, isd, out.data_ptr(),
        l.data_ptr(), *_tail(dev)), "the warp forward walk")
    return out, l


def fwd_edit(name, packed, q, z, isd: float, order):
    """K7's (out, l) by the edit ``name`` of the listed walk, at the
    package's layout."""
    return tbd.launch_fwd(packed, q, z, isd, order,
                          fn=build_probe()[f"fwd_{name}"]
                          ["dgl_bitdot_fwd_list"])


def fwd_attrs(heads: int, dim: int, variant=None):
    """(registers a thread, local memory bytes a thread, resident warps an
    SM) of the forward's instance for ``heads`` x ``dim`` in the package's
    build or the edit ``variant``'s."""
    if variant is None:
        return tbd.fwd_kernel_attrs(heads, dim)
    cpl = tbd.dz_layout(heads, dim)[2]
    out = (ctypes.c_int * 3)()
    _check(build_probe()[f"fwd_{variant}"]["dgl_bitdot_fwd_attrs"](
        cpl, int(heads == 1), 0, ctypes.addressof(out)),
        f"the attributes of {variant}")
    return out[0], out[1], out[2] * 8


def bucket_scores(tf, U3, V3, attn, slope: float, ef_slot=None, wf=None,
                  fe_slot=None):
    """K11's p (B, H, C) by the bucket walk the dot-product walk replaced,
    on CUDA operands, launched as the package launched it: K11 v2's with
    ``ef_slot`` and ``wf``, K11 v1's with ``fe_slot`` (B, C, H D) f32 or
    bf16."""
    heads, dim, fe, rows = tgf._check_vattn(tf, U3, V3, attn, ef_slot, wf)
    dev = U3.device
    b, cap = tf.num_buckets, tf.cap
    p = torch.empty(b, heads, cap, dtype=torch.float32, device=dev)
    u, v, a = (t.float().contiguous() for t in (U3, V3, attn))
    edge = (ef_slot.float().contiguous(), wf.float().contiguous()) \
        if ef_slot is not None else None
    fe_s = None if fe_slot is None else fe_slot.contiguous()
    blocks = max(1, min(-(-(b * cap // 32) // _BUCKET_WARPS),
                        16 * tts._sms(dev)))
    _check(build_probe()["retired"]["dgl_vattn_scores"](
        tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
        tf.valid.data_ptr(), tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(),
        b, tf.tile, cap, u.data_ptr(), v.data_ptr(), a.data_ptr(),
        0 if edge is None else edge[0].data_ptr(),
        0 if edge is None else edge[1].data_ptr(), fe, rows, heads, dim,
        tts._lanes_per_head(heads), float(slope),
        0 if fe_s is None else fe_s.data_ptr(),
        0 if fe_s is None else tts.STORED_DTYPES[fe_s.dtype], p.data_ptr(),
        blocks, *_tail(dev)), "the bucket scores walk")
    return p


def scores_edit(name, tf, U3, V3, attn, slope: float, ef_slot, wf):
    """K11 v2's p by the edit ``name`` of its scores walk, then the
    package's exp pass."""
    heads, dim = U3.shape[1], U3.shape[2]
    hp = -(-dim // 4) * 4
    view = tf.row_view("dst")
    slots = tf.num_buckets * tf.cap
    sm, parts = tts.vattn_fe_dots(
        view, tts._vec4_rows(U3, hp), tts._vec4_rows(V3, hp),
        tts._vec4_rows(attn.reshape(1, heads, dim), hp), slope,
        tts.edge_operands(ef_slot, wf, heads, hp),
        fn=build_probe()[f"scores_{name}"]["dgl_row_vattn_fe"])
    p = torch.empty(tf.num_buckets, heads, tf.cap, dtype=torch.float32,
                    device=U3.device)
    tts._launch("dgl_slot_finish", sm.data_ptr(),
                view.entries(slots).data_ptr(), slots, heads, parts,
                sm.shape[1], tf.cap, p.data_ptr(), tts.finish_vec(heads, sm),
                1, tts.finish_blocks(slots, U3.device), U3.device.index,
                tts._stream(U3.device))
    return p


def scores_attrs(kf: int, variant=None):
    """(registers a thread, local memory bytes a thread, resident blocks an
    SM) of K11 v2's scores walk for ``kf`` rows of wf, in the package's
    build or the edit ``variant``'s."""
    if variant is None:
        return tts.vattn_fe_kernel_attrs(kf)
    out = (ctypes.c_int * 3)()
    _check(build_probe()[f"scores_{variant}"]["dgl_row_vattn_fe_attrs"](
        kf, 0, ctypes.addressof(out)), f"the attributes of {variant}")
    return tuple(out)


def tiny_check():
    """On the CPU: every edit applies once to its source, and the probe's
    source has its C functions.  Returns the probe's variants' names."""
    fwd, scores = edited_sources()
    if "CPL == 2 ? 8 : 4;" not in fwd["u2x"] \
            or "KF <= 16 ? 8 : 4;" not in scores["u2x"]:
        raise AssertionError("an edit did not apply")
    with open(PROBE_SOURCE) as f:
        own = f.read()
    for fn in RETIRED_SIGNATURES:
        if f"int {fn}(" not in own:
            raise AssertionError(f"{PROBE_SOURCE} lacks {fn}")
    return ["retired"] + [f"fwd_{n}" for n in sorted(fwd)] + [
        f"scores_{n}" for n in sorted(scores)]


def main():
    if sys.argv[1:] == ["attrs"]:
        # on the card: the new instances at DotGatConv's gate and EGAT's
        # widths, in the package and in each edit
        for heads, dim in ((2, 64), (1, 128), (1, 64)):
            for variant in (None, *FWD_EDITS):
                print(f"bitdot_fwd_list_kernel ({heads}, {dim}) "
                      f"({variant or 'package'}): registers, local bytes, "
                      f"warps an SM {fwd_attrs(heads, dim, variant)}")
        for kf in (8, 16, 32):
            for variant in (None, *SCORES_EDITS):
                print(f"row_vattn_fe_kernel<{kf}> ({variant or 'package'}): "
                      "registers, local bytes, blocks an SM "
                      f"{scores_attrs(kf, variant)}")
        return
    if sys.argv[1:] != ["tiny"]:
        raise SystemExit("usage: python -m dgl_tpu_torch.tools."
                         "perf_fwd_scores tiny | attrs (on the card, "
                         "chip_smoke.py's yardsticks run the probe on their "
                         "graphs)")
    print(f"tiny check: {tiny_check()} apply")


if __name__ == "__main__":
    main()
