"""Probe of K7's dz and K11 v2's slot gradient, each timed beside the
kernel it replaced and beside an edit of its own design, in one run on the
card:

* K7's dz (``bitdot_bwd_dz``): the listed walk by src (``csrc/bitdot.cu``
  ``bitdot_dz_list_kernel``) beside
  - the warp walk it replaced, ``bitdot_dz_kernel`` (``dz_slot_grad_probe.cu``
    beside this file: a warp a src row, its set bits one at a time);
  - the edit ``u2x`` of ``bitdot.cu``: twice the entries a group keeps in
    flight (``DzUnroll``);
  - the walk at one step fewer or more lanes an entry (:func:`dz_layouts`),
    launched from the package's build;
* K11 v2's slot gradient (``vattn_slot_grad`` with the edge term): the
  tensor-core kernel (``csrc/gatv2.cu`` ``vattn_slot_grad_mma_kernel``)
  beside
  - the edge instances of ``vattn_slot_grad_kernel`` it replaced
    (``dz_slot_grad_probe.cu``: a lane a few columns, fe and dWf as f32
    FMAs, shared and global atomics);
  - the edit ``one_part`` of ``gatv2.cu``: its contractions in one bf16
    part (``kSplit`` 1), which shows what the split into three costs (and
    is not f32-accurate: its output is only timed).

Every probe library is built with the package's ``nvcc`` flags into its
build directory (``tools.build_edited``), the three sources side by side,
at the first call of :func:`build_probe`, which ``chip_smoke.py`` starts
beside the package's build.  Each variant's output is held to the package
kernel's by the caller (``chip_smoke.py``'s yardsticks, phases 24 and 30).
The probe is not a main path: nothing here counts launches.

Usage: ``python -m dgl_tpu_torch.tools.perf_dz_slot_grad tiny`` (the CPU
check: every edit applies once, the layouts on either side).
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
                            "dz_slot_grad_probe.cu")
_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, \
    ctypes.c_double
RETIRED_SIGNATURES = {
    "dgl_probe_dz_warp": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _F, _P, _I,
                          _P],
    "dgl_probe_slot_grad_tiled": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                                  _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _D,
                                  _P, _P, _P, _I, _I, _P],
    "dgl_probe_slot_grad_attrs": [_I, _I, _I, _I, _P],
}
DZ_SIGNATURES = {
    "dgl_bitdot_bwd_dz_list": tbd._SIGNATURES["dgl_bitdot_bwd_dz_list"]}
MMA_SIGNATURES = {
    "dgl_vattn_slot_grad_mma":
        tgf._VATTN_SIGNATURES["dgl_vattn_slot_grad_mma"]}
# edits, each old text found exactly once in its source.  "u2x": twice the
# entries a group of the dz walk keeps in flight; "one_part": the slot
# gradient's operands in one bf16 part each, one product a contraction
DZ_EDITS = {
    "u2x": [("  static constexpr int value = CPL == 1 ? 4 : CPL == 2 ? 2 : 1;",
             "  static constexpr int value = CPL == 1 ? 8 : CPL == 2 ? 4 : 2;")],
}
MMA_EDITS = {
    "one_part": [("constexpr int kSplit = 3;       // bf16 parts",
                  "constexpr int kSplit = 1;       // bf16 parts")],
}

_BUILT = {}
_LOCK = threading.Lock()


def edited_sources():
    """({name: ``csrc/bitdot.cu`` with DZ_EDITS[name]}, {name:
    ``csrc/gatv2.cu`` with MMA_EDITS[name]})."""
    return ({name: edited_source("bitdot", edits, name)
             for name, edits in DZ_EDITS.items()},
            {name: edited_source("gatv2", edits, name)
             for name, edits in MMA_EDITS.items()})


def build_probe():
    """{"retired": the probe source's C functions, DZ_EDITS' and MMA_EDITS'
    names: each edit's C function}, the three sources built side by side at
    the first call (a caller in another thread waits for it)."""
    with _LOCK:
        if _BUILT:
            return _BUILT
        with open(PROBE_SOURCE) as f:
            own = f.read()
        dz, mma = edited_sources()
        with ThreadPoolExecutor(3) as pool:
            jobs = [pool.submit(build_edited, "dz_slot_grad_probe",
                                {"retired": own}, RETIRED_SIGNATURES),
                    pool.submit(build_edited, "bitdot", dz, DZ_SIGNATURES),
                    pool.submit(build_edited, "gatv2", mma, MMA_SIGNATURES)]
            retired, dz_fns, mma_fns = (j.result() for j in jobs)
        _BUILT["retired"] = retired["retired"]
        for name, fns in dz_fns.items():
            _BUILT[name] = fns["dgl_bitdot_bwd_dz_list"]
        for name, fns in mma_fns.items():
            _BUILT[name] = fns["dgl_vattn_slot_grad_mma"]
        return _BUILT


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {err}")


def warp_dz(packed_rev, q, z, g, linv, rho, isd: float):
    """K7's dz (N_src, H, D) by the warp walk the listed walk replaced, on
    CUDA operands."""
    num_src, heads, dim = z.shape
    dev = z.device
    dz = torch.empty(z.shape, dtype=torch.float32, device=dev)
    nvec = torch.stack([linv.float(), rho.float()], 1)
    qc, zc, gc = (t.float().contiguous() for t in (q, z, g))
    packed_rev = packed_rev.contiguous()
    _check(build_probe()["retired"]["dgl_probe_dz_warp"](
        packed_rev.data_ptr(), packed_rev.shape[1], num_src, q.shape[0],
        qc.data_ptr(), zc.data_ptr(), gc.data_ptr(), nvec.data_ptr(), heads,
        dim, isd, dz.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream), "the warp dz walk")
    return dz


def dz_edit(name, packed_rev, q, z, g, linv, rho, isd: float, order):
    """K7's dz by the edit ``name`` of the listed walk, at the package's
    layout."""
    return tbd.launch_dz(packed_rev, q, z, g, linv, rho, isd, order,
                         fn=build_probe()[name])


def dz_layouts(heads: int, dim: int):
    """{lanes an entry: (dp, lpe, cpl)} of the dz walk at the package's
    layout and one step (a factor of two in lanes an entry) on either side,
    where the walk takes it (at most 32 lanes, at least a head's vectors
    with several heads, at most 4 vectors a lane)."""
    dp, lpe, _ = tbd.dz_layout(heads, dim)
    out = {}
    for lanes in (lpe // 2, lpe, 2 * lpe):
        if lanes < 1 or lanes > 32 or (heads > 1 and lanes < dp // 4):
            continue
        layout = tbd.dz_layout(heads, dim, lanes)
        if layout[2] <= 4:
            out[lanes] = layout
    return out


def tiled_slot_grad(tf, U3, V3, attn, ds, slope: float, ef_slot, wf,
                    need_def: bool = False):
    """K11 v2's slot gradient (da, d_ef or None, dwf) by the edge instances
    of ``vattn_slot_grad_kernel`` that the tensor-core kernel replaced, on
    CUDA operands, launched as the package launched them."""
    heads, dim, fe, rows = tgf._check_vattn(tf, U3, V3, attn, ef_slot, wf)
    hd = heads * dim
    dev = U3.device
    fe_cap = tgf._fe_cap(rows)
    da = torch.zeros(heads, dim, dtype=torch.float32, device=dev)
    dwf = torch.zeros(rows, hd, dtype=torch.float32, device=dev)
    d_ef = (torch.empty(ef_slot.shape, dtype=torch.float32, device=dev)
            if need_def else None)
    lanes = tts._lanes_per_head(heads)
    cols, max_cols = 1, 2 if fe_cap == 32 and need_def else 4
    while cols < min(-(-dim // lanes), max_cols):
        cols *= 2
    u, v, a, g = (t.float().contiguous() for t in (U3, V3, attn, ds))
    ef_c, wf_c = ef_slot.float().contiguous(), wf.float().contiguous()
    b, cap = tf.num_buckets, tf.cap
    blocks = max(1, min(-(-(b * cap // 32) // tgf._VATTN_WARPS),
                        4 * tts._sms(dev)))
    _check(build_probe()["retired"]["dgl_probe_slot_grad_tiled"](
        tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
        tf.valid.data_ptr(), tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(),
        b, tf.tile, cap, u.data_ptr(), v.data_ptr(), a.data_ptr(),
        g.data_ptr(), ef_c.data_ptr(), wf_c.data_ptr(), fe, rows, heads, dim,
        lanes, cols, fe_cap, float(slope), da.data_ptr(),
        0 if d_ef is None else d_ef.data_ptr(), dwf.data_ptr(), blocks,
        dev.index, tts._stream(dev)), "the tiled slot-gradient walk")
    return da, d_ef, dwf


def tiled_attrs(heads: int, dim: int, rows: int, need_def: bool,
                device=None):
    """(registers a thread, local memory bytes a thread) of the retired
    edge instance the package launched for ``heads`` x ``dim`` with
    ``rows`` edge-feature rows."""
    fe_cap = tgf._fe_cap(rows)
    lanes = tts._lanes_per_head(heads)
    cols, max_cols = 1, 2 if fe_cap == 32 and need_def else 4
    while cols < min(-(-dim // lanes), max_cols):
        cols *= 2
    device = torch.device("cuda") if device is None else torch.device(device)
    out = (ctypes.c_int * 2)()
    _check(build_probe()["retired"]["dgl_probe_slot_grad_attrs"](
        cols, fe_cap, int(need_def), device.index or 0,
        ctypes.addressof(out)), "dgl_probe_slot_grad_attrs")
    return out[0], out[1]


def one_part_slot_grad(tf, U3, V3, attn, ds, slope: float, ef_slot, wf,
                       need_def: bool = False):
    """K11 v2's slot gradient by the edit ``one_part`` (one bf16 part an
    operand), on CUDA operands."""
    return tgf.launch_slot_grad_mma(tf, U3, V3, attn, ds, slope, ef_slot, wf,
                                    need_def, fn=build_probe()["one_part"])


def tiny_check():
    """On the CPU: every edit applies once to its source, and the dz
    layouts on either side of the package's.  Returns the probe's
    variants' names."""
    dz, mma = edited_sources()
    if "CPL == 1 ? 8 : CPL == 2 ? 4 : 2;" not in dz["u2x"] or \
            "kSplit = 1;" not in mma["one_part"]:
        raise AssertionError("an edit did not apply")
    if sorted(dz_layouts(2, 64)) != [16, 32] or \
            sorted(dz_layouts(1, 128)) != [8, 16]:
        raise AssertionError("the dz layouts on either side")
    return ["retired"] + sorted(dz) + sorted(mma)


def main():
    if sys.argv[1:] != ["tiny"]:
        raise SystemExit("usage: python -m dgl_tpu_torch.tools."
                         "perf_dz_slot_grad tiny (on the card, "
                         "chip_smoke.py's yardsticks run the probe on their "
                         "graphs)")
    print(f"tiny check: {tiny_check()} apply")


if __name__ == "__main__":
    main()
