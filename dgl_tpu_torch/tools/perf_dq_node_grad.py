"""Probe of K7's dq and K11 v2's node gradient, each timed beside the
kernel it replaced and beside edits of its own design, in one run on the
card:

* K7's dq (``bitdot_bwd_dq``): the listed walk by dst (``csrc/bitdot.cu``
  ``bitdot_dq_list_kernel``) beside
  - the warp walk it replaced, ``bitdot_dq_kernel`` (``dq_node_grad_probe.cu``
    beside this file: a warp a dst row, its set bits one at a time);
  - the edit ``dz_count`` of ``bitdot.cu``: the dz walk's entries in flight
    (``DzUnroll``: two rows gathered an entry) where the walk keeps K5's
    forward's (``DqUnroll``: one row);
* K11 v2's node gradient (``vattn_node_grad`` with the edge term): the row
  walk with the edge term (``csrc/row_agg.cu`` ``row_fe_grad_kernel``)
  beside
  - the tiled walk it replaced, ``vattn_node_grad_kernel``
    (``dq_node_grad_probe.cu``: a block per (tile, column chunk, split),
    dW added into shared memory with a float atomicAdd);
  - the edit ``double`` of ``row_agg.cu``: twice the entries a group keeps
    in flight (``FeUnroll``: 4 at (4, 32) with 16 features);
  - the layout ``narrow`` (:func:`narrow_layout`): at most 2 columns a
    lane, half of wf's registers, launched from the package's build;
  - the walk without the edge term (K9's instance) on the same operands,
    which shows what forming fe costs.

Every probe library is built with the package's ``nvcc`` flags into its
build directory (``tools.build_edited``), the three sources side by side,
at the first call of :func:`build_probe`, which ``chip_smoke.py`` starts
beside the package's build.  Each variant's output is held to the package
kernel's by the caller (``chip_smoke.py``'s yardsticks, phases 24 and 30).
The probe is not a main path: nothing here counts launches.

Usage: ``python -m dgl_tpu_torch.tools.perf_dq_node_grad tiny`` (the CPU
check: every edit applies once, the narrow layout), or ``... attrs`` on
the card (the node gradient's registers and local memory at (4, 32) with
16 features, in the package and in the edit ``double``).
"""
from __future__ import annotations

import ctypes
import os
import sys
import threading
import types
from concurrent.futures import ThreadPoolExecutor

import torch

from . import build_edited, edited_source
from . import tile_group, tile_group_per_sm, tile_splits
from ..ops.kernels import bitdot as tbd
from ..ops.kernels import gat_fused as tgf
from ..ops.kernels import tiled_spmm as tts

PROBE_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "dq_node_grad_probe.cu")
_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, \
    ctypes.c_double
RETIRED_SIGNATURES = {
    "dgl_probe_dq_warp": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _F, _P, _I,
                          _P],
    "dgl_vattn_node_grad": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                            _P, _P, _P, _P, _I, _I, _I, _I, _I, _D, _P, _I,
                            _I, _I, _I, _I, _P],
    "dgl_probe_node_grad_attrs": [_I, _I, _I, _I, _P],
}
DQ_SIGNATURES = {
    "dgl_bitdot_bwd_dq_list": tbd._SIGNATURES["dgl_bitdot_bwd_dq_list"]}
FE_SIGNATURES = {
    name: tts._SIGNATURES["row_agg"][name]
    for name in ("dgl_row_fe_grad", "dgl_row_fe_grad_attrs")}
# edits, each old text found exactly once in its source.  "dz_count": the
# dq walk keeps the dz walk's entries in flight; "double": the
# node-gradient walk with the edge term keeps twice its entries in flight
DQ_EDITS = {
    "dz_count": [("value = CPL == 1 ? 8 : CPL == 2 ? 4 : 1;",
                  "value = CPL == 1 ? 4 : CPL == 2 ? 2 : 1; // dz's")],
}
FE_EDITS = {
    "double": [("((VEC) + 1) <= 60 ? 4 : 2)", "((VEC) + 1) <= 60 ? 8 : 4)")],
}
NARROW_FLOATS = 2   # the narrow layout's columns a lane

_BUILT = {}
_LOCK = threading.Lock()


def edited_sources():
    """({name: ``csrc/bitdot.cu`` with DQ_EDITS[name]}, {name:
    ``csrc/row_agg.cu`` with FE_EDITS[name]})."""
    return ({name: edited_source("bitdot", edits, name)
             for name, edits in DQ_EDITS.items()},
            {name: edited_source("row_agg", edits, name)
             for name, edits in FE_EDITS.items()})


def build_probe():
    """{"retired": the probe source's C functions, DQ_EDITS' and FE_EDITS'
    names: each edit's C function}, the three sources built side by side at
    the first call (a caller in another thread waits for it)."""
    with _LOCK:
        if _BUILT:
            return _BUILT
        with open(PROBE_SOURCE) as f:
            own = f.read()
        dq, fe = edited_sources()
        with ThreadPoolExecutor(3) as pool:
            jobs = [pool.submit(build_edited, "dq_node_grad_probe",
                                {"retired": own}, RETIRED_SIGNATURES),
                    pool.submit(build_edited, "bitdot", dq, DQ_SIGNATURES),
                    pool.submit(build_edited, "row_agg", fe, FE_SIGNATURES)]
            retired, dq_fns, fe_fns = (j.result() for j in jobs)
        _BUILT["retired"] = retired["retired"]
        for name, fns in dq_fns.items():
            _BUILT[name] = fns["dgl_bitdot_bwd_dq_list"]
        for name, fns in fe_fns.items():
            _BUILT[name] = fns["dgl_row_fe_grad"]
            _BUILT[name + "_attrs"] = fns["dgl_row_fe_grad_attrs"]
        return _BUILT


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {err}")


def warp_dq(packed, q, z, g, linv, rho, isd: float):
    """K7's dq (N_dst, H, D) by the warp walk the listed walk replaced, on
    CUDA operands."""
    num_dst, heads, dim = q.shape
    dev = q.device
    dq = torch.empty(q.shape, dtype=torch.float32, device=dev)
    nvec = torch.stack([linv.float(), rho.float()], 1)
    qc, zc, gc = (t.float().contiguous() for t in (q, z, g))
    packed = packed.contiguous()
    _check(build_probe()["retired"]["dgl_probe_dq_warp"](
        packed.data_ptr(), packed.shape[1], z.shape[0], num_dst,
        qc.data_ptr(), zc.data_ptr(), gc.data_ptr(), nvec.data_ptr(), heads,
        dim, isd, dq.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream), "the warp dq walk")
    return dq


def dq_edit(name, packed, q, z, g, linv, rho, isd: float, order):
    """K7's dq by the edit ``name`` of the listed walk, at the package's
    layout."""
    return tbd.launch_dq(packed, q, z, g, linv, rho, isd, order,
                         fn=build_probe()[name])


def tiled_node_grad(tf, U3, V3, attn, ds, slope: float, side: str, ef_slot,
                    wf):
    """K11 v2's node gradient by the tiled walk the row walk replaced, on
    CUDA operands, launched as the package launched it; ``ds`` (B, H, C)."""
    heads, dim, fe, rows = tgf._check_vattn(tf, U3, V3, attn, ef_slot, wf)
    src = side == "src"
    hd = heads * dim
    n_rows = tf.num_src if src else tf.num_dst
    n_t = tf.num_src_tiles if src else tf.num_dst_tiles
    dev = U3.device
    g = tile_group(hd, tf.tile)
    splits = tile_splits(tf, n_t, -(-hd // g), tile_group_per_sm(g, tf.tile),
                         dev)
    out = (torch.zeros if splits > 1 else torch.empty)(
        n_rows, heads, dim, dtype=torch.float32, device=dev)
    u, v, a, d, ef_c, wf_c = (t.float().contiguous()
                              for t in (U3, V3, attn, ds, ef_slot, wf))
    _check(build_probe()["retired"]["dgl_vattn_node_grad"](
        tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
        tf.valid.data_ptr(), tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(),
        tf.src_order.data_ptr() if src else 0,
        (tf.src_ptr if src else tf.dst_ptr).data_ptr(), n_t, tf.tile,
        tf.cap, u.data_ptr(), v.data_ptr(), a.data_ptr(), d.data_ptr(),
        ef_c.data_ptr(), wf_c.data_ptr(), fe, rows - fe, tgf._fe_cap(rows),
        heads, dim, float(slope), out.data_ptr(), n_rows, g, splits,
        int(src), dev.index, tts._stream(dev)), "the tiled walk")
    return out


def tiled_attrs(heads: int, dim: int, rows: int, side: str, tile: int,
                device=None):
    """(registers a thread, local memory bytes a thread) of the tiled
    walk's instance the package launched for ``heads`` x ``dim`` with
    ``rows`` edge-feature rows on ``side``."""
    device = torch.device("cuda") if device is None else torch.device(device)
    out = (ctypes.c_int * 2)()
    _check(build_probe()["retired"]["dgl_probe_node_grad_attrs"](
        tile_group(heads * dim, tile), int(side == "src"),
        tgf._fe_cap(rows), device.index or 0, ctypes.addressof(out)),
        "dgl_probe_node_grad_attrs")
    return out[0], out[1]


def narrow_layout(heads: int, dim: int):
    """(vec, cpl, lpr, n_chunks) of the node-gradient walk with the edge
    term at NARROW_FLOATS columns a lane (16-byte-aligned operands)."""
    hp = tts.padded_width(dim)
    return tts.fe_layout(heads * hp, hp, lane_floats=NARROW_FLOATS)


def fe_walk(tf, U3, V3, attn, ds, slope: float, side: str, ef_slot, wf,
            variant=None, layout=None):
    """K11 v2's node gradient by the row walk with the edge term, from the
    edit ``variant``'s build or the package's, at ``layout`` or the
    package's; ``ds`` as ``vattn_node_grad`` takes it."""
    own, nbr = (V3, U3) if side == "dst" else (U3, V3)
    return tts.row_aggregate(
        tf, side, nbr, ds, types.SimpleNamespace(launches=0),
        grad=(own, attn, float(slope)), edge=(ef_slot, wf), layout=layout,
        fn=None if variant is None else build_probe()[variant])


def fe_attrs(vec: int, cpl: int, kf: int, variant=None):
    """(registers a thread, local memory bytes a thread, resident blocks an
    SM) of the node-gradient walk's instance <vec, cpl, kf> in the
    package's build or the edit ``variant``'s."""
    if variant is None:
        return tts.fe_grad_kernel_attrs(vec, cpl, kf)
    out = (ctypes.c_int * 3)()
    _check(build_probe()[variant + "_attrs"](vec, cpl, kf, 0,
                                             ctypes.addressof(out)),
           f"the attributes of {variant}")
    return tuple(out)


def tiny_check():
    """On the CPU: every edit applies once to its source, and the narrow
    layout holds every column of a row.  Returns the probe's variants'
    names."""
    dq, fe = edited_sources()
    if "CPL == 1 ? 4 : CPL == 2 ? 2 : 1; // dz's" not in dq["dz_count"] \
            or "<= 60 ? 8 : 4)" not in fe["double"]:
        raise AssertionError("an edit did not apply")
    for heads, dim in ((4, 32), (1, 41), (8, 8)):
        vec, cpl, lpr, chunks = narrow_layout(heads, dim)
        if vec * cpl > NARROW_FLOATS or \
                vec * cpl * lpr * chunks < heads * tts.padded_width(dim):
            raise AssertionError(f"the narrow layout at ({heads}, {dim})")
    return ["retired"] + sorted(dq) + sorted(fe)


def main():
    if sys.argv[1:] == ["attrs"]:
        # on the card: the node gradient's instance at EGATConv's (4, 32)
        # with 16 features, in the package and in each edit of FE_EDITS
        for variant in (None, *FE_EDITS):
            print(f"row_fe_grad_kernel<4, 1, 16> ({variant or 'package'}): "
                  "registers, local bytes, blocks an SM "
                  f"{fe_attrs(4, 1, 16, variant)}")
        return
    if sys.argv[1:] != ["tiny"]:
        raise SystemExit("usage: python -m dgl_tpu_torch.tools."
                         "perf_dq_node_grad tiny | attrs (on the card, "
                         "chip_smoke.py's yardsticks run the probe on their "
                         "graphs)")
    print(f"tiny check: {tiny_check()} apply")


if __name__ == "__main__":
    main()
