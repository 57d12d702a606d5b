"""Probe of K5's two forwards, redesigned for Hopper as one listed-bit walk
by dst (``csrc/bitgat.cu`` ``bitgat_fwd_list_kernel``), each timed beside
the kernel it replaced, in one run on the card:

* ``bitgat_fwd`` (K5's forward over the bits of A): the walk beside the
  warp walk it replaced (``fwd_probe.cu`` beside this file: a warp a dst
  row, its set bits one at a time, each bit's gathers waiting on the
  previous bit's arithmetic), and beside an edit of the walk, ``u2x``
  (``EDITS``), which keeps twice the entries a group in flight;
* ``bitgat_fwd_t`` (the forward over the bits of A^T, the mesh-sharded
  GAT's): the walk on the shard's dst-major view beside the scatter walk it
  replaced (``fwd_probe.cu``: a warp a src row, its set bits one at a
  time, 128 floats added into L2 a set bit with ``red.global.add.v4.f32``,
  then a divide pass).

The probe's own source and the edit are built with the package's ``nvcc``
flags into its build directory (``tools.build_edited``), side by side, at
the first call of :func:`build_probe`, which ``chip_smoke.py`` starts
beside the package's build.  Each variant's output is held to the package
kernel's by the caller's check (``chip_smoke.py``'s yardsticks, phases 10
and 36, call :func:`fwd_side_by_side` and :func:`fwd_t_side_by_side` on
their full-size graphs).  Every time is the median of 5 calls after one
(``cuda_ms``).  The probe is not a main path: nothing here counts
launches.

Usage: ``python -m dgl_tpu_torch.tools.perf_fwd_walks tiny`` (the CPU
check: the edit applies once, the probe's source has its C functions).
"""
from __future__ import annotations

import ctypes
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from . import build_edited, cuda_ms, edited_source
from ..ops.kernels import bitgat as tbg

PROBE_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fwd_probe.cu")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
RETIRED_SIGNATURES = {
    "dgl_probe_fwd_warp": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _F, _I, _P,
                           _P, _P, _I, _P],
    "dgl_probe_fwd_t": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _F, _I, _P, _P,
                        _P, _I, _P]}
LIST_SIGNATURES = {
    "dgl_bitgat_fwd_list": tbg._SIGNATURES["dgl_bitgat_fwd_list"]}
# edits of csrc/bitgat.cu, each old text found exactly once.  "u2x": twice
# the entries a group keeps in flight (the forward's loads of a batch are
# z[s] and el[s] alone, so more fit the registers than the backward's)
EDITS = {
    "u2x": [("      CPL == 1 ? 8 : CPL == 2 ? 4 : CPL == 3 ? 3 : 2;",
             "      CPL == 1 ? 16 : CPL == 2 ? 8 : CPL == 3 ? 6 : 4;")],
}

_BUILT = {}
_LOCK = threading.Lock()


def edited_sources():
    """{name: ``csrc/bitgat.cu`` with the edits of EDITS[name]}."""
    return {name: edited_source("bitgat", edits, name)
            for name, edits in EDITS.items()}


def build_probe():
    """{"warp": the warp walk's C function, "scatter": the scatter walk's,
    EDITS' names: each edit's ``dgl_bitgat_fwd_list``}, the sources built
    side by side at the first call (a caller in another thread waits for
    it)."""
    with _LOCK:
        if _BUILT:
            return _BUILT
        with open(PROBE_SOURCE) as f:
            own = f.read()
        with ThreadPoolExecutor(2) as pool:
            retired = pool.submit(build_edited, "fwd_probe",
                                  {"retired": own}, RETIRED_SIGNATURES)
            edits = pool.submit(build_edited, "bitgat", edited_sources(),
                                LIST_SIGNATURES)
            retired, edits = retired.result(), edits.result()
        _BUILT["warp"] = retired["retired"]["dgl_probe_fwd_warp"]
        _BUILT["scatter"] = retired["retired"]["dgl_probe_fwd_t"]
        for name, fns in edits.items():
            _BUILT[name] = fns["dgl_bitgat_fwd_list"]
        return _BUILT


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {err}")


def _tail(dev):
    return dev.index, torch.cuda.current_stream(dev).cuda_stream


def listed_walk(packed, el, er, z, num_dst, slope, thresh=None, seed=0,
                order=None, variant=None):
    """(out, l) of the walk by dst on CUDA operands, from the package's
    build or, with ``variant`` (a name of EDITS), from that edit's."""
    heads, dim = z.shape[1:]
    if order is None:
        order = tbg.claim_order(packed, num_dst)
    args, out, keep = tbg.fwd_list_args(packed, el, er, z, num_dst, slope,
                                        thresh, seed, order,
                                        tbg.list_layout(heads, dim))
    if variant is None:
        tbg._launch("dgl_bitgat_fwd_list", *args, *_tail(z.device))
    else:
        _check(build_probe()[variant](*args, *_tail(z.device)),
               f"edit {variant}")
    del keep
    return out


def warp_walk(packed, el, er, z, num_dst, slope, thresh=None, seed=0):
    """(out, l) of the warp walk that the walk by dst replaced in
    ``bitgat_fwd``, on CUDA operands."""
    num_src, heads, dim = z.shape
    dev = z.device
    el, er, z = (t.float().contiguous() for t in (el, er, z))
    packed = packed.contiguous()
    out = torch.empty(num_dst, heads, dim, dtype=torch.float32, device=dev)
    l = torch.empty(num_dst, heads, dtype=torch.float32, device=dev)
    seed_t = tbg._seed_ptr(seed, dev)
    _check(build_probe()["warp"](
        packed.data_ptr(), packed.shape[1], num_src, num_dst, el.data_ptr(),
        er.data_ptr(), z.data_ptr(), heads, dim, slope, thresh or 0,
        seed_t.data_ptr(), out.data_ptr(), l.data_ptr(), *_tail(dev)),
        "the warp walk")
    return out, l


def scatter_walk(packed_t, el, er, z, num_dst, slope):
    """(out, l) of the scatter walk over the bits of A^T that the walk by
    dst replaced in ``bitgat_fwd_t``, on CUDA operands, with its zeroed
    sum buffer (rows padded to 4 floats) and divide pass."""
    num_src, heads, dim = z.shape
    dev = z.device
    el, er, z = (t.float().contiguous() for t in (el, er, z))
    packed_t = packed_t.contiguous()
    out = torch.zeros(num_dst, heads, dim, dtype=torch.float32, device=dev)
    l = torch.zeros(num_dst, heads, dtype=torch.float32, device=dev)
    ostride = -(-heads * dim // 4) * 4
    acc = torch.zeros(num_dst, ostride, dtype=torch.float32, device=dev)
    _check(build_probe()["scatter"](
        packed_t.data_ptr(), packed_t.shape[1], num_src, num_dst,
        el.data_ptr(), er.data_ptr(), z.data_ptr(), heads, dim, slope,
        ostride, acc.data_ptr(), out.data_ptr(), l.data_ptr(), *_tail(dev)),
        "the scatter walk")
    return out, l


def _side_by_side(calls, check, what):
    """{name: ms} of each of ``calls`` ({name: fn giving (out, l)}), each
    output held to the first call's by ``check(got, want, what)``, which
    returns max|err|; "max_abs_err" is the largest."""
    want = None
    out, err = {}, 0.0
    for name, call in calls.items():
        got = call()
        if want is None:
            want = got
        else:
            err = max([err] + [check(a, w, f"{what} {name} {part}")
                               for part, a, w in zip(("out", "l"), got,
                                                     want)])
        del got
        out[name] = cuda_ms(call)
    out["max_abs_err"] = err
    return out


def fwd_side_by_side(packed, order, args, check, what):
    """{name: ms} of K5's forward on ``packed`` (its dst rows claimed in
    ``order``) for ``args`` (el, er, z, num_dst, slope, thresh, seed):
    "listed" (the package's walk), "warp" (the kernel it replaced) and
    each of EDITS, their outputs held to the walk's."""
    calls = {"listed": lambda: listed_walk(packed, *args, order=order),
             "warp": lambda: warp_walk(packed, *args)}
    for name in EDITS:
        calls[name] = (lambda name=name: listed_walk(
            packed, *args, order=order, variant=name))
    return _side_by_side(calls, check, what)


def fwd_t_side_by_side(packed_t, rows, order, args, check, what):
    """{name: ms} of ``bitgat_fwd_t`` for ``args`` (el, er, z, num_dst,
    slope): "listed" (the walk by dst on ``rows``, the dst-major view of
    ``packed_t``, claimed in ``order``) and "scatter" (the walk over
    ``packed_t`` it replaced), the latter's output held to the former's."""
    return _side_by_side(
        {"listed": lambda: listed_walk(rows, *args, order=order),
         "scatter": lambda: scatter_walk(packed_t, *args)}, check, what)


def tiny_check():
    """On the CPU: every edit applies once to its source and the probe's
    source holds its C functions.  Returns the variants' names."""
    edited_sources()
    with open(PROBE_SOURCE) as f:
        src = f.read()
    for fn in RETIRED_SIGNATURES:
        if fn not in src:
            raise AssertionError(f"fwd_probe.cu lacks {fn}")
    return sorted(EDITS) + ["scatter", "warp"]


def main():
    if sys.argv[1:] != ["tiny"]:
        raise SystemExit("usage: python -m dgl_tpu_torch.tools."
                         "perf_fwd_walks tiny (on the card, chip_smoke.py's "
                         "yardsticks run the probe on their graphs)")
    print(f"tiny check: {tiny_check()} apply")


if __name__ == "__main__":
    main()
