"""Probe of the two backward walks redesigned for Hopper, each timed beside
the kernel it replaced and beside edits of its own design, in one run on
the card:

* K5's backward (``bitgat_bwd``, which K13 launches on a shard too): the
  listed walk (``csrc/bitgat.cu`` ``bitgat_bwd_list_kernel``) beside
  - the warp walk it replaced (``bwd_probe.cu`` beside this file: a warp a
    src row, its set bits one at a time);
  - two edits of the listed walk (``EDITS``): ``vector_der``, der by one
    16-byte reduction a 4 heads of an edge, gathered by shuffles into one
    lane, where the walk takes one scalar reduction an (edge, head), and
    ``lb3``, at most 80 registers a thread (3 blocks, 24 warps an SM)
    where the walk takes 128;
  - the walk at other lanes an entry (:func:`layout`), launched from the
    package's build;
* K9's node gradient (``vattn_node_grad`` without the edge term): the row
  walk (``csrc/row_agg.cu`` ``row_agg_kernel``) beside the tiled walk it
  replaced, ``vattn_node_grad_kernel`` (once ``csrc/gatv2.cu``'s, now in
  ``dq_node_grad_probe.cu`` beside this file, which
  :mod:`.perf_dq_node_grad` builds) instantiated again with no edge term
  (``TILED_K9``, an edit of that source).

Every probe library is built with the package's ``nvcc`` flags into its
build directory (``tools.build_edited``), all at once, at the first call.
Each variant's output is held to the package kernel's by the caller's
check (``chip_smoke.py``'s yardsticks, phases 10, 24 and 36, call
:func:`k5_side_by_side` and :func:`tiled_node_grad` on their full-size
graphs).  Every time is the median of 5 calls after one (``cuda_ms``).
The probe is not a main path: nothing here counts launches.

Usage: ``python -m dgl_tpu_torch.tools.perf_bwd_walks tiny`` (the CPU
check: every edit applies once, the layouts at other lanes an entry).
"""
from __future__ import annotations

import ctypes
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from . import build_edited, cuda_ms, edited_source
from . import tile_group, tile_group_per_sm, tile_splits
from . import perf_dq_node_grad as tdq
from ..ops.kernels import bitgat as tbg
from ..ops.kernels import gat_fused as tgf
from ..ops.kernels import tiled_spmm as tts

PROBE_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "bwd_probe.cu")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
WARP_SIGNATURES = {
    "dgl_probe_bwd_warp": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _F, _I,
                           _P, _P, _P, _P, _I, _P]}
LIST_SIGNATURES = {
    "dgl_bitgat_bwd_list": tbg._SIGNATURES["dgl_bitgat_bwd_list"]}
TILED_SIGNATURES = {
    "dgl_vattn_node_grad": tdq.RETIRED_SIGNATURES["dgl_vattn_node_grad"]}
# edits of csrc/bitgat.cu's listed walk, each old text found exactly once.
# "vector_der": at H = 4 or 8 the group's first lane gathers an entry's H
# sums by shuffles from the first lanes of the heads' blocks (head h is
# chain h / nb of block h % nb) and adds each 4 with one
# red.global.add.v4.f32; every lane of the warp takes part in the
# shuffles, so no lane leaves an entry early
_ENTRY_TAIL = """          if (dd[u] < 0) continue;
          const int64_t d = dd[u];
          const uint32_t x0 =
              kDrop ? spart ^ (static_cast<uint32_t>(d) * kC2) : 0u;
          float am[NH], dr[NH];
#pragma unroll
          for (int t = 0; t < NH; ++t) {
            const float raw = elq[t] + erv[u][t];
            const float alpha = lrelu_exp(raw, slope) * liv[u][t];
            am[t] = (!kDrop || keep_bit(x0, mult[t], thresh)) ? alpha : 0.f;
            const float de = am[t] * dot[t] - alpha * rhv[u][t];
            dr[t] = raw > 0.f ? de : slope * de;
            if (chain[t]) delq[t] += dr[t];
          }
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            const float a = am[kOneHead ? 0 : q];
            dzq[q].x = fmaf(a, gv[u][q].x, dzq[q].x);
            dzq[q].y = fmaf(a, gv[u][q].y, dzq[q].y);
            dzq[q].z = fmaf(a, gv[u][q].z, dzq[q].z);
            dzq[q].w = fmaf(a, gv[u][q].w, dzq[q].w);
          }
          if (!der_lane) continue;
"""
_VECTOR_TAIL = """          const bool on = dd[u] >= 0;
          const int64_t d = on ? dd[u] : 0;
          float dr[NH];
#pragma unroll
          for (int t = 0; t < NH; ++t) dr[t] = 0.f;
          if (on) {
            const uint32_t x0 =
                kDrop ? spart ^ (static_cast<uint32_t>(d) * kC2) : 0u;
            float am[NH];
#pragma unroll
            for (int t = 0; t < NH; ++t) {
              const float raw = elq[t] + erv[u][t];
              const float alpha = lrelu_exp(raw, slope) * liv[u][t];
              am[t] = (!kDrop || keep_bit(x0, mult[t], thresh)) ? alpha : 0.f;
              const float de = am[t] * dot[t] - alpha * rhv[u][t];
              dr[t] = raw > 0.f ? de : slope * de;
              if (chain[t]) delq[t] += dr[t];
            }
#pragma unroll
            for (int q = 0; q < CPL; ++q) {
              const float a = am[kOneHead ? 0 : q];
              dzq[q].x = fmaf(a, gv[u][q].x, dzq[q].x);
              dzq[q].y = fmaf(a, gv[u][q].y, dzq[q].y);
              dzq[q].z = fmaf(a, gv[u][q].z, dzq[q].z);
              dzq[q].w = fmaf(a, gv[u][q].w, dzq[q].w);
            }
          }
          if (!kOneHead && (heads == 4 || heads == 8) && nv == lpe * CPL) {
            const int nb = lpe / vph, nb_log = __ffs(nb) - 1;
            for (int h0 = 0; h0 < heads; h0 += 4) {  // warp-uniform
              float v[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int h = h0 + i;
                const int t = h >> nb_log, b = h & (nb - 1);
                float x = dr[0];
#pragma unroll
                for (int k = 1; k < NH; ++k)
                  if (t == k) x = dr[k];
                v[i] = b == 0 ? x
                              : __shfl_sync(kFull, x, grp * lpe + b * vph);
              }
              if (on && li == 0)
                red_add_v4(der + d * heads + h0, v[0], v[1], v[2], v[3]);
            }
            continue;
          }
          if (!on || !der_lane) continue;
"""
# the 16-byte reduction the edit adds with, defined before the walks
_RED_ADD_V4 = ("__device__ __forceinline__ bool keep_bit(",
               """__device__ __forceinline__ void red_add_v4(float* a, float x, float y,
                                           float z, float w) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(a),
               "f"(x), "f"(y), "f"(z), "f"(w)
               : "memory");
}

__device__ __forceinline__ bool keep_bit(""")
EDITS = {
    "vector_der": [_RED_ADD_V4, (_ENTRY_TAIL, _VECTOR_TAIL)],
    "lb3": [("__launch_bounds__(kWarps * 32, 2)\nbitgat_bwd_list_kernel(",
             "__launch_bounds__(kWarps * 32, 3)\nbitgat_bwd_list_kernel(")],
}
# the tiled node-gradient walk's source with its no-edge-term instances
_FE_SWITCH = ("  switch (fe_cap) {\n"
              "    case 8:\n"
              "      return launch_node_grad<G, kSrc, 8>(")
TILED_K9 = [(_FE_SWITCH,
             "  switch (fe_cap) {\n"
             "    case 0:\n"
             "      return launch_node_grad<G, kSrc, 0>(sl, order, ptr, "
             "num_tiles, tile,\n"
             "                                          cap, op, ds, "
             "has_bias, out,\n"
             "                                          num_rows, splits, "
             "stream);\n"
             "    case 8:\n"
             "      return launch_node_grad<G, kSrc, 8>(")]

_BUILT = {}


def edited_sources():
    """({name: ``csrc/bitgat.cu`` with the edits of EDITS[name]}, the
    tiled walk's source, ``dq_node_grad_probe.cu``, with TILED_K9)."""
    return ({name: edited_source("bitgat", edits, name)
             for name, edits in EDITS.items()},
            edited_source("dq_node_grad_probe", TILED_K9, "tiled_k9",
                          tdq.PROBE_SOURCE))


def build_probe():
    """{"warp": the warp walk's C functions, EDITS' names: each edit's
    ``dgl_bitgat_bwd_list``, "tiled_k9": the edited tiled walk's
    ``dgl_vattn_node_grad``}, built once, the three sources' builds side by
    side."""
    if _BUILT:
        return _BUILT
    with open(PROBE_SOURCE) as f:
        own = f.read()
    lists, tiled = edited_sources()
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(build_edited, "bwd_probe", {"warp": own},
                            WARP_SIGNATURES),
                pool.submit(build_edited, "bitgat", lists, LIST_SIGNATURES),
                pool.submit(build_edited, "dq_node_grad_probe",
                            {"tiled_k9": tiled}, TILED_SIGNATURES)]
        warp, edits, k9 = (j.result() for j in jobs)
    _BUILT["warp"] = warp["warp"]["dgl_probe_bwd_warp"]
    for name, fns in edits.items():
        _BUILT[name] = fns["dgl_bitgat_bwd_list"]
    _BUILT["tiled_k9"] = k9["tiled_k9"]["dgl_vattn_node_grad"]
    return _BUILT


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {err}")


def layout(heads: int, dim: int, lanes=None):
    """(dp, lpe, cpl) of the listed walk at ``lanes`` lanes an entry
    (``bitgat.list_layout``'s when None); raises ValueError where the
    kernel does not take them (not a power of two up to 32, more than
    MAX_LIST_CPL vectors a lane, or fewer lanes than a head's vectors)."""
    dp, lpe, cpl = tbg.list_layout(heads, dim)
    if lanes is None:
        return dp, lpe, cpl
    nv = heads * dp // 4
    if lanes < 1 or lanes > 32 or lanes & (lanes - 1) or \
            -(-nv // lanes) > tbg.MAX_LIST_CPL or \
            (heads > 1 and lanes < dp // 4):
        raise ValueError(f"{lanes} lanes an entry do not fit {heads} heads "
                         f"of {dim}")
    return dp, lanes, -(-nv // lanes)


def listed_walk(packed_rev, el, er, z, g, linv, rho, num_dst, slope,
                thresh=None, seed=0, order=None, lanes=None, variant=None):
    """(del, der, dz) of the listed walk on CUDA operands at ``lanes``
    lanes an entry, from the package's build or, with ``variant`` (a name
    of EDITS), from that edit's."""
    heads, dim = z.shape[1:]
    if order is None:
        order = tbg.claim_order(packed_rev, z.shape[0])
    args, (d_el, d_er, dz), keep = tbg.bwd_list_args(
        packed_rev, el, er, z, g, linv, rho, num_dst, slope, thresh, seed,
        order, layout(heads, dim, lanes))
    dev = z.device
    tail = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if variant is None:
        tbg._launch("dgl_bitgat_bwd_list", *args, *tail)
    else:
        _check(build_probe()[variant](*args, *tail), f"edit {variant}")
    del keep
    return d_el, d_er, dz[..., :dim]


def warp_walk(packed_rev, el, er, z, g, linv, rho, num_dst, slope,
              thresh=None, seed=0):
    """(del, der, dz) of the warp walk that the listed walk replaced, on
    CUDA operands (K5's backward, or K13's on a shard)."""
    num_src, heads, dim = z.shape
    dev = z.device
    nvec = torch.stack([er.float(), linv.float(), rho.float()], 1)
    el, z, g = (t.float().contiguous() for t in (el, z, g))
    packed_rev = packed_rev.contiguous()
    d_el = torch.zeros(num_src, heads, dtype=torch.float32, device=dev)
    d_er = torch.zeros(num_dst, heads, dtype=torch.float32, device=dev)
    dz = torch.zeros(num_src, heads, dim, dtype=torch.float32, device=dev)
    seed_t = tbg._seed_ptr(seed, dev)
    _check(build_probe()["warp"](
        packed_rev.data_ptr(), packed_rev.shape[1], num_src, num_dst,
        el.data_ptr(), nvec.data_ptr(), z.data_ptr(), g.data_ptr(), heads,
        dim, slope, thresh or 0, seed_t.data_ptr(), dz.data_ptr(),
        d_el.data_ptr(), d_er.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream), "the warp walk")
    return d_el, d_er, dz


def tiled_node_grad(tf, U3, V3, attn, ds, slope: float, side: str):
    """K9's node gradient (no edge term) by the tiled walk that the row
    walk replaced, on CUDA operands; ``ds`` (B, H, C)."""
    heads, dim = U3.shape[1:]
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
    u, v, a, d = (t.float().contiguous() for t in (U3, V3, attn, ds))
    _check(build_probe()["tiled_k9"](
        tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
        tf.valid.data_ptr(), tf.src_tile.data_ptr(), tf.dst_tile.data_ptr(),
        tf.src_order.data_ptr() if src else 0,
        (tf.src_ptr if src else tf.dst_ptr).data_ptr(), n_t, tf.tile,
        tf.cap, u.data_ptr(), v.data_ptr(), a.data_ptr(), d.data_ptr(), 0, 0,
        0, 0, 0, heads, dim, float(slope), out.data_ptr(), n_rows, g, splits,
        int(src), dev.index, tts._stream(dev)), "the tiled walk")
    return out


def k5_side_by_side(packed_rev, order, args, check, what, lanes=True):
    """{name: ms} of K5's backward on ``packed_rev`` (its rows claimed in
    ``order``) for ``args`` (el, er, z, g, linv, rho, num_dst, slope,
    thresh, seed): "listed" (the package's), "warp", each of EDITS and,
    with ``lanes``, "lanes_<k>" at half and twice the layout's lanes an
    entry where the kernel takes them.  Each variant's outputs are held to
    the listed walk's by ``check(got, want, what)``, which returns
    max|err|; "max_abs_err" is the largest."""
    heads, dim = args[2].shape[1:]
    want = listed_walk(packed_rev, *args, order=order)
    calls = {"listed": lambda: listed_walk(packed_rev, *args, order=order),
             "warp": lambda: warp_walk(packed_rev, *args)}
    for name in EDITS:
        calls[name] = (lambda name=name: listed_walk(
            packed_rev, *args, order=order, variant=name))
    if lanes:
        lpe = layout(heads, dim)[1]
        for k in (lpe // 2, 2 * lpe):
            try:
                layout(heads, dim, k)
            except ValueError:
                continue
            calls[f"lanes_{k}"] = (lambda k=k: listed_walk(
                packed_rev, *args, order=order, lanes=k))
    out, err = {}, 0.0
    for name, call in calls.items():
        got = call()
        err = max([err] + [check(a, w, f"{what} {name} {part}") for part, a, w
                           in zip(("d_el", "d_er", "d_z"), got, want)])
        del got
        out[name] = cuda_ms(call)
    out["max_abs_err"] = err
    return out


def tiny_check():
    """On the CPU: every edit applies once to its source, and the layouts
    at other lanes an entry cover every vector of a row once.  Returns the
    edits' names."""
    edited_sources()
    with open(PROBE_SOURCE) as f:
        if "dgl_probe_bwd_warp" not in f.read():
            raise AssertionError("bwd_probe.cu lacks its C function")
    for heads, dim in ((4, 32), (1, 41), (8, 16)):
        lpe = layout(heads, dim)[1]
        for k in (lpe // 2, 2 * lpe):
            try:
                dp, lanes, cpl = layout(heads, dim, k)
            except ValueError:
                continue
            if lanes * cpl < heads * dp // 4:
                raise AssertionError(f"{k} lanes miss vectors of "
                                     f"({heads}, {dim})")
    return sorted(EDITS) + ["tiled_k9", "warp"]


def main():
    if sys.argv[1:] != ["tiny"]:
        raise SystemExit("usage: python -m dgl_tpu_torch.tools."
                         "perf_bwd_walks tiny (on the card, chip_smoke.py's "
                         "yardsticks run the probe on their graphs)")
    print(f"tiny check: {tiny_check()} apply")


if __name__ == "__main__":
    main()
