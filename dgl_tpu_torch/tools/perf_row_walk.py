"""Probe of the row walk (``csrc/row_agg.cu`` ``row_agg_kernel``: K4's
SpMM by dst, K6's dx by src) on the Reddit-statistics graph, with the
choices of its design side by side in one run:

* ``layout``: the (B, H, cap) weights read in place against a slot-major
  copy made for the call (the copy's time and the walk's on it), by dst
  and by src at (4, 32), (1, 41) and (8, 8);
* ``pad44``: y padded from 41 to 44 columns, so that 16-byte loads apply
  where 41 takes scalar loads (sector waste);
* ``hubs``: the hub rows alone and the other rows alone (the tail);
* ``orders``: the rows claimed with hubs over 0 (every row by degree), 2,
  4 (the default), 8 times the mean degree, and every row by id;
* ``variants``: two edits of the source, 16 slots in flight a lane at
  two columns or fewer (``u16``), and the next group of slot and
  neighbour ids loaded a step ahead (``prefetch``), each built with the
  package's ``nvcc`` flags into ``dgl_tpu_torch/_build/``.

Every time is the median of 5 launches after one (``cuda_ms``); every
full walk's output is held bit for bit to the default's (each sums a
row's slots in the same order).  The probe is not a main path: nothing
here counts launches.

Usage: ``python -m dgl_tpu_torch.tools.perf_row_walk [tiny]`` (tiny: the
CPU check of the claim orders and of the variants' edits).
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from . import build_edited, cuda_ms, edited_source
from .. import add_self_loop, graph, remove_self_loop
from ..data import reddit_like_graph_sym
from ..ops.kernels import build
from ..ops.kernels import tiled_spmm as tts

N_NODES, N_EDGES = 232_965, 114_615_892   # the Reddit statistics
SHAPES = ((4, 32), (1, 41), (8, 8))
HUB_DEGREES = (0, 2, tts.HUB_DEGREE, 8, math.inf)

# each variant: (old, new) edits of csrc/row_agg.cu, each old text found
# exactly once
VARIANTS = {
    "u16": [(
        "static constexpr int value = kCols <= 4 ? 8 :",
        "static constexpr int value = kCols <= 2 ? 16 : kCols <= 4 ? 8 :")],
    "prefetch": [
        ("    const int p1 = has ? ptr[r + 1] : 0;\n",
         "    const int p1 = has ? ptr[r + 1] : 0;\n"
         "    int nx_nbr = 0, nx_slot = 0;\n"
         "    if (p0 + li < p1) {\n"
         "      nx_nbr = nbr[p0 + li];\n"
         "      nx_slot = slot[p0 + li];\n"
         "    }\n"),
        ("      int my_nbr = 0, my_wb = 0;  // this lane's slot: neighbour,"
         " w offset\n"
         "      if (li < n) {\n"
         "        my_nbr = nbr[pb + li];\n"
         "        const int s = slot[pb + li];\n",
         "      int my_nbr = nx_nbr, my_wb = 0;\n"
         "      const int s = nx_slot;\n"
         "      if (pb + lpr + li < p1) {\n"
         "        nx_nbr = nbr[pb + lpr + li];\n"
         "        nx_slot = slot[pb + lpr + li];\n"
         "      }\n"
         "      if (li < n) {\n")],
}


def variant_source(name: str) -> str:
    """``csrc/row_agg.cu`` with the edits of VARIANTS[name]."""
    return edited_source("row_agg", VARIANTS[name], name)


def build_variants():
    """{name: the ``dgl_row_agg`` C function of each variant}, built all at
    once into the package's build directory."""
    sig = {"dgl_row_agg": tts._SIGNATURES["row_agg"]["dgl_row_agg"]}
    return {name: fns["dgl_row_agg"] for name, fns in build_edited(
        "row_agg", {n: variant_source(n) for n in VARIANTS}, sig).items()}


def tiny_check():
    """On the CPU: the claim orders of ``_build_row_view`` on a small graph
    with two hubs (0: by degree, then the rows without a slot; inf: by
    id) and the variants' edits.  Returns the orders' first rows."""
    rng = np.random.default_rng(0)
    row = np.concatenate([rng.integers(0, 300, 900), np.full(200, 7),
                          np.full(120, 250)])
    col = np.concatenate([rng.integers(0, 300, 900),
                          rng.integers(0, 300, 320)])
    tf = tts.build_tiled_format(row, col, 300, 300, 128, 128, device="cpu")
    firsts = {}
    for hd in HUB_DEGREES:
        v = tts._build_row_view(tf, "src", hd)
        deg = (v.ptr[1:] - v.ptr[:-1])[v.order.long()]
        if hd == 0 and not bool((deg[:-1] >= deg[1:]).all()):
            raise AssertionError("hub degree 0 does not claim by degree")
        if hd == math.inf and not torch.equal(v.order, torch.arange(300,
                                              dtype=torch.int32)):
            raise AssertionError("hub degree inf does not claim by id")
        if sorted(v.order.tolist()) != list(range(300)):
            raise AssertionError(f"hub degree {hd}: not every row claimed")
        firsts[hd] = v.order[:2].tolist()
    for name in VARIANTS:
        variant_source(name)
    return firsts


def reddit_format():
    """The tiled format (auto cap) of the Reddit-statistics graph with
    self-loops, built on the card as ``chip_smoke.py`` builds it."""
    t0 = time.perf_counter()
    src, dst = reddit_like_graph_sym(N_NODES, N_EDGES, seed=0)
    g = add_self_loop(remove_self_loop(graph((src, dst), num_nodes=N_NODES,
                                             device="cuda")))
    fwd, _ = g.unit().tiled_format()
    torch.cuda.synchronize()
    print(f"# graph and tiled format in {time.perf_counter() - t0:.1f} s: "
          f"{g.num_edges()} edges, {fwd.num_buckets} buckets of {fwd.cap}")
    return fwd


def walk(view, cap, y, w, fn=None):
    """The row walk's output (every row of the format; rows not in
    ``view.order`` left unwritten)."""
    out = torch.empty(view.ptr.numel() - 1, y.shape[1], y.shape[2],
                      device=y.device)
    tts.row_walk(view, cap, y, w, out, fn)
    return out


def timed(view, cap, y, w, want=None, fn=None):
    """(ms, out) of the walk, the output held bit for bit to ``want``."""
    out = walk(view, cap, y, w, fn)
    if want is not None and not torch.equal(out, want):
        raise AssertionError("a variant of the row walk changed its sums")
    return cuda_ms(lambda: walk(view, cap, y, w, fn)), out


def gather_tb_s(edges, cols, ms):
    return edges * cols * 4 / ms / 1e9


def probe(fwd):
    """Every probe on ``fwd``; returns {probe: readings} and prints a line
    each."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    cap, e = fwd.cap, int(fwd.row_view("dst").slot.numel())
    res = {"layout": [], "pad44": [], "hubs": [], "orders": [],
           "variants": []}
    fns = build_variants()
    for heads, d in SHAPES:
        w = torch.rand(fwd.num_buckets, heads, cap, device="cuda",
                       generator=gen)
        y = torch.randn(N_NODES, heads, d, device="cuda", generator=gen)
        for side in ("dst", "src"):
            view = fwd.row_view(side)
            ms, want = timed(view, cap, y, w)
            copy_ms = cuda_ms(lambda: w.transpose(1, 2).contiguous())
            w_sm = w.transpose(1, 2).contiguous().transpose(1, 2)
            sm_ms, _ = timed(view, cap, y, w_sm, want)
            del w_sm
            r = {"side": side, "shape": [heads, d], "in_place_ms": ms,
                 "copy_ms": copy_ms, "slot_major_ms": sm_ms,
                 "gather_tb_s": gather_tb_s(e, heads * d, ms)}
            res["layout"].append(r)
            print(f"# layout {side} ({heads}, {d}): in place {ms:.4f} ms; "
                  f"slot-major copy {copy_ms:.4f} + walk {sm_ms:.4f} = "
                  f"{copy_ms + sm_ms:.4f} ms; gathers at "
                  f"{r['gather_tb_s']:.3f} TB/s in place")
            if side == "dst" and heads * d != 64:
                res["orders"] += probe_orders(fwd, cap, y, w, want, heads, d)
                res["hubs"].append(probe_hubs(view, cap, y, w, heads, d))
                for name, fn in fns.items():
                    v_ms, _ = timed(view, cap, y, w, want, fn)
                    res["variants"].append({"variant": name,
                                            "shape": [heads, d],
                                            "ms": v_ms, "default_ms": ms})
                    print(f"# variant {name} ({heads}, {d}): {v_ms:.4f} ms "
                          f"(default {ms:.4f})")
                if d == 41:
                    res["pad44"] = probe_pad(view, cap, y, w, want, ms)
            del want
        del w, y
        torch.cuda.empty_cache()
    return res


def probe_orders(fwd, cap, y, w, want, heads, d):
    out = []
    for hd in HUB_DEGREES:
        view = tts._build_row_view(fwd, "dst", hd)
        ms, _ = timed(view, cap, y, w, want)
        out.append({"hub_degree": str(hd), "shape": [heads, d], "ms": ms})
        print(f"# order ({heads}, {d}), hubs over {hd}x the mean degree "
              f"first: {ms:.4f} ms")
        del view
    return out


def probe_hubs(view, cap, y, w, heads, d):
    deg = view.ptr[1:] - view.ptr[:-1]
    n_hub = int((deg.long() * view.rows
                 > tts.HUB_DEGREE * view.slot.numel()).sum())
    r = {"shape": [heads, d], "hub_rows": n_hub}
    for part, order in (("hubs", view.order[:n_hub]),
                        ("rest", view.order[n_hub:])):
        sub = tts.RowView(view.ptr, view.slot, view.nbr, order)
        edges = int(deg[order.long()].sum())
        ms = cuda_ms(lambda: walk(sub, cap, y, w))
        r[part] = {"rows": int(order.numel()), "edges": edges, "ms": ms,
                   "gather_tb_s": gather_tb_s(edges, heads * d, ms)}
        print(f"# {part} alone ({heads}, {d}): {order.numel()} rows, "
              f"{edges} edges, {ms:.4f} ms, gathers at "
              f"{r[part]['gather_tb_s']:.3f} TB/s")
    return r


def probe_pad(view, cap, y, w, want, ms41):
    y44 = torch.zeros(y.shape[0], 1, 44, device="cuda")
    y44[..., :41] = y
    out = walk(view, cap, y44, w)
    if not torch.equal(out[..., :41], want):
        raise AssertionError("the 44-column walk changed its sums")
    ms = cuda_ms(lambda: walk(view, cap, y44, w))
    print(f"# (1, 41) padded to 44 columns (16-byte loads): {ms:.4f} ms "
          f"(41 columns, scalar loads: {ms41:.4f})")
    return {"ms44": ms, "ms41": ms41}


def main():
    if sys.argv[1:] == ["tiny"]:
        print(f"tiny check: first rows claimed {tiny_check()}")
        return
    if not torch.cuda.is_available():
        raise SystemExit("the probe times the CUDA kernel: run it on a card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"# card: {card.strip()}")
    print(json.dumps(probe(reddit_format())))


if __name__ == "__main__":
    main()
