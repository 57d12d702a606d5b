"""Probe of K4's SDDMM (``tiled_sddmm_dot_multihead``) on the card: the
dot-product walk by dst (``csrc/row_agg.cu`` ``row_sddmm_kernel``) with
the choices of its design side by side in one run, at (4, 32) and (1, 41)
on the Reddit-statistics graph:

* ``layouts``: where the outputs are written, each call timed whole
  (allocation and passes included): "entry" (the wrapper's: a slot's H
  outputs at its entry in the row view, an (E, H) scratch that a round's
  stores fill in whole sectors, then a pass that gathers it into
  (B, H, C) through the view's slot -> entry map and writes the zeros),
  "slot_major" (one store a slot into a (B, C, H) scratch, then a pass
  that transposes it into (B, H, C) and writes the zeros), "direct"
  (4-byte stores into (B, H, C), then a pass that writes 0 at the padded
  slots) and "bucket" (the bucket-order walk of the port's first SDDMM
  kernel with 16-byte loads, which gathers z[dst] beside x[src] and
  writes a bucket's outputs coalesced).  The direct and slot-major walks
  are edits of ``row_sddmm_kernel`` (LAYOUT_EDITS) that read each entry's
  neighbour and slot from one interleaved array; the bucket walk and the
  two passes are ``sddmm_probe.cu`` beside this file; the probe builds
  them all with the package's ``nvcc`` flags into its build directory;
* ``zeroing``: the direct walk on (B, H, C) zeroed first
  ("direct_memset") against the pass over the padded slots, and each
  pass alone (the zero pass, the transpose, the gather through the map),
  and each walk alone (entry, direct, slot-major);
* ``hubs``: the wrapper's walk alone over the hub rows (over 4x the mean
  degree) and over the rest, with the rate of their gathers;
* ``variants``: edits of the wrapper's walk, alone: the outputs stored
  with plain stores where the kernel stores with ``st.global.cs`` (evict
  first; ``st``), the neighbour ids loaded with ``ld.global.cs``
  (``ldcs``), 16 slots in flight a lane at one vector a lane (``u16``),
  and at most 51 registers a thread (``lb5``: 5 blocks an SM).

Every layout's output is held bit for bit to the wrapper's: the inputs
lie on a dyadic grid (multiples of 1/16 in [-1, 1]), on which every dot
is exact in any order.  Every time is the median of 5 calls after
one (``cuda_ms``).  The probe is not a main path: nothing here counts
launches.

Usage: ``python -m dgl_tpu_torch.tools.perf_sddmm_walk [tiny]`` (tiny: the
CPU check of the layouts' index arithmetic against the plain version).
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from . import build_edited, cuda_ms, edited_source
from ..ops.kernels import tiled_spmm as tts

SHAPES = ((4, 32), (1, 41))
LAYOUTS = ("entry", "direct", "slot_major", "bucket")
PROBE_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "sddmm_probe.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int64
PROBE_SIGNATURES = {
    "dgl_bucket_sddmm": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I,
                         _I, _I, _I, _P, _I, _I, _I, _P],
    "dgl_probe_finish": [_P, _P, _I, _I, _I, _P, _I, _I, _P]}
# the wrapper's walk reads entry k's neighbour and writes at k * ostride
_ENTRY_IDS = ("my_nbr = nbr[pb + li];\n"
              "        my_out = (pb + li) * ostride;")
_STORE = "__stcs(out + ob + hq[q], d[q][i]);"
# the other write layouts' walks, launched with ``nbr`` the interleaved
# (neighbour, slot) of each entry: "direct" at out[b, h, c] (ostride the
# cap), "slot_major" at out[slot * H + h] (ostride H)
LAYOUT_EDITS = {
    "direct": [(_ENTRY_IDS,
                "my_nbr = nbr[2 * (pb + li)];\n"
                "        const int s = nbr[2 * (pb + li) + 1];\n"
                "        const int b = s / ostride;\n"
                "        my_out = b * heads * ostride + (s - b * ostride);"),
               (_STORE, "__stcs(out + ob + hq[q] * ostride, d[q][i]);")],
    "slot_major": [(_ENTRY_IDS,
                    "my_nbr = nbr[2 * (pb + li)];\n"
                    "        my_out = nbr[2 * (pb + li) + 1] * ostride;")],
}
# each variant of the wrapper's walk: (old, new) edits of csrc/row_agg.cu,
# each old text found exactly once
VARIANTS = {
    "st": [(_STORE, "out[ob + hq[q]] = d[q][i];")],
    "ldcs": [(_ENTRY_IDS, "my_nbr = __ldcs(nbr + pb + li);\n"
                          "        my_out = (pb + li) * ostride;")],
    "u16": [("constexpr int U = Unroll<4, CPL>::value;",
             "constexpr int U = CPL == 1 ? 16 : Unroll<4, CPL>::value;")],
    "lb5": [("__launch_bounds__(kWarps * 32)\nrow_sddmm_kernel(",
             "__launch_bounds__(kWarps * 32, 5)\nrow_sddmm_kernel(")],
}


def edited_sources():
    """{name: ``csrc/row_agg.cu`` with the edits of LAYOUT_EDITS[name] or
    VARIANTS[name]}."""
    return {name: edited_source("row_agg", edits, name)
            for name, edits in {**LAYOUT_EDITS, **VARIANTS}.items()}


def build_probe():
    """({name: the ``dgl_row_sddmm`` of each edited source}, {fn: the C
    functions of ``sddmm_probe.cu``}), built with the package's ``nvcc``
    flags into its build directory."""
    with open(PROBE_SOURCE) as f:
        src = f.read()
    own = build_edited("sddmm_probe", {"probe": src}, PROBE_SIGNATURES)
    walks = build_edited(
        "row_agg", edited_sources(),
        {"dgl_row_sddmm": tts._SIGNATURES["row_agg"]["dgl_row_sddmm"]})
    return ({name: fns["dgl_row_sddmm"] for name, fns in walks.items()},
            own["probe"])


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {err}")


def _one_launch(x):
    """The plan's one launch over x's heads and columns (the probe's rows
    fit one)."""
    plan, _ = tts._sddmm_plan(x.shape[1], x.shape[2] // 4)
    if len(plan) != 1:
        raise ValueError("the probe's rows must fit one launch of the walk")
    return plan[0]


def walk_alone(fn, view, ids, x, z, out, ostride):
    """One launch of the walk ``fn`` (the wrapper's ``dgl_row_sddmm`` when
    None) over the rows of ``view.order``, entry ids ``ids``, into
    ``out`` at ``ostride``."""
    args = tts._sddmm_args(view, ids, x, z, out, ostride,
                           torch.zeros(1, dtype=torch.int32,
                                       device=x.device), _one_launch(x))
    if fn is None:
        tts._launch("dgl_row_sddmm", *args, source="row_agg")
    else:
        _check(fn(*args), "an edited dgl_row_sddmm")


def bucket_walk(tf, x, z, fn):
    """(B, H, cap) from one launch of the bucket-order walk; ``x``, ``z``
    as ``tts.sddmm_walk`` takes them."""
    heads, hp = x.shape[1], x.shape[2]
    lph, cph, lpr, cpl = tts._sddmm_layout(heads, hp // 4)
    out = torch.empty(tf.num_buckets, heads, tf.cap, device=x.device)
    # grid-stride over the 32-slot chunks, 8 warps a block
    blocks = max(1, min(-(-tf.num_buckets * tf.cap // 256),
                        16 * tts._sms(x.device)))
    _check(fn(tf.src_local.data_ptr(), tf.dst_local.data_ptr(),
              tf.valid.data_ptr(), tf.src_tile.data_ptr(),
              tf.dst_tile.data_ptr(), tf.num_buckets, tf.tile, tf.cap,
              x.data_ptr(), z.data_ptr(), heads * hp, heads, hp // 4, lph,
              cph, lpr, out.data_ptr(), cpl, blocks, x.device.index,
              tts._stream(x.device)), "dgl_bucket_sddmm")
    return out


def interleaved_ids(view):
    """(2E,) int32: each entry's neighbour and slot, the edited walks'
    ``nbr``."""
    return torch.stack([view.nbr, view.slot], 1).reshape(-1)


def finish_pass(tf, own, sm, out):
    """One launch of ``sddmm_probe.cu``'s pass on ``out`` (B, H, cap):
    the transpose of the slot-major scratch ``sm`` with 0 at the padded
    slots, or with ``sm`` None only the padded slots' zeros."""
    heads, slots = out.shape[1], tf.num_buckets * tf.cap
    _check(own["dgl_probe_finish"](
        tf.valid.data_ptr(), 0 if sm is None else sm.data_ptr(), slots,
        heads, tf.cap, out.data_ptr(),
        max(1, min(-(-slots // 256), 32 * tts._sms(out.device))),
        out.device.index, tts._stream(out.device)), "dgl_probe_finish")


def layout_calls(tf, x, z, walks, own):
    """{layout: a call that returns e (B, H, cap) as that layout writes
    it, allocation and passes included} on the forward format ``tf``:
    LAYOUTS and "direct_memset" (the direct walk on e zeroed first).
    ``walks`` and ``own`` as :func:`build_probe` returns them."""
    view = tf.row_view("dst")
    b_n, cap, heads = tf.num_buckets, tf.cap, x.shape[1]
    ids = interleaved_ids(view)

    def direct(memset):
        out = (torch.zeros if memset else torch.empty)(
            b_n, heads, cap, device=x.device)
        walk_alone(walks["direct"], view, ids, x, z, out, cap)
        if not memset:
            finish_pass(tf, own, None, out)
        return out

    def slot_major():
        if heads == 1:        # the (B, C, 1) scratch is e itself
            out = torch.zeros(b_n, 1, cap, device=x.device)
            walk_alone(walks["slot_major"], view, ids, x, z, out, 1)
            return out
        sm = torch.empty(b_n * cap * heads, device=x.device)
        walk_alone(walks["slot_major"], view, ids, x, z, sm, heads)
        out = torch.empty(b_n, heads, cap, device=x.device)
        finish_pass(tf, own, sm, out)
        return out

    return {"entry": lambda: tts.sddmm_walk(view, b_n, cap, x, z),
            "direct": lambda: direct(False),
            "direct_memset": lambda: direct(True),
            "slot_major": slot_major,
            "bucket": lambda: bucket_walk(tf, x, z,
                                          own["dgl_bucket_sddmm"])}


# -- the CPU rendering of each layout's index arithmetic ---------------------

def _dots(x, z, src, dst):
    return (x[src] * z[dst]).sum(-1)              # (n, H)


def render(tf, x, z, layout):
    """On the CPU, e (B, H, cap) as ``layout`` writes it: "entry",
    "direct" and "slot_major" by dst row over the row view (at entry * H
    + h and then gathered through ``view.entries``, at ``slot``, or at
    slot * H + h and then transposed), the zeros by ``valid`` (by the
    map's -1 for "entry"); "bucket" by 32-slot chunks of buckets, each
    slot's src and dst from its tiles and locals, 0 where ``valid`` is
    0."""
    b_n, cap, heads = tf.num_buckets, tf.cap, x.shape[1]
    valid = tf.valid.reshape(-1) != 0
    if layout == "bucket":
        out = torch.zeros(b_n, heads, cap)
        for k in range(b_n * cap // 32):
            b, c0 = divmod(k * 32, cap)
            s = b * cap + c0 + torch.arange(32)
            src = tf.src_tile[b] * tf.tile + tf.src_local.reshape(-1)[s]
            dst = tf.dst_tile[b] * tf.tile + tf.dst_local.reshape(-1)[s]
            d = _dots(x, z, src.long(), dst.long())
            out[b, :, c0:c0 + 32] = torch.where(valid[s, None], d, 0.0).T
        return out
    v = tf.row_view("dst")
    rows = torch.repeat_interleave(torch.arange(v.rows),
                                   (v.ptr[1:] - v.ptr[:-1]).long())
    d = _dots(x, z, v.nbr.long(), rows)
    s = v.slot.long()
    if layout == "entry":
        sm = d.reshape(-1)                      # entry k, head h: k * H + h
        k = v.entries(b_n * cap).long()
        got = sm.view(-1, heads)[k.clamp(min=0)]
        return torch.where((k >= 0)[:, None], got, 0.0).view(
            b_n, cap, heads).transpose(1, 2).contiguous()
    if layout == "slot_major":
        sm = torch.full((b_n * cap * heads,), float("nan"))
        sm[(s[:, None] * heads + torch.arange(heads)).reshape(-1)] = \
            d.reshape(-1)
        sm = sm.view(b_n * cap, heads)
        return torch.where(valid[:, None], sm, 0.0).view(
            b_n, cap, heads).transpose(1, 2).contiguous()
    flat = torch.full((b_n * heads * cap,), float("nan"))
    idx = (s // cap)[:, None] * heads * cap + torch.arange(heads) * cap \
        + (s % cap)[:, None]
    flat[idx.reshape(-1)] = d.reshape(-1)
    out = flat.view(b_n, heads, cap)
    return torch.where(valid.view(b_n, 1, cap), out, 0.0)


def tiny_check():
    """On the CPU, on a small graph with a hub and a dst tile with no
    bucket: each layout's rendering equals the plain version exactly
    (inputs on a dyadic grid), and the hub rows and the rest together are
    every row.  Returns the layouts checked."""
    rng = np.random.default_rng(0)
    n = 300
    row = np.concatenate([rng.integers(0, n, 900), rng.integers(0, n, 200)])
    col = np.concatenate([rng.integers(0, 128, 900), np.full(200, 7)])
    tf = tts.build_tiled_format(row, col, n, n, 64, 128, device="cpu")
    for heads, fh in SHAPES + ((8, 8),):
        x = torch.from_numpy(rng.integers(-16, 17, (n, heads, fh))
                             .astype(np.float32) / 16)
        z = torch.from_numpy(rng.integers(-16, 17, (n, heads, fh))
                             .astype(np.float32) / 16)
        want = tts.tiled_sddmm_dot_multihead_plain(tf, x, z)
        for layout in LAYOUTS:
            if not torch.equal(render(tf, x, z, layout), want):
                raise AssertionError(f"layout {layout} at ({heads}, {fh}) "
                                     "differs from the plain version")
    hubs, rest = hub_split(tf.row_view("dst"))
    if sorted(torch.cat([hubs.order, rest.order]).tolist()) != \
            list(range(n)) or int(hubs.order[0]) != 7:
        raise AssertionError("the hub split does not cover every row once")
    edited_sources()
    return LAYOUTS


# -- the probe on the card ----------------------------------------------------

def hub_split(view):
    """(the hub rows' view, the rest's view): the rows over
    ``tts.HUB_DEGREE`` times the mean degree, which the view lists first,
    and the others."""
    deg = view.ptr[1:] - view.ptr[:-1]
    n_hub = int((deg.long() * view.rows
                 > tts.HUB_DEGREE * view.slot.numel()).sum())
    return (tts.RowView(view.ptr, view.slot, view.nbr, view.order[:n_hub]),
            tts.RowView(view.ptr, view.slot, view.nbr, view.order[n_hub:]))


def reddit_format():
    """The tiled format (auto cap) of the Reddit-statistics graph with
    self-loops, built on the card as ``chip_smoke.py`` builds it."""
    from .perf_row_walk import reddit_format as build_format
    return build_format()


def probe(fwd, rate, log=print):
    """Every probe on ``fwd`` (the forward tiled format) at SHAPES;
    ``rate`` the card's memory rate (bytes/s) for the gather rates.
    Returns {shape: readings} and logs a line each."""
    gen = torch.Generator(device="cuda").manual_seed(43)
    view = fwd.row_view("dst")
    e = view.slot.numel()
    walks, own = build_probe()
    res = {}
    for heads, fh in SHAPES:
        hp = -(-fh // 4) * 4
        x, z = (tts._vec4_rows(torch.randint(
            -16, 17, (n, heads, fh), device="cuda", generator=gen).float()
            / 16, hp) for n in (fwd.num_src, fwd.num_dst))
        calls = layout_calls(fwd, x, z, walks, own)
        ids = interleaved_ids(view)
        want = calls["entry"]()
        r = {}
        for name, call in calls.items():
            if not torch.equal(call(), want):
                raise AssertionError(f"layout {name} at ({heads}, {fh}) "
                                     "changed the dots")
            r[name] = cuda_ms(call)
        out = torch.empty_like(want)
        scratch = torch.randn(out.numel(), device="cuda", generator=gen)
        slots = fwd.num_buckets * fwd.cap
        entries = view.entries(slots)
        blocks = max(1, min(-(-slots // 256), 32 * tts._sms(x.device)))
        r["zero_pass"] = cuda_ms(lambda: finish_pass(fwd, own, None, out))
        r["transpose_pass"] = cuda_ms(lambda: finish_pass(fwd, own, scratch,
                                                          out))
        r["entry_pass"] = cuda_ms(lambda: tts._launch(
            "dgl_slot_finish", scratch.data_ptr(), entries.data_ptr(), slots,
            heads, 1, e * heads, fwd.cap, out.data_ptr(),
            tts.finish_vec(heads, scratch), 0, blocks, x.device.index,
            tts._stream(x.device), source="row_agg"))
        r["direct_walk"] = cuda_ms(lambda: walk_alone(
            walks["direct"], view, ids, x, z, out, fwd.cap))
        r["slot_major_walk"] = cuda_ms(lambda: walk_alone(
            walks["slot_major"], view, ids, x, z, scratch, heads))

        def alone(sub=view, fn=None):
            """The wrapper's walk alone, into the entry-major scratch."""
            return lambda: walk_alone(fn, sub, sub.nbr, x, z, scratch, heads)
        scratch.zero_()     # what no walk writes stays 0 in every run
        alone()()
        base = scratch.clone()
        r["walk"] = cuda_ms(alone())
        r["gather_tb_s"] = e * heads * hp * 4 / r["walk"] / 1e9
        r["variants"] = {}
        for name in VARIANTS:
            scratch.zero_()
            alone(fn=walks[name])()
            if not torch.equal(scratch, base):
                raise AssertionError(f"variant {name} at ({heads}, {fh}) "
                                     "changed the dots")
            r["variants"][name] = cuda_ms(alone(fn=walks[name]))
        del base
        for part, sub in zip(("hubs", "rest"), hub_split(view)):
            edges = int((sub.ptr[1:] - sub.ptr[:-1])[sub.order.long()].sum())
            ms = cuda_ms(alone(sub))
            r[part] = {"rows": int(sub.rows), "edges": edges, "ms": ms,
                       "gather_tb_s": edges * heads * hp * 4 / ms / 1e9}
        del scratch
        res[f"{heads}x{fh}"] = r
        log(f"# SDDMM probe ({heads}, {fh}): entry (the wrapper's) "
            f"{r['entry']:.4f} ms (walk alone {r['walk']:.4f}, gathers at "
            f"{r['gather_tb_s']:.3f} TB/s, memory rate {rate / 1e12:.2f}; "
            f"gather pass {r['entry_pass']:.4f}), slot_major "
            f"{r['slot_major']:.4f} (walk alone {r['slot_major_walk']:.4f}; "
            f"transpose pass {r['transpose_pass']:.4f}), direct "
            f"{r['direct']:.4f} "
            f"(walk alone {r['direct_walk']:.4f}; zero pass "
            f"{r['zero_pass']:.4f}), direct_memset {r['direct_memset']:.4f}, "
            f"bucket {r['bucket']:.4f} ms")
        log(f"# SDDMM probe ({heads}, {fh}) variants, walk alone: "
            + ", ".join(f"{k} {v:.4f}" for k, v in r["variants"].items())
            + f" ms (default {r['walk']:.4f})")
        for part in ("hubs", "rest"):
            p = r[part]
            log(f"# SDDMM probe ({heads}, {fh}) {part} alone: {p['rows']} "
                f"rows, {p['edges']} edges, {p['ms']:.4f} ms, gathers at "
                f"{p['gather_tb_s']:.3f} TB/s")
        del x, z, want, out, calls
        torch.cuda.empty_cache()
    return res


def main():
    if sys.argv[1:] == ["tiny"]:
        print(f"tiny check: layouts {tiny_check()} equal the plain version")
        return
    if not torch.cuda.is_available():
        raise SystemExit("the probe times the CUDA kernels: run it on a card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"# card: {card.strip()}")
    print(json.dumps(probe(reddit_format(), 3.35e12)))


if __name__ == "__main__":
    main()
