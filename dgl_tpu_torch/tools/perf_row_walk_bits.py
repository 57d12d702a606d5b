"""The row walks' instances in two checkouts of the package, side by side
on one card: each instance's output bits and its time, so that a change
to ``csrc/row_agg.cu`` can be shown to leave the instances it does not
touch as they were.

The instances, at the main path's widths on one seeded graph (a uniform
random graph of 1,000,000 edges over Reddit's 232,965 nodes, its tiled
format built on the card): K3 at F = 16, weightless and weighted; K4's
SpMM at (4, 32), (1, 41) and (8, 8); K6's dx at (4, 32) and (1, 41);
K9's node gradient on both sides at (8, 8) without da and by dst with
da (its dV: da meets in L2 in no fixed order); and the dot-product
walk's: K4's SDDMM at (4, 32) and (1, 41), K6's ds there in both
layouts, K9's scores at (8, 8), K10 v1's ds with a stored row (f32 and
bf16) at (4, 32); and K11's scores at (4, 32), v1's with a stored row
(f32 and bf16) and v2's with 16 edge features and the bias row.  Inputs
lie on dyadic grids, so every compared row-walk sum is exact and does not
depend on its order; each dot-product walk sums a dot in one fixed order:
two checkouts that compile one instance alike give the same bits.  K11's
logits are exact too, and p is one expf of each, so a checkout whose
scores are another kernel (the bucket walk before the dot-product walk
took them) gives the same bits as well.  The slot walk's instances (K11
v1's node sums on both sides and K10 v1's numerator and dx with dfe, f32
and bf16 stored rows; K10 v2's slot-feature reduce) and K11 v1's slot
gradient (da, dFE and dFNJ, f32 and bf16 rows), on the same COO in
buckets of 128 slots, and the scores (K6's, K10 v1's with the slot bias,
K10 v2's with the edge logit, p and g) are hashed, every output of each:
a (B, C, F) stored slot tensor by its valid rows and whether any padded
row holds a nonzero.

Usage, from the root of a checkout, on the card::

    python -m dgl_tpu_torch.tools.perf_row_walk_bits ROOT_A ROOT_B ...

runs each ROOT (a directory holding ``dgl_tpu_torch``) in a process of
its own, in the order given (for example parent, change, change,
parent), then prints whether every run's outputs equal the first's bit
for bit (by a SHA-256 of each output's bytes) and each instance's median
time (5 launches after one) in each run, and the same as one JSON line.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

N_NODES = 232_965
EDGES = 1_000_000


def _run(root: str):
    """In this process: import the package at ``root``, run every
    instance and return ({instance: ms}, {instance: a SHA-256 of its
    output's bytes})."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from dgl_tpu_torch.ops.kernels import gat_fused as tgf
    from dgl_tpu_torch.ops.kernels import tiled_spmm as tts
    from dgl_tpu_torch.tools import cuda_ms
    import dgl_tpu_torch
    assert os.path.abspath(dgl_tpu_torch.__file__).startswith(
        os.path.abspath(root))
    rng = np.random.default_rng(0)
    row = rng.integers(0, N_NODES, EDGES)
    col = rng.integers(0, N_NODES, EDGES)
    tf = tts.build_tiled_format_device(row, col, N_NODES, N_NODES,
                                       device="cuda").with_src_first()
    gen = torch.Generator(device="cuda").manual_seed(7)
    b, cap = tf.num_buckets, tf.cap

    def grid(*shape, step=1 / 16, top=1.0):
        return torch.randint(-round(top / step), round(top / step) + 1,
                             shape, device="cuda", generator=gen).float() \
            * step

    def slots(heads):
        return grid(b, heads, cap, step=1 / 8) * tf.valid.view(b, 1, cap)

    calls = {}
    x16 = grid(N_NODES, 16)
    w1 = grid(*tf.valid.shape, step=1 / 8) * tf.valid
    calls["k3_ones"] = lambda: tts.tiled_spmm(tf, x16)
    calls["k3_weighted"] = lambda: tts.tiled_spmm(tf, x16, slot_weights=w1)
    for heads, fh in ((4, 32), (1, 41), (8, 8)):
        x = grid(N_NODES, heads, fh)
        w = slots(heads)
        calls[f"k4_spmm_{heads}x{fh}"] = (
            lambda x=x, w=w, h=heads, f=fh:
            tts.tiled_spmm_multihead(tf, x, w, h, f))
        if heads != 8:
            calls[f"k6_dx_{heads}x{fh}"] = (
                lambda x=x, w=w: tgf.src_aggregate(tf, x, w))
    U, V = grid(N_NODES, 8, 8), grid(N_NODES, 8, 8)
    attn = grid(8, 8, step=1 / 16, top=0.5)
    ds = slots(8).transpose(1, 2).contiguous().transpose(1, 2)
    for side in ("dst", "src"):
        calls[f"k9_node_grad_{side}"] = (
            lambda side=side: tgf.vattn_node_grad(tf, U, V, attn, ds, 0.25,
                                                  side))
    calls["k9_node_grad_da"] = lambda: tgf.vattn_node_grad(
        tf, U, V, attn, ds, 0.25, "dst", with_da=True)
    for heads, fh in ((4, 32), (1, 41)):
        x, z = grid(N_NODES, heads, fh), grid(N_NODES, heads, fh)
        rp, g = grid(N_NODES, heads), slots(heads)
        calls[f"k4_sddmm_{heads}x{fh}"] = (
            lambda x=x, z=z, h=heads, f=fh:
            tts.tiled_sddmm_dot_multihead(tf, x, z, h, f))
        for major in (False, True):
            calls[f"k6_ds_{heads}x{fh}" + ("_slot_major" if major else "")] = (
                lambda x=x, z=z, rp=rp, g=g, major=major:
                tgf.gat_ds(tf, x, z, rp, g, slot_major=major).contiguous())
    calls["k9_scores"] = lambda: tgf.vattn_scores(tf, U, V, attn, 0.25)
    x, z = grid(N_NODES, 4, 32), grid(N_NODES, 4, 32)
    rp, g = grid(N_NODES, 4), slots(4)
    attn4 = grid(4, 32, step=1 / 16, top=0.5)
    ef = torch.randint(-1, 2, (b, cap, 16), device="cuda",
                       generator=gen).float() * tf.valid.view(b, cap, 1)
    wf = grid(17, 128, step=1 / 16, top=0.5)
    for dtype in (torch.float32, torch.bfloat16):
        fe = (grid(b, cap, 128, step=1 / 16, top=0.5)
              * tf.valid.view(b, cap, 1)).to(dtype)
        name = str(dtype).split(".")[-1]
        calls[f"k10v1_fe_ds_{name}"] = (
            lambda fe=fe: tgf.fe_ds(tf, x, fe, z, rp, g))
        calls[f"k11v1_scores_{name}"] = (
            lambda fe=fe: tgf.egatc_scores(tf, x, z, attn4, fe, 0.25))
    calls["k11v2_scores"] = lambda: tgf.vattn_scores(tf, x, z, attn4, 0.25,
                                                     ef, wf)
    # the slot walk's instances (K10 v1's numerator and dx with dfe, K11
    # v1's node sums, K10 v2's slot-feature reduce) and K11 v1's slot
    # gradient (da, dFE and dFNJ: a checkout whose slot gradient writes no
    # dFNJ takes the slot vector sum of its dFE by dst), every output of
    # each, on the same COO in buckets of 128 slots (sf: its (B, C, 128)
    # stored tensors 3.4 GB in f32, where tf's would take 13.6)
    sf = tts.build_tiled_format_device(row, col, N_NODES, N_NODES, cap=128,
                                       device="cuda").with_src_first()
    b2, cap2 = sf.num_buckets, sf.cap
    valid2 = sf.valid.view(b2, 1, cap2)
    ps = tgf._slot_major(grid(b2, 4, cap2, step=1 / 16, top=4).abs()
                         * valid2)
    g2 = grid(b2, 4, cap2, step=1 / 8) * valid2
    ef2 = torch.randint(-1, 2, (b2, cap2, 16), device="cuda",
                        generator=gen).float() * sf.valid.view(b2, cap2, 1)
    for dtype in (torch.float32, torch.bfloat16):
        # stored rows of 1/16 in [-1, 1], 0 at padded slots
        st = torch.randint(-16, 17, (b2, cap2, 128), dtype=torch.int8,
                           device="cuda", generator=gen).to(dtype)
        st.mul_(1 / 16).mul_(sf.valid.view(b2, cap2, 1).to(dtype))
        name = str(dtype).split(".")[-1]
        for side in ("dst", "src"):
            calls[f"slot_vec_{side}_{name}"] = (
                lambda st=st, side=side: tgf.slot_vec_reduce(sf, st, side))
        calls[f"k10v1_num_{name}"] = (
            lambda st=st: tgf.fe_aggregate(sf, x, st, ps))
        calls[f"k10v1_dx_dfe_{name}"] = (
            lambda dtype=dtype: tgf.dx_dfe(sf, z, ps, dtype))

        def slot_grad(st=st):
            got = tgf.egatc_slot_grad(sf, x, z, attn4, st, g2, 0.25)
            if len(got) == 2:
                got = got + (tgf.slot_vec_reduce(sf, got[1], "dst"),)
            return got

        calls[f"k11v1_slot_grad_{name}"] = slot_grad
    calls["k10v2_feat"] = lambda: tgf.slot_feat_reduce(sf, ps, ef2)
    # the scores (K6's, K10 v1's with the slot bias, K10 v2's with the
    # edge logit): p and g
    el, er = grid(N_NODES, 4), grid(N_NODES, 4)
    m = grid(16, 4, step=1 / 256, top=0.5)
    calls["k6_scores"] = lambda: tgf.gat_scores(tf, el, er, 0.2)
    calls["k10v1_scores"] = lambda: tgf.gat_scores(tf, el, er, 0.2, g)
    calls["k10v2_scores"] = lambda: tgf.edgegat_scores(tf, el, er, ef, m,
                                                       0.2)
    live = torch.nonzero(sf.valid.reshape(-1) > 0).reshape(-1)
    pad = sf.valid.reshape(-1) == 0
    digests, times = {}, {}
    for name, call in calls.items():
        got = call()
        h = hashlib.sha256()
        for t in got if isinstance(got, tuple) else (got,):
            if t.dim() == 3 and tuple(t.shape[:2]) == (b2, cap2):
                # a (B, C, F) slot tensor of sf: whether any padded row
                # holds a nonzero, then the valid rows
                rows = t.reshape(b2 * cap2, -1)
                h.update(bytes([int(rows.ne(0).any(dim=1)[pad].any())]))
                t = rows[live]
            # the bytes as stored (numpy has no bfloat16)
            h.update(t.contiguous().reshape(-1).view(torch.uint8).cpu()
                     .numpy().tobytes())
        digests[name] = h.hexdigest()
        del got
        times[name] = cuda_ms(call)
    return times, digests


def main():
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--one":
        print(json.dumps(_run(args[1])))
        return
    if not args:
        raise SystemExit("usage: python -m dgl_tpu_torch.tools."
                         "perf_row_walk_bits ROOT [ROOT ...]")
    runs = []
    for root in args:
        # the file run as a script: the process imports the package only
        # from ``root``
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root],
            capture_output=True, text=True)
        if done.returncode != 0:
            raise SystemExit(f"the run of {root} failed "
                             f"(rc {done.returncode}):\n{done.stderr}")
        runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
    for i, (root, (_, digests)) in enumerate(zip(args, runs)):
        print(f"# run {i} ({root}): the same bits as run 0 at every "
              f"instance: {digests == runs[0][1]}")
    for name in runs[0][0]:
        print(f"# {name}: " + ", ".join(f"{t[name]:.4f}" for t, _ in runs)
              + " ms (runs in order)")
    print(json.dumps({"roots": args, "times_ms": [t for t, _ in runs],
                      "same_bits": [d == runs[0][1] for _, d in runs]}))


if __name__ == "__main__":
    main()
