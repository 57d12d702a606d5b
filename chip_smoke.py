"""Drive the PyTorch/CUDA port (``dgl_tpu_torch``) on one GPU.

Phases, each of which raises on failure (nothing is caught):

1. device: a CUDA device must be present; prints the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build: compiles ``dgl_tpu_torch/csrc/*.cu`` (one ``nvcc`` each, all at
   once) and prints the build seconds and ptxas' resource report;
3. every kernel against its plain PyTorch version on an asymmetric
   graph with multi-edges (24,000 src x 16,300 dst, so both packings
   reach bit plane 31), forward and backward of ``bit_spmm`` at F = 16,
   41, 96 (K1) and 97, 128, 160, 256 (K2);
4. the slice at full width and size: 2-layer GCN 602 -> 16 -> 41 (norm
   ``both``) trained for 10 Adam steps on the Reddit-statistics graph
   (232,965 nodes, 114.6M edges plus self-loops) in the bitmask format,
   then one warm-up step and one recorded step under ``torch.profiler``
   for the device time by kernel (every profiled step below is taken so);
5. one step's loss and weight gradients through the kernels against the
   gather + ``index_add_`` path, and K1 against its plain version at full
   size;
6. ``GraphConv(128, 128)`` forward and backward at full size (K2);
7. yardsticks at full size: each kernel's time (median of 5), its plain
   version's, one ``torch.sparse.mm`` on a CSR copy of A, and the bound;
   the spread of set bits over the word columns of K1's slabs; then both
   kernels at F = 16, 32, 64 and at the K1/K2 gate, F = 96;
8. the GAT slice at mid size: K5 forward and backward
   (``bitgat_attention_aggregate``) against their plain versions on the
   phase-3 graph made simple, at (H, D) = (4, 32), (1, 41) and (8, 16),
   with and without attention dropout 0.6; then a 2-layer GAT forward and
   backward through the kernels against edgeflat's gather path;
9. the GAT slice at full width and size: the 2-layer GAT 602 -> 4 x 32
   -> elu -> 1 x 41 with attention dropout 0.6 trained for 10 Adam steps
   on the phase-4 graph, then one more step under ``torch.profiler``;
10. K5 yardsticks at full size, (H, D) = (4, 32) and (1, 41) with
   dropout 0.6: each kernel against its plain version on all rows, its
   time (median of 5), its plain version's and the bound;
11. the tiled slice at mid size: K3 (F = 16, 41, 128; no weights, edge
   weights and slot weights; forward and backward) and K4's SpMM and
   SDDMM ((H, Fh) = (4, 32), (1, 41), (8, 16)) against their plain
   versions on the phase-3 multigraph in the tiled format, built on the
   card and equal to the host builder's; then K4's SpMM (the row walk by
   dst) and SDDMM (the dot-product walk by dst) equal to their plain
   versions on dyadic inputs at (4, 32), (1, 41), (8, 8) and (2, 64) on
   that graph with a dst hub and a src hub of degree 12,000 added, a dst
   tile with no bucket and rows with no slot, the SDDMM 0 at every padded
   slot, and the SDDMM also at (8, 256), (3, 300) and (1, 2048), rows
   wider than one launch of its walk holds;
12. the tiled format at full size: a second graph over the phase-4 COO,
   whose format ``auto_format`` picks by the JAX package's rules (it must
   be the tiled one), forward and reverse built on the card (no bitmask),
   and the row walk's views (the forward's by dst and by src, the
   reverse's by dst) and the forward dst view's slot -> entry map (K4's
   SDDMM), their build time and bytes;
13. route 1: the phase-4 GCN for 10 Adam steps on the tiled format (K3),
   a profiled step, and one step against the gather path;
14. route 3: the same GCN with ``norm="none"`` and edge weights from
   ``EdgeWeightNorm("both")`` of ones, cached in slot order: its logits
   against route 1's; then the weights as a tensor that needs a gradient,
   one step against the gather path;
15. route 2: the phase-9 GAT with attention dropout 0.6 for 10 Adam steps
   on the tiled format (edgeflat, K4), and a profiled step; then the same
   model in eval mode, one forward on K6 (the validation pass);
16. K3 and K4 yardsticks at full size: each kernel against its plain
   version and against one PyTorch call computing the same function
   (``torch.sparse.mm`` on a CSR copy, block-diagonal over the heads for
   K4's SpMM; a batched ``torch.sparse.sampled_addmm`` for K4's SDDMM),
   the three times (median of 5) and the bound (for the SDDMM also the
   bucket walk's, in brackets); for both walks of K4 also the rate of
   their gathers;
17. the slot-space slice at mid size: each K6 kernel (scores with and
   without a per-slot bias, the slot reduce on both sides, ds, the
   src-side aggregation) against its plain version on the phase-3
   multigraph in the tiled format at (H, Fh) = (4, 32), (1, 41), (8, 16);
   the src-side aggregation (the row walk by src) as phase 11 holds K4's
   SpMM; ``GATConv`` on K6 against edgeflat's gather path and
   ``DotGatConv`` on K8 against its gather path, forward and backward;
18. route 4: the phase-9 GAT without attention dropout for 10 Adam steps
   on the tiled format, both layers on K6 forward and backward, a
   profiled step whose trace is held to the launch counters, and one
   step's loss and gradients against the same model computed through
   edgeflat's functions;
19. ``DotGatConv(64, 32, 4)`` forward and backward of (out^2).mean() for
   3 steps on the tiled graph (K8: K4's SDDMM and SpMM, K6's kernels);
20. K6 yardsticks at full size, (H, Fh) = (4, 32) and (1, 41): each
   kernel against its plain version, its time (median of 5), its plain
   version's, the bound and, where one PyTorch call computes the same
   function, that call's time (``index_add_`` for the slot reduce, a
   block-diagonal ``torch.sparse.mm`` on the transposed pattern for the
   src-side aggregation).
21. the vector-attention slice at mid size: each K9 / K11 v2 kernel
   (scores, slot gradient, node gradient on both sides) against its plain
   version on the phase-3 multigraph in the tiled format at (H, D) = (8,
   8), (1, 41), (4, 32), without and with the edge term (16 features and
   the bias row); the 2-layer GATv2 of phase 22 through K9 against its
   edge chain, forward and backward;
22. route 5: the GATv2 recipe of examples/gatv2.py:22-31 (602 -> 8 x 8 ->
   elu -> 1 x 41, AdamW lr 5e-3, weight decay 5e-4) for 10 steps on the
   tiled format, both layers on K9, a profiled step whose trace is held
   to the launch counters (and one without the warm-up step, which shows
   what the profiler drops then), and one step's loss and gradients
   against the same step built from the plain versions;
23. EGATConv(64, 16, 32, 32, 4) at the JAX package's EGAT scale
   (tools/perf_egat128.py:27-80: 23M uniform random edges over the Reddit
   node count, compute_edge_feats=False, (out^2).mean(), Adam 1e-3) for 4
   steps on K11 v2, and one step against its flat route;
24. K9 yardsticks on the phase-12 format at (8, 8) and (1, 41) (run
   before phase 23, which frees the Reddit graphs), and K11 v2's on the
   phase-23 format at (4, 32) with 16 edge features and the bias row
   (inputs exact in f32, as phase 21's): each kernel against
   its plain version, its time (median of 5), its plain version's and the
   bound; no PyTorch call computes any of them.  Then route 5's other
   launches at its (8, 8) layer: K6's yardsticks and K4's SpMM, as phases
   16 and 20 time them at (1, 41);
25. the EdgeGAT slice at mid size: each K10 v2 kernel (the edge scores,
   the slot-feature reduce, the edge ds without and with d(ef)) against
   its plain version on the phase-21 multigraph at (H, Fh) = (4, 32), (1,
   41), (8, 8), with 16 and 5 edge features, inputs exact in f32; then
   ``EdgeGATConv(64, 16, 32, 4)`` through K10 v2 against its edge chain,
   forward and backward;
26. ``EdgeGATConv(64, 16, 32, 4)`` (tools/perf_egat128.py:81-82,
   (out^2).mean(), Adam 1e-3) for 4 steps on K10 v2 on phase 23's graph,
   before it is freed, the launch counters held to their count a step,
   and one step against its flat route;
27. K10 v2 yardsticks on the phase-23 format at (4, 32) with 16 edge
   features: each kernel against its plain version, its time (median of
   5), its plain version's, the bound and, for the slot-feature reduce,
   one ``torch.sparse.mm`` of the (H N, slots) CSR holding p; then the
   EdgeGAT step's other launches at (4, 32) on that format, as phases 16
   and 20 time them: K6's reduce on both sides and src-side aggregation
   (dx), K4's SpMM; and the v1 functions' K6 launches there, the scores
   with the slot bias (K10 v1) and ds (K11 v1);
28. the DotGat-on-K7 slice at mid size, on the phase-8 graph: each K7
   kernel (forward, dz, dq) through ``bitdot_attention_aggregate``
   against its plain version at (H, D) = (2, 64), (1, 128), (4, 32), (3,
   8), and at (2, 64) with scores past +-40, one launch each way; l at
   zero scores equal to the in-degree exactly; each kernel's time at each
   shape; then ``DotGatConv(64, 64, 2)`` on K7 against its gather path,
   forward and backward, and the same layer at D = 32, which must not
   launch K7;
29. ``DotGatConv(64, 64, 2)`` on the phase-4 bitmask graph
   (tools/perf_bitdot_full.py:52-90: x (N, 64) from a seeded generator,
   loss (out^2).mean(), Adam 1e-3), one warm-up and 5 timed steps on K7
   with every launch counter held to one launch of each K7 kernel a step
   and no other, a profiled step held to the counters, and one step's
   loss and weight gradients against the same step built from the plain
   versions;
30. K7 yardsticks on the phase-4 graph at (2, 64) and (1, 128): each
   kernel against its plain version on every row, its time (median of 5),
   its plain version's and the bound; no PyTorch call computes it;
31. the hybrid slice at mid size: K12 in both orientations against its
   plain version (F = 1, 16, 41, 128; exact on a grid; an all-zero
   block); ``update_all(copy_u, sum)`` on the hybrid format against the
   gather path, forward and gradient, not symmetric, symmetric, multires,
   with a weighted bf16 block and with an empty remainder; auto_format on
   the three graphs of tests/test_pallas.py against the JAX package's
   choices;
32. bench.py's symmetric hybrid format (k_dense 32,768, min_degree 96,
   tile 1024, cap 512) on a third graph over the phase-4 COO, its sizes
   held to those measured on the host; the phase-4 GCN for 10 Adam steps
   on it (K12 rows and columns and K3 on the remainder, 4 launches each a
   step), a profiled step held to the counters, and one step against
   route 1's tiled step;
33. K12 yardsticks on the phase-32 block at F = 16: each orientation
   exactly equal to its plain version on a grid, its time (median of 5),
   its plain version's, the bound and ``torch.matmul`` of the block in
   bf16.

34. the mesh-sharded slice at mid size, on the phase-8 simple graph on
   24,000 nodes with 64 edges more into its last dst (every build's
   shards reach bit plane 31): the sharded format built on the card for
   1, 2 and 4 parts, each equal to the host builder's arrays; on every
   shard K1, K5's forward over the A^T packing (``bitgat_fwd_t``) and K13
   (``bit_shard_gat_bwd``) against their plain versions at (H, D) = (4,
   32), (1, 41), (8, 16) and (2, 16); on a world-size-1 NCCL group
   ``bit_sharded_spmm`` and ``bit_sharded_gat``, forward and gradients,
   against the single-card ``bit_spmm`` and ``bitgat_attention_aggregate``;
   a 4-shard emulation in this process (cat and sum in place of the
   collectives) against the world-size-1 result; ``dryrun_multichip(1)``;
35. the sharded slice at full size: the Reddit graph's symmetric one-part
   sharded format built on the card (its bytes and set bits held to the
   graph's), the phase-4 GCN for 10 Adam steps on ``bit_sharded_spmm``
   (4 K1 launches a step; one step against phase 4's bitmask step) and
   the route-4 GAT recipe (attention dropout 0, weights through
   ``params.gatconv_state_dict``) for 10 Adam steps on
   ``bit_sharded_gat`` (one ``bitgat_fwd_t`` and one K13 launch a layer
   and step, no other K5 launch), a profiled step held to the counters,
   and one step against the same step built from the plain versions;
36. ``bitgat_fwd_t`` and K13 yardsticks on the one-part shard and on
   shard 0 of a 4-part build at (4, 32) and (1, 41): each against its
   plain version on every row, its time (median of 5), its plain
   version's and the bound;
37. the stored-edge-term slice at mid size: each K11 v1 kernel (the
   scores and the slot gradient over a stored FE, the slot vector sum on
   both sides) and each K10 v1 kernel (the numerator with a stored
   message, its ds, dx with dfe) against its plain version on the
   phase-21 multigraph at (H, D) = (4, 32), (1, 41), (8, 8), the stored
   slot tensors in f32 and in bf16, inputs on dyadic grids; then both v1
   functions against their v2 counterparts on the same leaves, values and
   gradients;
38. EGATConv(64, 16, 32, 32, 4)'s widths on K11 v1 on phase 23's graph:
   FE = ef_slot Wf with Wf (16, 128) stored per slot ((B, C, 128) f32),
   (out^2).mean(), Adam 1e-3, one warm-up and 4 timed steps with every
   launch counter held to its count a step, a profiled step held to the
   counters, one step's loss and gradients against the same step through
   the plain versions, and the loss against
   ``egatconv_attention_aggregate_v2`` on the same leaves;
39. EdgeGATConv(64, 16, 32, 4)'s widths on K10 v1 the same way: fe_slot =
   ef_slot We and ee_slot = <fe_slot, attn_e> per head stored per slot,
   against ``edgegat_attention_aggregate_v2``;
40. K11 v1 and K10 v1 yardsticks on the phase-23 format at (4, 32), f32:
   each kernel against its plain version on grid inputs (exact sums), its
   time (median of 5), its plain version's, the bound and, for the slot
   vector sum, one ``index_add_``;
41. K1's slab-width sweep (``dgl_tpu_torch/tools/perf_bitmm_variants.py``,
   the JAX package's P1): KP = N = 110,592, F = 16, random bits, 8, 16 and
   32 words, each width exactly equal to the plain version;
42. the probe of ``bitgat_fwd_t`` at full bit density
   (``dgl_tpu_torch/tools/perf_bitgat_probe.py``, P2): s_pad = k_pad =
   110,592, H = 4, D = 32, random bits, one warm-up and two timed
   launches, and the block of 1,024 src rows against the plain version;
43. the probe of K4's SDDMM walk (``dgl_tpu_torch/tools/
   perf_sddmm_walk.py``) on the phase-12 format at (4, 32) and (1, 41):
   the write layouts (an entry-major scratch gathered through the view's
   slot -> entry map, the wrapper's; a slot-major scratch and a transpose;
   direct stores and a zero pass, these two walks edits of the wrapper's
   source; the bucket-order walk with 16-byte loads), the zeroing (a
   memset first against the pass), each pass and walk alone, the hub rows
   alone against the rest, and four edits of the walk's source, every
   output held bit for bit to the wrapper's.

Phases 28-30 run after phases 25 and 10, phase 31 after phase 28, phases
32-33 after phase 24, with the bitmask freed, phases 34-36 after phase
33, with the hybrid block freed, phase 37 after phase 25, phases 38-40
after phase 27, phase 43 after phase 16 and phases 41-42 last, with the
EGAT graph freed; each phase prints its seconds.  Prints the card line
and a ``{"kernels": [...]}`` line before the last; the last line is
``{"ok": true, "device": {...}}``.  The script finds ``dgl_tpu_torch``
from its own directory or the working directory (``package_root``).

Usage: python3 chip_smoke.py
"""
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PACKAGE = "dgl_tpu_torch"


def package_root(script=__file__, cwd=None):
    """The first directory that holds ``dgl_tpu_torch/__init__.py``,
    searching from the script's own directory up through its parents, then
    from the working directory up through its parents: a copy of this file
    outside the checkout still finds the package it drives.  Raises when
    none holds it."""
    starts = (os.path.dirname(os.path.abspath(script)),
              os.path.abspath(os.getcwd() if cwd is None else cwd))
    for start in starts:
        d = start
        while True:
            if os.path.isfile(os.path.join(d, PACKAGE, "__init__.py")):
                return d
            parent = os.path.dirname(d)
            if parent == d:
                break
            d = parent
    raise SystemExit(f"chip_smoke: no {PACKAGE}/__init__.py in {starts[0]}, "
                     f"{starts[1]} or any of their parents")


N_NODES, N_EDGES, FEAT, HIDDEN, CLASSES = 232_965, 114_615_892, 602, 16, 41
STEPS = 10
RTOL, ATOL = 1e-4, 1e-3     # f32 sums in another order, and K1's atomics
F32_PEAK = 67e12            # H100 SXM f32 outside the tensor cores
BF16_PEAK = 989e12          # H100 SXM bf16 on the tensor cores, dense


def log(msg):
    print(msg, flush=True)


def mem_rate(name: str) -> float:
    """Published memory rate (bytes/s) of the card named ``name``."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    return 3.35e12


def cuda_ms(fn, reps=5):
    """Median device time of ``fn()`` over ``reps`` runs, CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def close(got, want, what, rtol=RTOL, atol=ATOL):
    """assert_close, and max|got - want|, 2^26 elements at a time (bounded
    temporaries: a (B, C, 128) slot tensor at 23M edges is 13.6 GB).  A
    check that used more than half of its tolerance at some element (|err|
    over atol + rtol |want|) is logged: a later run may cross it."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shapes {tuple(got.shape)} and "
                             f"{tuple(want.shape)} differ")
    g, w = got.reshape(-1), want.reshape(-1)
    err = used = 0.0
    for i in range(0, g.numel(), 1 << 26):
        gc, wc = g[i:i + (1 << 26)], w[i:i + (1 << 26)]
        torch.testing.assert_close(gc, wc, rtol=rtol, atol=atol,
                                   msg=lambda m, i=i: f"{what} (elements "
                                   f"from {i}): {m}")
        d = (gc - wc).abs()
        err = max(err, float(d.max()))
        used = max(used, float((d / (wc.abs() * rtol + atol)).max()))
    if used > 0.5:
        log(f"# near the tolerance: {what}, max|err| {err:.3g}, "
            f"{used:.0%} of the allowed error at its worst element")
    return err


def grid(gen, *shape, step, top, low=None):
    """Random multiples of ``step`` in [``low``, ``top``] (``low`` = -top
    by default) on the card.  The full-size checks take such inputs: the
    plain versions and the library calls sum with atomics, in an order
    that changes from run to run, and at the Reddit graph's hubs (degree
    up to 10,674 with self-loops) the order alone moved an output by more
    than ATOL.  On a
    grid the sums are exact in any order (see ``exact_sums``)."""
    low = -top if low is None else low
    return torch.randint(round(low / step), round(top / step) + 1, shape,
                         device="cuda", generator=gen).float() * step


def exact_sums(terms, step, what):
    """Raise unless f32 sums of products on a grid of ``step``, whose
    absolute values add up to at most ``terms``, are exact in any order:
    they must stay within f32's 24-bit significand."""
    if terms / step >= 2 ** 24:
        raise AssertionError(f"{what}: sums of up to {terms} on a grid of "
                             f"{step} are not exact in f32")


def max_degree(g):
    return int(max(g.in_degrees().max(), g.out_degrees().max()))


def mid_graph():
    """The asymmetric mid-size COO of phase 3, with multi-edges."""
    n_src, n_dst, e = 24_000, 16_300, 600_000
    rng = np.random.default_rng(3)
    row = rng.integers(0, n_src, e)
    col = rng.integers(0, n_dst, e)
    row[: 20_000] = row[20_000:40_000]          # multi-edges
    col[: 20_000] = col[20_000:40_000]
    row[:64], col[:64] = n_src - 1, n_dst - 1   # plane 31 on both sides
    return row, col, n_src, n_dst


def phase_kernels_mid(bm):
    """Phase 3: each kernel against its plain version, fwd and bwd."""
    row, col, n_src, n_dst = mid_graph()
    bf = bm.build_bit_format_device(row, col, n_src, n_dst,
                                    assume_simple=False, device="cuda")
    host = bm.pack_bits(row, col, n_src, n_dst)[0]
    if not np.array_equal(bf.packed.cpu().numpy(), host):
        raise AssertionError("device packing differs from the host packing")
    if bf.rem_src.numel() == 0:
        raise AssertionError("mid-size graph has no remainder")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for f in (16, 41, 96, 97, 128, 160, 256):
        x = torch.randn(n_src, f, device="cuda", generator=gen,
                        requires_grad=True)
        dz = torch.randn(n_dst, f, device="cuda", generator=gen)
        k1, k2 = bm.bit_matmul_t.launches, bm.bit_matmul.launches
        out = bm.bit_spmm(bf, x)
        out.backward(dz)
        torch.cuda.synchronize()
        if f <= bm.T_MAX_F:
            ref = bm.bit_matmul_t_plain(bf.packed_rev, x.detach(), n_dst)
            dref = bm.bit_matmul_t_plain(bf.packed, dz, n_src)
            launched = bm.bit_matmul_t.launches - k1
        else:
            ref = bm.bit_matmul_plain(bf.packed, x.detach(), n_dst)
            dref = bm.bit_matmul_plain(bf.packed_rev, dz, n_src)
            launched = bm.bit_matmul.launches - k2
        if launched != 2:
            raise AssertionError(f"F={f}: {launched} kernel launches, not 2")
        ref = bm.add_remainder(ref, x.detach(), bf.rem_src, bf.rem_dst,
                               bf.rem_w)
        dref = bm.add_remainder(dref, dz, bf.rem_dst, bf.rem_src, bf.rem_w)
        e_fwd = close(out.detach(), ref, f"forward F={f}")
        e_bwd = close(x.grad, dref, f"backward F={f}")
        log(f"# mid-size F={f}: forward max|err| {e_fwd:.3g}, backward "
            f"{e_bwd:.3g} ({'K1' if f <= bm.T_MAX_F else 'K2'})")


def reddit_graph(dgt):
    t0 = time.perf_counter()
    src, dst = dgt.data.reddit_like_graph_sym(N_NODES, N_EDGES, seed=0)
    log(f"# graph generated on the host in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    g = dgt.graph((src, dst), num_nodes=N_NODES, device="cuda")
    g = dgt.add_self_loop(dgt.remove_self_loop(g))
    g.unit().create_bitmask_format(symmetric=True, on_device=True,
                                   assume_simple=True)
    torch.cuda.synchronize()
    log(f"# graph + bitmask format on the card in "
        f"{time.perf_counter() - t0:.1f}s: {g.num_edges()} edges, "
        f"{g.unit()._bits.nbytes} bytes of bits")
    return g


def reddit_inputs():
    """Features with a weak community signal and the planted community
    labels (as tools/train_full_reddit.py:36-46)."""
    rng = np.random.default_rng(7)
    y = (np.arange(N_NODES) * CLASSES // N_NODES).astype(np.int64)
    sig = rng.normal(size=(CLASSES, FEAT)).astype(np.float32)
    x = rng.normal(size=(N_NODES, FEAT)).astype(np.float32) + 0.25 * sig[y]
    train = np.sort(rng.permutation(N_NODES)[: N_NODES // 10])
    return (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda(),
            torch.from_numpy(train).cuda())


class GCN(torch.nn.Module):
    def __init__(self, dgt, gen):
        super().__init__()
        self.conv1 = dgt.nn.GraphConv(FEAT, HIDDEN, activation=torch.relu,
                                      generator=gen)
        self.conv2 = dgt.nn.GraphConv(HIDDEN, CLASSES, generator=gen)

    def forward(self, g, x):
        return self.conv2(g, self.conv1(g, x))


def loss_fn(model, g, x, y, train):
    logits = model(g, x)
    return torch.nn.functional.cross_entropy(logits[train], y[train])


def train_loop(name, model, opt, g, x, y, train, loss=loss_fn):
    """STEPS optimizer steps of ``loss``: (losses, median step s after
    one warm-up step)."""
    loss_of = loss
    losses, times = [], []
    for step in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = loss_of(model, g, x, y, train)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        log(f"# {name + ' ' if name else ''}step {step}: loss "
            f"{losses[-1]:.6f}, {times[-1] * 1e3:.2f} ms")
    return losses, statistics.median(times[1:])


def phase_train(dgt, bm, g, x, y, train):
    """Phase 4: 10 Adam steps of the 602 -> 16 -> 41 GCN."""
    model = GCN(dgt, torch.Generator(device="cuda").manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    torch.cuda.reset_peak_memory_stats()
    bm.bit_matmul_t.launches = 0
    bm.bit_matmul.launches = 0
    losses, step_s = train_loop("", model, opt, g, x, y, train)
    k1 = bm.bit_matmul_t.launches
    log(f"# train: median step {step_s * 1e3:.3f} ms after one warm-up "
        f"step, {g.num_edges() / step_s:.6g} train-edges/s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes, "
        f"K1 launches {k1}, K2 launches {bm.bit_matmul.launches}")
    if k1 != 4 * STEPS:
        raise AssertionError(f"K1 launched {k1} times, not {4 * STEPS}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses do not fall: {losses}")
    return model, opt, k1


# each wrapper's launch counter and the CUDA kernel it launches, once a
# call, or the kernels it launches, each once a call (K4's SDDMM: the walk
# and its finishing pass, at the main path's widths, which one launch of
# the walk holds; K12's columns: the split of z and the tensor-core
# product); K4's SpMM and the src-side aggregation share the row
# walk, K13 and K5's backward another kernel: the counts of wrappers that
# share one are held together
TRACED_KERNELS = {
    "bit_matmul_t": "bit_matmul_t_kernel",
    "bitgat_fwd": "bitgat_fwd_kernel", "bitgat_bwd": "bitgat_bwd_kernel",
    "gat_scores": "gat_scores_kernel", "slot_reduce": "slot_reduce_kernel",
    "gat_ds": "gat_ds_kernel", "src_aggregate": "row_agg_kernel",
    "vattn_scores": "vattn_scores_kernel",
    "vattn_slot_grad": "vattn_slot_grad_kernel",
    "vattn_node_grad": "vattn_node_grad_kernel",
    "k4_spmm": "row_agg_kernel", "k4_sddmm": ("row_sddmm_kernel", "slot_finish_kernel"),
    "bitdot_fwd": "bitdot_fwd_kernel", "bitdot_bwd_dz": "bitdot_dz_kernel",
    "bitdot_bwd_dq": "bitdot_dq_kernel",
    "int8_matmul_rows": "int8_rows_kernel",
    "int8_matmul_cols": ("split_z_kernel", "int8_cols_kernel"),
    "k3_spmm": "tiled_spmm_kernel",
    "bitgat_fwd_t": "bitgat_fwd_t_kernel",
    "bit_shard_gat_bwd": "bitgat_bwd_kernel",
    "egatc_scores": "vattn_scores_kernel",
    "egatc_slot_grad": "vattn_slot_grad_kernel",
    "slot_vec_reduce": "src_agg_kernel", "fe_aggregate": "src_agg_kernel",
    "fe_ds": "gat_ds_kernel", "dx_dfe": "src_agg_kernel",
    "edgegat_scores": "gat_scores_kernel",
    "slot_feat_reduce": "src_agg_kernel", "edgegat_ds": "gat_ds_kernel"}


def phase_profile(model, opt, g, x, y, train, counts, warmup=1,
                  loss=loss_fn):
    """Optimizer steps of ``loss`` under torch.profiler, ``warmup`` of them
    before the one that its schedule records: device time by kernel and
    the device's busy share of the recorded step (the wall time includes
    the profiler's own cost).  ``counts`` is a function that reads the
    step's wrappers' launch counters: each wrapper of ``TRACED_KERNELS``
    that it reads has its launches in the recorded step held against its
    kernel's entries in the trace.  Where they differ, the trace misses
    launches, the busy share is not measured, and the traced kernels are
    listed in order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=1,
                                   repeat=1)) as prof:
        for recorded in (False,) * warmup + (True,):
            if recorded:
                before = counts()
                t0 = time.perf_counter()
            opt.zero_grad()
            loss(model, g, x, y, train).backward()
            opt.step()
            torch.cuda.synchronize()
            if recorded:
                wall_us = (time.perf_counter() - t0) * 1e6
                after = counts()
            prof.step()
    # the device's kernels and copies, without the ranges that annotate
    # them on the device (the profiler's step, the optimizer's step)
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith("ProfilerStep")),
                  key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    traced = {name: kernel for name, kernel in TRACED_KERNELS.items()
              if name in after}
    launched = {}
    for name, kernels in traced.items():
        for kernel in (kernels,) if isinstance(kernels, str) else kernels:
            launched[kernel] = (launched.get(kernel, 0) + after[name]
                                - before[name])
    seen = {kernel: sum(e.count for e in rows
                        if f"::{kernel}<" in e.key or f"::{kernel}(" in e.key)
            for kernel in launched}
    log(f"# profiled step: launches by counter {launched}, in the trace "
        f"{seen}")
    if busy_us == 0:
        log("# profiled step: the profiler saw no device time (not measured)")
        return
    busy = (f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us:.1%})"
            if seen == launched else "not measured (the trace misses "
            f"launches; it shows {busy_us / 1e3:.3f} ms)")
    log(f"# profiled step: {wall_us / 1e3:.3f} ms wall, device busy {busy}; "
        "by kernel:")
    for e in rows[:12]:
        log(f"#   {e.self_device_time_total / 1e3:9.3f} ms {e.count:3d}x "
            f"{e.key[:100]}")
    if seen != launched:
        order = sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and any(f"::{k}" in e.name for k in launched))
        log("# profiled step: the trace misses launches; its counted kernels "
            "in order: " + "; ".join(
            f"{n[n.find('::') + 2:][:50]} {d:.0f}us" for _, n, d in order))


def phase_check(model, g, x, y, train):
    """Phase 5: one step through the kernels vs the gather path, and K1
    against its plain version at full size."""
    from dgl_tpu_torch.utils import config

    def grads():
        model.zero_grad()
        loss = loss_fn(model, g, x, y, train)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}

    loss_k, grad_k = grads()
    config.set_use_kernels(False)
    try:
        loss_g, grad_g = grads()
    finally:
        config.set_use_kernels(True)
    if abs(loss_k - loss_g) > 1e-4 * abs(loss_g):
        raise AssertionError(f"loss {loss_k} (kernels) vs {loss_g} (gather)")
    for n in grad_k:
        close(grad_k[n], grad_g[n], f"grad {n}", rtol=1e-3, atol=1e-5)
    log(f"# kernels vs gather path: loss {loss_k:.8f} vs {loss_g:.8f}, "
        f"{len(grad_k)} gradients agree")


def phase_k2(dgt, bm, g):
    """Phase 6: GraphConv(128, 128) forward and backward (K2)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    conv = dgt.nn.GraphConv(128, 128, generator=gen)
    x = torch.randn(N_NODES, 128, device="cuda", generator=gen,
                    requires_grad=True)
    bm.bit_matmul.launches = 0
    conv(g, x).square().mean().backward()
    torch.cuda.synchronize()
    k2 = bm.bit_matmul.launches
    log(f"# GraphConv(128, 128) forward + backward: K2 launches {k2}")
    if k2 == 0 or not torch.isfinite(x.grad).all():
        raise AssertionError("GraphConv(128, 128) did not run through K2")
    return k2


def yardstick(g, bm, name, kernel, plain, packed, f, rate):
    """Kernel vs plain version on one full-size call, and the timings."""
    unit = g.unit()
    bf = unit._bits
    gen = torch.Generator(device="cuda").manual_seed(f)
    x = grid(gen, N_NODES, f, step=1 / 16, top=2)
    exact_sums(max_degree(g) * 2, 1 / 16, f"{name} full size F={f}")
    got = kernel(packed, x, N_NODES)
    want = plain(packed, x, N_NODES)
    err = close(got, want, f"{name} full size F={f}")
    ms = cuda_ms(lambda: kernel(packed, x, N_NODES))
    plain_ms = cuda_ms(lambda: plain(packed, x, N_NODES), reps=3)
    row, col = unit.coo()
    a = torch.sparse_coo_tensor(torch.stack([col, row]),
                                torch.ones_like(row, dtype=torch.float32),
                                (N_NODES, N_NODES)).coalesce()
    a = a.to_sparse_csr()
    lib_ms = cuda_ms(lambda: torch.sparse.mm(a, x))
    close(torch.sparse.mm(a, x), want, f"torch.sparse.mm F={f}")
    del a
    nnz = unit.num_edges - int(bf.rem_w.sum())
    nbytes = packed.numel() * 4 + x.numel() * 4 + N_NODES * f * 4
    bytes_ms = nbytes / rate * 1e3
    ops_ms = 2 * nnz * f / F32_PEAK * 1e3
    bound = max(bytes_ms, ops_ms)
    log(f"# {name} F={f}: {ms:.4f} ms (bound {bound:.4f} ms by "
        f"{'bytes' if bytes_ms >= ops_ms else 'operations'}: {nbytes} B), "
        f"plain {plain_ms:.4f} ms, torch.sparse.mm {lib_ms:.4f} ms, "
        f"max|err| {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib_ms}


def slab_balance(bm, packed):
    """The set bits of each word column of ``packed``, and for each of K1's
    slabs the largest column's against the slab's mean: the load of the
    busiest of its warps, had each column's dst nodes one owner in the
    block (K1 gives its bits none: reductions in L2).  Logged."""
    n32 = packed.shape[1]
    cols = torch.zeros(n32, dtype=torch.int64, device=packed.device)
    step = max(1, (1 << 26) // n32)
    for r in range(0, packed.shape[0], step):
        cols += popcounts(packed[r:r + step]).sum(0)
    w = bm.T_SLAB_WORDS
    slabs = cols[:n32 // w * w].view(-1, w).float()
    ratio = slabs.max(1).values / slabs.mean(1).clamp(min=1)
    log(f"# K1's slabs of {w} words: the busiest word column's set bits "
        f"{float(ratio.mean()):.3f}x its slab's mean on average, "
        f"{float(ratio.max()):.3f}x at most")


def gate_times(bm, bits):
    """Both kernels at F = 16, 32, 64 and at the gate F = T_MAX_F on the
    same inputs: the route switches from K1 to K2 above T_MAX_F."""
    gen = torch.Generator(device="cuda").manual_seed(96)
    for f in (HIDDEN, 32, 64, bm.T_MAX_F):
        x = torch.randn(N_NODES, f, device="cuda", generator=gen)
        k1 = cuda_ms(lambda: bm.bit_matmul_t(bits.packed_rev, x, N_NODES))
        k2 = cuda_ms(lambda: bm.bit_matmul(bits.packed, x, N_NODES))
        log(f"# gate F={f}: K1 {k1:.4f} ms, K2 {k2:.4f} ms")


# -- the GAT slice ---------------------------------------------------------

GAT_SHAPES = ((4, 32), (1, 41))   # the two layers: 4 x 32, then 1 x 41
ATTN_DROP, SLOPE = 0.6, 0.2       # the reference recipe's dropout


class GAT(torch.nn.Module):
    """feat -> GATConv(4 heads x 32) -> elu -> GATConv(1 head x 41), as
    tools/perf_gat_train_reddit.py:32-42."""

    def __init__(self, dgt, gen, feat, attn_drop):
        super().__init__()
        (h1, d1), (h2, d2) = GAT_SHAPES
        self.conv1 = dgt.nn.GATConv(feat, d1, h1, attn_drop=attn_drop,
                                    generator=gen)
        self.conv2 = dgt.nn.GATConv(h1 * d1, d2, h2, attn_drop=attn_drop,
                                    generator=gen)

    def forward(self, g, x):
        h = torch.nn.functional.elu(self.conv1(g, x).flatten(1))
        return self.conv2(g, h).flatten(1)


def bitgat_reference(bg, bf, el, er, z, g, thresh, seed, num_dst):
    """K5's plain versions chained as the autograd function chains the
    kernels: (out, d_el, d_er, d_z) for inputs inside the clip."""
    out, l = bg.bitgat_fwd_plain(bf.packed, el, er, z, num_dst, SLOPE,
                                 thresh, seed)
    linv, rho = bg.backward_scales(g, out, l, thresh)
    return (out,) + bg.bitgat_bwd_plain(bf.packed_rev, el, er, z, g, linv,
                                        rho, num_dst, SLOPE, thresh, seed)


def phase_bitgat_mid(dgt, bm, bg):
    """Phase 8: K5 against its plain versions at mid size, then a 2-layer
    GAT through the kernels against edgeflat's gather path (what
    ``use_kernels(False)`` gives on a graph of this size)."""
    from dgl_tpu_torch.utils import config
    row, col, n_src, n_dst = mid_graph()
    key = np.unique(col * n_src + row)
    row, col = key % n_src, key // n_src
    bf = bm.build_bit_format_device(row, col, n_src, n_dst, device="cuda")
    if bf.rem_src.numel() or not ((bf.packed < 0).any()
                                  and (bf.packed_rev < 0).any()):
        raise AssertionError("mid-size graph is not simple or misses "
                             "plane 31")
    gen = torch.Generator(device="cuda").manual_seed(8)
    for heads, dim in GAT_SHAPES + ((8, 16),):
        for drop in (0.0, ATTN_DROP):
            thresh = bg.drop_thresh(drop)
            seed = torch.tensor([-123_456_789 - heads], device="cuda")
            el, er = (torch.randn(n, heads, device="cuda", generator=gen)
                      for n in (n_src, n_dst))
            z = torch.randn(n_src, heads, dim, device="cuda", generator=gen)
            g = torch.randn(n_dst, heads, dim, device="cuda", generator=gen)
            ins = [t.clone().requires_grad_() for t in (el, er, z)]
            f0, b0 = bg.bitgat_fwd.launches, bg.bitgat_bwd.launches
            out = bg.bitgat_attention_aggregate(bf, *ins, SLOPE, drop,
                                                seed if thresh else None)
            out.backward(g)
            torch.cuda.synchronize()
            if (bg.bitgat_fwd.launches - f0, bg.bitgat_bwd.launches - b0) \
                    != (1, 1):
                raise AssertionError("K5 did not launch once each way")
            ref = bitgat_reference(bg, bf, el, er, z, g, thresh, seed, n_dst)
            errs = [close(got, want, f"K5 mid {name} H={heads} D={dim} "
                          f"drop={drop}")
                    for name, got, want in zip(
                        ("out", "d_el", "d_er", "d_z"),
                        (out.detach(),) + tuple(t.grad for t in ins), ref)]
            log(f"# K5 mid H={heads} D={dim} drop={drop}: max|err| out "
                f"{errs[0]:.3g}, d_el {errs[1]:.3g}, d_er {errs[2]:.3g}, "
                f"d_z {errs[3]:.3g}")

    # a 2-layer GAT through the kernels against edgeflat's gather path
    gr = dgt.graph((row, col), num_nodes=n_src, device="cuda")
    gr.unit().create_bitmask_format(on_device=True)
    feat = 64
    x = torch.randn(n_src, feat, device="cuda", generator=gen)
    y = torch.randint(0, CLASSES, (n_src,), device="cuda", generator=gen)
    model = GAT(dgt, torch.Generator(device="cuda").manual_seed(9), feat,
                attn_drop=0.0)
    train = torch.arange(n_dst, device="cuda")

    def step():
        model.zero_grad()
        logits = model(gr, x)
        torch.nn.functional.cross_entropy(logits[train],
                                          y[train]).backward()
        return logits.detach(), {n: p.grad.clone()
                                 for n, p in model.named_parameters()}

    f0, b0 = bg.bitgat_fwd.launches, bg.bitgat_bwd.launches
    out_k, grad_k = step()
    if (bg.bitgat_fwd.launches - f0, bg.bitgat_bwd.launches - b0) != (2, 2):
        raise AssertionError("the GAT did not run through K5")
    config.set_use_kernels(False)
    try:
        out_c, grad_c = step()
    finally:
        config.set_use_kernels(True)
    err = close(out_k, out_c, "GAT kernels vs edgeflat gather path")
    for n in grad_k:
        close(grad_k[n], grad_c[n], f"GAT grad {n}", rtol=1e-3, atol=1e-5)
    log(f"# GAT mid size, kernels vs edgeflat (gather path): logits "
        f"max|err| {err:.3g}, {len(grad_k)} gradients agree")


def phase_gat_train(dgt, bg, g, x, y, train):
    """Phase 9: 10 Adam steps of the 602 -> 4 x 32 -> 1 x 41 GAT with
    attention dropout 0.6; K5's counts are set to 0 just before and read
    just after."""
    model = GAT(dgt, torch.Generator(device="cuda").manual_seed(0), FEAT,
                attn_drop=ATTN_DROP)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    torch.cuda.reset_peak_memory_stats()
    bg.bitgat_fwd.launches = 0
    bg.bitgat_bwd.launches = 0
    losses, step_s = train_loop("GAT", model, opt, g, x, y, train)
    launches = (bg.bitgat_fwd.launches, bg.bitgat_bwd.launches)
    log(f"# GAT train: median step {step_s * 1e3:.3f} ms after one warm-up "
        f"step, {g.num_edges() / step_s:.6g} train-edges/s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes, "
        f"K5 launches {launches[0]} forward, {launches[1]} backward")
    if launches != (2 * STEPS, 2 * STEPS):
        raise AssertionError(f"K5 launched {launches}, not "
                             f"({2 * STEPS}, {2 * STEPS})")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"GAT losses do not fall: {losses}")
    return model, opt, launches


def bitgat_yardstick(bg, g, heads, dim, rate):
    """K5 forward and backward against their plain versions on every row
    of the full graph, with dropout as trained, and the timings."""
    bf = g.unit()._bits
    n = N_NODES
    gen = torch.Generator(device="cuda").manual_seed(heads * 100 + dim)
    el, er = (torch.randn(n, heads, device="cuda", generator=gen)
              for _ in range(2))
    z, gr = (torch.randn(n, heads, dim, device="cuda", generator=gen)
             for _ in range(2))
    thresh, seed = bg.drop_thresh(ATTN_DROP), 20_240_611
    out, l = bg.bitgat_fwd(bf.packed, el, er, z, n, SLOPE, thresh, seed)
    want_out, want_l = bg.bitgat_fwd_plain(bf.packed, el, er, z, n, SLOPE,
                                           thresh, seed)
    err_f = close(out, want_out, f"K5 fwd H={heads} D={dim}")
    err_l = close(l, want_l, f"K5 l H={heads} D={dim}")
    linv, rho = bg.backward_scales(gr, want_out, want_l, thresh)
    bwd_args = (el, er, z, gr, linv, rho, n, SLOPE, thresh, seed)
    got = bg.bitgat_bwd(bf.packed_rev, *bwd_args)
    want = bg.bitgat_bwd_plain(bf.packed_rev, *bwd_args)
    err_b = max(close(a, b, f"K5 bwd {name} H={heads} D={dim}")
                for name, a, b in zip(("d_el", "d_er", "d_z"), got, want))
    del out, l, want_out, want_l, got, want
    times = {
        "fwd": cuda_ms(lambda: bg.bitgat_fwd(bf.packed, el, er, z, n, SLOPE,
                                             thresh, seed)),
        "fwd_plain": cuda_ms(lambda: bg.bitgat_fwd_plain(
            bf.packed, el, er, z, n, SLOPE, thresh, seed), reps=1),
        "bwd": cuda_ms(lambda: bg.bitgat_bwd(bf.packed_rev, *bwd_args)),
        "bwd_plain": cuda_ms(lambda: bg.bitgat_bwd_plain(bf.packed_rev,
                                                         *bwd_args), reps=1),
    }
    # bytes: each input read once and each output written once;
    # operations (f32): per edge and head about 5 (forward) or 12
    # (backward), per edge and feature column 2 (forward) or 4 (backward)
    e = g.unit().num_edges
    node, feat_b = n * heads * 4, n * heads * dim * 4
    rows = {}
    for name, nbytes, ops, err in (
            # in: the bits of A, el, er, z; out: out, l
            ("fwd", bf.packed.numel() * 4 + 3 * node + 2 * feat_b,
             e * heads * (2 * dim + 5), err_f),
            # in: the bits of A^T, el, er, linv, rho, z, g; out: del,
            # der, dz
            ("bwd", bf.packed_rev.numel() * 4 + 6 * node + 3 * feat_b,
             e * heads * (4 * dim + 12), err_b)):
        bytes_ms, ops_ms = nbytes / rate * 1e3, ops / F32_PEAK * 1e3
        rows[name] = {"max_abs_err": err, "ms": times[name],
                      "plain_ms": times[f"{name}_plain"],
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": ("bytes" if bytes_ms >= ops_ms
                                   else "operations"),
                      "library_ms": None}
        log(f"# K5 {name} H={heads} D={dim} drop={ATTN_DROP}: "
            f"{times[name]:.4f} ms (bound {rows[name]['bound_ms']:.4f} ms by "
            f"{rows[name]['bound_by']}: {nbytes} B, {ops} ops), plain "
            f"{times[f'{name}_plain']:.4f} ms, library none, max|err| "
            f"{err:.3g}" + (f" (l {err_l:.3g})" if name == "fwd" else ""))
    return rows


# -- the tiled slice ---------------------------------------------------------

TILED_MH_SHAPES = GAT_SHAPES + ((8, 16),)


def phase_tiled_mid(tts, tsp, ef):
    """Phase 11: K3 and K4 against their plain versions at mid size."""
    row, col, n_src, n_dst = mid_graph()
    fwd = tts.build_tiled_format_device(row, col, n_src, n_dst,
                                        device="cuda")
    rev = tts.build_tiled_format_device(col, row, n_dst, n_src,
                                        device="cuda")
    host = tts.build_tiled_format(row, col, n_src, n_dst, device="cpu")
    for name in ("src_local", "dst_local", "eid", "valid", "src_tile",
                 "dst_tile", "dst_ptr"):
        if not torch.equal(getattr(fwd, name).cpu(), getattr(host, name)):
            raise AssertionError(f"device-built {name} differs from host")
    rt, ct = (torch.as_tensor(a, device="cuda") for a in (row, col))
    gen = torch.Generator(device="cuda").manual_seed(11)
    ew = torch.rand(len(row), device="cuda", generator=gen) + 0.5
    w_f, w_r = tts.slot_edge_weights(fwd, ew), tts.slot_edge_weights(rev, ew)
    for f in (16, 41, 128):
        for kind in ("none", "edge", "slot"):
            x = torch.randn(n_src, f, device="cuda", generator=gen,
                            requires_grad=True)
            w = ew.clone().requires_grad_()
            dz = torch.randn(n_dst, f, device="cuda", generator=gen)
            k3 = tts.tiled_spmm.launches
            if kind == "none":
                out = tsp.spmm_tiled_copy(fwd, rev, x)
            elif kind == "edge":
                out = tsp.spmm_tiled_mul(fwd, rev, rt, ct, x, w)
            else:
                out = tsp.spmm_tiled_static(fwd, rev, w_f, w_r, x)
            out.backward(dz)
            torch.cuda.synchronize()
            if tts.tiled_spmm.launches - k3 != 2:
                raise AssertionError(f"K3 F={f} {kind}: not 2 launches")
            wf, wr = (None, None) if kind == "none" else (w_f, w_r)
            e_f = close(out.detach(), tts.tiled_spmm_plain(fwd, x.detach(),
                                                           wf),
                        f"K3 mid forward F={f} {kind}")
            e_b = close(x.grad, tts.tiled_spmm_plain(rev, dz, wr),
                        f"K3 mid backward F={f} {kind}")
            msg = ""
            if kind == "edge":
                e_w = close(w.grad, (x.detach()[rt] * dz[ct]).sum(-1),
                            f"K3 mid dEw F={f}")
                msg = f", dEw {e_w:.3g}"
            log(f"# K3 mid F={f} weights={kind}: max|err| forward "
                f"{e_f:.3g}, backward {e_b:.3g}{msg}")
    for heads, fh in TILED_MH_SHAPES:
        x = torch.randn(n_src, heads, fh, device="cuda", generator=gen)
        z = torch.randn(n_dst, heads, fh, device="cuda", generator=gen)
        w = torch.rand(len(row) * heads, device="cuda", generator=gen)
        w_slot = ef._w_slot_from_flat(fwd, w, heads)
        k4 = (tts.tiled_spmm_multihead.launches,
              tts.tiled_sddmm_dot_multihead.launches)
        out = tts.tiled_spmm_multihead(fwd, x, w_slot, heads, fh)
        e = tts.tiled_sddmm_dot_multihead(fwd, x, z, heads, fh)
        torch.cuda.synchronize()
        if (tts.tiled_spmm_multihead.launches - k4[0],
                tts.tiled_sddmm_dot_multihead.launches - k4[1]) != (1, 1):
            raise AssertionError("K4 did not launch once each")
        e_s = close(out, tts.tiled_spmm_multihead_plain(fwd, x, w_slot),
                    f"K4 SpMM mid H={heads} Fh={fh}")
        e_d = close(e, tts.tiled_sddmm_dot_multihead_plain(fwd, x, z),
                    f"K4 SDDMM mid H={heads} Fh={fh}")
        log(f"# K4 mid H={heads} Fh={fh}: max|err| SpMM {e_s:.3g}, SDDMM "
            f"{e_d:.3g}")
    row_walk_mid(tts, None, ef, "dst")


ROW_WALK_SHAPES = ((4, 32), (1, 41), (8, 8), (2, 64))
ROW_WALK_HUB = 12_000


def row_walk_mid(tts, tgf, ef, side):
    """The row walk by ``side`` (dst: K4's SpMM, src: the src-side
    aggregation) against its plain version at ROW_WALK_SHAPES on the
    phase-3 graph with a dst hub and a src hub of degree 12,000 added, no
    edge into dst tile 3 nor out of 50 src rows: x (or z) and w on dyadic
    grids, on which the plain version's atomics sum exactly, so the two
    must be equal."""
    row, col, n_src, n_dst = mid_graph()
    # dst tile 3 and src rows 20,000-20,049 have no edge
    keep = ((col < 3072) | (col >= 4096)) & ((row < 20_000) | (row >= 20_050))
    hub = np.arange(ROW_WALK_HUB)
    row = np.r_[row[keep], np.full(ROW_WALK_HUB, 11), hub % n_src]
    col = np.r_[col[keep], hub % 3072, np.full(ROW_WALK_HUB, 7)]
    fwd = tts.build_tiled_format_device(row, col, n_src, n_dst,
                                        device="cuda").with_src_first()
    view = fwd.row_view(side)
    deg = view.ptr[1:] - view.ptr[:-1]
    if int(deg.max()) < 10_000 or int(deg.min()) != 0:
        raise AssertionError(f"row walk mid {side}: degrees {int(deg.min())}"
                             f"..{int(deg.max())}, not 0..over 10,000")
    n_nbr = n_src if side == "dst" else n_dst
    exact_sums(int(deg.max()), 1 / 256, f"row walk mid {side}")
    gen = torch.Generator(device="cuda").manual_seed(110)
    wrapper = tts.tiled_spmm_multihead if side == "dst" else tgf.src_aggregate
    for heads, fh in ROW_WALK_SHAPES:
        y = grid(gen, n_nbr, heads, fh, step=1 / 16, top=1)
        w = ef._w_slot_from_flat(fwd, grid(gen, len(row) * heads,
                                           step=1 / 16, top=1, low=0), heads)
        before = wrapper.launches
        if side == "dst":
            got = tts.tiled_spmm_multihead(fwd, y, w, heads, fh)
            want = tts.tiled_spmm_multihead_plain(fwd, y, w)
        else:
            got = tgf.src_aggregate(fwd, y, w)
            want = tgf.src_aggregate_plain(fwd, y, w)
        torch.cuda.synchronize()
        if wrapper.launches != before + 1:
            raise AssertionError(f"row walk mid {side}: not 1 launch")
        if not torch.equal(got, want):
            raise AssertionError(
                f"row walk mid {side} H={heads} Fh={fh}: max|err| "
                f"{float((got - want).abs().max()):.3g}, not 0")
        if side == "dst" and not (got[3072:4096] == 0).all():
            raise AssertionError("row walk mid: dst tile 3 is not 0")
        msg = ""
        if side == "dst":
            # K4's SDDMM walks the same view: dots of grid values are exact
            sddmm_walk_mid(tts, fwd, y, gen, heads, fh)
            msg = "; K4's SDDMM walk equal too, 0 at every padded slot"
        log(f"# row walk mid by {side} H={heads} Fh={fh}: equal to the "
            f"plain version (degrees 0..{int(deg.max())}){msg}")
    if side == "dst":
        for heads, fh in SDDMM_WIDE_SHAPES:
            y = grid(gen, n_nbr, heads, fh, step=1 / 16, top=1)
            launches = sddmm_walk_mid(tts, fwd, y, gen, heads, fh)
            log(f"# K4's SDDMM walk mid H={heads} Fh={fh}: {launches} "
                "launches of the walk, equal to the plain version, 0 at "
                "every padded slot")


# rows wider than one launch of the SDDMM walk holds (1,024 columns): two
# groups of 4 heads, groups of 2 and 1 heads, two column chunks of a head
SDDMM_WIDE_SHAPES = ((8, 256), (3, 300), (1, 2048))


def sddmm_walk_mid(tts, fwd, x, gen, heads, fh):
    """K4's SDDMM on ``fwd`` against its plain version, x (num_src, H, Fh)
    and a z drawn here on the dyadic grid (every dot exact): equal, one
    launch counted, 0 at every padded slot.  Returns the walk's launches
    (``tts._sddmm_plan``)."""
    z = grid(gen, fwd.num_dst, heads, fh, step=1 / 16, top=1)
    before = tts.tiled_sddmm_dot_multihead.launches
    e_got = tts.tiled_sddmm_dot_multihead(fwd, x, z, heads, fh)
    e_want = tts.tiled_sddmm_dot_multihead_plain(fwd, x, z)
    torch.cuda.synchronize()
    if tts.tiled_sddmm_dot_multihead.launches != before + 1:
        raise AssertionError("SDDMM walk mid: not 1 launch")
    if not torch.equal(e_got, e_want):
        raise AssertionError(
            f"SDDMM walk mid H={heads} Fh={fh}: max|err| "
            f"{float((e_got - e_want).abs().max()):.3g}, not 0")
    pad = fwd.valid.reshape(fwd.num_buckets, 1, fwd.cap) == 0
    if not (e_got.masked_select(pad) == 0).all():
        raise AssertionError("SDDMM walk mid: a padded slot is not 0")
    return len(tts._sddmm_plan(heads, -(-fh // 4))[0])


def tiled_graph(dgt, g):
    """Phase 12: a second graph over g's COO whose format ``auto_format``
    picks by the JAX package's rules: the tiled format (auto cap), forward
    and reverse built on the card, and no bitmask.  With symmetric=None
    and over 50M edges no symmetry check runs, so the bitmask counts
    twice, over the 12 GiB budget, and the top 8,192 rows carry under 30%
    of the edges."""
    gt = dgt.graph(g.unit().coo(), num_nodes=N_NODES, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    choice = gt.unit()._auto_format_choice()
    families = gt.auto_format()
    torch.cuda.synchronize()
    log(f"# auto_format: {families}, deciding on a bitmask of "
        f"{choice['bits_bytes']} bytes (symmetric {choice['symmetric']}) "
        f"against a {12 << 30}-byte budget and the top 8,192 rows' "
        f"{choice['top_edges']} of {choice['edges']} edges "
        f"({choice['top_edges'] / choice['edges']:.4f}, the hybrid takes "
        f"0.3 or more)")
    if families != {gt.canonical_etypes[0]: "tiled"} or \
            choice["family"] != "tiled":
        raise AssertionError(f"auto_format picked {families}, not tiled")
    fwd, rev = gt.unit().tiled_format()
    slots = fwd.num_buckets * fwd.cap
    log(f"# tiled format (forward and reverse) built on the card in "
        f"{time.perf_counter() - t0:.3f}s: tile {fwd.tile}, cap {fwd.cap}, "
        f"{fwd.num_buckets} and {rev.num_buckets} buckets, {slots} slots "
        f"per direction, fill {gt.num_edges() / slots:.4f}, "
        f"{fwd.nbytes} + {rev.nbytes} bytes, covered_mask "
        f"{'none' if fwd.covered_mask is None else 'set'}")
    # the row walk's views: the forward's by dst (K4's SpMM) and by src
    # (the src-side aggregation), the reverse's by dst (edgeflat's dx)
    t0 = time.perf_counter()
    views = (fwd.row_view("dst"), fwd.row_view("src"), rev.row_view("dst"))
    torch.cuda.synchronize()
    log(f"# row views built on the card in {time.perf_counter() - t0:.3f}s: "
        + ", ".join(f"{v.nbytes}" for v in views) + " bytes (forward by "
        "dst and by src, reverse by dst)")
    # K4's SDDMM gathers its output through the forward dst view's slot ->
    # entry map
    t0 = time.perf_counter()
    entries = views[0].entries(slots)
    torch.cuda.synchronize()
    log(f"# the forward dst view's slot -> entry map built on the card in "
        f"{time.perf_counter() - t0:.3f}s: {entries.numel() * 4} bytes")
    return gt


class WeightedGCN(torch.nn.Module):
    """The GCN with ``norm="none"`` and the aggregation weighted by
    ``edge_weight`` (an edata field's name or a tensor)."""

    def __init__(self, dgt, gen):
        super().__init__()
        self.conv1 = dgt.nn.GraphConv(FEAT, HIDDEN, norm="none",
                                      activation=torch.relu, generator=gen)
        self.conv2 = dgt.nn.GraphConv(HIDDEN, CLASSES, norm="none",
                                      generator=gen)
        self.edge_weight = None

    def forward(self, g, x):
        ew = self.edge_weight
        return self.conv2(g, self.conv1(g, x, edge_weight=ew),
                          edge_weight=ew)


def phase_tiled_gcn(dgt, tts, gt, x, y, train):
    """Phase 13 (route 1): 10 Adam steps of the GCN through K3; K3's
    count is set to 0 just before and read just after."""
    model = GCN(dgt, torch.Generator(device="cuda").manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    torch.cuda.reset_peak_memory_stats()
    tts.tiled_spmm.launches = 0
    losses, step_s = train_loop("tiled GCN", model, opt, gt, x, y, train)
    k3 = tts.tiled_spmm.launches
    log(f"# tiled GCN train: median step {step_s * 1e3:.3f} ms after one "
        f"warm-up step, {gt.num_edges() / step_s:.6g} train-edges/s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes, "
        f"K3 launches {k3}")
    if k3 != 4 * STEPS:
        raise AssertionError(f"K3 launched {k3} times, not {4 * STEPS}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"tiled GCN losses do not fall: {losses}")
    return model, opt, k3


def phase_weighted_gcn(dgt, tts, gt, x, y, train):
    """Phase 14 (route 3): static slot weights against route 1's logits,
    then learnable weights against the gather path."""
    from dgl_tpu_torch.utils import config
    e = gt.num_edges()
    gt.edata["w"] = dgt.nn.EdgeWeightNorm("both")(
        gt, torch.ones(e, device="cuda"))
    gt.cache_edge_weights("w")
    plain = GCN(dgt, torch.Generator(device="cuda").manual_seed(0))
    model = WeightedGCN(dgt, torch.Generator(device="cuda").manual_seed(0))
    model.load_state_dict(plain.state_dict())
    with torch.no_grad():
        want = plain(gt, x)
        model.edge_weight = "w"
        k3 = tts.tiled_spmm.launches
        got = model(gt, x)
        torch.cuda.synchronize()
        static_launches = tts.tiled_spmm.launches - k3
    err = close(got, want, "static weighted logits vs route 1")
    log(f"# weighted GCN, static slot weights: logits max|err| {err:.3g} "
        f"against route 1, K3 launches {static_launches}")
    if static_launches != 2:
        raise AssertionError("the static route did not run through K3")

    w = gt.edata["w"].detach()

    def step():
        model.zero_grad()
        model.edge_weight = w.clone().requires_grad_()
        loss = loss_fn(model, gt, x, y, train)
        loss.backward()
        return loss.item(), [p.grad.clone() for p in model.parameters()] + [
            model.edge_weight.grad]

    k3 = tts.tiled_spmm.launches
    loss_k, grad_k = step()
    torch.cuda.synchronize()
    learn_launches = tts.tiled_spmm.launches - k3
    config.set_use_kernels(False)
    try:
        loss_g, grad_g = step()
    finally:
        config.set_use_kernels(True)
    if abs(loss_k - loss_g) > 1e-4 * abs(loss_g):
        raise AssertionError(f"loss {loss_k} (K3) vs {loss_g} (gather)")
    for i, (a, b) in enumerate(zip(grad_k, grad_g)):
        close(a, b, f"weighted GCN grad {i}", rtol=1e-3, atol=1e-5)
    log(f"# weighted GCN, learnable weights: loss {loss_k:.8f} vs gather "
        f"path {loss_g:.8f}, {len(grad_k)} gradients agree (dEw included), "
        f"K3 launches {learn_launches}")
    if learn_launches != 4:
        raise AssertionError("the learnable route did not run through K3")
    del gt.edata["w"]
    gt.unit().uncache_edge_weights("w")
    return static_launches + learn_launches


def phase_tiled_gat(dgt, tts, gt, x, y, train):
    """Phase 15 (route 2): 10 Adam steps of the GAT with attention dropout
    0.6 on the tiled format; K4's counts are set to 0 just before and read
    just after."""
    model = GAT(dgt, torch.Generator(device="cuda").manual_seed(0), FEAT,
                attn_drop=ATTN_DROP)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    torch.cuda.reset_peak_memory_stats()
    tts.tiled_spmm_multihead.launches = 0
    tts.tiled_sddmm_dot_multihead.launches = 0
    losses, step_s = train_loop("tiled GAT", model, opt, gt, x, y, train)
    launches = (tts.tiled_spmm_multihead.launches,
                tts.tiled_sddmm_dot_multihead.launches)
    log(f"# tiled GAT train: median step {step_s * 1e3:.3f} ms after one "
        f"warm-up step, {gt.num_edges() / step_s:.6g} train-edges/s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes, "
        f"K4 launches {launches[0]} SpMM, {launches[1]} SDDMM")
    if launches != (4 * STEPS, 2 * STEPS):
        raise AssertionError(f"K4 launched {launches}, not "
                             f"({4 * STEPS}, {2 * STEPS})")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"tiled GAT losses do not fall: {losses}")
    return model, opt, launches


def bound(nbytes, ops, rate, peak=F32_PEAK):
    """(bound ms, what bounds it) for ``nbytes`` moved and ``ops``
    operations at ``peak`` per second (f32 by default)."""
    bytes_ms, ops_ms = nbytes / rate * 1e3, ops / peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def log_gathers(name, e, f, ms, rate, padded=None):
    """Log the rate at which the row walk ``name`` gathered its e rows of
    f f32 columns in ``ms``: above the memory rate, L2 served part of
    them.  ``padded``: the columns the walk loads where it pads f (44 for
    41), whose rate is logged beside."""
    tb_s = e * f * 4 / ms / 1e9
    pad = ("" if padded in (None, f) else f"; at the {padded} padded "
           f"columns it loads {e * padded * 4} B, "
           f"{e * padded * 4 / ms / 1e9:.3f} TB/s")
    log(f"# {name}: gathers {e * f * 4} B of rows, {tb_s:.3f} TB/s at its "
        f"time ({'above' if tb_s * 1e12 > rate else 'below'} the memory "
        f"rate, {rate / 1e12:.2f} TB/s){pad}")


def row_walk_bytes(tf, side, heads, f):
    """The bytes the row walk by ``side`` must move: its row view (slot
    and nbr, 8 B an edge; ptr and order, 8 B a row), the weights at the
    edges (4H B an edge), y read once and out written once (f f32 columns
    a node)."""
    view = tf.row_view(side)
    n_nbr = tf.num_src if side == "dst" else tf.num_dst
    return (view.nbytes + view.slot.numel() * 4 * heads
            + (view.rows + n_nbr) * f * 4)


def sddmm_walk_bytes(tf, heads, fh):
    """The bytes K4's SDDMM walk by dst must move: its row view, x and z
    read once (fh f32 columns a head) and e written at every slot (4H B a
    slot)."""
    return (tf.row_view("dst").nbytes
            + (tf.num_src + tf.num_dst) * heads * fh * 4
            + tf.num_buckets * tf.cap * 4 * heads)


def walk_bytes(slots, e):
    """The tiled format's slot arrays that a walk of its ``e`` edges must
    read: ``valid`` for each of the ``slots`` slots, the src and dst locals
    only for the edges (a padded slot's indices are not needed).  Per-slot
    inputs are likewise counted over the edges, outputs over every slot."""
    return slots * 4 + e * 8


def csr_pattern(gt, by="dst"):
    """The graph's (dst, src) CSR pattern for the library yardsticks, or
    with ``by="src"`` the transposed (src, dst) one: (crow (N+1,) int64,
    cols (E,) int32, order (E,)), where order[k] is the canonical edge at
    CSR position k."""
    row, col = gt.unit().coo()
    if by == "src":
        row, col = col, row
    order = torch.argsort(col * N_NODES + row)
    crow = torch.zeros(N_NODES + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(torch.bincount(col, minlength=N_NODES), 0)
    return crow, row[order].to(torch.int32), order


def block_csr(pattern, heads, w=None):
    """The (H N, H N) block-diagonal CSR whose block h holds head h's
    weights w.view(E, H)[:, h] (ones when None), int32 indices: one
    ``torch.sparse.mm`` of it with head-major x (H N, F) gives every
    head's weighted sum."""
    crow, src, order = pattern
    e = src.shape[0]
    crows = torch.cat([crow[:-1] + h * e for h in range(heads)]
                      + [crow[-1:] + (heads - 1) * e]).to(torch.int32)
    cols = torch.cat([src + h * N_NODES for h in range(heads)])
    vals = (torch.ones(heads * e, device="cuda") if w is None else
            torch.cat([torch.index_select(w.view(e, heads)[:, h], 0, order)
                       for h in range(heads)]))
    return torch.sparse_csr_tensor(crows, cols, vals,
                                   (heads * N_NODES, heads * N_NODES),
                                   check_invariants=False)


def batched_csr(pattern, heads):
    """The (H, N, N) batched CSR of H copies of the pattern, int32
    indices: the input of a batched ``torch.sparse.sampled_addmm``."""
    crow, src, _ = pattern
    return torch.sparse_csr_tensor(
        crow.to(torch.int32).expand(heads, -1).contiguous(),
        src.expand(heads, -1).contiguous(),
        torch.ones(heads, src.shape[0], device="cuda"),
        (heads, N_NODES, N_NODES), check_invariants=False)


def tiled_yardsticks(ef, tts, gt, rate):
    """Phase 16: K3 at F = 16 and K4 at (4, 32) and (1, 41) at full size,
    each against its plain version and its library call, with the
    timings.  The library calls: ``torch.sparse.mm`` on a CSR copy for K3
    and, block-diagonal over the heads on head-major x, for K4's SpMM;
    ``torch.sparse.sampled_addmm`` on an (H, N, N) batched CSR for K4's
    SDDMM."""
    fwd, _ = gt.unit().tiled_format()
    e = gt.num_edges()
    slots = fwd.num_buckets * fwd.cap
    gen = torch.Generator(device="cuda").manual_seed(16)
    pattern = csr_pattern(gt)
    rows = {}
    deg = max_degree(gt)

    x = grid(gen, N_NODES, HIDDEN, step=1 / 16, top=2)
    exact_sums(deg * 2, 1 / 16, "K3 full size")
    want = tts.tiled_spmm_plain(fwd, x)
    err = close(tts.tiled_spmm(fwd, x), want, "K3 full size F=16")
    a = block_csr(pattern, 1)
    close(torch.sparse.mm(a, x), want, "torch.sparse.mm F=16")
    nbytes = walk_bytes(slots, e) + 2 * x.numel() * 4
    b, by = bound(nbytes, 2 * e * HIDDEN, rate)
    rows["k3"] = {"max_abs_err": err,
                  "ms": cuda_ms(lambda: tts.tiled_spmm(fwd, x)),
                  "plain_ms": cuda_ms(lambda: tts.tiled_spmm_plain(fwd, x),
                                      reps=1),
                  "bound_ms": b, "bound_by": by,
                  "library_ms": cuda_ms(lambda: torch.sparse.mm(a, x))}
    log(f"# K3 F={HIDDEN}: {rows['k3']['ms']:.4f} ms (bound {b:.4f} ms by "
        f"{by}: {nbytes} B), plain {rows['k3']['plain_ms']:.4f} ms, "
        f"torch.sparse.mm {rows['k3']['library_ms']:.4f} ms, max|err| "
        f"{err:.3g}")
    del want, a

    pos = fwd.edge_slot().long()[pattern[2]]   # slot of CSR position k
    exact_sums(deg, 1 / 256, "K4 SpMM full size")    # |x|, w <= 1
    for heads, fh in GAT_SHAPES:
        x = grid(gen, N_NODES, heads, fh, step=1 / 16, top=1)
        z = torch.randn(N_NODES, heads, fh, device="cuda", generator=gen)
        w = grid(gen, e * heads, step=1 / 16, top=1, low=0)
        w_slot = ef._w_slot_from_flat(fwd, w, heads)
        feat_b = N_NODES * heads * fh * 4
        ops = 2 * e * heads * fh
        # the library calls take head-major operands, laid out beforehand
        xh = x.permute(1, 0, 2).contiguous()
        zh = z.permute(1, 0, 2).contiguous()
        aw = block_csr(pattern, heads, w)
        lib_s = cuda_ms(lambda: torch.sparse.mm(aw, xh.view(-1, fh)))
        close(torch.sparse.mm(aw, xh.view(-1, fh)).view(heads, N_NODES, fh),
              tts.tiled_spmm_multihead(fwd, x, w_slot, heads, fh)
              .permute(1, 0, 2), f"torch.sparse.mm block-diagonal H={heads}")
        del aw
        ab = batched_csr(pattern, heads)
        lib_d = cuda_ms(lambda: torch.sparse.sampled_addmm(
            ab, zh, xh.transpose(1, 2), beta=0.0))
        got = torch.sparse.sampled_addmm(ab, zh, xh.transpose(1, 2),
                                         beta=0.0).values()
        e_slot = tts.tiled_sddmm_dot_multihead(fwd, x, z, heads, fh)
        close(got, torch.stack([e_slot[:, h].reshape(-1)[pos]
                                for h in range(heads)]),
              f"torch.sparse.sampled_addmm batched H={heads}")
        del ab, got, e_slot, xh, zh
        for name, kernel, plain, nbytes, lib in (
                ("spmm_mh",
                 lambda: tts.tiled_spmm_multihead(fwd, x, w_slot, heads, fh),
                 lambda: tts.tiled_spmm_multihead_plain(fwd, x, w_slot),
                 row_walk_bytes(fwd, "dst", heads, heads * fh), lib_s),
                ("sddmm_mh",
                 lambda: tts.tiled_sddmm_dot_multihead(fwd, x, z, heads, fh),
                 lambda: tts.tiled_sddmm_dot_multihead_plain(fwd, x, z),
                 sddmm_walk_bytes(fwd, heads, fh), lib_d)):
            err = close(kernel(), plain(), f"K4 {name} full size H={heads} "
                        f"Fh={fh}")
            b, by = bound(nbytes, ops, rate)
            rows[f"{name}_{heads}"] = {
                "max_abs_err": err, "ms": cuda_ms(kernel),
                "plain_ms": cuda_ms(plain, reps=1), "bound_ms": b,
                "bound_by": by, "library_ms": lib}
            r = rows[f"{name}_{heads}"]
            # the bucket walk's bound before the row walk, in brackets
            old = bound(walk_bytes(slots, e) + slots * 4 * heads + 2 * feat_b,
                        ops, rate)[0] if name == "sddmm_mh" else None
            log(f"# K4 {name} H={heads} Fh={fh}: {r['ms']:.4f} ms (bound "
                f"{b:.4f} ms by {by}: {nbytes} B, {ops} ops"
                + ("" if old is None else f"; [{old:.4f}] by the slot "
                   "arrays") + f"), plain {r['plain_ms']:.4f} ms, library ("
                f"{'torch.sparse.mm' if name == 'spmm_mh' else 'sampled_addmm'}"
                f") {lib:.4f} ms, max|err| {err:.3g}")
            # the walks gather x rows, 16-byte vectors: (1, 41) at 44 columns
            log_gathers(f"K4 {name} H={heads} Fh={fh}", e, heads * fh,
                        r["ms"], rate, heads * -(-fh // 4) * 4)
        del x, z, w, w_slot
    return rows


# -- the slot-space slice -----------------------------------------------------

def k6_kernel_checks(tgf, fwd, heads, fh, gen, tag):
    """Each K6 kernel against its plain version on ``fwd``: (name,
    max|err|) pairs; each wrapper launches once (the reduce twice)."""
    n_src, n_dst = fwd.num_src, fwd.num_dst

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    el, er = randn(n_src, heads), randn(n_dst, heads)
    zn, rp = randn(n_dst, heads, fh), randn(n_dst, heads)
    x = randn(n_src, heads, fh)
    ee = randn(fwd.num_buckets, heads, fwd.cap) * fwd.valid.view(
        fwd.num_buckets, 1, fwd.cap)
    counters = (tgf.gat_scores, tgf.slot_reduce, tgf.gat_ds,
                tgf.src_aggregate)
    before = [k.launches for k in counters]
    errs = []
    for bias in (None, ee):
        p, g = tgf.gat_scores(fwd, el, er, SLOPE, bias)
        want = tgf.gat_scores_plain(fwd, el, er, SLOPE, bias)
        suffix = "" if bias is None else "+ee"
        errs += [(f"p{suffix}", close(p, want[0], f"{tag} p{suffix}")),
                 (f"g{suffix}", close(g, want[1], f"{tag} g{suffix}"))]
    for side in ("dst", "src"):
        errs.append((f"reduce {side}",
                     close(tgf.slot_reduce(fwd, g, side),
                           tgf.slot_reduce_plain(fwd, g, side),
                           f"{tag} slot reduce {side}")))
    errs.append(("ds", close(tgf.gat_ds(fwd, x, zn, rp, g),
                             tgf.gat_ds_plain(fwd, x, zn, rp, g),
                             f"{tag} ds")))
    errs.append(("src agg", close(tgf.src_aggregate(fwd, zn, p),
                                  tgf.src_aggregate_plain(fwd, zn, p),
                                  f"{tag} src_aggregate")))
    torch.cuda.synchronize()
    launched = [k.launches - b for k, b in zip(counters, before)]
    if launched != [2, 2, 1, 1]:
        raise AssertionError(f"{tag}: K6 launches {launched}, not "
                             "[2, 2, 1, 1]")
    return errs


def phase_gat_fused_mid(dgt, tts, tgf, ef):
    """Phase 17: the K6 kernels against their plain versions at mid size;
    GATConv on K6 against edgeflat's gather path and DotGatConv on K8
    against its gather path (``use_kernels(False)``)."""
    from dgl_tpu_torch.utils import config
    row, col, n_src, n_dst = mid_graph()
    fwd = tts.build_tiled_format_device(row, col, n_src, n_dst,
                                        device="cuda").with_src_first()
    gen = torch.Generator(device="cuda").manual_seed(17)
    for heads, fh in TILED_MH_SHAPES:
        errs = k6_kernel_checks(tgf, fwd, heads, fh, gen,
                                f"K6 mid H={heads} Fh={fh}")
        log(f"# K6 mid H={heads} Fh={fh}: max|err| " + ", ".join(
            f"{name} {err:.3g}" for name, err in errs))
    row_walk_mid(tts, tgf, ef, "src")

    gr = dgt.graph((row, col), num_nodes=n_src, device="cuda")
    gr.create_tiled_format()
    feat = 64
    x = torch.randn(n_src, feat, device="cuda", generator=gen)
    mseed = torch.Generator(device="cuda").manual_seed(18)
    for conv, counter in (
            (dgt.nn.GATConv(feat, 32, 4, residual=True, generator=mseed),
             tgf.gat_scores),
            (dgt.nn.DotGatConv(feat, 32, 4, generator=mseed),
             tts.tiled_sddmm_dot_multihead)):
        name = type(conv).__name__

        def step():
            conv.zero_grad()
            xs = x.clone().requires_grad_()
            out = conv(gr, xs)
            out.square().mean().backward()
            return [out.detach(), xs.grad] + [p.grad.clone()
                                              for p in conv.parameters()]

        before = counter.launches
        kern = step()
        torch.cuda.synchronize()
        if counter.launches - before != 1:
            raise AssertionError(f"{name} did not run through its kernels")
        config.set_use_kernels(False)
        try:
            ref = step()
        finally:
            config.set_use_kernels(True)
        err = close(kern[0], ref[0], f"{name} kernels vs gather path")
        for i, (a, b) in enumerate(zip(kern[1:], ref[1:])):
            close(a, b, f"{name} grad {i}", rtol=1e-3, atol=1e-5)
        log(f"# {name} mid size, {'K6' if counter is tgf.gat_scores else 'K8'}"
            f" vs gather path: out max|err| {err:.3g}, {len(kern) - 1} "
            f"gradients agree")


K6_COUNTERS = ("gat_scores", "slot_reduce", "gat_ds", "src_aggregate")
K9_COUNTERS = ("vattn_scores", "vattn_slot_grad", "vattn_node_grad")
K10_COUNTERS = ("edgegat_scores", "slot_feat_reduce", "edgegat_ds")
# K11 v1's three kernels, then K10 v1's
V1_COUNTERS = ("egatc_scores", "egatc_slot_grad", "slot_vec_reduce",
               "fe_aggregate", "fe_ds", "dx_dfe")
NO_K9 = {name: 0 for name in K9_COUNTERS}
NO_K10 = {name: 0 for name in K10_COUNTERS}
NO_V1 = {name: 0 for name in V1_COUNTERS}
SLOT_COUNTERS = K6_COUNTERS + K9_COUNTERS + K10_COUNTERS + V1_COUNTERS


def reset_counts(tts, tgf):
    for name in SLOT_COUNTERS:
        getattr(tgf, name).launches = 0
    tts.tiled_spmm_multihead.launches = 0
    tts.tiled_sddmm_dot_multihead.launches = 0


def read_counts(tts, tgf):
    counts = {name: getattr(tgf, name).launches for name in SLOT_COUNTERS}
    counts["k4_spmm"] = tts.tiled_spmm_multihead.launches
    counts["k4_sddmm"] = tts.tiled_sddmm_dot_multihead.launches
    return counts


def phase_route4(dgt, tts, tgf, gt, x, y, train):
    """Phase 18 (route 4): 10 Adam steps of the GAT without attention
    dropout on the tiled format; K6's and K4's counts are set to 0 just
    before and read just after."""
    model = GAT(dgt, torch.Generator(device="cuda").manual_seed(0), FEAT,
                attn_drop=0.0)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(tts, tgf)
    losses, step_s = train_loop("route 4", model, opt, gt, x, y, train)
    counts = read_counts(tts, tgf)
    log(f"# route 4 train: median step {step_s * 1e3:.3f} ms after one "
        f"warm-up step, {gt.num_edges() / step_s:.6g} train-edges/s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes, "
        f"launches {counts}")
    # per step and layer: scores, den; K4's SpMM for the numerator; ds,
    # der, del and dx; K4's SDDMM never
    want = {"gat_scores": 2, "slot_reduce": 6, "gat_ds": 2,
            "src_aggregate": 2, "k4_spmm": 2, "k4_sddmm": 0,
            **NO_K9, **NO_K10, **NO_V1}
    if counts != {k: v * STEPS for k, v in want.items()}:
        raise AssertionError(f"route 4 launches {counts}, not {want} a step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"route 4 losses do not fall: {losses}")
    return model, opt, counts


def gat_edgeflat(ef, conv, g, h):
    """One GATConv layer (no residual, attention dropout off) through
    edgeflat's functions, on the layer's own weights."""
    unit = g.unit()
    heads, dim = conv.num_heads, conv.out_feats
    ft = conv.fc(h).reshape(-1, heads, dim)
    el = (ft * conv.attn_l).sum(-1)
    er = (ft * conv.attn_r).sum(-1)
    e = torch.nn.functional.leaky_relu(ef.sddmm_flat(unit, "add", el, er),
                                       conv.negative_slope)
    rst = ef.spmm_mul_flat(unit, ft, ef.edge_softmax_flat(unit, e, heads),
                           heads)
    return rst + conv.bias


def phase_route4_check(ef, model, gt, x, y, train):
    """One step of route 4's model on K6 against the same weights through
    edgeflat's functions: loss and every gradient."""

    def grads(forward):
        model.zero_grad()
        logits = forward()
        loss = torch.nn.functional.cross_entropy(logits[train], y[train])
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}

    loss_k, grad_k = grads(lambda: model(gt, x))

    def edgeflat_forward():
        h = torch.nn.functional.elu(
            gat_edgeflat(ef, model.conv1, gt, x).flatten(1))
        return gat_edgeflat(ef, model.conv2, gt, h).flatten(1)

    loss_e, grad_e = grads(edgeflat_forward)
    if abs(loss_k - loss_e) > 1e-4 * abs(loss_e):
        raise AssertionError(f"loss {loss_k} (K6) vs {loss_e} (edgeflat)")
    for n in grad_k:
        close(grad_k[n], grad_e[n], f"route 4 grad {n}", rtol=1e-3,
              atol=1e-5)
    log(f"# route 4, K6 vs edgeflat at full size: loss {loss_k:.8f} vs "
        f"{loss_e:.8f}, {len(grad_k)} gradients agree")


def phase_gat_eval(tts, tgf, model, gt, x, y):
    """The phase-15 GAT (attention dropout 0.6) in eval mode: one forward,
    the validation pass, on K6; counts set to 0 just before."""
    model.eval()
    reset_counts(tts, tgf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model(gt, x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts(tts, tgf)
    if logits.shape != (N_NODES, CLASSES) or not torch.isfinite(
            logits).all():
        raise AssertionError("eval logits are not finite of shape "
                             f"{(N_NODES, CLASSES)}")
    acc = float((logits.argmax(1) == y).float().mean())
    log(f"# eval forward of the dropout-0.6 GAT on K6: {ms:.3f} ms, "
        f"accuracy on all nodes {acc:.4f}, launches {counts}")
    if counts != {"gat_scores": 2, "slot_reduce": 2, "gat_ds": 0,
                  "src_aggregate": 0, "k4_spmm": 2, "k4_sddmm": 0,
                  **NO_K9, **NO_K10, **NO_V1}:
        raise AssertionError(f"the eval forward did not run on K6: {counts}")


DOTGAT_STEPS = 3


def phase_dotgat(dgt, tts, tgf, gt):
    """Phase 19: DotGatConv(64, 32, 4) forward and backward of
    (out^2).mean() for 3 steps, as tools/perf_gat_full_reddit.py:88-107;
    counts set to 0 just before and read just after."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    conv = dgt.nn.DotGatConv(64, 32, 4, generator=gen)
    xs = [torch.randn(N_NODES, 64, device="cuda", generator=gen)
          for _ in range(DOTGAT_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts(tts, tgf)
    times = []
    for xi in xs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        conv.zero_grad()
        loss = conv(gt, xi).square().mean()
        loss.backward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not np.isfinite(loss.item()):
            raise AssertionError("DotGat loss is not finite")
    counts = read_counts(tts, tgf)
    log(f"# DotGatConv(64, 32, 4) forward + backward: "
        f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes, "
        f"launches {counts}")
    # per step: K4's SDDMM (scores), den, K4's SpMM (numerator, dq), ds,
    # the src-side aggregation (dk, dx)
    want = {"gat_scores": 0, "slot_reduce": 1, "gat_ds": 1,
            "src_aggregate": 2, "k4_spmm": 2, "k4_sddmm": 1, **NO_K9,
            **NO_K10, **NO_V1}
    if counts != {k: v * DOTGAT_STEPS for k, v in want.items()}:
        raise AssertionError(f"DotGat launches {counts}, not {want} a step")
    if not all(torch.isfinite(p.grad).all() for p in conv.parameters()):
        raise AssertionError("DotGat gradients are not finite")
    return counts


def slot_ids(fwd, side):
    """(B * C,) int64 global dst (or src) id of every slot; padded slots
    name row 0 of their tile."""
    tiles = fwd.dst_tile if side == "dst" else fwd.src_tile
    local = fwd.dst_local if side == "dst" else fwd.src_local
    return (tiles.long()[:, None] * fwd.tile
            + local.view(fwd.num_buckets, fwd.cap)).reshape(-1)


def k6_yardsticks(tgf, tts, gt, heads, fh, rate, scores=True,
                  sides=("dst", "src"), ds=True, bias=False):
    """Phase 20: each K6 kernel at full size against its plain version,
    with the timings, the bound and the library call where there is
    one.  ``scores``, ``sides`` and ``ds`` leave out the rows a caller
    does not launch (route 5 launches neither the scores nor the src side);
    ``bias`` adds the scores with a per-slot bias (K10 v1's)."""
    fwd, _ = gt.unit().tiled_format()
    e = gt.num_edges()
    b, cap = fwd.num_buckets, fwd.cap
    slots = b * cap
    gen = torch.Generator(device="cuda").manual_seed(heads * 100 + fh)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    # logits of a trained layer's size (p within a few units), so that
    # the sums of p over a node's edges stay exact on their grid
    el, er = 0.25 * randn(N_NODES, heads), 0.25 * randn(N_NODES, heads)
    x, zn = randn(N_NODES, heads, fh), randn(N_NODES, heads, fh)
    rp = randn(N_NODES, heads)
    p, g = tgf.gat_scores(fwd, el, er, SLOPE)
    # the sums over a node's edges (reduce, src_agg) take p rounded to a
    # grid of 1/16 and zq on a grid of 1/2
    p = (p * 16).round() / 16
    zq = grid(gen, N_NODES, heads, fh, step=1 / 2, top=1)
    exact_sums(max_degree(gt) * float(p.max()), 1 / 32, f"K6 H={heads}")
    node, feat_b = N_NODES * heads * 4, N_NODES * heads * fh * 4
    slot_h, edge_h = slots * heads * 4, e * heads * 4
    walk = walk_bytes(slots, e)
    rows = {}

    def row(name, kernel, plain, nbytes, ops, lib=None, lib_name=None):
        got = kernel()
        want = plain()
        err = max(close(a, w, f"K6 {name} full size H={heads} Fh={fh}")
                  for a, w in zip(got if isinstance(got, tuple) else (got,),
                                  want if isinstance(want, tuple)
                                  else (want,)))
        del got, want
        bnd, by = bound(nbytes, ops, rate)
        r = {"max_abs_err": err, "ms": cuda_ms(kernel),
             "plain_ms": cuda_ms(plain, reps=1), "bound_ms": bnd,
             "bound_by": by, "library_ms": lib}
        rows[name] = r
        log(f"# K6 {name} H={heads} Fh={fh}: {r['ms']:.4f} ms (bound "
            f"{bnd:.4f} ms by {by}: {nbytes} B, {ops} ops), plain "
            f"{r['plain_ms']:.4f} ms, library "
            + (f"({lib_name}) {lib:.4f} ms" if lib is not None else "none")
            + f", max|err| {err:.3g}")

    # scores: in the slot arrays, el, er; out p, g at every slot
    if scores:
        row("scores", lambda: tgf.gat_scores(fwd, el, er, SLOPE),
            lambda: tgf.gat_scores_plain(fwd, el, er, SLOPE),
            walk + 2 * node + 2 * slot_h, 8 * e * heads)
    # with the bias: in also ee at the edges
    if bias:
        ee = 0.25 * randn(b, heads, cap) * fwd.valid.view(b, 1, cap)
        row("scores_bias", lambda: tgf.gat_scores(fwd, el, er, SLOPE, ee),
            lambda: tgf.gat_scores_plain(fwd, el, er, SLOPE, ee),
            walk + 2 * node + edge_h + 2 * slot_h, 9 * e * heads)
        del ee

    # the slot reduce: one index_add_ of head-major slot values at the
    # slots' global ids computes each side
    for side in sides:
        ids = slot_ids(fwd, side)
        vals_h = p.permute(1, 0, 2).reshape(heads, -1).contiguous()

        def lib_call():
            return torch.zeros(heads, N_NODES, device="cuda").index_add_(
                1, ids, vals_h)

        close(lib_call().t(), tgf.slot_reduce(fwd, p, side),
              f"index_add_ {side} H={heads}")
        lib = cuda_ms(lib_call)
        del vals_h, ids
        # in: valid at every slot, one side's local and the values at the
        # edges; out: one row per node
        row(f"reduce_{side}", lambda: tgf.slot_reduce(fwd, p, side),
            lambda: tgf.slot_reduce_plain(fwd, p, side),
            slots * 4 + e * 4 + edge_h + node
            + (b * 4 if side == "src" else 0),
            e * heads, lib, "index_add_")

    # ds: in the slot arrays, g, x, zn, rp; out ds at every slot
    if ds:
        row("ds", lambda: tgf.gat_ds(fwd, x, zn, rp, g),
            lambda: tgf.gat_ds_plain(fwd, x, zn, rp, g),
            walk + edge_h + slot_h + 2 * feat_b + node,
            e * heads * (2 * fh + 2))
    del g

    # the src-side aggregation: one torch.sparse.mm of the block-diagonal
    # (H N, H N) CSR over the transposed pattern, weighted by p, with
    # head-major zq
    pattern = csr_pattern(gt, by="src")
    slot = fwd.edge_slot().long()
    p_edge = p.permute(0, 2, 1).reshape(slots, heads)[slot].reshape(-1)
    del slot
    aw = block_csr(pattern, heads, p_edge)
    del p_edge, pattern
    zh = zq.permute(1, 0, 2).contiguous().view(-1, fh)
    close(torch.sparse.mm(aw, zh).view(heads, N_NODES, fh).permute(1, 0, 2),
          tgf.src_aggregate(fwd, zq, p),
          f"torch.sparse.mm block-diagonal transposed H={heads}")
    lib = cuda_ms(lambda: torch.sparse.mm(aw, zh))
    del aw, zh
    row("src_agg", lambda: tgf.src_aggregate(fwd, zq, p),
        lambda: tgf.src_aggregate_plain(fwd, zq, p),
        row_walk_bytes(fwd, "src", heads, heads * fh), 2 * e * heads * fh,
        lib, "torch.sparse.mm")
    log_gathers(f"K6 src_agg H={heads} Fh={fh}", e, heads * fh,
                rows["src_agg"]["ms"], rate)
    return rows


# -- the vector-attention slice (GATv2, EGATConv) -----------------------------

GATV2_SHAPES = ((8, 8), (1, CLASSES))   # examples/gatv2.py:22-28
VATTN_SHAPES = ((8, 8), (1, 41), (4, 32))
EGAT_SLOPE = 0.01
# tools/perf_egat128.py:27-80: 23M uniform random edges over the Reddit
# node count, EGATConv(64, 16, 32, 32, 4) without edge outputs
EGAT_E, EGAT_FIN, EGAT_FE, EGAT_H, EGAT_D = 23_000_000, 64, 16, 4, 32
EGAT_STEPS = 4


class GATv2(torch.nn.Module):
    """feat -> GATv2Conv(8 heads x 8) -> elu -> GATv2Conv(1 head x 41), as
    examples/gatv2.py:22-28 (attn_drop 0, its default)."""

    def __init__(self, dgt, gen, feat):
        super().__init__()
        (h1, d1), (h2, d2) = GATV2_SHAPES
        self.conv1 = dgt.nn.GATv2Conv(feat, d1, h1, generator=gen)
        self.conv2 = dgt.nn.GATv2Conv(h1 * d1, d2, h2, generator=gen)

    def forward(self, g, x):
        h = torch.nn.functional.elu(self.conv1(g, x).flatten(1))
        return self.conv2(g, h).flatten(1)


def vattn_inputs(tf, heads, dim, fe, gen):
    """U, V, attn, ds and, with fe > 0, slot edge features and wf with the
    bias row, on the format ``tf``.  U, V, attn and wf are multiples of
    1/16 and the edge features are in {-1, 0, 1}, so raw = U + V + FE is
    exact in f32 in any order: the kernels and the plain versions then
    agree on the side of lrelu's kink, which at EGAT's slope of 0.01
    changes dW a hundredfold.  ds is a multiple of 1/8 in [-1, 1], so
    that with a slope of 1/4 the node gradient's sums are exact too."""

    def exact(*shape, top=0.5):
        return grid(gen, *shape, step=1 / 16, top=top)

    b, cap = tf.num_buckets, tf.cap
    U = exact(tf.num_src, heads, dim, top=1)
    V = exact(tf.num_dst, heads, dim, top=1)
    attn = exact(heads, dim)
    ds = (grid(gen, b, heads, cap, step=1 / 8, top=1)
          * tf.valid.view(b, 1, cap))
    ef = wf = None
    if fe:
        ef = torch.randint(-1, 2, (b, cap, fe), device="cuda",
                           generator=gen).float() * tf.valid.view(b, cap, 1)
        wf = exact(fe + 1, heads * dim)
    return U, V, attn, ds, ef, wf


def close_sum(got, want, what):
    """``close`` for sums over every edge (da, dWf): atol scaled by the
    largest magnitude, since they grow with the edge count."""
    return close(got, want, what,
                 atol=ATOL * max(1.0, float(want.abs().max())))


def vattn_kernel_checks(tgf, tf, heads, dim, fe, gen, tag):
    """Each K9 / K11 v2 kernel against its plain version on ``tf``, with
    the edge term when fe > 0: (name, max|err|) pairs."""
    U, V, attn, ds, ef, wf = vattn_inputs(tf, heads, dim, fe, gen)
    slope = EGAT_SLOPE if fe else SLOPE
    counters = [getattr(tgf, name) for name in K9_COUNTERS]
    before = [k.launches for k in counters]
    errs = [("p", close(tgf.vattn_scores(tf, U, V, attn, slope, ef, wf),
                        tgf.vattn_scores_plain(tf, U, V, attn, slope, ef,
                                               wf), f"{tag} p"))]
    got = tgf.vattn_slot_grad(tf, U, V, attn, ds, slope, ef, wf)
    want = tgf.vattn_slot_grad_plain(tf, U, V, attn, ds, slope, ef, wf)
    for name, a, w in zip(("da", "d_ef", "dwf"), got, want):
        if a is not None:
            check = close if name == "d_ef" else close_sum
            errs.append((name, check(a, w, f"{tag} {name}")))
    for side, name in (("dst", "dV"), ("src", "dU")):
        errs.append((name, close(
            tgf.vattn_node_grad(tf, U, V, attn, ds, slope, side, ef, wf),
            tgf.vattn_node_grad_plain(tf, U, V, attn, ds, slope, side, ef,
                                      wf), f"{tag} {name}")))
    torch.cuda.synchronize()
    launched = [k.launches - b for k, b in zip(counters, before)]
    if launched != [1, 1, 2]:
        raise AssertionError(f"{tag}: K9 launches {launched}, not [1, 1, 2]")
    return errs


def phase_gatv2_mid(dgt, tts, tgf):
    """Phase 21: each K9 / K11 v2 kernel against its plain version at mid
    size, without and with the edge term (16 features and the bias row);
    then the 2-layer GATv2 through K9 against its edge chain
    (``use_kernels(False)``)."""
    from dgl_tpu_torch.utils import config
    row, col, n_src, n_dst = mid_graph()
    fwd = tts.build_tiled_format_device(row, col, n_src, n_dst,
                                        device="cuda").with_src_first()
    gen = torch.Generator(device="cuda").manual_seed(21)
    for heads, dim in VATTN_SHAPES:
        for fe in (0, EGAT_FE):
            tag = f"K9 mid H={heads} D={dim}" + (f" Fe={fe}+1" if fe else "")
            errs = vattn_kernel_checks(tgf, fwd, heads, dim, fe, gen, tag)
            log(f"# {tag}: max|err| " + ", ".join(
                f"{name} {err:.3g}" for name, err in errs))

    gr = dgt.graph((row, col), num_nodes=n_src, device="cuda")
    gr.create_tiled_format()
    feat = 64
    x = torch.randn(n_src, feat, device="cuda", generator=gen)
    y = torch.randint(0, CLASSES, (n_src,), device="cuda", generator=gen)
    model = GATv2(dgt, torch.Generator(device="cuda").manual_seed(22), feat)
    train = torch.arange(n_dst, device="cuda")

    def step():
        model.zero_grad()
        logits = model(gr, x)
        torch.nn.functional.cross_entropy(logits[train],
                                          y[train]).backward()
        return logits.detach(), {n: p.grad.clone()
                                 for n, p in model.named_parameters()}

    before = tgf.vattn_scores.launches
    out_k, grad_k = step()
    torch.cuda.synchronize()
    if tgf.vattn_scores.launches - before != 2:
        raise AssertionError("the GATv2 did not run through K9")
    config.set_use_kernels(False)
    try:
        out_c, grad_c = step()
    finally:
        config.set_use_kernels(True)
    err = close(out_k, out_c, "GATv2 K9 vs edge chain")
    for n in grad_k:
        close(grad_k[n], grad_c[n], f"GATv2 grad {n}", rtol=1e-3, atol=1e-5)
    log(f"# GATv2 mid size, K9 vs edge chain: logits max|err| {err:.3g}, "
        f"{len(grad_k)} gradients agree")


def phase_route5(dgt, tts, tgf, gt, x, y, train):
    """Phase 22 (route 5): the GATv2 recipe for 10 AdamW steps (lr 5e-3,
    weight decay 5e-4, as examples/gatv2.py:31) on the tiled format, both
    layers on K9; the counts are set to 0 just before and read just
    after."""
    model = GATv2(dgt, torch.Generator(device="cuda").manual_seed(0), FEAT)
    opt = torch.optim.AdamW(model.parameters(), lr=5e-3, weight_decay=5e-4)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(tts, tgf)
    losses, step_s = train_loop("route 5", model, opt, gt, x, y, train)
    counts = read_counts(tts, tgf)
    log(f"# route 5 train: median step {step_s * 1e3:.3f} ms after one "
        f"warm-up step, {gt.num_edges() / step_s:.6g} train-edges/s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes, "
        f"loss {losses[0]:.6f} -> {losses[-1]:.6f}, launches {counts}")
    # per step and layer: scores, den, K4's SpMM for the numerator; ds,
    # the slot gradient (da), the node gradient on both sides, dx
    want = {"gat_scores": 0, "slot_reduce": 2, "gat_ds": 2,
            "src_aggregate": 2, "k4_spmm": 2, "k4_sddmm": 0,
            "vattn_scores": 2, "vattn_slot_grad": 2, "vattn_node_grad": 4,
            **NO_K10, **NO_V1}
    if counts != {k: v * STEPS for k, v in want.items()}:
        raise AssertionError(f"route 5 launches {counts}, not {want} a step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"route 5 losses do not fall: {losses}")
    return model, opt, counts


class PlainVectorAttention(torch.autograd.Function):
    """K9's attention built from the plain versions alone, for values x =
    U as GATv2Conv passes them: the twin of the port's autograd function."""

    @staticmethod
    def forward(ctx, U3, V3, attn, tf, slope):
        from dgl_tpu_torch.ops.kernels import gat_fused as tgf
        from dgl_tpu_torch.ops.kernels import tiled_spmm as tts
        p = tgf.vattn_scores_plain(tf, U3, V3, attn, slope)
        den = tgf.slot_reduce_plain(tf, p, "dst").clamp_(min=tgf.DEN_EPS)
        out = tts.tiled_spmm_multihead_plain(tf, U3, p) / den.unsqueeze(-1)
        ctx.save_for_backward(U3, V3, attn, p, den, out)
        ctx.tf, ctx.slope = tf, slope
        return out

    @staticmethod
    def backward(ctx, dz):
        from dgl_tpu_torch.ops.kernels import gat_fused as tgf
        U3, V3, attn, p, den, out = ctx.saved_tensors
        tf, slope = ctx.tf, ctx.slope
        zn, rp = tgf._scales(out, dz, den)
        ds = tgf.gat_ds_plain(tf, U3, zn, rp, p)
        da = tgf.vattn_slot_grad_plain(tf, U3, V3, attn, ds, slope)[0]
        dV = tgf.vattn_node_grad_plain(tf, U3, V3, attn, ds, slope, "dst")
        dU = tgf.vattn_node_grad_plain(tf, U3, V3, attn, ds, slope, "src")
        del ds
        return dU + tgf.src_aggregate_plain(tf, zn, p), dV, da, None, None


def gatv2_plain_layer(conv, tf, h):
    """One GATv2Conv layer (no residual) through the plain versions, on
    the layer's own weights."""
    heads, dim = conv.num_heads, conv.out_feats
    ft_src = conv.fc_src(h).reshape(-1, heads, dim)
    ft_dst = conv.fc_dst(h).reshape(-1, heads, dim)
    return PlainVectorAttention.apply(ft_src, ft_dst, conv.attn[0], tf,
                                      conv.negative_slope)


def phase_route5_check(model, gt, x, y, train):
    """One step of route 5's model on K9 against the same step built from
    the plain versions: loss and every gradient."""
    tf = gt.unit().tiled_format()[0]

    def grads(forward):
        model.zero_grad()
        logits = forward()
        loss = torch.nn.functional.cross_entropy(logits[train], y[train])
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}

    loss_k, grad_k = grads(lambda: model(gt, x))

    def plain_forward():
        h = torch.nn.functional.elu(
            gatv2_plain_layer(model.conv1, tf, x).flatten(1))
        return gatv2_plain_layer(model.conv2, tf, h).flatten(1)

    loss_p, grad_p = grads(plain_forward)
    if abs(loss_k - loss_p) > 1e-4 * abs(loss_p):
        raise AssertionError(f"loss {loss_k} (K9) vs {loss_p} (plain)")
    for n in grad_k:
        close(grad_k[n], grad_p[n], f"route 5 grad {n}", rtol=1e-3,
              atol=1e-5)
    log(f"# route 5, K9 vs its plain versions at full size: loss "
        f"{loss_k:.8f} vs {loss_p:.8f}, {len(grad_k)} gradients agree")


def egat_graph(dgt):
    """Phase 23's graph (tools/perf_egat128.py:28-36): 23M uniform random
    edges from seed 0 over the Reddit node count, its tiled format, node
    features (N, 64) and edge features (E, 16) made on the card, and the
    edge features in slot order."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    row = rng.integers(0, N_NODES, EGAT_E)
    col = rng.integers(0, N_NODES, EGAT_E)
    g = dgt.graph((row, col), num_nodes=N_NODES, device="cuda")
    g.create_tiled_format()
    gen = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn(N_NODES, EGAT_FIN, device="cuda", generator=gen)
    ef = torch.randn(EGAT_E, EGAT_FE, device="cuda", generator=gen)
    ef_slot = dgt.nn.EGATConv.slot_edge_feats(g, ef)
    torch.cuda.synchronize()
    tf = g.unit().tiled_format()[0]
    log(f"# EGAT graph, tiled format and slot edge features in "
        f"{time.perf_counter() - t0:.1f}s: {g.num_edges()} edges, tile "
        f"{tf.tile}, cap {tf.cap}, {tf.num_buckets} buckets, fill "
        f"{g.num_edges() / (tf.num_buckets * tf.cap):.4f}")
    return g, x, ef, ef_slot


def phase_egat(dgt, tts, tgf, g, x, ef, ef_slot):
    """Phase 23: EGATConv(64, 16, 32, 32, 4) with compute_edge_feats=False,
    loss (out^2).mean(), Adam 1e-3 (tools/perf_egat128.py:45-80), on K11
    v2; the counts are set to 0 just before and read just after."""
    conv = dgt.nn.EGATConv(EGAT_FIN, EGAT_FE, EGAT_D, EGAT_D, EGAT_H,
                           generator=torch.Generator(device="cuda")
                           .manual_seed(24))
    opt = torch.optim.Adam(conv.parameters(), lr=1e-3)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(tts, tgf)
    times, losses = [], []
    for step in range(EGAT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        h, _ = conv(g, x, ef, compute_edge_feats=False, efeats_slot=ef_slot)
        loss = h.square().mean()
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = read_counts(tts, tgf)
    step_s = statistics.median(times[1:])
    log(f"# EGATConv(64, 16, 32, 32, 4) on K11 v2: steps "
        f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms, median after one "
        f"warm-up step {step_s * 1e3:.3f} ms, "
        f"{g.num_edges() / step_s:.6g} train-edges/s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes, loss {losses[0]:.6f} "
        f"-> {losses[-1]:.6f}, launches {counts}")
    want = {"gat_scores": 0, "slot_reduce": 1, "gat_ds": 1,
            "src_aggregate": 1, "k4_spmm": 1, "k4_sddmm": 0,
            "vattn_scores": 1, "vattn_slot_grad": 1, "vattn_node_grad": 2,
            **NO_K10, **NO_V1}
    if counts != {k: v * EGAT_STEPS for k, v in want.items()}:
        raise AssertionError(f"EGAT launches {counts}, not {want} a step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"EGAT losses are not finite: {losses}")
    return conv, counts


def phase_egat_check(conv, g, x, ef, ef_slot):
    """One EGATConv step on K11 v2 against the same weights through the
    flat route (chunked logits, edgeflat): loss and every gradient."""

    def grads(**kw):
        conv.zero_grad()
        h, _ = conv(g, x, ef, compute_edge_feats=False, **kw)
        loss = h.square().mean()
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in conv.named_parameters()}

    loss_k, grad_k = grads(efeats_slot=ef_slot)
    loss_f, grad_f = grads()
    if abs(loss_k - loss_f) > 1e-4 * abs(loss_f):
        raise AssertionError(f"loss {loss_k} (K11 v2) vs {loss_f} (flat)")
    for n in grad_k:
        close(grad_k[n], grad_f[n], f"EGAT grad {n}", rtol=1e-3, atol=1e-5)
    log(f"# EGATConv, K11 v2 vs the flat route at 23M edges: loss "
        f"{loss_k:.8f} vs {loss_f:.8f}, {len(grad_k)} gradients agree")


def vattn_yardsticks(tgf, g, heads, dim, fe, rate):
    """Phase 24: each K9 / K11 v2 kernel at full size on ``g`` against its
    plain version, with the timings and the bound; no single PyTorch call
    computes any of them (each needs raw = U[src] + V[dst] (+ FE) formed
    per slot, then lrelu, the dot with attn or the scaling by ds).  K9
    takes a slope of 1/4 here, so that its node gradient's sums over the
    Reddit graph's hubs are exact (``vattn_inputs``); K11 v2 keeps EGAT's
    0.01, where the uniform graph's degrees stay near 100."""
    tf, e = g.unit().tiled_format()[0], g.num_edges()
    gen = torch.Generator(device="cuda").manual_seed(heads * 100 + dim)
    U, V, attn, ds, ef, wf = vattn_inputs(tf, heads, dim, fe, gen)
    slope = EGAT_SLOPE if fe else 0.25
    if not fe:       # |ds| <= 1, |attn| <= 1/2, on a grid of 1/8 * 1/16 * 1/4
        exact_sums(max_degree(g) / 2, 1 / 512, f"K9 H={heads} D={dim}")
    b, cap = tf.num_buckets, tf.cap
    slots, hd = b * cap, heads * dim
    rows = fe + 1 if fe else 0
    node_b = N_NODES * hd * 4
    slot_h, edge_h = slots * heads * 4, e * heads * 4
    walk = walk_bytes(slots, e)
    edge_b = e * fe * 4 + rows * hd * 4          # ef at the edges, wf
    fe_ops = 2 * rows * hd                       # FE per edge
    tag = f"H={heads} D={dim}" + (f" Fe={fe}+1" if fe else "")
    out = {}

    def row(name, kernel, plain, nbytes, ops, check=close):
        got, want = kernel(), plain()
        pairs = [(a, w) for a, w in zip(
            got if isinstance(got, tuple) else (got,),
            want if isinstance(want, tuple) else (want,)) if a is not None]
        err = max(check(a, w, f"K9 {name} full size {tag}")
                  for a, w in pairs)
        del got, want, pairs
        bnd, by = bound(nbytes, ops, rate)
        r = {"max_abs_err": err, "ms": cuda_ms(kernel),
             "plain_ms": cuda_ms(plain, reps=1), "bound_ms": bnd,
             "bound_by": by, "library_ms": None}
        out[name] = r
        log(f"# K9 {name} {tag}: {r['ms']:.4f} ms (bound {bnd:.4f} ms by "
            f"{by}: {nbytes} B, {ops} ops), plain {r['plain_ms']:.4f} ms, "
            f"library none, max|err| {err:.3g}")

    # scores: in the slot arrays, U, V, attn (and the edge term); out p at
    # every slot.  Per edge and column: raw, lrelu, the dot (5 ops); per
    # edge and head the clip and exp
    row("scores", lambda: tgf.vattn_scores(tf, U, V, attn, slope, ef, wf),
        lambda: tgf.vattn_scores_plain(tf, U, V, attn, slope, ef, wf),
        walk + 2 * node_b + hd * 4 + edge_b + slot_h,
        e * (5 * hd + fe_ops + 4 * heads))
    # the slot gradient as the main path calls it (no d(ef)): in the slot
    # arrays, ds, U, V, attn (and the edge term); out da (and dWf).  Per
    # edge and column: raw, lrelu, da (5 ops), with the edge term dW and
    # dWf (3 + 2 rows)
    row("slot_grad",
        lambda: tgf.vattn_slot_grad(tf, U, V, attn, ds, slope, ef, wf,
                                    need_def=False),
        lambda: tgf.vattn_slot_grad_plain(tf, U, V, attn, ds, slope, ef, wf,
                                          need_def=False),
        walk + edge_h + 2 * node_b + 2 * hd * 4 + edge_b + rows * hd * 4,
        e * hd * (5 + (fe_ops // hd + 3 + 2 * rows if fe else 0)),
        check=close_sum)
    # the node gradient on each side: in the slot arrays (and src_order),
    # ds, U, V, attn (and the edge term); out one row per node.  Per edge
    # and column: raw, dW, the add (5 ops)
    for side in ("dst", "src"):
        row(f"node_grad_{side}",
            lambda: tgf.vattn_node_grad(tf, U, V, attn, ds, slope, side, ef,
                                        wf),
            lambda: tgf.vattn_node_grad_plain(tf, U, V, attn, ds, slope,
                                              side, ef, wf),
            walk + (b * 4 if side == "src" else 0) + edge_h
            + 3 * node_b + hd * 4 + edge_b, e * (5 * hd + fe_ops))
    return out


# -- the EdgeGAT slice (EdgeGATConv on K10 v2) --------------------------------

EDGEGAT_SHAPES = ((4, 32), (1, 41), (8, 8))
EDGEGAT_FES = (EGAT_FE, 5)
# tools/perf_egat128.py:81-82: EdgeGATConv(64, 16, 32, 4), (out^2).mean(),
# Adam 1e-3, on phase 23's graph
EDGEGAT_STEPS = 4


def edgegat_inputs(tf, heads, fh, fe, gen):
    """el, er, slot edge features, We, attn_e and M = We . attn_e on
    ``tf``.  el and er are multiples of 1/16 in [-1, 1], We and attn_e in
    [-1/4, 1/4] and the edge features in {-1, 0, 1}: M is a multiple of
    1/256 and the logit el + er + ef . M is exact in f32 in any order, so
    the kernel and the plain version take the same side of lrelu's
    kink."""
    b, cap = tf.num_buckets, tf.cap
    el = grid(gen, tf.num_src, heads, step=1 / 16, top=1)
    er = grid(gen, tf.num_dst, heads, step=1 / 16, top=1)
    ef = torch.randint(-1, 2, (b, cap, fe), device="cuda",
                       generator=gen).float() * tf.valid.view(b, cap, 1)
    We = grid(gen, fe, heads * fh, step=1 / 16, top=0.25)
    attn = grid(gen, heads, fh, step=1 / 16, top=0.25)
    m = torch.einsum("fhd,hd->fh", We.view(fe, heads, fh), attn)
    return el, er, ef, We, attn, m


def edgegat_kernel_checks(tgf, tf, heads, fh, fe, gen, tag):
    """Each K10 v2 kernel against its plain version on ``tf``: the edge
    scores, the slot-feature reduce with nonnegative and with signed
    weights on a grid of 1/16 (its sums exact in any order), and the edge
    ds without and with d(ef): (name, max|err|) pairs."""
    el, er, ef, We, attn, m = edgegat_inputs(tf, heads, fh, fe, gen)
    b, cap = tf.num_buckets, tf.cap
    counters = [getattr(tgf, name) for name in K10_COUNTERS]
    before = [k.launches for k in counters]
    p, g = tgf.edgegat_scores(tf, el, er, ef, m, SLOPE)
    want = tgf.edgegat_scores_plain(tf, el, er, ef, m, SLOPE)
    errs = [("p", close(p, want[0], f"{tag} p")),
            ("g", close(g, want[1], f"{tag} g"))]
    valid = tf.valid.view(b, 1, cap)
    for name, low in (("S", 0.0), ("S_ds", None)):
        w = grid(gen, b, heads, cap, step=1 / 16, top=1, low=low) * valid
        errs.append((name, close(tgf.slot_feat_reduce(tf, w, ef),
                                 tgf.slot_feat_reduce_plain(tf, w, ef),
                                 f"{tag} {name}")))
    x = torch.randn(tf.num_src, heads, fh, device="cuda", generator=gen)
    zn = torch.randn(tf.num_dst, heads, fh, device="cuda", generator=gen)
    zp = torch.randn(tf.num_dst, heads, fe, device="cuda", generator=gen)
    rp = torch.randn(tf.num_dst, heads, device="cuda", generator=gen)
    for extra in ((), (p, m)):
        got = tgf.edgegat_ds(tf, x, zn, rp, g, ef, zp, *extra)
        want = tgf.edgegat_ds_plain(tf, x, zn, rp, g, ef, zp, *extra)
        errs.append(("ds" + ("+d_ef" if extra else ""),
                     close(got[0], want[0], f"{tag} ds")))
        if extra:
            errs.append(("d_ef", close(got[1], want[1], f"{tag} d_ef")))
    torch.cuda.synchronize()
    launched = [k.launches - b0 for k, b0 in zip(counters, before)]
    if launched != [1, 2, 2]:
        raise AssertionError(f"{tag}: K10 v2 launches {launched}, not "
                             "[1, 2, 2]")
    return errs


def phase_edgegat_mid(dgt, tts, tgf):
    """Phase 25: each K10 v2 kernel against its plain version at mid size
    on the phase-21 multigraph, at (H, Fh) = (4, 32), (1, 41), (8, 8) and
    Fe = 16 and 5; then EdgeGATConv(64, 16, 32, 4) through K10 v2 against
    its edge chain (``kernel_spmm_min_edges`` above the edge count),
    forward and backward."""
    from dgl_tpu_torch.utils import config
    row, col, n_src, n_dst = mid_graph()
    fwd = tts.build_tiled_format_device(row, col, n_src, n_dst,
                                        device="cuda").with_src_first()
    gen = torch.Generator(device="cuda").manual_seed(25)
    for heads, fh in EDGEGAT_SHAPES:
        for fe in EDGEGAT_FES:
            tag = f"K10 v2 mid H={heads} Fh={fh} Fe={fe}"
            errs = edgegat_kernel_checks(tgf, fwd, heads, fh, fe, gen, tag)
            log(f"# {tag}: max|err| " + ", ".join(
                f"{name} {err:.3g}" for name, err in errs))

    gr = dgt.graph((row, col), num_nodes=n_src, device="cuda")
    gr.create_tiled_format()
    x = torch.randn(n_src, EGAT_FIN, device="cuda", generator=gen)
    efc = torch.randn(len(row), EGAT_FE, device="cuda", generator=gen)
    ef_slot = dgt.nn.EdgeGATConv.slot_edge_feats(gr, efc)
    conv = dgt.nn.EdgeGATConv(EGAT_FIN, EGAT_FE, EGAT_D, EGAT_H,
                              generator=torch.Generator(device="cuda")
                              .manual_seed(26))

    def step(**kw):
        conv.zero_grad()
        xs = x.clone().requires_grad_()
        out = conv(gr, xs, efc, **kw)
        out.square().mean().backward()
        return out.detach(), {"x": xs.grad, **{
            n: p.grad.clone() for n, p in conv.named_parameters()
            if p.grad is not None}}

    before = tgf.edgegat_scores.launches
    out_k, grad_k = step(efeats_slot=ef_slot)
    torch.cuda.synchronize()
    if tgf.edgegat_scores.launches - before != 1:
        raise AssertionError("the EdgeGATConv did not run through K10 v2")
    saved = config.get("kernel_spmm_min_edges")
    config.set("kernel_spmm_min_edges", len(row) + 1)
    try:
        out_c, grad_c = step()
    finally:
        config.set("kernel_spmm_min_edges", saved)
    err = close(out_k, out_c, "EdgeGATConv K10 v2 vs edge chain")
    if set(grad_k) != set(grad_c):
        raise AssertionError(f"gradients {sorted(grad_k)} vs "
                             f"{sorted(grad_c)}")
    for n in grad_k:
        close(grad_k[n], grad_c[n], f"EdgeGATConv grad {n}", rtol=1e-3,
              atol=1e-5)
    log(f"# EdgeGATConv mid size, K10 v2 vs edge chain: out max|err| "
        f"{err:.3g}, {len(grad_k)} gradients agree")


def phase_edgegat(dgt, tts, tgf, g, x, ef, ef_slot):
    """Phase 26: EdgeGATConv(64, 16, 32, 4), loss (out^2).mean(), Adam
    1e-3 (tools/perf_egat128.py:81-82), for 4 steps on K10 v2 on phase
    23's graph; the counts are set to 0 just before and read just
    after."""
    conv = dgt.nn.EdgeGATConv(EGAT_FIN, EGAT_FE, EGAT_D, EGAT_H,
                              generator=torch.Generator(device="cuda")
                              .manual_seed(27))
    opt = torch.optim.Adam(conv.parameters(), lr=1e-3)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(tts, tgf)
    times, losses = [], []
    for _ in range(EDGEGAT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = conv(g, x, ef, efeats_slot=ef_slot).square().mean()
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = read_counts(tts, tgf)
    step_s = statistics.median(times[1:])
    log(f"# EdgeGATConv(64, 16, 32, 4) on K10 v2: steps "
        f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms, median after one "
        f"warm-up step {step_s * 1e3:.3f} ms, "
        f"{g.num_edges() / step_s:.6g} train-edges/s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes, loss "
        f"{', '.join(f'{v:.6f}' for v in losses)}, launches {counts}")
    # per step: the edge scores, den, K4's SpMM and S for the forward; the
    # edge ds, der, del, Q and dx for the backward
    want = {"gat_scores": 0, "slot_reduce": 3, "gat_ds": 0,
            "src_aggregate": 1, "k4_spmm": 1, "k4_sddmm": 0, **NO_K9,
            "edgegat_scores": 1, "slot_feat_reduce": 2, "edgegat_ds": 1,
            **NO_V1}
    if counts != {k: v * EDGEGAT_STEPS for k, v in want.items()}:
        raise AssertionError(f"EdgeGAT launches {counts}, not {want} a step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"EdgeGAT losses are not finite: {losses}")
    return conv, counts


def phase_edgegat_check(conv, g, x, ef, ef_slot):
    """One EdgeGATConv step on K10 v2 against the same weights through the
    flat route (chunked logits, edgeflat): loss and every gradient."""

    def grads(**kw):
        conv.zero_grad()
        out = conv(g, x, ef, **kw)
        if out.shape != (N_NODES, EGAT_H, EGAT_D) or not torch.isfinite(
                out).all():
            raise AssertionError("EdgeGATConv output is not finite of shape "
                                 f"{(N_NODES, EGAT_H, EGAT_D)}")
        loss = out.square().mean()
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in conv.named_parameters()
                             if p.grad is not None}

    loss_k, grad_k = grads(efeats_slot=ef_slot)
    loss_f, grad_f = grads()
    if abs(loss_k - loss_f) > 1e-4 * abs(loss_f):
        raise AssertionError(f"loss {loss_k} (K10 v2) vs {loss_f} (flat)")
    if set(grad_k) != set(grad_f):
        raise AssertionError(f"gradients {sorted(grad_k)} vs {sorted(grad_f)}")
    for n in grad_k:
        close(grad_k[n], grad_f[n], f"EdgeGAT grad {n}", rtol=1e-3,
              atol=1e-5)
    log(f"# EdgeGATConv, K10 v2 vs the flat route at 23M edges: loss "
        f"{loss_k:.8f} vs {loss_f:.8f}, {len(grad_k)} gradients agree")


def edgegat_yardsticks(tgf, g, heads, fh, fe, rate):
    """Phase 27: each K10 v2 kernel at full size on ``g`` against its
    plain version, with the timings and the bound; the slot-feature reduce
    also against one ``torch.sparse.mm`` of the (H N, slots) CSR that
    holds p at row h N + dst of each edge's slot, times the slot features
    viewed (slots, Fe).  p is rounded to a grid of 1/16 so that its sums
    over a node's edges are exact in any order (``exact_sums``)."""
    tf, e = g.unit().tiled_format()[0], g.num_edges()
    b, cap = tf.num_buckets, tf.cap
    slots = b * cap
    gen = torch.Generator(device="cuda").manual_seed(heads * 100 + fh)
    el, er, ef, We, attn, m = edgegat_inputs(tf, heads, fh, fe, gen)
    p, g_slot = tgf.edgegat_scores(tf, el, er, ef, m, SLOPE)
    p = (p * 16).round() / 16
    exact_sums(max_degree(g) * float(p.max()), 1 / 16, f"K10 v2 H={heads}")
    x = torch.randn(N_NODES, heads, fh, device="cuda", generator=gen)
    zn = torch.randn(N_NODES, heads, fh, device="cuda", generator=gen)
    zp = torch.randn(N_NODES, heads, fe, device="cuda", generator=gen)
    rp = torch.randn(N_NODES, heads, device="cuda", generator=gen)
    node = N_NODES * heads * 4
    slot_h, edge_h = slots * heads * 4, e * heads * 4
    edge_f = e * fe * 4                       # ef read at the edges
    walk = walk_bytes(slots, e)
    tag = f"H={heads} Fh={fh} Fe={fe}"
    rows = {}

    def row(name, kernel, plain, nbytes, ops, lib=None):
        got, want = kernel(), plain()
        err = max(close(a, w, f"K10 v2 {name} full size {tag}")
                  for a, w in zip(got if isinstance(got, tuple) else (got,),
                                  want if isinstance(want, tuple)
                                  else (want,)) if a is not None)
        del got, want
        bnd, by = bound(nbytes, ops, rate)
        r = {"max_abs_err": err, "ms": cuda_ms(kernel),
             "plain_ms": cuda_ms(plain, reps=1), "bound_ms": bnd,
             "bound_by": by, "library_ms": lib}
        rows[name] = r
        log(f"# K10 v2 {name} {tag}: {r['ms']:.4f} ms (bound {bnd:.4f} ms "
            f"by {by}: {nbytes} B, {ops} ops), plain {r['plain_ms']:.4f} ms,"
            f" library " + (f"(torch.sparse.mm) {lib:.4f} ms"
                            if lib is not None else "none")
            + f", max|err| {err:.3g}")

    # scores: in the slot arrays, el, er, ef at the edges, M; out p, g at
    # every slot.  Per edge and head: ef . M (2 Fe), then raw, lrelu, the
    # clip, exp and g (8)
    row("scores", lambda: tgf.edgegat_scores(tf, el, er, ef, m, SLOPE),
        lambda: tgf.edgegat_scores_plain(tf, el, er, ef, m, SLOPE),
        walk + 2 * node + edge_f + m.numel() * 4 + 2 * slot_h,
        e * heads * (2 * fe + 8))

    # the slot-feature reduce: one torch.sparse.mm of the (H N, slots) CSR
    # of p at the edges' slots, ordered by dst within each head's block
    ids = slot_ids(tf, "dst")
    live = torch.nonzero(tf.valid.reshape(-1) > 0).reshape(-1)
    order = live[torch.argsort(ids[live], stable=True)]
    crow = torch.zeros(N_NODES + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(torch.bincount(ids[order], minlength=N_NODES), 0)
    p_hs = p.permute(1, 0, 2).reshape(heads, slots)
    a = torch.sparse_csr_tensor(
        torch.cat([crow[:-1] + h * e for h in range(heads)]
                  + [crow[-1:] + (heads - 1) * e]).to(torch.int32),
        order.to(torch.int32).repeat(heads),
        torch.cat([p_hs[h, order] for h in range(heads)]),
        (heads * N_NODES, slots), check_invariants=False)
    del ids, live, order, crow, p_hs
    ef2 = ef.view(slots, fe)
    close(torch.sparse.mm(a, ef2).view(heads, N_NODES, fe).permute(1, 0, 2),
          tgf.slot_feat_reduce(tf, p, ef), f"torch.sparse.mm H={heads}")
    lib = cuda_ms(lambda: torch.sparse.mm(a, ef2))
    del a
    # in: valid at every slot, dst_local, w and ef at the edges; out one
    # (H, Fe) row per node.  2 ops per edge, head and feature
    row("slot_feat_reduce", lambda: tgf.slot_feat_reduce(tf, p, ef),
        lambda: tgf.slot_feat_reduce_plain(tf, p, ef),
        slots * 4 + e * 4 + edge_h + edge_f + node * fe,
        2 * e * heads * fe, lib)

    # ds as the main path calls it (no d(ef)): in the slot arrays, g, x,
    # zn, rp, Zp, ef at the edges; out ds at every slot.  Per edge and
    # head: the two dots (2 Fh + 2 Fe) and the epilogue (2)
    row("ds", lambda: tgf.edgegat_ds(tf, x, zn, rp, g_slot, ef, zp),
        lambda: tgf.edgegat_ds_plain(tf, x, zn, rp, g_slot, ef, zp),
        walk + edge_h + 2 * node * fh + node + node * fe + edge_f + slot_h,
        e * heads * (2 * fh + 2 * fe + 2))
    return rows


def k4_spmm_yardstick(ef, tts, gt, heads, fh, rate):
    """K4's SpMM at full size at (``heads``, ``fh``) against its plain
    version and the block-diagonal ``torch.sparse.mm``, as phase 16 times
    it: the row of route 5's numerator at (8, 8)."""
    fwd, _ = gt.unit().tiled_format()
    e = gt.num_edges()
    gen = torch.Generator(device="cuda").manual_seed(heads * 100 + fh + 1)
    exact_sums(max_degree(gt), 1 / 256, "K4 SpMM full size")
    x = grid(gen, N_NODES, heads, fh, step=1 / 16, top=1)
    w = grid(gen, e * heads, step=1 / 16, top=1, low=0)
    w_slot = ef._w_slot_from_flat(fwd, w, heads)
    xh = x.permute(1, 0, 2).contiguous().view(-1, fh)
    aw = block_csr(csr_pattern(gt), heads, w)
    got = tts.tiled_spmm_multihead(fwd, x, w_slot, heads, fh)
    close(torch.sparse.mm(aw, xh).view(heads, N_NODES, fh).permute(1, 0, 2),
          got, f"torch.sparse.mm block-diagonal H={heads}")
    lib = cuda_ms(lambda: torch.sparse.mm(aw, xh))
    del aw, xh
    err = close(got, tts.tiled_spmm_multihead_plain(fwd, x, w_slot),
                f"K4 spmm_mh full size H={heads} Fh={fh}")
    nbytes = row_walk_bytes(fwd, "dst", heads, heads * fh)
    ops = 2 * e * heads * fh
    bnd, by = bound(nbytes, ops, rate)
    r = {"max_abs_err": err,
         "ms": cuda_ms(lambda: tts.tiled_spmm_multihead(fwd, x, w_slot,
                                                        heads, fh)),
         "plain_ms": cuda_ms(lambda: tts.tiled_spmm_multihead_plain(
             fwd, x, w_slot), reps=1),
         "bound_ms": bnd, "bound_by": by, "library_ms": lib}
    log(f"# K4 spmm_mh H={heads} Fh={fh}: {r['ms']:.4f} ms (bound {bnd:.4f} "
        f"ms by {by}: {nbytes} B, {ops} ops), plain {r['plain_ms']:.4f} ms, "
        f"library (torch.sparse.mm) {lib:.4f} ms, max|err| {err:.3g}")
    log_gathers(f"K4 spmm_mh H={heads} Fh={fh}", e, heads * fh, r["ms"],
                rate)
    return r


# -- the stored-edge-term slice (EGATConv v1 on K11 v1, EdgeGATConv v1, K10 v1)

V1_SHAPES = ((4, 32), (1, 41), (8, 8))
V1_DTYPES = (torch.float32, torch.bfloat16)
# tools/perf_egat128.py:27-82: EGATConv(64, 16, 32, 32, 4) and
# EdgeGATConv(64, 16, 32, 4) on phase 23's graph, (out^2).mean(), Adam
# 1e-3; one warm-up step and 4 timed steps
V1_STEPS = 5
# a slope on a dyadic grid for the kernel checks: dW = ds attn lrelu'(raw)
# then lies on a grid, and its sums over a node's slots are exact
EXACT_SLOPE = 0.25
K11V1_STEP = {"egatc_scores": 1, "slot_reduce": 1, "k4_spmm": 1, "gat_ds": 1,
              "egatc_slot_grad": 1, "slot_vec_reduce": 2, "src_aggregate": 1}
K10V1_STEP = {"gat_scores": 1, "slot_reduce": 3, "fe_aggregate": 1,
              "fe_ds": 1, "dx_dfe": 1}


def slot_rows(tf, gen, width, step, top, dtype=torch.float32):
    """A (B, C, width) slot tensor on a grid, 0 at padded slots."""
    b, cap = tf.num_buckets, tf.cap
    return (grid(gen, b, cap, width, step=step, top=top)
            * tf.valid.view(b, cap, 1)).to(dtype)


def slot_heads(tf, gen, heads, step, top, low=None):
    """A (B, H, C) slot tensor on a grid, 0 at padded slots."""
    b, cap = tf.num_buckets, tf.cap
    return (grid(gen, b, heads, cap, step=step, top=top, low=low)
            * tf.valid.view(b, 1, cap))


def egatc_inputs(tf, heads, dim, gen, dtype):
    """K11 v1's U, V (multiples of 1/16 in [-1, 1]), attn and the stored FE
    in ``dtype`` (of 1/16 in [-1/2, 1/2], exact in bf16) and ds (of 1/8 in
    [-1, 1]): raw = U + V + FE is exact in f32, and with EXACT_SLOPE every
    dW is a multiple of 1/512 of at most 1/2."""
    U = grid(gen, tf.num_src, heads, dim, step=1 / 16, top=1)
    V = grid(gen, tf.num_dst, heads, dim, step=1 / 16, top=1)
    attn = grid(gen, heads, dim, step=1 / 16, top=0.5)
    fe = slot_rows(tf, gen, heads * dim, 1 / 16, 0.5, dtype)
    ds = slot_heads(tf, gen, heads, 1 / 8, 1)
    return U, V, attn, fe, ds


def egatc_kernel_checks(tgf, tf, heads, dim, dtype, gen, tag):
    """Each K11 v1 kernel against its plain version on ``tf`` with the
    stored FE in ``dtype``: (name, max|err|) pairs."""
    U, V, attn, fe, ds = egatc_inputs(tf, heads, dim, gen, dtype)
    counters = [getattr(tgf, name) for name in V1_COUNTERS[:3]]
    before = [k.launches for k in counters]
    errs = [("p", close(tgf.egatc_scores(tf, U, V, attn, fe, EXACT_SLOPE),
                        tgf.egatc_scores_plain(tf, U, V, attn, fe,
                                               EXACT_SLOPE), f"{tag} p"))]
    da, dfe = tgf.egatc_slot_grad(tf, U, V, attn, fe, ds, EXACT_SLOPE)
    want = tgf.egatc_slot_grad_plain(tf, U, V, attn, fe, ds, EXACT_SLOPE)
    if dfe.dtype != dtype:
        raise AssertionError(f"{tag}: dFE is {dfe.dtype}, not {dtype}")
    errs += [("da", close_sum(da, want[0], f"{tag} da")),
             ("dFE", close(dfe.float(), want[1].float(), f"{tag} dFE"))]
    for side, name in (("dst", "dFNJ"), ("src", "dFNI")):
        errs.append((name, close(tgf.slot_vec_reduce(tf, dfe, side),
                                 tgf.slot_vec_reduce_plain(tf, dfe, side),
                                 f"{tag} {name}")))
    torch.cuda.synchronize()
    launched = [k.launches - b0 for k, b0 in zip(counters, before)]
    if launched != [1, 1, 2]:
        raise AssertionError(f"{tag}: K11 v1 launches {launched}, not "
                             "[1, 1, 2]")
    return errs


def edgegat_v1_inputs(tf, heads, fh, gen, dtype):
    """K10 v1's x and zn (multiples of 1/16 in [-1, 1]), the stored fe in
    ``dtype`` (the same grid), p (of 1/16 in [0, 4]), g and rp (normal):
    every per-slot product and every sum of them over a node's slots is
    exact in f32."""
    x = grid(gen, tf.num_src, heads, fh, step=1 / 16, top=1)
    zn = grid(gen, tf.num_dst, heads, fh, step=1 / 16, top=1)
    fe = slot_rows(tf, gen, heads * fh, 1 / 16, 1, dtype)
    p = slot_heads(tf, gen, heads, 1 / 16, 4, low=0)
    g = torch.randn(p.shape, device="cuda", generator=gen) * (p != 0)
    rp = torch.randn(tf.num_dst, heads, device="cuda", generator=gen)
    return x, zn, fe, p, g, rp


def edgegat_v1_kernel_checks(tgf, tf, heads, fh, dtype, gen, tag):
    """Each K10 v1 kernel against its plain version on ``tf`` with the
    stored fe in ``dtype``: (name, max|err|) pairs."""
    x, zn, fe, p, g, rp = edgegat_v1_inputs(tf, heads, fh, gen, dtype)
    counters = [getattr(tgf, name) for name in V1_COUNTERS[3:]]
    before = [k.launches for k in counters]
    errs = [("num", close(tgf.fe_aggregate(tf, x, fe, p),
                          tgf.fe_aggregate_plain(tf, x, fe, p),
                          f"{tag} num")),
            ("ds", close(tgf.fe_ds(tf, x, fe, zn, rp, g),
                         tgf.fe_ds_plain(tf, x, fe, zn, rp, g),
                         f"{tag} ds"))]
    dx, dfe = tgf.dx_dfe(tf, zn, p, dtype)
    want = tgf.dx_dfe_plain(tf, zn, p, dtype)
    if dfe.dtype != dtype:
        raise AssertionError(f"{tag}: dfe is {dfe.dtype}, not {dtype}")
    errs += [("dx", close(dx, want[0], f"{tag} dx")),
             ("dfe", close(dfe.float(), want[1].float(), f"{tag} dfe"))]
    torch.cuda.synchronize()
    launched = [k.launches - b0 for k, b0 in zip(counters, before)]
    if launched != [1, 1, 1]:
        raise AssertionError(f"{tag}: K10 v1 launches {launched}, not "
                             "[1, 1, 1]")
    return errs


def v1_against_v2(tgf, tf, n_src, n_dst, gen, tag):
    """At (4, 32) with 16 edge features: each v1 function through its
    kernels on the slot tensors formed from the v2 function's leaves
    (FE = ef_slot Wf; fe = ef_slot We and ee = <fe, attn_e>) against the v2
    function on those leaves, the value and every leaf's gradient."""
    heads, dim, fe_in = EGAT_H, EGAT_D, EGAT_FE
    b, cap = tf.num_buckets, tf.cap

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device="cuda", generator=gen)
                ).requires_grad_()

    ef_slot = slot_rows(tf, gen, fe_in, 1 / 16, 1).requires_grad_()
    u, v, x = (randn(n, heads, dim, scale=s) for n, s in (
        (n_src, 0.5), (n_dst, 0.5), (n_src, 1.0)))
    wf, attn = randn(fe_in, heads * dim, scale=0.1), randn(heads, dim)
    dz = torch.randn(n_dst, heads, dim, device="cuda", generator=gen)
    leaves = (u, v, ef_slot, wf, attn, x)

    def run(v1):
        for a in leaves:
            a.grad = None
        if v1:
            out = tgf.egatconv_attention_aggregate(
                tf, u, v, ef_slot @ wf, attn, x, heads, dim, dim, EGAT_SLOPE)
        else:
            out = tgf.egatconv_attention_aggregate_v2(
                tf, u, v, ef_slot, wf, attn, x, heads, dim, dim, EGAT_SLOPE)
        out.backward(dz)
        return [out.detach()] + [a.grad.clone() for a in leaves]

    errs = [close(a, w, f"{tag} EGAT v1 vs v2 {i}", atol=ATOL * max(
        1.0, float(w.abs().max()))) for i, (a, w) in enumerate(
        zip(run(True), run(False)))]
    el, er = randn(n_src, heads), randn(n_dst, heads)
    leaves = (el, er, ef_slot, wf, attn, x)

    def run_e(v1):
        for a in leaves:
            a.grad = None
        if v1:
            fe = ef_slot @ wf
            ee = (fe.view(b, cap, heads, dim) * attn).sum(-1)
            out = tgf.edgegat_attention_aggregate(
                tf, el, er, ee.transpose(1, 2).contiguous(), fe, x, heads,
                dim, SLOPE)
        else:
            out = tgf.edgegat_attention_aggregate_v2(
                tf, el, er, ef_slot, wf, attn, x, heads, dim, SLOPE)
        out.backward(dz)
        return [out.detach()] + [a.grad.clone() for a in leaves]

    errs += [close(a, w, f"{tag} EdgeGAT v1 vs v2 {i}", atol=ATOL * max(
        1.0, float(w.abs().max()))) for i, (a, w) in enumerate(
        zip(run_e(True), run_e(False)))]
    return max(errs)


def phase_v1_mid(dgt, tts, tgf):
    """Phase 37: each K11 v1 and K10 v1 kernel against its plain version on
    the phase-21 multigraph at (H, D) = (4, 32), (1, 41), (8, 8), with the
    stored slot tensors in f32 and in bf16; then both v1 functions against
    their v2 counterparts on the same leaves."""
    row, col, n_src, n_dst = mid_graph()
    fwd = tts.build_tiled_format_device(row, col, n_src, n_dst,
                                        device="cuda").with_src_first()
    gen = torch.Generator(device="cuda").manual_seed(37)
    for heads, dim in V1_SHAPES:
        for dtype in V1_DTYPES:
            for name, checks in (("K11 v1", egatc_kernel_checks),
                                 ("K10 v1", edgegat_v1_kernel_checks)):
                tag = (f"{name} mid H={heads} D={dim} "
                       f"{str(dtype).split('.')[-1]}")
                errs = checks(tgf, fwd, heads, dim, dtype, gen, tag)
                log(f"# {tag}: max|err| " + ", ".join(
                    f"{n} {e:.3g}" for n, e in errs))
    err = v1_against_v2(tgf, fwd, n_src, n_dst, gen, "mid")
    log(f"# v1 vs v2 mid size (4, 32), Fe = 16: values and every gradient "
        f"agree, max|err| {err:.3g}")


class EgatV1(torch.nn.Module):
    """EGATConv(64, 16, 32, 32, 4)'s widths on K11 v1 (compute_edge_feats
    False, tools/perf_egat128.py:45-80): fni, fnj and the node values from
    three (64, 128) projections of x, the stored edge term FE = ef_slot Wf
    with Wf (16, 128) (a plain matmul), attn (4, 32)."""

    def __init__(self, gen):
        super().__init__()
        hd = EGAT_H * EGAT_D

        def param(*shape):
            return torch.nn.Parameter(torch.randn(
                *shape, device="cuda", generator=gen) * shape[0] ** -0.5)

        self.w_ni, self.w_nj = param(EGAT_FIN, hd), param(EGAT_FIN, hd)
        self.w_node = param(EGAT_FIN, hd)
        self.wf, self.attn = param(EGAT_FE, hd), param(EGAT_H, EGAT_D)

    def nodes(self, x):
        shape = (x.shape[0], EGAT_H, EGAT_D)
        return tuple((x @ w).view(shape)
                     for w in (self.w_ni, self.w_nj, self.w_node))

    def forward(self, tf, x, ef_slot, attention=None):
        """(N, 4, 32) through K11 v1, or through ``attention`` on the same
        tensors (the plain versions' twin)."""
        from dgl_tpu_torch.ops.kernels import gat_fused as tgf
        fni, fnj, h = self.nodes(x)
        fe = ef_slot @ self.wf
        if attention is not None:
            return attention(fni, fnj, fe, self.attn, h, tf, EGAT_SLOPE)
        return tgf.egatconv_attention_aggregate(
            tf, fni, fnj, fe, self.attn, h, EGAT_H, EGAT_D, EGAT_D,
            EGAT_SLOPE)

    def v2(self, tf, x, ef_slot):
        """The same leaves through ``egatconv_attention_aggregate_v2``."""
        from dgl_tpu_torch.ops.kernels import gat_fused as tgf
        fni, fnj, h = self.nodes(x)
        return tgf.egatconv_attention_aggregate_v2(
            tf, fni, fnj, ef_slot, self.wf, self.attn, h, EGAT_H, EGAT_D,
            EGAT_D, EGAT_SLOPE)


class PlainEgatc(torch.autograd.Function):
    """K11 v1's attention built from the plain versions alone: the twin of
    the port's autograd function."""

    @staticmethod
    def forward(ctx, fni, fnj, fe, attn, x, tf, slope):
        from dgl_tpu_torch.ops.kernels import gat_fused as tgf
        from dgl_tpu_torch.ops.kernels import tiled_spmm as tts
        p = tgf.egatc_scores_plain(tf, fni, fnj, attn, fe, slope)
        den = tgf.slot_reduce_plain(tf, p, "dst").clamp_(min=tgf.DEN_EPS)
        out = tts.tiled_spmm_multihead_plain(tf, x, p) / den.unsqueeze(-1)
        ctx.save_for_backward(fni, fnj, fe, attn, x, p, den, out)
        ctx.tf, ctx.slope = tf, slope
        return out

    @staticmethod
    def backward(ctx, dz):
        from dgl_tpu_torch.ops.kernels import gat_fused as tgf
        fni, fnj, fe, attn, x, p, den, out = ctx.saved_tensors
        tf = ctx.tf
        zn, rp = tgf._scales(out, dz, den)
        ds = tgf.gat_ds_plain(tf, x, zn, rp, p)
        da, dfe = tgf.egatc_slot_grad_plain(tf, fni, fnj, attn, fe, ds,
                                            ctx.slope)
        del ds
        du = tgf.slot_vec_reduce_plain(tf, dfe, "src").view(fni.shape)
        dv = tgf.slot_vec_reduce_plain(tf, dfe, "dst").view(fnj.shape)
        return (du, dv, dfe, da, tgf.src_aggregate_plain(tf, zn, p), None,
                None)


class EdgeGatV1(torch.nn.Module):
    """EdgeGATConv(64, 16, 32, 4)'s widths on K10 v1
    (tools/perf_egat128.py:81-82): the node values x3 = x W with W (64,
    128), el and er their dots with attn_l and attn_r, the stored message
    fe_slot = ef_slot We with We (16, 128) and the stored logit ee_slot =
    <fe_slot, attn_e> per head, (B, H, C), formed as ef_slot M with M = We
    contracted with attn_e (the same function without a second
    (B, C, 128) tensor)."""

    def __init__(self, gen):
        super().__init__()
        hd = EGAT_H * EGAT_D

        def param(*shape):
            return torch.nn.Parameter(torch.randn(
                *shape, device="cuda", generator=gen) * shape[-1] ** -0.5)

        self.w, self.we = param(EGAT_FIN, hd), param(EGAT_FE, hd)
        self.attn_l, self.attn_r = param(EGAT_H, EGAT_D), param(EGAT_H,
                                                                 EGAT_D)
        self.attn_e = param(EGAT_H, EGAT_D)

    def nodes(self, x):
        h = (x @ self.w).view(x.shape[0], EGAT_H, EGAT_D)
        return h, (h * self.attn_l).sum(-1), (h * self.attn_r).sum(-1)

    def slots(self, ef_slot):
        """(ee_slot (B, H, C), fe_slot (B, C, H * D))."""
        m = torch.einsum("fhd,hd->fh", self.we.view(EGAT_FE, EGAT_H, EGAT_D),
                         self.attn_e)
        return (ef_slot @ m).transpose(1, 2).contiguous(), ef_slot @ self.we

    def forward(self, tf, x, ef_slot, attention=None):
        from dgl_tpu_torch.ops.kernels import gat_fused as tgf
        h, el, er = self.nodes(x)
        ee, fe = self.slots(ef_slot)
        if attention is not None:
            return attention(el, er, ee, fe, h, tf, SLOPE)
        return tgf.edgegat_attention_aggregate(tf, el, er, ee, fe, h, EGAT_H,
                                               EGAT_D, SLOPE)

    def v2(self, tf, x, ef_slot):
        """The same leaves through ``edgegat_attention_aggregate_v2``."""
        from dgl_tpu_torch.ops.kernels import gat_fused as tgf
        h, el, er = self.nodes(x)
        return tgf.edgegat_attention_aggregate_v2(
            tf, el, er, ef_slot, self.we, self.attn_e, h, EGAT_H, EGAT_D,
            SLOPE)


class PlainEdgeGatV1(torch.autograd.Function):
    """K10 v1's attention built from the plain versions alone."""

    @staticmethod
    def forward(ctx, el, er, ee, fe, x, tf, slope):
        from dgl_tpu_torch.ops.kernels import gat_fused as tgf
        p, g = tgf.gat_scores_plain(tf, el, er, slope, ee)
        den = tgf.slot_reduce_plain(tf, p, "dst").clamp_(min=tgf.DEN_EPS)
        out = tgf.fe_aggregate_plain(tf, x, fe, p) / den.unsqueeze(-1)
        ctx.save_for_backward(x, fe, p, g, den, out)
        ctx.tf = tf
        return out

    @staticmethod
    def backward(ctx, dz):
        from dgl_tpu_torch.ops.kernels import gat_fused as tgf
        x, fe, p, g, den, out = ctx.saved_tensors
        tf = ctx.tf
        zn, rp = tgf._scales(out, dz, den)
        ds = tgf.fe_ds_plain(tf, x, fe, zn, rp, g)
        dx, dfe = tgf.dx_dfe_plain(tf, zn, p, fe.dtype)
        return (tgf.slot_reduce_plain(tf, ds, "src"),
                tgf.slot_reduce_plain(tf, ds, "dst"), ds, dfe, dx, None,
                None)


def v1_loss(model, tf, x, ef_slot, train=None):
    return model(tf, x, ef_slot).square().mean()


def phase_v1_train(tgf, tts, model, tf, x, ef_slot, e, name, want, plain):
    """Phases 38 and 39: one warm-up and 4 timed Adam steps (lr 1e-3) of
    (out^2).mean() with the counts set to 0 just before and read just
    after, each wrapper's launches held to ``want`` a step; a profiled step
    held to the counters; one step's loss and gradients against the same
    step through ``plain`` (the plain versions); the loss against the v2
    function on the same leaves."""
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(tts, tgf)
    times, losses = [], []
    for _ in range(V1_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = v1_loss(model, tf, x, ef_slot)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = read_counts(tts, tgf)
    step_s = statistics.median(times[1:])
    log(f"# {name}: steps {', '.join(f'{t * 1e3:.2f}' for t in times)} ms, "
        f"median after one warm-up step {step_s * 1e3:.3f} ms, "
        f"{e / step_s:.6g} train-edges/s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes, loss "
        f"{', '.join(f'{v:.6f}' for v in losses)}, launches {counts}")
    full = {k: want.get(k, 0) * V1_STEPS for k in counts}
    if counts != full:
        raise AssertionError(f"{name} launches {counts}, not {want} a step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name} losses are not finite: {losses}")
    phase_profile(model, opt, tf, x, ef_slot, None,
                  lambda: read_counts(tts, tgf), loss=v1_loss)

    def grads(forward):
        model.zero_grad()
        out = forward()
        if out.shape != (N_NODES, EGAT_H, EGAT_D) or not torch.isfinite(
                out).all():
            raise AssertionError(f"{name}: the output is not finite of shape "
                                 f"{(N_NODES, EGAT_H, EGAT_D)}")
        loss = out.square().mean()
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}

    loss_k, grad_k = grads(lambda: model(tf, x, ef_slot))
    loss_p, grad_p = grads(lambda: model(tf, x, ef_slot, plain.apply))
    if abs(loss_k - loss_p) > 1e-4 * abs(loss_p):
        raise AssertionError(f"{name}: loss {loss_k} (kernels) vs {loss_p} "
                             "(plain)")
    for n in grad_k:
        close(grad_k[n], grad_p[n], f"{name} grad {n}", rtol=1e-3, atol=1e-5)
    del grad_p
    with torch.no_grad():
        loss_2 = model.v2(tf, x, ef_slot).square().mean().item()
    if abs(loss_k - loss_2) > 1e-4 * abs(loss_2):
        raise AssertionError(f"{name}: loss {loss_k} (v1) vs {loss_2} (v2)")
    log(f"# {name} at 23M edges: loss {loss_k:.8f} (kernels), {loss_p:.8f} "
        f"(plain versions), {loss_2:.8f} (v2 on the same leaves); "
        f"{len(grad_k)} gradients agree with the plain versions'")
    return {k: v for k, v in counts.items() if k in want}


def phase_egatc_v1(tgf, tts, g, x, ef_slot):
    """Phase 38: EGATConv(64, 16, 32, 32, 4)'s widths on K11 v1."""
    tf = g.unit().tiled_format()[0]
    model = EgatV1(torch.Generator(device="cuda").manual_seed(38))
    fe_b = tf.num_buckets * tf.cap * EGAT_H * EGAT_D * 4
    log(f"# K11 v1 slot tensors: FE and dFE (B, C, 128) f32, {fe_b} bytes "
        f"each; ef_slot {ef_slot.numel() * ef_slot.element_size()} bytes")
    return phase_v1_train(tgf, tts, model, tf, x, ef_slot, g.num_edges(),
                          "EGATConv(64, 16, 32, 32, 4) on K11 v1",
                          K11V1_STEP, PlainEgatc)


def phase_edgegat_v1(tgf, tts, g, x, ef_slot):
    """Phase 39: EdgeGATConv(64, 16, 32, 4)'s widths on K10 v1."""
    tf = g.unit().tiled_format()[0]
    model = EdgeGatV1(torch.Generator(device="cuda").manual_seed(39))
    slots = tf.num_buckets * tf.cap
    log(f"# K10 v1 slot tensors: fe_slot and dfe (B, C, 128) f32, "
        f"{slots * EGAT_H * EGAT_D * 4} bytes each; ee_slot and ds (B, 4, "
        f"C) f32, {slots * EGAT_H * 4} bytes each")
    return phase_v1_train(tgf, tts, model, tf, x, ef_slot, g.num_edges(),
                          "EdgeGATConv(64, 16, 32, 4) on K10 v1",
                          K10V1_STEP, PlainEdgeGatV1)


def v1_yardsticks(tgf, g, rate):
    """Phase 40: each K11 v1 and K10 v1 kernel at full size on the EGAT
    graph at (4, 32), f32 slot tensors, against its plain version on the
    inputs of the mid-size checks (exact sums on their grids, held by
    ``exact_sums``), with its time (median of 5), its plain version's, the
    bound and, for the slot vector sum, one ``index_add_`` of the slot rows
    at the slots' node ids."""
    tf, e = g.unit().tiled_format()[0], g.num_edges()
    heads, dim = EGAT_H, EGAT_D
    b, cap = tf.num_buckets, tf.cap
    slots, hd = b * cap, heads * dim
    gen = torch.Generator(device="cuda").manual_seed(40)
    deg = max_degree(g)
    exact_sums(deg * 0.5, 1 / 512, "K11 v1 dFE sums")
    exact_sums(deg * 4 * 2, 1 / 256, "K10 v1 sums")
    walk = walk_bytes(slots, e)
    node_h, node_f = N_NODES * heads * 4, N_NODES * hd * 4
    slot_h, edge_h = slots * heads * 4, e * heads * 4
    slot_f, edge_f = slots * hd * 4, e * hd * 4
    rows = {}

    def row(name, kernel, plain, nbytes, ops, lib=None, lib_name=None):
        got, want = kernel(), plain()
        pairs = [(a, w) for a, w in zip(
            got if isinstance(got, tuple) else (got,),
            want if isinstance(want, tuple) else (want,))]
        err = max((close_sum if a.shape == (heads, dim) else close)(
            a.float(), w.float(), f"{name} full size") for a, w in pairs)
        del got, want, pairs
        bnd, by = bound(nbytes, ops, rate)
        r = {"max_abs_err": err, "ms": cuda_ms(kernel),
             "plain_ms": cuda_ms(plain, reps=1), "bound_ms": bnd,
             "bound_by": by, "library_ms": lib}
        rows[name] = r
        log(f"# {name} H={heads} D={dim}: {r['ms']:.4f} ms (bound {bnd:.4f} "
            f"ms by {by}: {nbytes} B, {ops} ops), plain {r['plain_ms']:.4f} "
            f"ms, library " + (f"({lib_name}) {lib:.4f} ms" if lib is not None
                               else "none") + f", max|err| {err:.3g}")

    U, V, attn, fe, ds = egatc_inputs(tf, heads, dim, gen, torch.float32)
    # K11 v1 scores: in the slot arrays, U, V, attn, FE at the edges; out p
    # at every slot.  Per edge and column raw (2), lrelu and the dot (3);
    # per edge and head the clip and exp
    row("egatc_scores",
        lambda: tgf.egatc_scores(tf, U, V, attn, fe, EXACT_SLOPE),
        lambda: tgf.egatc_scores_plain(tf, U, V, attn, fe, EXACT_SLOPE),
        walk + 2 * node_f + hd * 4 + edge_f + slot_h,
        e * (5 * hd + 4 * heads))
    # the slot gradient: in the slot arrays, ds, U, V, attn, FE at the
    # edges; out da and dFE at every slot.  Per edge and column raw (2),
    # lrelu and da (3), dW (2)
    row("egatc_slot_grad",
        lambda: tgf.egatc_slot_grad(tf, U, V, attn, fe, ds, EXACT_SLOPE),
        lambda: tgf.egatc_slot_grad_plain(tf, U, V, attn, fe, ds,
                                          EXACT_SLOPE),
        walk + edge_h + 2 * node_f + 2 * hd * 4 + edge_f + slot_f,
        7 * e * hd)
    dfe = tgf.egatc_slot_grad(tf, U, V, attn, fe, ds, EXACT_SLOPE)[1]
    del U, V, attn, fe, ds
    # the slot vector sum by dst: one index_add_ of the (B C, 128) rows at
    # the slots' dst ids (padded slots hold 0)
    ids = slot_ids(tf, "dst")
    flat = dfe.view(slots, hd)

    def lib_call():
        return torch.zeros(N_NODES, hd, device="cuda").index_add_(0, ids,
                                                                  flat)

    close(lib_call(), tgf.slot_vec_reduce(tf, dfe, "dst"), "index_add_ dFE")
    lib = cuda_ms(lib_call)
    del ids, flat
    # in: valid at every slot, dst_local and dFE at the edges; out one row
    # per node; an add per edge and column
    row("slot_vec_reduce", lambda: tgf.slot_vec_reduce(tf, dfe, "dst"),
        lambda: tgf.slot_vec_reduce_plain(tf, dfe, "dst"),
        slots * 4 + e * 4 + edge_f + node_f, e * hd, lib, "index_add_")
    row("slot_vec_reduce_src", lambda: tgf.slot_vec_reduce(tf, dfe, "src"),
        lambda: tgf.slot_vec_reduce_plain(tf, dfe, "src"),
        slots * 4 + e * 4 + b * 4 + edge_f + node_f, e * hd)
    del dfe
    x, zn, fe, p, g_slot, rp = edgegat_v1_inputs(tf, heads, dim, gen,
                                                 torch.float32)
    # K10 v1 numerator: in the slot arrays, p at the edges, x, fe at the
    # edges; out one row per node.  Per edge and column the add and the
    # product's add (3)
    row("fe_aggregate", lambda: tgf.fe_aggregate(tf, x, fe, p),
        lambda: tgf.fe_aggregate_plain(tf, x, fe, p),
        walk + edge_h + node_f + edge_f + node_f, 3 * e * hd)
    # ds: in the slot arrays, g at the edges, x, zn, rp, fe at the edges;
    # out ds at every slot.  Per edge and column the add and the dot (3),
    # per edge and head the epilogue (2)
    row("fe_ds", lambda: tgf.fe_ds(tf, x, fe, zn, rp, g_slot),
        lambda: tgf.fe_ds_plain(tf, x, fe, zn, rp, g_slot),
        walk + edge_h + 2 * node_f + node_h + edge_f + slot_h,
        e * (3 * hd + 2 * heads))
    # dx with dfe: in the slot arrays and src_order, p at the edges, zn;
    # out dx (one row per node) and dfe at every slot.  Per edge and
    # column the product and the add (2)
    row("dx_dfe", lambda: tgf.dx_dfe(tf, zn, p),
        lambda: tgf.dx_dfe_plain(tf, zn, p),
        walk + b * 4 + edge_h + node_f + node_f + slot_f, 2 * e * hd)
    return rows


def phase_bitmm_sweep(bm, tp1, rate):
    """Phase 41: K1's slab-width sweep (P1's counterpart,
    ``dgl_tpu_torch.tools.perf_bitmm_variants``) at the JAX sweep's size,
    its launches counted from 0, each width exactly equal to the plain
    version; the bound of the default width's work."""
    bm.bit_matmul_t.launches = 0
    res = tp1.sweep(reps=3)
    torch.cuda.synchronize()
    launches = bm.bit_matmul_t.launches
    w = bm.T_SLAB_WORDS
    bnd, by = bound(res["nbytes"], 2 * res["bits"] * tp1.F, rate)
    log(f"# K1 slab sweep KP = N = {tp1.KP}, F = {tp1.F}, {res['bits']} set "
        "bits: " + ", ".join(f"{k} words {v:.4f} ms"
                             for k, v in res["ms"].items())
        + f"; plain {res['plain_ms']:.4f} ms; bound {bnd:.4f} ms by {by} "
        f"({res['nbytes']} B); {launches} K1 launches; every width exact")
    return {"launches": launches, "max_abs_err": res["max_abs_err"],
            "ms": res["ms"][w], "plain_ms": res["plain_ms"], "bound_ms": bnd,
            "bound_by": by, "library_ms": None,
            "slab_ms": {str(k): v for k, v in res["ms"].items()}}


def phase_bitgat_probe(bg, tp2, rate):
    """Phase 42: the probe of K5's src-major forward at full bit density
    (P2's counterpart, ``dgl_tpu_torch.tools.perf_bitgat_probe``): its
    launches counted from 0, the probe's time a launch, and the block of
    1,024 src rows held to the plain version, with its time, the plain
    version's and the bound."""
    bg.bitgat_fwd_t.launches = 0
    tp2.tiny_check()
    res = tp2.probe()
    torch.cuda.synchronize()
    launches = bg.bitgat_fwd_t.launches
    blk = res["block"]
    bnd, by = bound(blk["nbytes"], blk["bits"] * tp2.H * (2 * tp2.D + 5),
                    rate)
    # the probe: its bits, el and z in, er in, out and l out
    full_bnd, full_by = bound(
        tp2.S_PAD * tp2.K_PAD // 8 + (tp2.S_PAD * tp2.H * (1 + tp2.D)
                                      + tp2.K_PAD * tp2.H * (2 + tp2.D)) * 4,
        res["bits"] * tp2.H * (2 * tp2.D + 5), rate)
    log(f"# bitgat_fwd_t probe s_pad = k_pad = {tp2.S_PAD}, H = {tp2.H}, "
        f"D = {tp2.D}, {res['bits']} set bits: launches "
        + ", ".join(f"{t:.3f}" for t in res["launch_ms"])
        + f" ms (bound {full_bnd:.4f} ms by {full_by}); block of "
        f"{tp2.BLOCK_ROWS} src rows ({blk['bits']} bits): {blk['ms']:.4f} ms "
        f"(bound {bnd:.4f} ms by {by}), plain {blk['plain_ms']:.4f} ms, "
        f"max|err| {blk['max_abs_err']:.3g}; {launches} launches")
    return {"launches": launches, "max_abs_err": blk["max_abs_err"],
            "ms": blk["ms"], "plain_ms": blk["plain_ms"], "bound_ms": bnd,
            "bound_by": by, "library_ms": None,
            "probe_ms": statistics.median(res["launch_ms"]),
            "probe_bound_ms": full_bnd}


# -- the DotGat-on-K7 slice (DotGatConv's bitmask route) ---------------------

BITDOT_SHAPES = ((2, 64), (1, 128), (4, 32), (3, 8))
DOTGAT_FIN, DOTGAT_D, DOTGAT_H = 64, 64, 2    # tools/perf_bitdot_full.py:52-58
DOTGAT_K7_STEPS = 6                            # one warm-up step, 5 timed
K7_COUNTERS = ("bitdot_fwd", "bitdot_bwd_dz", "bitdot_bwd_dq")


def bitdot_inputs(gen, n_src, n_dst, heads, dim, top=1.0, saturate=False):
    """q and z on a grid of 1/16 in [-top, top], g normal.  At D = 64 (isd
    = 1/8) the scores are exact in f32, so a kernel and its plain version
    clip the same edges.  ``saturate`` makes z positive and sets every
    eighth row of q to +c or -c, with c such that about half of those
    rows' scores lie past +40 or -40 (as tests/test_torch_bitdot.py)."""
    q = grid(gen, n_dst, heads, dim, step=1 / 16, top=top)
    z = grid(gen, n_src, heads, dim, step=1 / 16, top=top)
    if saturate:
        z = z.abs() + 1 / 16
        c = round(40 / (0.5625 * dim ** 0.5) * 16) / 16
        q[::16], q[8::16] = c, -c
    g = torch.randn(n_dst, heads, dim, device="cuda", generator=gen)
    return q, z, g


def bitdot_plain_bwd(bf, q, z, g, out, l):
    """(dq, dz) from K7's plain versions, linv and rho formed as
    ``_BitDot`` forms them from the forward's out and l."""
    from dgl_tpu_torch.ops.kernels import bitdot as bd, bitgat as bg
    isd = 1 / q.shape[2] ** 0.5
    linv, rho = bg.backward_scales(g, out, l, None)
    return (bd.bitdot_bwd_dq_plain(bf.packed, q, z, g, linv, rho, isd),
            bd.bitdot_bwd_dz_plain(bf.packed_rev, q, z, g, linv, rho, isd))


def phase_bitdot_mid(dgt, bm, bg, bd):
    """Phase 28: each K7 kernel against its plain version on the phase-8
    graph (simple, bipartite, plane 31 on both sides) at (H, D) = (2, 64),
    (1, 128), (4, 32), (3, 8) and with scores past +-40 at (2, 64); l
    exactly at zero scores; the kernels' times at each shape; then
    DotGatConv(64, 64, 2) on K7 against its gather path, and the same layer
    at D = 32, which must not launch K7."""
    from dgl_tpu_torch.utils import config
    row, col, n_src, n_dst = mid_graph()
    key = np.unique(col * n_src + row)
    row, col = key % n_src, key // n_src
    bf = bm.build_bit_format_device(row, col, n_src, n_dst, device="cuda")
    if bf.rem_src.numel() or not ((bf.packed < 0).any()
                                  and (bf.packed_rev < 0).any()):
        raise AssertionError("mid-size graph is not simple or misses "
                             "plane 31")
    counters = [getattr(bd, name) for name in K7_COUNTERS]
    gen = torch.Generator(device="cuda").manual_seed(28)
    src_t = torch.from_numpy(row).cuda()
    dst_t = torch.from_numpy(col).cuda()
    for heads, dim, saturate in [s + (False,) for s in BITDOT_SHAPES] + [
            (2, 64, True)]:
        tag = f"H={heads} D={dim}" + (" saturated" if saturate else "")
        q, z, g = bitdot_inputs(gen, n_src, n_dst, heads, dim,
                                saturate=saturate)
        isd = 1 / dim ** 0.5
        if saturate:
            e = (z[src_t] * q[dst_t]).sum(-1) * isd
            frac = float((e.abs() >= 40).float().mean())
            if frac < 0.01:
                raise AssertionError(f"K7 mid {tag}: {frac:.4f} saturated")
        ins = [t.clone().requires_grad_() for t in (q, z)]
        before = [c.launches for c in counters]
        out = bd.bitdot_attention_aggregate(bf, *ins)
        out.backward(g)
        torch.cuda.synchronize()
        if [c.launches - b for c, b in zip(counters, before)] != [1, 1, 1]:
            raise AssertionError(f"K7 mid {tag}: not one launch each way")
        l = bd.bitdot_fwd(bf.packed, q, z, isd)[1]
        want = bd.bitdot_fwd_plain(bf.packed, q, z, isd)
        want += bitdot_plain_bwd(bf, q, z, g, *want)
        errs = [close(got, w, f"K7 mid {name} {tag}")
                for name, got, w in zip(
                    ("out", "l", "dq", "dz"),
                    (out.detach(), l, ins[0].grad, ins[1].grad), want)]
        msg = (f"# K7 mid {tag}: max|err| out {errs[0]:.3g}, l "
               f"{errs[1]:.3g}, dq {errs[2]:.3g}, dz {errs[3]:.3g}")
        if saturate:
            msg += f"; {frac:.1%} of the scores past +-40"
        else:
            linv, rho = bg.backward_scales(g, want[0], want[1], None)
            times = [cuda_ms(lambda: bd.bitdot_fwd(bf.packed, q, z, isd)),
                     cuda_ms(lambda: bd.bitdot_bwd_dz(bf.packed_rev, q, z,
                                                      g, linv, rho, isd)),
                     cuda_ms(lambda: bd.bitdot_bwd_dq(bf.packed, q, z, g,
                                                      linv, rho, isd))]
            msg += ("; fwd {:.4f} ms, dz {:.4f} ms, dq {:.4f} ms ({} edges)"
                    .format(*times, len(row)))
        log(msg)
    # all scores 0: every p is 1 and l is each dst's in-degree, a sum that
    # is exact in any order
    l = bd.bitdot_fwd(bf.packed, torch.zeros_like(q), z, 0.125)[1]
    deg = torch.bincount(dst_t, minlength=n_dst).float()
    if not torch.equal(l, deg.unsqueeze(1).expand_as(l)):
        raise AssertionError("K7 mid: l at zero scores is not the in-degree")

    gr = dgt.graph((row, col), num_nodes=n_src, device="cuda")
    gr.unit().create_bitmask_format(on_device=True)
    x = torch.randn(n_src, DOTGAT_FIN, device="cuda", generator=gen)
    mseed = torch.Generator(device="cuda").manual_seed(29)
    for dim, heads, launches in ((DOTGAT_D, DOTGAT_H, 1), (32, DOTGAT_H, 0)):
        conv = dgt.nn.DotGatConv(DOTGAT_FIN, dim, heads, generator=mseed)

        def step():
            conv.zero_grad()
            xs = x.clone().requires_grad_()
            out = conv(gr, xs)
            out.square().mean().backward()
            return [out.detach(), xs.grad] + [p.grad.clone()
                                              for p in conv.parameters()]

        before = [c.launches for c in counters]
        kern = step()
        torch.cuda.synchronize()
        got = [c.launches - b for c, b in zip(counters, before)]
        if got != [launches] * 3:
            raise AssertionError(f"DotGatConv(64, {dim}, {heads}): K7 "
                                 f"launches {got}, not {launches} each")
        if not launches:
            log(f"# DotGatConv(64, {dim}, {heads}) mid size: no K7 launch "
                f"(D < 64)")
            continue
        config.set_use_kernels(False)
        try:
            ref = step()
        finally:
            config.set_use_kernels(True)
        err = close(kern[0], ref[0], "DotGatConv K7 vs gather path")
        for i, (a, b) in enumerate(zip(kern[1:], ref[1:])):
            close(a, b, f"DotGatConv K7 grad {i}", rtol=1e-3, atol=1e-5)
        log(f"# DotGatConv(64, {dim}, {heads}) mid size, K7 vs gather "
            f"path: out max|err| {err:.3g}, {len(kern) - 1} gradients agree")


def all_counts(bm, bg, bd, tts, tgf):
    """Every wrapper's launch counter of the port's kernels."""
    counts = read_counts(tts, tgf)
    for mod, names in ((bm, ("bit_matmul_t", "bit_matmul")),
                       (bg, ("bitgat_fwd", "bitgat_bwd")),
                       (bd, K7_COUNTERS)):
        counts.update({name: getattr(mod, name).launches for name in names})
    return counts


def dotgat_loss(model, g, x, y=None, train=None):
    """(out^2).mean() of one DotGatConv (tools/perf_bitdot_full.py:81)."""
    return model(g, x).square().mean()


def phase_dotgat_k7(dgt, bm, bg, bd, tts, tgf, g):
    """Phase 29: DotGatConv(64, 64, 2) with loss (out^2).mean() and Adam
    1e-3 on the phase-4 bitmask graph, K7 forward and backward: one
    warm-up step and 5 timed steps, every counter set to 0 just before and
    read just after; then a profiled step held to the counters."""
    gen = torch.Generator(device="cuda").manual_seed(30)
    conv = dgt.nn.DotGatConv(DOTGAT_FIN, DOTGAT_D, DOTGAT_H, generator=gen)
    x = torch.randn(N_NODES, DOTGAT_FIN, device="cuda", generator=gen)
    opt = torch.optim.Adam(conv.parameters(), lr=1e-3)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(tts, tgf)
    for mod in (bm.bit_matmul_t, bm.bit_matmul, bg.bitgat_fwd,
                bg.bitgat_bwd) + tuple(getattr(bd, n) for n in K7_COUNTERS):
        mod.launches = 0
    times, losses = [], []
    for _ in range(DOTGAT_K7_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = dotgat_loss(conv, g, x)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = all_counts(bm, bg, bd, tts, tgf)
    step_s = statistics.median(times[1:])
    log(f"# DotGatConv(64, 64, 2) on K7: steps "
        f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms, median after one "
        f"warm-up step {step_s * 1e3:.3f} ms, "
        f"{g.num_edges() / step_s:.6g} train-edges/s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes, loss "
        f"{', '.join(f'{v:.6f}' for v in losses)}, launches a step "
        f"{ {k: v / DOTGAT_K7_STEPS for k, v in counts.items()} }")
    want = {name: 0 for name in counts}
    want.update({name: DOTGAT_K7_STEPS for name in K7_COUNTERS})
    if counts != want:
        raise AssertionError(f"DotGat K7 launches {counts}, not one of each "
                             f"K7 kernel a step and no other")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"DotGat losses do not fall: {losses}")
    phase_profile(conv, opt, g, x, None, None,
                  lambda: all_counts(bm, bg, bd, tts, tgf), loss=dotgat_loss)
    return conv, x, counts


class PlainBitDot(torch.autograd.Function):
    """K7's attention built from the plain versions alone: the twin of the
    port's ``_BitDot``."""

    @staticmethod
    def forward(ctx, q, z, bf):
        from dgl_tpu_torch.ops.kernels import bitdot as bd
        out, l = bd.bitdot_fwd_plain(bf.packed, q, z, 1 / q.shape[2] ** 0.5)
        ctx.save_for_backward(q, z, out, l)
        ctx.bf = bf
        return out

    @staticmethod
    def backward(ctx, g):
        return bitdot_plain_bwd(ctx.bf, *ctx.saved_tensors[:2], g,
                                *ctx.saved_tensors[2:]) + (None,)


def phase_dotgat_k7_check(conv, g, x):
    """One step of phase 29's layer on K7 against the same step built from
    the plain versions: loss and both weight gradients."""
    heads, dim = conv.num_heads, conv.out_feats

    def grads(forward):
        conv.zero_grad()
        out = forward()
        if out.shape != (N_NODES, heads, dim) or not torch.isfinite(
                out).all():
            raise AssertionError("DotGatConv output is not finite of shape "
                                 f"{(N_NODES, heads, dim)}")
        loss = out.square().mean()
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in conv.named_parameters()}

    loss_k, grad_k = grads(lambda: conv(g, x))
    loss_p, grad_p = grads(lambda: PlainBitDot.apply(
        conv.fc_dst(x).reshape(-1, heads, dim),
        conv.fc_src(x).reshape(-1, heads, dim), g.unit()._bits))
    if abs(loss_k - loss_p) > 1e-4 * abs(loss_p):
        raise AssertionError(f"loss {loss_k} (K7) vs {loss_p} (plain)")
    for n in grad_k:
        close(grad_k[n], grad_p[n], f"DotGat K7 grad {n}", rtol=1e-3,
              atol=1e-5)
    log(f"# DotGatConv, K7 vs its plain versions at full size: loss "
        f"{loss_k:.8f} vs {loss_p:.8f}, {len(grad_k)} gradients agree")


def timed_once(fn):
    """(fn(), its device ms) from one call between CUDA events: the plain
    versions take seconds at full size, so their yardstick is the call
    that also gives the reference."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    return result, start.elapsed_time(end)


def bitdot_yardsticks(bd, bg, g, heads, dim, rate):
    """Phase 30: each K7 kernel at full size on the phase-4 graph against
    its plain version on every row, with its time (median of 5), its plain
    version's (the one call that gives the reference), the bound and no
    library time: no PyTorch call computes masked-softmax attention on a
    graph.  q and z are of a trained layer's size, on a grid of 1/16 in
    [-2, 2] (scores about 1.3 wide, inside the clip), g normal.  No sum
    here is exact (exp(e) lies on no grid), so each check takes the
    standard tolerance and ``close``'s half-tolerance log."""
    bf, e = g.unit()._bits, g.num_edges()
    n, isd = N_NODES, 1 / dim ** 0.5
    gen = torch.Generator(device="cuda").manual_seed(heads * 100 + dim)
    q, z, gr = bitdot_inputs(gen, n, n, heads, dim, top=2.0)
    node, feat_b = n * heads * 4, n * heads * dim * 4
    rows = {}

    def row(name, kernel, plain, nbytes, ops):
        got = kernel()
        want, plain_ms = timed_once(plain)
        err = max(close(a, w, f"K7 {name} full size H={heads} D={dim}")
                  for a, w in zip(got if isinstance(got, tuple) else (got,),
                                  want if isinstance(want, tuple)
                                  else (want,)))
        bnd, by = bound(nbytes, ops, rate)
        r = {"max_abs_err": err, "ms": cuda_ms(kernel), "plain_ms": plain_ms,
             "bound_ms": bnd, "bound_by": by, "library_ms": None}
        rows[name] = r
        log(f"# K7 {name} H={heads} D={dim}: {r['ms']:.4f} ms (bound "
            f"{bnd:.4f} ms by {by}: {nbytes} B, {ops} ops), plain "
            f"{plain_ms:.4f} ms, library none, max|err| {err:.3g}")
        return want

    # forward: in the bits of A, q, z; out out, l.  Per edge and head the
    # score (2 D), clip and exp (3), l (1) and the sum p z (2 D)
    out, l = row("fwd", lambda: bd.bitdot_fwd(bf.packed, q, z, isd),
                 lambda: bd.bitdot_fwd_plain(bf.packed, q, z, isd),
                 bf.packed.numel() * 4 + 3 * feat_b + node,
                 e * heads * (4 * dim + 5))
    linv, rho = bg.backward_scales(gr, out, l, None)
    del out, l
    args = (q, z, gr, linv, rho, isd)
    # dz: in the bits of A^T, q, z, g, linv, rho; out dz.  Per edge and
    # head the two dots (4 D), p, alpha, de, the clip mask and draw (12),
    # draw q + alpha g (4 D)
    row("dz", lambda: bd.bitdot_bwd_dz(bf.packed_rev, *args),
        lambda: bd.bitdot_bwd_dz_plain(bf.packed_rev, *args),
        bf.packed_rev.numel() * 4 + 4 * feat_b + 2 * node,
        e * heads * (8 * dim + 12))
    # dq: the same inputs over the bits of A; the sum draw z (2 D)
    row("dq", lambda: bd.bitdot_bwd_dq(bf.packed, *args),
        lambda: bd.bitdot_bwd_dq_plain(bf.packed, *args),
        bf.packed.numel() * 4 + 4 * feat_b + 2 * node,
        e * heads * (6 * dim + 12))
    return rows


# -- the hybrid slice (K12) ---------------------------------------------------

K12_FS = (1, 8, 16, 41, 128)
# bench.py's hybrid settings (bench.py:91-97: k_dense 32768, min_degree
# 96, symmetric; tile 1024, cap 512), and what they give on the phase-4
# graph (seed 0, 114,848,857 edges with self-loops), measured on the host
HYBRID_K, HYBRID_MIN_DEGREE = 32_768, 96
HYBRID_WANT = {"k": 32_768, "dense_edges": 57_834_296,
               "hub_src_edges": 32_008_552, "remainder_edges": 25_006_009,
               "block_bytes": 7_637_827_584}
# auto_format on the three graphs of tests/test_pallas.py:1067-1097: what
# the JAX package returns there
AUTO_FORMAT_WANT = ("bitmask", "hybrid", "tiled")


def k12_counts(i8, tts):
    """The hybrid route's launch counters: K12 both ways and K3."""
    return {"int8_matmul_rows": i8.int8_matmul_rows.launches,
            "int8_matmul_cols": i8.int8_matmul_cols.launches,
            "k3_spmm": tts.tiled_spmm.launches}


def reset_k12_counts(i8, tts):
    for fn in (i8.int8_matmul_rows, i8.int8_matmul_cols, tts.tiled_spmm):
        fn.launches = 0


def close_f32_sums(got, want, mag, terms, what):
    """Raise unless |got - want| <= 2 terms 2^-24 mag at every element:
    two f32 sums of ``terms`` products taken in two orders, each within
    terms 2^-24 of ``mag``, the sum of the products' magnitudes.  The
    K12 checks on normal inputs take this bound: their sums of up to
    23,900 products of counts up to 127 cancel to near 0, where RTOL and
    ATOL do not hold.  Returns max|got - want|."""
    err = (got - want).abs()
    if (err > 2 * terms * 2.0 ** -24 * mag).any():
        raise AssertionError(f"{what}: past the f32 rounding of two sums")
    return float(err.max())


def hub_graph(kind, n=23_900, seed=31):
    """A mid-size COO on 23,900 nodes (N_pad = 23,936, a multiple of no
    K12 block size): 600,000 edges, 240,000 of them into the 300 hubs
    0..299, 20,000 multi-edges.  ``kind``: "sym" adds every edge's
    reverse; "multires" adds 30,000 edges in one 256 x 256 tile pair;
    "star" keeps only edges between a hub and a non-hub, both ways."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, 600_000)
    col = np.r_[rng.integers(0, n, 360_000), rng.integers(0, 300, 240_000)]
    row[:20_000], col[:20_000] = row[20_000:40_000], col[20_000:40_000]
    if kind == "multires":
        row = np.r_[row, rng.integers(4096, 4352, 30_000)]
        col = np.r_[col, rng.integers(8192, 8448, 30_000)]
    if kind == "star":
        row, col = rng.integers(300, n, 300_000), rng.integers(0, 300,
                                                               300_000)
    if kind in ("sym", "star"):
        row, col = np.r_[row, col], np.r_[col, row]
    return row, col, n


def auto_format_graphs():
    """The three graphs of tests/test_pallas.py:1067-1097, with the
    keyword arguments that test passes."""
    rng = np.random.default_rng(7)
    n, e = 2000, 1_200_000
    r0, c0 = rng.integers(0, n, e // 2), rng.integers(0, n, e // 2)
    hub = rng.integers(0, 64, e)
    src = rng.integers(0, 30000, e)
    return [((np.r_[r0, c0], np.r_[c0, r0]), n, {}),
            ((src, hub), 30000, {"hbm_budget_bytes": 1 << 20}),
            ((rng.integers(0, 5000, 20000), rng.integers(0, 5000, 20000)),
             None, {})]


def phase_hybrid_mid(dgt, i8, tts):
    """Phase 31: K12 against its plain version in both orientations at
    mid size (k = 1003, N = 23,900, N_pad = 23,936; F = 1, 8, 16, 41, 128;
    counts up to 127 at a hub row's density; exact on a grid of 2^-12,
    which bf16 does not hold, within the f32 rounding of two sums on
    normal inputs; an all-zero block), each one's time; then
    ``update_all(copy_u, sum)`` on the hybrid format, forward and
    gradient, against the gather path on the ``hub_graph`` cases (not
    symmetric, symmetric, multires ((256, 512), (1024, 256)), a weighted
    bf16 block, an empty remainder), with the launches each takes; then
    auto_format on the JAX test's three graphs."""
    from dgl_tpu_torch.utils import config
    gen = torch.Generator(device="cuda").manual_seed(31)
    k, n = 1003, 23_900
    n_pad = -(-n // 128) * 128
    a = torch.randint(0, 128, (k, n_pad), dtype=torch.int8, device="cuda",
                      generator=gen)
    # about 7,600 counted edges a row, within the Reddit hubs' degrees
    # (96 to 10,674)
    a *= torch.rand(k, n_pad, device="cuda", generator=gen) < 0.005
    a[:, n:] = 0
    zero = torch.zeros_like(a)
    # products of the counts and inputs on a grid of 2^-12 in [-1/4, 1/4]
    counted = max(int(a.sum(dim, dtype=torch.int64).max()) for dim in (0, 1))
    exact_sums(counted / 4, 2 ** -12, "K12 mid size")
    for f in K12_FS:
        for name, kernel, plain, rows in (
                ("rows", i8.int8_matmul_rows, i8.int8_matmul_rows_plain, n),
                ("cols", i8.int8_matmul_cols, i8.int8_matmul_cols_plain, k)):
            x = grid(gen, rows, f, step=2 ** -12, top=0.25)
            if torch.equal(x.to(torch.bfloat16).float(), x):
                raise AssertionError(f"K12 {name} F={f}: the inputs are "
                                     "exact in bf16")
            xn = torch.randn(rows, f, device="cuda", generator=gen)
            before = kernel.launches
            got = kernel(a, x)
            torch.cuda.synchronize()
            if kernel.launches != before + 1:
                raise AssertionError(f"K12 {name} F={f} did not launch")
            if not torch.equal(got, plain(a, x)):
                raise AssertionError(f"K12 {name} mid F={f}: not exact on "
                                     "a grid")
            err = close_f32_sums(kernel(a, xn), plain(a, xn),
                                 plain(a, xn.abs()), rows,
                                 f"K12 {name} mid F={f}")
            if kernel(zero, xn).any():
                raise AssertionError(f"K12 {name} F={f}: a zero block gave "
                                     "a nonzero product")
            log(f"# K12 {name} mid F={f}: exact on the grid, normal inputs "
                f"max|err| {err:.3g}, {cuda_ms(lambda: kernel(a, xn)):.4f} "
                f"ms")
    del a, zero

    for kind in ("asym", "sym", "multires", "weighted", "star"):
        row, col, n = hub_graph(kind)
        kw = dict(k_dense=512, min_degree=256,
                  symmetric=kind in ("sym", "star"))
        hub = col < 300
        w = None
        if kind == "multires":
            kw["multires"] = ((256, 512), (1024, 256))
        if kind == "weighted":
            w = grid(gen, len(row), step=1 / 4, top=2, low=0.25)
            kw["weights"] = w.cpu().numpy()
        g = dgt.graph((row, col), num_nodes=n, device="cuda")
        t0 = time.perf_counter()
        g.unit().create_hybrid_format(**kw)
        build_s = time.perf_counter() - t0
        hf = g.unit()._hybrid
        levels = len(hf.tf_fwd) if isinstance(hf.tf_fwd, tuple) else 1
        if hf.k != 300 or levels != {"multires": 2, "star": 0}.get(kind, 1):
            raise AssertionError(f"hybrid {kind}: k {hf.k}, {levels} levels")
        x = grid(gen, n, HIDDEN, step=1 / 8, top=1)
        dz = grid(gen, n, HIDDEN, step=1 / 8, top=1)

        def run(op, ew):
            xg = x.clone().requires_grad_()
            out = dgt.ops.gspmm(g, op, "sum", xg, ew)
            out.backward(dz)
            return out.detach(), xg.grad

        before = k12_counts(i8, tts)
        out, dx = run("copy_lhs", None)
        torch.cuda.synchronize()
        launched = {name: v - before[name]
                    for name, v in k12_counts(i8, tts).items()}
        config.set_use_kernels(False)
        try:
            # the weights reach the hub rows only (the JAX package's
            # builder): the remainder's edges count 1
            ew = None if w is None else torch.where(
                torch.from_numpy(hub).cuda(), w, 1.0)
            ref, dref = run("copy_lhs" if w is None else "mul", ew)
        finally:
            config.set_use_kernels(True)
        e_f = close(out, ref, f"hybrid {kind} forward")
        e_b = close(dx, dref, f"hybrid {kind} gradient")
        want_k12 = 0 if kind == "weighted" else 2 if kw["symmetric"] else 1
        if (launched["int8_matmul_rows"], launched["int8_matmul_cols"]) != (
                want_k12, want_k12):
            raise AssertionError(f"hybrid {kind}: launches {launched}")
        log(f"# hybrid {kind} mid size (built in {build_s:.2f}s, block "
            f"{hf.a_dense.dtype}, {levels} level(s)): forward max|err| "
            f"{e_f:.3g}, gradient {e_b:.3g}, launches {launched}")
        del g, hf

    for i, ((row, col), n, kw) in enumerate(auto_format_graphs()):
        g = dgt.graph((row, col), num_nodes=n, device="cuda")
        got = g.auto_format(**kw)
        if got != {g.canonical_etypes[0]: AUTO_FORMAT_WANT[i]}:
            raise AssertionError(f"auto_format on graph {i}: {got}, the JAX "
                                 f"package's {AUTO_FORMAT_WANT[i]}")
        log(f"# auto_format on tests/test_pallas.py's graph {i}: {got}")
        del g


def hybrid_graph(dgt, hyb, gt):
    """Phase 32: a third graph over the phase-4 COO with bench.py's
    symmetric hybrid format, built on the host and moved to the card; its
    sizes held against those measured on the host."""
    gh = dgt.graph(gt.unit().coo(), num_nodes=N_NODES, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gh.unit().create_hybrid_format(k_dense=HYBRID_K,
                                   min_degree=HYBRID_MIN_DEGREE,
                                   symmetric=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    hf = gh.unit()._hybrid
    levels = hyb._levels(hf.tf_fwd)
    got = {"k": hf.k,
           # the block's counts, summed 1,024 rows at a time
           "dense_edges": sum(int(hf.a_dense[r:r + 1024].sum(
               dtype=torch.int64)) for r in range(0, hf.k, 1024)),
           "remainder_edges": sum(int((tf.eid >= 0).sum()) for tf in levels),
           "block_bytes": hf.a_dense.numel() * hf.a_dense.element_size()}
    got["hub_src_edges"] = (gh.num_edges() - got["dense_edges"]
                            - got["remainder_edges"])
    fwd = levels[0]
    log(f"# hybrid format (k_dense {HYBRID_K}, min_degree "
        f"{HYBRID_MIN_DEGREE}, symmetric) built in {build_s:.1f}s: {got}, "
        f"block {tuple(hf.a_dense.shape)} {hf.a_dense.dtype}, remainder "
        f"tile {fwd.tile}, cap {fwd.cap}, {fwd.num_buckets} buckets, "
        f"{fwd.nbytes} bytes")
    if got != HYBRID_WANT or hf.a_dense.dtype != torch.int8:
        raise AssertionError(f"hybrid sizes {got}, not {HYBRID_WANT}")
    return gh


def phase_hybrid_gcn(dgt, i8, tts, gh, x, y, train):
    """Phase 32: 10 Adam steps of the GCN on the hybrid format; the K12 and
    K3 counts are set to 0 just before and read just after."""
    model = GCN(dgt, torch.Generator(device="cuda").manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    torch.cuda.reset_peak_memory_stats()
    reset_k12_counts(i8, tts)
    losses, step_s = train_loop("hybrid GCN", model, opt, gh, x, y, train)
    counts = k12_counts(i8, tts)
    log(f"# hybrid GCN train: median step {step_s * 1e3:.3f} ms after one "
        f"warm-up step, {gh.num_edges() / step_s:.6g} train-edges/s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes, "
        f"launches {counts}")
    # per step: two SpMMs forward and two backward, each K3 on the
    # remainder, K12 on the hub rows and K12 on the hub columns
    if counts != {name: 4 * STEPS for name in counts}:
        raise AssertionError(f"hybrid GCN launches {counts}, not 4 each a "
                             "step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"hybrid GCN losses do not fall: {losses}")
    return model, opt, counts


def phase_hybrid_check(model, gh, gt, x, y, train):
    """Phase 32: one step of the model on the hybrid format against the
    same step on route 1's tiled format (K3 alone), same COO."""
    def grads(g):
        model.zero_grad()
        loss = loss_fn(model, g, x, y, train)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}

    loss_h, grad_h = grads(gh)
    loss_t, grad_t = grads(gt)
    if abs(loss_h - loss_t) > 1e-4 * abs(loss_t):
        raise AssertionError(f"loss {loss_h} (hybrid) vs {loss_t} (tiled)")
    for n in grad_h:
        close(grad_h[n], grad_t[n], f"hybrid grad {n}", rtol=1e-3, atol=1e-5)
    log(f"# hybrid vs route 1's tiled step: loss {loss_h:.8f} vs "
        f"{loss_t:.8f}, {len(grad_h)} gradients agree")


def hybrid_yardsticks(i8, gh, rate):
    """Phase 33: K12 in both orientations at full size (k = 32,768, N_pad =
    233,088, F = 16), exactly equal to its plain version on inputs on a
    grid of 2^-12 in [-1/4, 1/4] (values of up to 11 significant bits,
    which bf16 does not hold: a kernel that rounded x or z to bf16 would
    fail), its time (median of 5), its plain version's (the one call that
    gives the reference), the bound and the library time: ``torch.matmul``
    of the block widened once to bf16 (not timed) with x or z in bf16,
    XLA's product off the TPU.

    The bound is the card's, not this kernel design's: the int8 block is
    exact in bf16, and x split into three bf16 parts gives the products at
    f32 accuracy on the tensor cores, 3 * 2 k N_pad F operations at the
    bf16 rate.  At F = 16 that is 0.74 ms, under the 2.28 ms stream of the
    block, so the bytes bound it."""
    a = gh.unit()._hybrid.a_dense
    k, n_pad = a.shape
    gen = torch.Generator(device="cuda").manual_seed(33)
    # a row sums at most max_degree counted edges, each times |x| <= 1/4
    deg = max_degree(gh)
    log(f"# the graph's largest degree: {deg}")
    exact_sums(deg / 4, 2 ** -12, "K12 full size")
    ab = a.to(torch.bfloat16)
    rows = {}
    for name, kernel, plain, n_in in (
            ("rows", i8.int8_matmul_rows, i8.int8_matmul_rows_plain,
             N_NODES),
            ("cols", i8.int8_matmul_cols, i8.int8_matmul_cols_plain, k)):
        x = grid(gen, n_in, HIDDEN, step=2 ** -12, top=0.25)
        if torch.equal(x.to(torch.bfloat16).float(), x):
            raise AssertionError(f"K12 {name}: the inputs are exact in bf16")
        got = kernel(a, x)
        want, plain_ms = timed_once(lambda: plain(a, x))
        if not torch.equal(got, want):
            raise AssertionError(f"K12 {name} full size is not exact")
        err = close(got, want, f"K12 {name} full size")
        xb = x.to(torch.bfloat16)
        lib = (lambda: torch.matmul(ab[:, :n_in], xb)) if name == "rows" \
            else (lambda: torch.matmul(ab.T, xb))
        # the library's sums come back in bf16, rounded (in cuBLAS's split
        # of a sum of up to 233,088 terms, maybe more than once): held to
        # 2^-6 of the sum of the terms' magnitudes, with its worst share
        # of that logged
        lib_err = (lib().float() - want).abs() / plain(a, x.abs()).clamp(
            min=1)
        if float(lib_err.max()) > 2 ** -6:
            raise AssertionError(f"torch.matmul bf16 {name}: off by "
                                 f"{float(lib_err.max()):.3g} of the sum of "
                                 "magnitudes")
        nbytes = a.numel() + x.numel() * 4 + want.numel() * 4
        ops = 3 * 2 * k * n_pad * HIDDEN
        bnd, by = bound(nbytes, ops, rate, peak=BF16_PEAK)
        r = {"max_abs_err": err, "ms": cuda_ms(lambda: kernel(a, x)),
             "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
             "library_ms": cuda_ms(lib)}
        rows[name] = r
        log(f"# K12 {name} F={HIDDEN}: {r['ms']:.4f} ms (bound {bnd:.4f} ms "
            f"by {by}: {nbytes} B, {ops} bf16 ops), plain "
            f"{plain_ms:.4f} ms, library (torch.matmul, bf16) "
            f"{r['library_ms']:.4f} ms (its error up to "
            f"{float(lib_err.max()):.3g} of the sum of magnitudes), "
            f"max|err| {err:.3g}")
        del want, got, lib_err
    del ab
    return rows


# -- the mesh-sharded slice (bitspmd, bitgat_spmd) ---------------------------

SHARD_SHAPES = GAT_SHAPES + ((8, 16), (2, 16))
SHARD_PARTS = (1, 2, 4)
SHARD_FIELDS = ("shards", "shards_rev", "rem_src_g", "rem_dst_l", "rem_w",
                "brem_src_g", "brem_dst_l", "brem_w")
# the Reddit graph's one-part symmetric format: kp = 233,472 rows of W =
# 7,296 words, and its set bits, one per edge with self-loops
REDDIT_SHARD_BYTES = 6_813_646_848
REDDIT_EDGES = 114_848_857


def popcounts(words):
    """The set bits of each word of an int32 tensor, as int64."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def popcount(words):
    """Set bits of an int32 tensor, counted 2^26 words at a time."""
    flat, total = words.reshape(-1), 0
    for i in range(0, flat.numel(), 1 << 26):
        total += int(popcounts(flat[i:i + (1 << 26)]).sum())
    return total


def shard_mid_graph():
    """Phase 34's simple COO on 24,000 nodes: the phase-8 graph and 64
    edges more into its last 192 dst, so that the shards of every build
    reach bit plane 31 (dst 23,808 and up at one part; device 0's last
    32nd at two and four)."""
    row, col, n, _ = mid_graph()
    rng = np.random.default_rng(34)
    row = np.r_[row, rng.integers(0, n, 64)]
    col = np.r_[col, n - 1 - rng.integers(0, 192, 64)]
    key = np.unique(col * n + row)
    return key % n, key // n, n


def emulate_spmm(bm, fmt, x, rev=False):
    """``bit_sharded_spmm``'s forward (or, with ``rev``, its backward) over
    every shard of ``fmt`` in this process, the all-gather replaced by
    the padded ``x`` itself: (P npp, F)."""
    names = ("shards_rev", "brem_src_g", "brem_dst_l", "brem_w") if rev \
        else ("shards", "rem_src_g", "rem_dst_l", "rem_w")
    shards, rsg, rdl, rw = (getattr(fmt, n) for n in names)
    outs = []
    for p in range(fmt.num_parts):
        out = bm.bit_matmul_t(shards[p], x[:fmt.kp], fmt.npp)
        real = rdl[p] < fmt.npp
        outs.append(bm.add_remainder(out, x, rsg[p][real].long(),
                                     rdl[p][real].long(), rw[p][real]))
    return torch.cat(outs)


def emulate_gat(bg, tgs, fmt, el, er, z, g):
    """``bit_sharded_gat``'s forward and backward over every shard of
    ``fmt`` in this process, the collectives replaced by slices, cat and
    sum: (out, d_el, d_er, d_z), all (P npp, ...), for inputs inside the
    clip."""
    kp, npp, parts = fmt.kp, fmt.npp, fmt.num_parts
    rows = lambda t, p: t[p * npp:(p + 1) * npp]  # noqa: E731
    fwd = [bg.bitgat_fwd_t(fmt.shards[p], el[:kp], rows(er, p), z[:kp], npp,
                           SLOPE) for p in range(parts)]
    out = torch.cat([o for o, _ in fwd])
    linv, rho = bg.backward_scales(g, out, torch.cat([l for _, l in fwd]),
                                   None)
    d_el, d_z, d_er = torch.zeros_like(el), torch.zeros_like(z), []
    for p in range(parts):
        a, b, c = tgs.bit_shard_gat_bwd(
            fmt.shards[p], el[:kp], rows(er, p), z[:kp], rows(g, p),
            rows(linv, p), rows(rho, p), npp, SLOPE)
        d_el[:kp] += a
        d_z[:kp] += c
        d_er.append(b)
    return out, d_el, torch.cat(d_er), d_z


def phase_sharded_mid(bm, bg, tbs, tgs, group):
    """Phase 34: the sharded format and its kernels at mid size, the ops on
    the world-size-1 NCCL ``group`` against the single-card routes, a
    4-shard emulation against them, and ``dryrun_multichip(1)``."""
    from dgl_tpu_torch.parallel import dryrun_multichip
    row, col, n = shard_mid_graph()
    gen = torch.Generator(device="cuda").manual_seed(34)
    fmts, errs = {}, {"K1": 0.0, "bitgat_fwd_t": 0.0, "K13": 0.0}
    for parts in SHARD_PARTS:
        fmt = tbs.build_bit_sharded_format_device(row, col, n, parts,
                                                  device="cuda")
        host = tbs.build_bit_sharded_format(row, col, n, parts, device="cpu")
        for name in SHARD_FIELDS:
            if not torch.equal(getattr(fmt, name).cpu(), getattr(host, name)):
                raise AssertionError(f"{parts} parts: the device builder's "
                                     f"{name} differs from the host's")
        if not ((fmt.shards < 0).any() and (fmt.shards_rev < 0).any()):
            raise AssertionError(f"{parts} parts: no shard reaches plane 31")
        fmts[parts] = fmt
        kp, npp = fmt.kp, fmt.npp
        for p in range(parts):
            shard = fmt.shards[p]
            for f in (HIDDEN, CLASSES):
                x = torch.randn(kp, f, device="cuda", generator=gen)
                errs["K1"] = max(errs["K1"], close(
                    bm.bit_matmul_t(shard, x, npp),
                    bm.bit_matmul_t_plain(shard, x, npp),
                    f"K1 shard {p}/{parts} F={f}"))
            for heads, dim in SHARD_SHAPES:
                tag = f"shard {p}/{parts} H={heads} D={dim}"
                el = torch.randn(kp, heads, device="cuda", generator=gen)
                er = torch.randn(npp, heads, device="cuda", generator=gen)
                z = torch.randn(kp, heads, dim, device="cuda", generator=gen)
                g = torch.randn(npp, heads, dim, device="cuda", generator=gen)
                f0 = bg.bitgat_fwd_t.launches
                b0 = tgs.bit_shard_gat_bwd.launches
                out, l = bg.bitgat_fwd_t(shard, el, er, z, npp, SLOPE)
                w_out, w_l = bg.bitgat_fwd_t_plain(shard, el, er, z, npp,
                                                   SLOPE)
                errs["bitgat_fwd_t"] = max(
                    errs["bitgat_fwd_t"], close(out, w_out, f"fwd_t {tag}"),
                    close(l, w_l, f"fwd_t l {tag}"))
                linv, rho = bg.backward_scales(g, w_out, w_l, None)
                args = (shard, el, er, z, g, linv, rho, npp, SLOPE)
                got = tgs.bit_shard_gat_bwd(*args)
                want = tgs.bit_shard_gat_bwd_plain(*args)
                errs["K13"] = max([errs["K13"]] + [
                    close(a, b, f"K13 {name} {tag}") for name, a, b in
                    zip(("d_el", "d_er", "d_z"), got, want)])
                if (bg.bitgat_fwd_t.launches - f0,
                        tgs.bit_shard_gat_bwd.launches - b0) != (1, 1):
                    raise AssertionError(f"{tag}: the kernels did not "
                                         "launch once each")
        log(f"# {parts}-part format built on the card, equal to the host "
            f"builder's: kp {kp}, npp {npp}, W {npp // 32}, "
            f"{fmt.bytes_per_device} bytes a device")
    log(f"# shard kernels vs plain versions: max|err| {errs}")

    # world size 1 against the single-card routes on the same graph
    fmt1 = fmts[1]
    bf = bm.build_bit_format_device(row, col, n, n, device="cuda")
    pad = lambda t: tbs.pad_nodes(fmt1, t)  # noqa: E731
    res = {}
    for f in (HIDDEN, CLASSES):
        x = torch.randn(n, f, device="cuda", generator=gen)
        dz = torch.randn(n, f, device="cuda", generator=gen)
        xs, xp = x.clone().requires_grad_(), pad(x).requires_grad_()
        want = bm.bit_spmm(bf, xs)
        want.backward(dz)
        k1 = bm.bit_matmul_t.launches
        out = tbs.bit_sharded_spmm(fmt1, xp, group)
        out.backward(pad(dz))
        if bm.bit_matmul_t.launches - k1 != 2:
            raise AssertionError("bit_sharded_spmm did not run on K1")
        e1 = close(out[:n].detach(), want.detach(), f"bit_sharded_spmm F={f}")
        e2 = close(xp.grad[:n], xs.grad, f"bit_sharded_spmm grad F={f}")
        res[f] = (out.detach(), xp.grad)
        log(f"# world size 1, bit_sharded_spmm F={f} vs bit_spmm: max|err| "
            f"{e1:.3g}, gradient {e2:.3g}")
        # four shards emulated in this process against world size 1
        fmt4 = fmts[4]
        o4 = emulate_spmm(bm, fmt4, tbs.pad_nodes(fmt4, x))
        d4 = emulate_spmm(bm, fmt4, tbs.pad_nodes(fmt4, dz), rev=True)
        close(o4[:n], res[f][0][:n], f"4-shard emulation F={f}")
        close(d4[:n], res[f][1][:n], f"4-shard emulation grad F={f}")
    for heads, dim in GAT_SHAPES:
        el, er = (torch.randn(n, heads, device="cuda", generator=gen)
                  for _ in range(2))
        z, g = (torch.randn(n, heads, dim, device="cuda", generator=gen)
                for _ in range(2))
        ins_s = [t.clone().requires_grad_() for t in (el, er, z)]
        want = bg.bitgat_attention_aggregate(bf, *ins_s, SLOPE)
        want.backward(g)
        ins_p = [pad(t).requires_grad_() for t in (el, er, z)]
        f0, b0 = bg.bitgat_fwd_t.launches, tgs.bit_shard_gat_bwd.launches
        out = tgs.bit_sharded_gat(fmt1, *ins_p, group, SLOPE)
        out.backward(pad(g))
        if (bg.bitgat_fwd_t.launches - f0,
                tgs.bit_shard_gat_bwd.launches - b0) != (1, 1):
            raise AssertionError("bit_sharded_gat did not run on its kernels")
        e = [close(out[:n].detach(), want.detach(),
                   f"bit_sharded_gat H={heads}")] + [
            close(tp.grad[:n], ts.grad, f"bit_sharded_gat {name} H={heads}")
            for name, tp, ts in zip(("d_el", "d_er", "d_z"), ins_p, ins_s)]
        fmt4 = fmts[4]
        em = emulate_gat(bg, tgs, fmt4, *(tbs.pad_nodes(fmt4, t)
                                         for t in (el, er, z, g)))
        for name, a, b in zip(("out", "d_el", "d_er", "d_z"), em,
                              (out.detach(),) + tuple(t.grad for t in ins_p)):
            close(a[:n], b[:n], f"4-shard emulation {name} H={heads}")
        log(f"# world size 1, bit_sharded_gat H={heads} D={dim} vs "
            f"bitgat_attention_aggregate: max|err| out {e[0]:.3g}, d_el "
            f"{e[1]:.3g}, d_er {e[2]:.3g}, d_z {e[3]:.3g}; the 4-shard "
            "emulation agrees")
    del fmts, fmt1, bf
    dryrun_multichip(1, device="cuda")


class ShardedGCN(torch.nn.Module):
    """The phase-4 GCN on the sharded format: ``GraphConv``'s norm "both"
    (degrees clamped at 1; the graph is symmetric, so in- and out-degrees
    agree) and the weight on the narrow side of each SpMM."""

    def __init__(self, gcn, group, deg):
        super().__init__()
        self.gcn, self.group = gcn, group
        self.norm = deg.clamp(min=1).pow(-0.5)[:, None]

    def forward(self, fmt, x):
        from dgl_tpu_torch.parallel import bit_sharded_spmm
        c1, c2, norm = self.gcn.conv1, self.gcn.conv2, self.norm
        h = torch.relu(bit_sharded_spmm(fmt, (x * norm) @ c1.weight,
                                        self.group) * norm + c1.bias)
        return (bit_sharded_spmm(fmt, h * norm, self.group) @ c2.weight) \
            * norm + c2.bias


def gcn_reference_step(dgt, g, x, y, train):
    """Phase 4's first step on the bitmask, recorded for phase 35: the loss
    and gradients of the seed-0 GCN, on the host."""
    model = GCN(dgt, torch.Generator(device="cuda").manual_seed(0))
    loss = loss_fn(model, g, x, y, train)
    loss.backward()
    return loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()}


def sharded_gat_convs(dgt, params):
    """The route-4 recipe's two ``GATConv`` layers (602 -> 4 x 32, 128 ->
    1 x 41, attention dropout 0), their weights drawn in the flax layout
    from a seed, as xavier-normal with the relu gain, and loaded through
    ``params.gatconv_state_dict``."""
    rng = np.random.default_rng(35)
    gain = np.sqrt(2.0)
    convs = []
    for fin, (h, d) in zip((FEAT, GAT_SHAPES[0][0] * GAT_SHAPES[0][1]),
                           GAT_SHAPES):
        attn = lambda: rng.normal(  # noqa: E731
            scale=gain * np.sqrt(2.0 / (h * d + d)), size=(1, h, d))
        flax = {"fc": {"kernel": rng.normal(
            scale=gain * np.sqrt(2.0 / (fin + h * d)), size=(fin, h * d))},
            "attn_l": attn(), "attn_r": attn(), "bias": np.zeros((1, h, d))}
        conv = dgt.nn.GATConv(fin, d, h, attn_drop=0.0, device="cuda")
        conv.load_state_dict(params.gatconv_state_dict(flax))
        convs.append(conv)
    return convs


class ShardedGAT(torch.nn.Module):
    """The route-4 GAT on the sharded format: each ``GATConv``'s
    projections (fc, attn_l, attn_r, bias) around ``gat``, which is
    ``bit_sharded_gat`` or its plain twin."""

    def __init__(self, convs, gat):
        super().__init__()
        self.conv1, self.conv2 = convs
        self.gat = gat

    def layer(self, conv, fmt, h):
        ft = conv.fc(h).reshape(-1, conv.num_heads, conv.out_feats)
        el = (ft * conv.attn_l).sum(-1)
        er = (ft * conv.attn_r).sum(-1)
        return self.gat(fmt, el, er, ft) + conv.bias

    def forward(self, fmt, x):
        h = torch.nn.functional.elu(self.layer(self.conv1, fmt, x).flatten(1))
        return self.layer(self.conv2, fmt, h).flatten(1)


class PlainShardedGAT(torch.autograd.Function):
    """``bit_sharded_gat`` built from the plain versions alone, with the
    same collectives: the twin of the port's ``_BitShardedGAT``."""

    @staticmethod
    def forward(ctx, el, er, z, fmt, group):
        from dgl_tpu_torch.ops.kernels import bitgat as bg
        from dgl_tpu_torch.parallel import comm
        clip = 20.0
        elc, erc = el.clamp(-clip, clip), er.clamp(-clip, clip)
        elg = comm.all_gather_rows(elc, group)[:fmt.kp]
        zg = comm.all_gather_rows(z, group)[:fmt.kp]
        out, l = bg.bitgat_fwd_t_plain(fmt.shards[0], elg, erc, zg, fmt.npp,
                                       SLOPE)
        ctx.save_for_backward(el, er, elg, erc, zg, out, l)
        ctx.fmt, ctx.group = fmt, group
        return out

    @staticmethod
    def backward(ctx, g):
        from dgl_tpu_torch.ops.kernels import bitgat as bg
        from dgl_tpu_torch.parallel import bitgat_spmd as tgs, comm
        el, er, elg, erc, zg, out, l = ctx.saved_tensors
        fmt, group, clip = ctx.fmt, ctx.group, 20.0
        linv, rho = bg.backward_scales(g, out, l, None)
        d_el, d_er, dz = tgs.bit_shard_gat_bwd_plain(
            fmt.shards[0], elg, erc, zg, g, linv, rho, fmt.npp, SLOPE)

        def scatter(part):
            full = part.new_zeros((fmt.num_parts * fmt.npp,)
                                  + tuple(part.shape[1:]))
            full[:fmt.kp] = part
            return comm.reduce_scatter_rows(full, group)
        d_el = torch.where((el > -clip) & (el < clip), scatter(d_el), 0.0)
        d_er = torch.where((er > -clip) & (er < clip), d_er, 0.0)
        return d_el, d_er, scatter(dz), None, None


def sharded_graph(tbs, gt):
    """Phase 35: the Reddit graph's symmetric one-part sharded format,
    scattered on the card from the phase-4 COO (simple by construction);
    its bytes and set bits held to the graph's."""
    row, col = gt.unit().coo()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fmt = tbs.build_bit_sharded_format_device(
        row, col, N_NODES, 1, symmetric=True, assume_simple=True,
        device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bits = popcount(fmt.shards)
    log(f"# one-part sharded format on the card in {build_s:.1f}s: kp "
        f"{fmt.kp}, npp {fmt.npp}, W {fmt.npp // 32}, "
        f"{fmt.bytes_per_device} bytes a device, {bits} set bits")
    if fmt.bytes_per_device != REDDIT_SHARD_BYTES or bits != REDDIT_EDGES \
            or fmt.has_remainder:
        raise AssertionError(f"sharded format of {fmt.bytes_per_device} B "
                             f"and {bits} bits, not {REDDIT_SHARD_BYTES} "
                             f"and {REDDIT_EDGES}")
    deg = tbs.sharded_in_degrees(fmt, row, col, device="cuda")
    return fmt, deg


def sharded_counts(bm, bg, tgs):
    return {"bit_matmul_t": bm.bit_matmul_t.launches,
            "bit_matmul": bm.bit_matmul.launches,
            "bitgat_fwd": bg.bitgat_fwd.launches,
            "bitgat_bwd": bg.bitgat_bwd.launches,
            "bitgat_fwd_t": bg.bitgat_fwd_t.launches,
            "bit_shard_gat_bwd": tgs.bit_shard_gat_bwd.launches}


def reset_sharded_counts(bm, bg, tgs):
    for fn in (bm.bit_matmul_t, bm.bit_matmul, bg.bitgat_fwd, bg.bitgat_bwd,
               bg.bitgat_fwd_t, tgs.bit_shard_gat_bwd):
        fn.launches = 0


def step_grads(model, fmt, x, y, train, params=None):
    """(loss, {name: gradient}) of one step of ``loss_fn``."""
    model.zero_grad()
    loss = loss_fn(model, fmt, x, y, train)
    loss.backward()
    named = (params or model).named_parameters()
    return loss.item(), {n: p.grad.clone() for n, p in named}


def hold_step(what, got, want):
    loss_g, grad_g = got
    loss_w, grad_w = want
    if abs(loss_g - loss_w) > 1e-4 * abs(loss_w):
        raise AssertionError(f"{what}: loss {loss_g} vs {loss_w}")
    for n in grad_w:
        close(grad_g[n].to(grad_w[n].device), grad_w[n], f"{what}: grad {n}",
              rtol=1e-3, atol=1e-5)
    log(f"# {what}: loss {loss_g:.8f} vs {loss_w:.8f}, {len(grad_w)} "
        "gradients agree")


def phase_sharded_gcn(dgt, bm, bg, tgs, group, fmt, deg, x, y, train, ref,
                      card):
    """Phase 35: the phase-4 GCN on ``bit_sharded_spmm``: one step of the
    seed-0 model against phase 4's bitmask step, then 10 Adam steps with
    the counts set to 0 just before and read just after."""
    gcn = GCN(dgt, torch.Generator(device="cuda").manual_seed(0))
    model = ShardedGCN(gcn, group, deg)
    hold_step("sharded GCN step vs phase 4's bitmask step",
              step_grads(model, fmt, x, y, train, gcn), ref)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    torch.cuda.reset_peak_memory_stats()
    reset_sharded_counts(bm, bg, tgs)
    losses, step_s = train_loop("sharded GCN", model, opt, fmt, x, y, train)
    counts = sharded_counts(bm, bg, tgs)
    log(f"# sharded GCN train ({card}): median step {step_s * 1e3:.3f} ms "
        f"after one warm-up step, {REDDIT_EDGES / step_s:.6g} train-edges/s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes, "
        f"launches {counts}")
    want = {name: 0 for name in counts}
    want["bit_matmul_t"] = 4 * STEPS
    if counts != want:
        raise AssertionError(f"sharded GCN launches {counts}, not 4 K1 a "
                             "step and no other")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"sharded GCN losses do not fall: {losses}")


def phase_sharded_gat(dgt, params, bm, bg, tgs, group, fmt, x, y, train,
                      card):
    """Phase 35: the route-4 GAT recipe on ``bit_sharded_gat`` for 10 Adam
    steps, the counts set to 0 just before and read just after; then a
    profiled step held to the counters and one step against the same step
    built from the plain versions."""
    from dgl_tpu_torch.parallel import bit_sharded_gat
    model = ShardedGAT(sharded_gat_convs(dgt, params),
                       lambda f, el, er, z: bit_sharded_gat(f, el, er, z,
                                                            group, SLOPE))
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    torch.cuda.reset_peak_memory_stats()
    reset_sharded_counts(bm, bg, tgs)
    losses, step_s = train_loop("sharded GAT", model, opt, fmt, x, y, train)
    counts = sharded_counts(bm, bg, tgs)
    log(f"# sharded GAT train ({card}): median step {step_s * 1e3:.3f} ms "
        f"after one warm-up step, {REDDIT_EDGES / step_s:.6g} train-edges/s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes, "
        f"launches {counts}")
    want = {name: 0 for name in counts}
    want.update(bitgat_fwd_t=2 * STEPS, bit_shard_gat_bwd=2 * STEPS)
    if counts != want:
        raise AssertionError(f"sharded GAT launches {counts}, not one "
                             "bitgat_fwd_t and one K13 a layer and step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"sharded GAT losses do not fall: {losses}")
    phase_profile(model, opt, fmt, x, y, train,
                  lambda: sharded_counts(bm, bg, tgs))
    got = step_grads(model, fmt, x, y, train)
    model.gat = lambda f, el, er, z: PlainShardedGAT.apply(el, er, z, f,
                                                           group)
    hold_step("sharded GAT step, kernels vs plain versions", got,
              step_grads(model, fmt, x, y, train))
    return counts


def shard_yardsticks(bg, tgs, shard, npp, bits, tag, heads, dim, rate):
    """Phase 36: ``bitgat_fwd_t`` and K13 on one full-size shard (rows =
    every src, bit columns = the npp dst of one device) against their
    plain versions on every row, with their times (median of 5), the
    plain versions' (the one call that gives the reference), the bound
    and no library time: no PyTorch call computes masked-softmax
    attention on a graph.  Inputs normal, as K5's yardsticks: exp lies on
    no grid, so the checks keep the standard tolerance."""
    kp = shard.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(heads * 100 + dim + npp)
    el = torch.randn(kp, heads, device="cuda", generator=gen)
    er = torch.randn(npp, heads, device="cuda", generator=gen)
    z = torch.randn(kp, heads, dim, device="cuda", generator=gen)
    g = torch.randn(npp, heads, dim, device="cuda", generator=gen)
    src_node, src_feat = kp * heads * 4, kp * heads * dim * 4
    dst_node, dst_feat = npp * heads * 4, npp * heads * dim * 4
    rows = {}

    def row(name, kernel, plain, nbytes, ops):
        got = kernel()
        want, plain_ms = timed_once(plain)
        err = max(close(a, w, f"{name} {tag} H={heads} D={dim}")
                  for a, w in zip(got, want))
        bnd, by = bound(nbytes, ops, rate)
        r = {"max_abs_err": err, "ms": cuda_ms(kernel), "plain_ms": plain_ms,
             "bound_ms": bnd, "bound_by": by, "library_ms": None}
        rows[name] = r
        log(f"# {name} {tag} H={heads} D={dim}: {r['ms']:.4f} ms (bound "
            f"{bnd:.4f} ms by {by}: {nbytes} B, {ops} ops), plain "
            f"{plain_ms:.4f} ms, library none, max|err| {err:.3g}")
        return want

    # forward: in the shard, el, z (every src), er (the device's dst); out
    # out, l.  Per edge and head the score and exp (5), l and p z (2 D)
    out, l = row("bitgat_fwd_t",
                 lambda: bg.bitgat_fwd_t(shard, el, er, z, npp, SLOPE),
                 lambda: bg.bitgat_fwd_t_plain(shard, el, er, z, npp, SLOPE),
                 shard.numel() * 4 + src_node + src_feat + 2 * dst_node
                 + dst_feat, bits * heads * (2 * dim + 5))
    linv, rho = bg.backward_scales(g, out, l, None)
    del out, l
    args = (shard, el, er, z, g, linv, rho, npp, SLOPE)
    # K13: in the shard, el, z, er, linv, rho, g; out del, dz (every
    # src), der.  Per edge and head the dot, alpha, de and draw (4 D + 12)
    row("bit_shard_gat_bwd", lambda: tgs.bit_shard_gat_bwd(*args),
        lambda: tgs.bit_shard_gat_bwd_plain(*args),
        shard.numel() * 4 + 2 * src_node + 2 * src_feat + 4 * dst_node
        + dst_feat, bits * heads * (4 * dim + 12))
    return rows


def phase_shard_yardsticks(bg, tgs, tbs, fmt, gt, rate):
    """Phase 36: the yardsticks on the one-part shard and on shard 0 of a
    4-part build, at (4, 32) and (1, 41)."""
    shard1 = fmt.shards[0]
    out = {f"1 part {h}x{d}": shard_yardsticks(
        bg, tgs, shard1, fmt.npp, REDDIT_EDGES, "1 part", h, d, rate)
        for h, d in GAT_SHAPES}
    row, col = gt.unit().coo()
    fmt4 = tbs.build_bit_sharded_format_device(
        row, col, N_NODES, 4, symmetric=True, assume_simple=True,
        device="cuda")
    shard0, npp4 = fmt4.shards[0].clone(), fmt4.npp
    del fmt4
    torch.cuda.empty_cache()
    bits = popcount(shard0)
    log(f"# shard 0 of the 4-part format: kp {shard0.shape[0]}, npp {npp4}, "
        f"W {shard0.shape[1]}, {shard0.numel() * 4} bytes, {bits} set bits")
    out.update({f"shard 0 of 4 {h}x{d}": shard_yardsticks(
        bg, tgs, shard0, npp4, bits, "shard 0 of 4", h, d, rate)
        for h, d in GAT_SHAPES})
    return out


def phase_sddmm_probe(tsw, gt, rate):
    """Phase 43: the SDDMM walk's write layouts, zeroing and hub rows side
    by side on the phase-12 format (``dgl_tpu_torch/tools/
    perf_sddmm_walk.py``), each layout held bit for bit to the wrapper's."""
    fwd, _ = gt.unit().tiled_format()
    return tsw.probe(fwd, rate, log)


def phase(name, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    result = fn(*args)
    torch.cuda.synchronize()
    log(f"# phase {name}: {time.perf_counter() - t0:.1f}s")
    return result


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, package_root())
    import dgl_tpu_torch as dgt
    from dgl_tpu_torch.ops import edgeflat as ef
    from dgl_tpu_torch.ops.kernels import bitdot as bd, bitgat as bg
    from dgl_tpu_torch.ops.kernels import bitmm as bm, build
    from dgl_tpu_torch.ops.kernels import spmm as tsp, tiled_spmm as tts
    from dgl_tpu_torch.ops.kernels import gat_fused as tgf
    from dgl_tpu_torch.ops.kernels import hybrid as hyb, int8mm as i8
    from dgl_tpu_torch import params
    from dgl_tpu_torch.parallel import bitgat_spmd as tgs
    from dgl_tpu_torch.parallel import bitspmd as tbs, comm
    from dgl_tpu_torch.tools import perf_bitgat_probe as tp2
    from dgl_tpu_torch.tools import perf_bitmm_variants as tp1
    from dgl_tpu_torch.tools import perf_sddmm_walk as tsw

    # phase 1: device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"# device: {kind}, {torch.cuda.device_count()} visible; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # phase 2: build
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"# kernels built in {time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                log(f"# {name}: {line.strip()}")

    # phase 3: kernels vs plain versions, mid size
    phase("3 (K1, K2 mid size)", phase_kernels_mid, bm)
    # phase 8 first among the slow ones: a fault in K5 shows before the
    # full-size graph is generated
    phase("8 (GAT mid size)", phase_bitgat_mid, dgt, bm, bg)
    phase("11 (K3, K4 mid size)", phase_tiled_mid, tts, tsp, ef)
    phase("17 (K6, K8 mid size)", phase_gat_fused_mid, dgt, tts, tgf, ef)
    phase("21 (K9, K11 v2 mid size)", phase_gatv2_mid, dgt, tts, tgf)
    phase("25 (K10 v2 mid size)", phase_edgegat_mid, dgt, tts, tgf)
    phase("37 (K10 v1, K11 v1 mid size)", phase_v1_mid, dgt, tts, tgf)
    phase("28 (K7 mid size)", phase_bitdot_mid, dgt, bm, bg, bd)
    phase("31 (K12 and the hybrid format, mid size)", phase_hybrid_mid, dgt,
          i8, tts)

    # phases 4-6: the GCN slice at full size
    g = phase("graph", reddit_graph, dgt)
    x, y, train = reddit_inputs()
    model, opt, k1_launches = phase("4 (GCN train)", phase_train, dgt, bm,
                                    g, x, y, train)
    phase("4 (GCN profile)", phase_profile, model, opt, g, x, y, train,
          lambda: {"bit_matmul_t": bm.bit_matmul_t.launches})
    phase("5 (GCN check)", phase_check, model, g, x, y, train)
    gcn_ref = phase("4 (GCN reference step for phase 35)",
                    gcn_reference_step, dgt, g, x, y, train)
    del model, opt
    k2_launches = phase("6 (K2)", phase_k2, dgt, bm, g)

    # phase 7: yardsticks
    rate = mem_rate(kind)
    bits = g.unit()._bits
    t0 = time.perf_counter()
    k1 = yardstick(g, bm, "K1 bit_matmul_t", bm.bit_matmul_t,
                   bm.bit_matmul_t_plain, bits.packed_rev, HIDDEN, rate)
    k2 = yardstick(g, bm, "K2 bit_matmul", bm.bit_matmul,
                   bm.bit_matmul_plain, bits.packed, 128, rate)
    slab_balance(bm, bits.packed_rev)
    gate_times(bm, bits)
    log(f"# phase 7 (K1, K2 yardsticks): {time.perf_counter() - t0:.1f}s")

    # phases 9-10: the GAT slice at full size
    model, opt, k5_launches = phase("9 (GAT train)", phase_gat_train, dgt,
                                    bg, g, x, y, train)
    phase("9 (GAT profile)", phase_profile, model, opt, g, x, y, train,
          lambda: {"bitgat_fwd": bg.bitgat_fwd.launches,
                   "bitgat_bwd": bg.bitgat_bwd.launches})
    del model, opt
    k5 = [phase(f"10 (K5 yardstick H={h} D={d})", bitgat_yardstick, bg, g,
                h, d, rate) for h, d in GAT_SHAPES]

    # phases 29-30: DotGatConv on K7, on the bitmask graph before the tiled
    # one is built
    conv, xd, k7_launches = phase("29 (DotGat on K7)", phase_dotgat_k7, dgt,
                                  bm, bg, bd, tts, tgf, g)
    phase("29 (DotGat on K7 check)", phase_dotgat_k7_check, conv, g, xd)
    del conv, xd
    k7 = [phase(f"30 (K7 yardsticks H={h} D={d})", bitdot_yardsticks, bd,
                bg, g, h, d, rate) for h, d in BITDOT_SHAPES[:2]]

    # phases 12-16: the tiled slice at full size
    gt = phase("12 (tiled format)", tiled_graph, dgt, g)
    model, opt, k3_launches = phase("13 (route 1: tiled GCN train)",
                                    phase_tiled_gcn, dgt, tts, gt, x, y,
                                    train)
    phase("13 (route 1 profile)", phase_profile, model, opt, gt, x, y, train,
          lambda: {"k3_spmm": tts.tiled_spmm.launches})
    phase("13 (route 1 check)", phase_check, model, gt, x, y, train)
    del model, opt
    phase("14 (route 3: weighted GCN)", phase_weighted_gcn, dgt, tts, gt, x,
          y, train)
    model, opt, k4_launches = phase("15 (route 2: tiled GAT train)",
                                    phase_tiled_gat, dgt, tts, gt, x, y,
                                    train)
    phase("15 (route 2 profile)", phase_profile, model, opt, gt, x, y, train,
          lambda: {"k4_spmm": tts.tiled_spmm_multihead.launches,
                   "k4_sddmm": tts.tiled_sddmm_dot_multihead.launches})
    phase("15 (eval forward on K6)", phase_gat_eval, tts, tgf, model, gt, x,
          y)
    del model, opt
    tiled = phase("16 (K3, K4 yardsticks)", tiled_yardsticks, ef, tts, gt,
                  rate)
    phase("43 (K4 SDDMM write layouts, probe)", phase_sddmm_probe, tsw, gt,
          rate)

    # phases 18-20: the slot-space slice at full size
    model, opt, k6_launches = phase("18 (route 4: GAT on K6 train)",
                                    phase_route4, dgt, tts, tgf, gt, x, y,
                                    train)
    phase("18 (route 4 profile)", phase_profile, model, opt, gt, x, y, train,
          lambda: read_counts(tts, tgf))
    phase("18 (route 4 check)", phase_route4_check, ef, model, gt, x, y,
          train)
    del model, opt
    phase("19 (DotGat on K8)", phase_dotgat, dgt, tts, tgf, gt)
    k6 = [phase(f"20 (K6 yardsticks H={h} Fh={d})", k6_yardsticks, tgf, tts,
                gt, h, d, rate) for h, d in GAT_SHAPES]

    # phases 22-24: the vector-attention slice at full size
    model, opt, k9_launches = phase("22 (route 5: GATv2 on K9 train)",
                                    phase_route5, dgt, tts, tgf, gt, x, y,
                                    train)
    phase("22 (route 5 profile, no warm-up)", phase_profile, model, opt, gt,
          x, y, train, lambda: read_counts(tts, tgf), 0)
    phase("22 (route 5 profile)", phase_profile, model, opt, gt, x, y, train,
          lambda: read_counts(tts, tgf))
    phase("22 (route 5 check)", phase_route5_check, model, gt, x, y, train)
    del model, opt
    k9 = [phase(f"24 (K9 yardsticks H={h} D={d})", vattn_yardsticks, tgf,
                gt, h, d, 0, rate)
          for h, d in VATTN_SHAPES[:2]]
    # the K6 and K4 launches of route 5's (8, 8) layer; its (1, 41) layer's
    # are phases 16 and 20's.  (B, 8, C) slot tensors take 6 GB each
    torch.cuda.empty_cache()
    phase("24 (K6 yardsticks H=8 Fh=8)", k6_yardsticks, tgf, tts, gt, 8, 8,
          rate, False, ("dst",))
    phase("24 (K4 SpMM yardstick H=8 Fh=8)", k4_spmm_yardstick, ef, tts, gt,
          8, 8, rate)

    # phases 32-33: the hybrid slice at full size, a third graph over the
    # COO; the bitmask goes first (the block takes 7.6 GB, the library
    # yardstick's bf16 copy 15.3 GB)
    del g, bits
    torch.cuda.empty_cache()
    gh = phase("32 (hybrid format)", hybrid_graph, dgt, hyb, gt)
    model, opt, k12_launches = phase("32 (hybrid GCN train)",
                                     phase_hybrid_gcn, dgt, i8, tts, gh, x,
                                     y, train)
    phase("32 (hybrid GCN profile)", phase_profile, model, opt, gh, x, y,
          train, lambda: k12_counts(i8, tts))
    phase("32 (hybrid GCN check)", phase_hybrid_check, model, gh, gt, x, y,
          train)
    del model, opt
    k12 = phase("33 (K12 yardsticks)", hybrid_yardsticks, i8, gh, rate)
    del gh
    torch.cuda.empty_cache()

    # phases 34-36: the mesh-sharded slice on a world-size-1 NCCL group,
    # with the hybrid block freed
    rendezvous = tempfile.mkdtemp()
    group = comm.init_group(1, 0, "cuda", os.path.join(rendezvous, "file"))
    phase("34 (sharded format and kernels, mid size)", phase_sharded_mid, bm,
          bg, tbs, tgs, group)
    fmt, deg = phase("35 (sharded format)", sharded_graph, tbs, gt)
    xs = tbs.pad_nodes(fmt, x)
    phase("35 (sharded GCN)", phase_sharded_gcn, dgt, bm, bg, tgs, group, fmt,
          deg, xs, y, train, gcn_ref, card)
    shard_launches = phase("35 (sharded GAT)", phase_sharded_gat, dgt, params,
                           bm, bg, tgs, group, fmt, xs, y, train, card)
    del xs, deg
    shard = phase("36 (sharded-GAT yardsticks)", phase_shard_yardsticks, bg,
                  tgs, tbs, fmt, gt, rate)
    torch.distributed.destroy_process_group()
    shutil.rmtree(rendezvous, ignore_errors=True)
    del fmt, gt, x, y, train
    torch.cuda.empty_cache()
    ge, xe, efe, ef_slot = phase("23 (EGAT graph)", egat_graph, dgt)
    conv, k11_launches = phase("23 (EGATConv on K11 v2)", phase_egat, dgt,
                               tts, tgf, ge, xe, efe, ef_slot)
    phase("23 (EGATConv check)", phase_egat_check, conv, ge, xe, efe,
          ef_slot)
    conv, k10_launches = phase("26 (EdgeGATConv on K10 v2)", phase_edgegat,
                               dgt, tts, tgf, ge, xe, efe, ef_slot)
    phase("26 (EdgeGATConv check)", phase_edgegat_check, conv, ge, xe, efe,
          ef_slot)
    del conv, efe
    k11 = phase("24 (K11 v2 yardsticks)", vattn_yardsticks, tgf, ge, EGAT_H,
                EGAT_D, EGAT_FE, rate)
    k10 = phase("27 (K10 v2 yardsticks)", edgegat_yardsticks, tgf, ge,
                EGAT_H, EGAT_D, EGAT_FE, rate)
    # EdgeGAT's other launches at (4, 32): K6's reduce (den, der; del) and
    # dx, K4's SpMM for the numerator; the v1 functions' K6 scores with the
    # slot bias (K10 v1) and ds (K11 v1)
    phase("27 (K6 yardsticks H=4 Fh=32, EGAT graph)", k6_yardsticks, tgf,
          tts, ge, EGAT_H, EGAT_D, rate, False, ("dst", "src"), True, True)
    phase("27 (K4 SpMM yardstick H=4 Fh=32, EGAT graph)", k4_spmm_yardstick,
          ef, tts, ge, EGAT_H, EGAT_D, rate)

    # phases 38-40: the stored-edge-term slice on the EGAT graph, its
    # (B, C, 128) f32 slot tensors 13.6 GB each at 23M edges
    torch.cuda.empty_cache()
    k11v1_launches = phase("38 (EGATConv v1 on K11 v1)", phase_egatc_v1, tgf,
                           tts, ge, xe, ef_slot)
    torch.cuda.empty_cache()
    k10v1_launches = phase("39 (EdgeGATConv v1 on K10 v1)", phase_edgegat_v1,
                           tgf, tts, ge, xe, ef_slot)
    del xe, ef_slot
    torch.cuda.empty_cache()
    v1 = phase("40 (K11 v1, K10 v1 yardsticks)", v1_yardsticks, tgf, ge, rate)
    del ge
    torch.cuda.empty_cache()

    # phases 41-42: the port's tools at the JAX tools' sizes
    p1 = phase("41 (K1 slab sweep, P1)", phase_bitmm_sweep, bm, tp1, rate)
    p2 = phase("42 (bitgat_fwd_t probe, P2)", phase_bitgat_probe, bg, tp2,
               rate)
    kernels = [
        {"name": "bit_matmul_t", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/bitmm.cu",
         "replaces": "dgl_tpu/ops/pallas/bitmm.py:298",
         "launches": k1_launches, **k1},
        {"name": "bit_matmul", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/bitmm.cu",
         "replaces": "dgl_tpu/ops/pallas/bitmm.py:371",
         "launches": k2_launches, **k2},
        # the first layer's shape, H x D = 4 x 32
        {"name": "bitgat_fwd", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/bitgat.cu",
         "replaces": "dgl_tpu/ops/pallas/bitgat.py:245",
         "launches": k5_launches[0], **k5[0]["fwd"]},
        {"name": "bitgat_bwd", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/bitgat.cu",
         "replaces": "dgl_tpu/ops/pallas/bitgat.py:408",
         "launches": k5_launches[1], **k5[0]["bwd"]},
        {"name": "tiled_spmm", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/tiled_spmm.cu",
         "replaces": "dgl_tpu/ops/pallas/tiled_spmm.py:302",
         "launches": k3_launches, **tiled["k3"]},
        # the first GAT layer's shape, H x Fh = 4 x 32
        {"name": "tiled_spmm_multihead", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/row_agg.cu",
         "replaces": "dgl_tpu/ops/pallas/tiled_spmm.py:455",
         "launches": k4_launches[0], **tiled["spmm_mh_4"]},
        {"name": "tiled_sddmm_dot_multihead", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/row_agg.cu",
         "replaces": "dgl_tpu/ops/pallas/tiled_spmm.py:521",
         "launches": k4_launches[1], **tiled["sddmm_mh_4"]},
        # K6 at the first GAT layer's shape, H x Fh = 4 x 32; launches
        # from route 4
        {"name": "gat_scores", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/gat_fused.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:300",
         "launches": k6_launches["gat_scores"], **k6[0]["scores"]},
        {"name": "slot_reduce", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/gat_fused.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:314, :387, :407, :533",
         "launches": k6_launches["slot_reduce"], **k6[0]["reduce_dst"]},
        {"name": "gat_ds", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/gat_fused.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:368, :597",
         "launches": k6_launches["gat_ds"], **k6[0]["ds"]},
        {"name": "src_aggregate", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/row_agg.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:428, :636",
         "launches": k6_launches["src_aggregate"], **k6[0]["src_agg"]},
        # K9 at the first GATv2 layer's shape, H x D = 8 x 8, launches from
        # route 5; K11 v2 at EGAT's (4, 32) with 16 edge features and the
        # bias row, launches from phase 23
        {"name": "vattn_scores", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/gatv2.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:783",
         "launches": k9_launches["vattn_scores"], **k9[0]["scores"]},
        {"name": "vattn_slot_grad", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/gatv2.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:878",
         "launches": k9_launches["vattn_slot_grad"], **k9[0]["slot_grad"]},
        {"name": "vattn_node_grad", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/gatv2.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:878, :903",
         "launches": k9_launches["vattn_node_grad"],
         **k9[0]["node_grad_dst"]},
        {"name": "vattn_scores_edge", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/gatv2.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:2075",
         "launches": k11_launches["vattn_scores"], **k11["scores"]},
        {"name": "vattn_slot_grad_edge", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/gatv2.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:2167",
         "launches": k11_launches["vattn_slot_grad"], **k11["slot_grad"]},
        {"name": "vattn_node_grad_edge", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/gatv2.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:2167, :2196",
         "launches": k11_launches["vattn_node_grad"],
         **k11["node_grad_dst"]},
        # K10 v2 at EdgeGATConv(64, 16, 32, 4)'s (4, 32) with 16 edge
        # features, launches from phase 26
        {"name": "edgegat_scores", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/gat_fused.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:1723",
         "launches": k10_launches["edgegat_scores"], **k10["scores"]},
        {"name": "slot_feat_reduce", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/gat_fused.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:1750, :1785, :1850",
         "launches": k10_launches["slot_feat_reduce"],
         **k10["slot_feat_reduce"]},
        {"name": "edgegat_ds", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/gat_fused.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:1785, :1850",
         "launches": k10_launches["edgegat_ds"], **k10["ds"]},
        # K7 at DotGatConv(64, 64, 2)'s (2, 64), launches from phase 29
        {"name": "bitdot_fwd", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/bitdot.cu",
         "replaces": "dgl_tpu/ops/pallas/bitdot.py:156",
         "launches": k7_launches["bitdot_fwd"], **k7[0]["fwd"]},
        {"name": "bitdot_bwd_dz", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/bitdot.cu",
         "replaces": "dgl_tpu/ops/pallas/bitdot.py:272",
         "launches": k7_launches["bitdot_bwd_dz"], **k7[0]["dz"]},
        {"name": "bitdot_bwd_dq", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/bitdot.cu",
         "replaces": "dgl_tpu/ops/pallas/bitdot.py:368",
         "launches": k7_launches["bitdot_bwd_dq"], **k7[0]["dq"]},
        # K12 at F = 16 on the Reddit hub block, launches from phase 32
        {"name": "int8_matmul_rows", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/int8mm.cu",
         "replaces": "dgl_tpu/ops/pallas/int8mm.py:79",
         "launches": k12_launches["int8_matmul_rows"], **k12["rows"]},
        {"name": "int8_matmul_cols", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/int8mm.cu",
         "replaces": "dgl_tpu/ops/pallas/int8mm.py:79",
         "launches": k12_launches["int8_matmul_cols"], **k12["cols"]},
        # the src-major forward and K13 at the first GAT layer's (4, 32) on
        # the Reddit graph's one-part shard, launches from phase 35
        {"name": "bitgat_fwd_t", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/bitgat.cu",
         "replaces": "dgl_tpu/ops/pallas/bitgat.py:245",
         "launches": shard_launches["bitgat_fwd_t"],
         **shard["1 part 4x32"]["bitgat_fwd_t"]},
        {"name": "bit_shard_gat_bwd", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/bitgat.cu",
         "replaces": "dgl_tpu/parallel/bitgat_spmd.py:135",
         "launches": shard_launches["bit_shard_gat_bwd"],
         **shard["1 part 4x32"]["bit_shard_gat_bwd"]},
        # K11 v1 and K10 v1 at (4, 32) on the EGAT graph, launches from
        # phases 38 and 39 (the slot vector sum's row is its dst side)
        {"name": "egatc_scores", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/gatv2.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:1093",
         "launches": k11v1_launches["egatc_scores"], **v1["egatc_scores"]},
        {"name": "egatc_slot_grad", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/gatv2.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:1193",
         "launches": k11v1_launches["egatc_slot_grad"],
         **v1["egatc_slot_grad"]},
        {"name": "slot_vec_reduce", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/gat_fused.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:1193, :1215",
         "launches": k11v1_launches["slot_vec_reduce"],
         **v1["slot_vec_reduce"]},
        {"name": "fe_aggregate", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/gat_fused.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:1393",
         "launches": k10v1_launches["fe_aggregate"], **v1["fe_aggregate"]},
        {"name": "fe_ds", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/gat_fused.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:1432",
         "launches": k10v1_launches["fe_ds"], **v1["fe_ds"]},
        {"name": "dx_dfe", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/gat_fused.cu",
         "replaces": "dgl_tpu/ops/pallas/gat_fused.py:1491",
         "launches": k10v1_launches["dx_dfe"], **v1["dx_dfe"]},
        # P1: K1 at its default slab width on the sweep's work (every width
        # in slab_ms); P2: bitgat_fwd_t on the probe's block of 1,024 src
        # rows (the whole probe's launch in probe_ms); launches from phases
        # 41 and 42
        {"name": "bit_matmul_t_slab_sweep", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/bitmm.cu",
         "replaces": "tools/perf_bitmm_variants.py:148", **p1},
        {"name": "bitgat_fwd_t_probe", "route": "cuda",
         "source": "dgl_tpu_torch/csrc/bitgat.cu",
         "replaces": "tools/perf_bitgat_probe.py:78", **p2},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
