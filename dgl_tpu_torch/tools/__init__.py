"""The port's measurement tools: K1's slab-width sweep
(:mod:`.perf_bitmm_variants`) and the probe of K5's forward at full bit
density (:mod:`.perf_bitgat_probe`), the counterparts of the JAX
package's ``tools/perf_bitmm_variants.py`` and
``tools/perf_bitgat_probe.py``; the probes of the row walk's design
choices (:mod:`.perf_row_walk`) and of the SDDMM walk's write layouts
(:mod:`.perf_sddmm_walk`) on the Reddit-statistics graph; and the probes
that time K5's backward and K9's node gradient (:mod:`.perf_bwd_walks`)
and K5's forward (:mod:`.perf_fwd_walks`) beside the kernels they
replaced and edits of their own, and the one that times K6's ds and
K9's da beside the kernels they replaced (:mod:`.perf_ds_fold`), and
the one that times K9's scores and K12's row product beside the kernels
they replaced (:mod:`.perf_scores_rows`), and the one that times K6's
slot reduce and K3 beside the kernels they replaced and edits of the row
walks (:mod:`.perf_reduce_k3`), the one that times K7's dz and K11 v2's
slot gradient (:mod:`.perf_dz_slot_grad`) and the one that times K7's dq
and K11 v2's node gradient (:mod:`.perf_dq_node_grad`) beside the
kernels they replaced and edits of their own, all called from
``chip_smoke.py``'s yardsticks, and the one that times K10's and K11
v1's slot walks and K10's edge ds beside the bucket walks they replaced
(:mod:`.perf_slot_walks`), and the one that times K7's forward and K11's
scores beside the kernels they replaced and an edit of each
(:mod:`.perf_fwd_scores`), and the one that times K11 v1's slot gradient
and K10 v2's scores beside the kernels they replaced and an edit of each
(:mod:`.perf_slot_grad_scores`); :mod:`.perf_row_walk_bits` holds the
row walks', the dot-product walk's, the slot walk's and the scores'
instances of two checkouts to the same bits.  Each runs as ``python -m
dgl_tpu_torch.tools.<name> [tiny]``; nothing runs at import.  The
retired tiled walks' launch arithmetic (:func:`tile_group`,
:func:`tile_group_per_sm`, :func:`tile_splits`) lives here, shared by the
probes that launch them as the package once did."""
import ctypes
import hashlib
import os
import statistics
import subprocess

import torch

from ..ops.kernels import build

SMEM_PER_BLOCK = 232_448   # shared memory a block may use on Hopper


def cuda_ms(fn, reps=5):
    """Median device time of ``fn()`` over ``reps`` runs after one warm-up
    run, between CUDA events."""
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


def timed_once(fn):
    """(fn(), its device ms) from one call between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    return result, start.elapsed_time(end)


def popcount(words: torch.Tensor) -> int:
    """Set bits of an int32 tensor, counted 2^26 words at a time."""
    flat, total = words.reshape(-1), 0
    for i in range(0, flat.numel(), 1 << 26):
        v = flat[i:i + (1 << 26)].to(torch.int64) & 0xFFFFFFFF
        v = v - ((v >> 1) & 0x55555555)
        v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
        v = (v + (v >> 4)) & 0x0F0F0F0F
        total += int((((v * 0x01010101) & 0xFFFFFFFF) >> 24).sum())
    return total


def edited_source(source: str, edits, name: str, path=None) -> str:
    """``csrc/<source>.cu`` (or the file at ``path``) with each (old, new)
    edit applied; raises if an old text is not found exactly once.
    ``name`` names the variant in the error."""
    with open(path or build.sources()[source]) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} occurs "
                             f"{src.count(old)} times in {source}.cu")
        src = src.replace(old, new)
    return src


def build_edited(source: str, sources: dict, signatures: dict) -> dict:
    """{name: {fn: the C function fn of that CUDA source}} for each source
    in ``sources`` ({name: text}) and each fn of ``signatures`` ({fn:
    argtypes}), built all at once with the package's ``nvcc`` flags into
    its build directory, each file named after ``source``, the name and a
    hash of the text."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        digest = hashlib.sha256(src.encode()).hexdigest()[:16]
        cu = os.path.join(build.BUILD_DIR, f"{source}_{name}-{digest}.cu")
        lib = cu[:-3] + ".so"
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        dll = ctypes.CDLL(lib)
        fns[name] = {}
        for fn, argtypes in signatures.items():
            f = getattr(dll, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            fns[name][fn] = f
    return fns


def tile_group(f: int, tile: int) -> int:
    """Columns a block of a retired tiled walk keeps per row, lanes a slot:
    the narrowest of 8, 16, 32 that covers F, within the shared memory of a
    (tile, group) f32 block."""
    g = 8 if f <= 8 else 16 if f <= 16 else 32
    while g > 8 and tile * g * 4 > SMEM_PER_BLOCK:
        g //= 2
    if tile * g * 4 > SMEM_PER_BLOCK:
        raise ValueError(f"tile {tile} is too large for the tiled walks' "
                         "shared-memory accumulator")
    return g


def tile_group_per_sm(g: int, tile: int) -> int:
    """Blocks of a (tile, g) shared-memory accumulator that fit an SM at
    once, with the registers of 512 threads at g = 32."""
    return max(1, min(2 if g <= 16 else 1, SMEM_PER_BLOCK // (tile * g * 4)))


def tile_splits(tf, n_tiles: int, blocks_per_tile: int, per_sm: int,
                device) -> int:
    """Splits of each tile's buckets over blocks: about two waves of the
    ``per_sm`` blocks that fit an SM at once, each split keeping about 4
    buckets or more of its tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-2 * sms * per_sm // max(n_tiles * blocks_per_tile, 1))
    return max(1, min(want, tf.num_buckets // max(4 * n_tiles, 1), 65535))
