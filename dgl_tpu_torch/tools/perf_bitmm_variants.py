"""K1's slab-width sweep on the card.

Counterpart of the JAX package's ``tools/perf_bitmm_variants.py`` (P1:
``make_swapped`` :148 and ``make`` :177, bodies ``_k_v0``..``_k_v7``
:41-131), which times TPU variants of K1, the transposed bit SpMM

    out[n, :] = sum_k bit(k, n) x[k, :],   bit(k, n) = bit b of
    packed[k, j] for n = b * N32 + j,

that differ in how a bit plane is unpacked into the matrix unit's operand
and in the output's layout.  Neither exists on the card: K1
(``csrc/bitmm.cu`` ``bit_matmul_t_kernel``) streams slabs of ``w`` words of
every row by TMA, lists their set bits and adds the listed x rows into
out by reductions in L2.  Its free axis is the slab's width, ``w`` words
of the packing (32 w dst nodes, 4 w bytes of each row a TMA box reads,
``bitmm.T_SLAB_WORDS`` by default), so this sweep times K1 at 8, 16 and
32 words on the JAX sweep's work: KP = N = 110,592, F = 16, uniformly
random bits (half of them set: each warp's list fills and is drained many
times a tile) made on the device.  x is on a grid of 1/16 in [-1, 1], so
every width's sums, and the plain version's, are exact in f32 in any order
and are held equal to the plain version's on the full output.

Usage: ``python -m dgl_tpu_torch.tools.perf_bitmm_variants [tiny]`` (tiny:
the small check only, on the CPU).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import cuda_ms, popcount, timed_once
from ..ops.kernels import bitmm
from ..utils import resolve_device

KP = N = 110_592          # the JAX sweep's rows and columns
N32 = N // 32
F = 16
WIDTHS = (8, 16, 32)      # slab widths in words
STEP = 1 / 16             # x's grid
TINY_KP, TINY_N = 512, 4096


def tiny_inputs(seed: int = 0):
    """(packed (TINY_KP, TINY_N / 32) int32, x (TINY_KP, F) f32): random
    words, half their bits set, and normal x."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(-2 ** 31, 2 ** 31, (TINY_KP, TINY_N // 32),
                          dtype=np.int64).astype(np.int32)
    x = rng.normal(size=(TINY_KP, F)).astype(np.float32)
    return packed, x


def tiny_oracle(packed, x):
    """out (TINY_N, F) float64 from a dense unpacking of ``packed``."""
    words = packed.view(np.uint32).astype(np.uint64)
    n32 = packed.shape[1]
    bits = np.stack([(words >> np.uint64(b)) & np.uint64(1)
                     for b in range(32)], 1).reshape(len(packed), 32 * n32)
    return bits.astype(np.float64).T @ x.astype(np.float64)


def tiny_check(device="cuda"):
    """K1 (on the CPU its plain version) on the tiny inputs against the
    dense oracle: (out (TINY_N, F) f32 on the host, max|err|)."""
    dev = resolve_device(device)
    packed, x = tiny_inputs()
    out = bitmm.bit_matmul_t(torch.from_numpy(packed).to(dev),
                             torch.from_numpy(x).to(dev), TINY_N).cpu()
    err = float(np.abs(out.numpy() - tiny_oracle(packed, x)).max())
    if err > 1e-3:
        raise AssertionError(f"K1 tiny check: max|err| {err:.3g}")
    return out.numpy(), err


def sweep_inputs(device="cuda", seed: int = 0):
    """(packed (KP, N32) int32, x (KP, F) f32 on a grid of 1/16) made on
    ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(-2 ** 31, 2 ** 31, (KP, N32), dtype=torch.int32,
                           device=dev, generator=gen)
    x = torch.randint(-16, 17, (KP, F), device=dev,
                      generator=gen).float() * STEP
    return packed, x


def sweep(device="cuda", reps: int = 5, seed: int = 0):
    """Each slab width's median time over ``reps`` launches at the sweep's
    size, each width's output exactly equal to the plain version's (the
    sums lie on a grid, see the module's docstring; raises otherwise).
    Returns {"ms": {w: ms}, "plain_ms", "max_abs_err" (over the widths),
    "bits" (set bits), "nbytes" (the bits, x and out)}."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the sweep times the CUDA kernel: run it on a card")
    if KP / STEP >= 2 ** 24:
        raise AssertionError("the sums are not exact in f32")
    packed, x = sweep_inputs(dev, seed)
    want, plain_ms = timed_once(lambda: bitmm.bit_matmul_t_plain(packed, x,
                                                                 N))
    res = {"ms": {}, "plain_ms": plain_ms, "max_abs_err": 0.0,
           "bits": popcount(packed),
           "nbytes": packed.numel() * 4 + x.numel() * 4 + N * F * 4}
    for w in WIDTHS:
        got = bitmm.bit_matmul_t(packed, x, N, slab_words=w)
        err = float((got - want).abs().max())
        if err != 0.0:
            raise AssertionError(f"K1 at {w}-word slabs: max|err| {err:.3g} "
                                 "on sums that are exact in any order")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["ms"][w] = cuda_ms(
            lambda w=w: bitmm.bit_matmul_t(packed, x, N, slab_words=w),
            reps)
    return res


def main():
    if sys.argv[1:] == ["tiny"]:
        _, err = tiny_check("cpu")
        print(f"tiny check (plain version): max|err| {err:.3g}")
        return
    print(f"tiny check on the card: max|err| {tiny_check()[1]:.3g}")
    res = sweep()
    for w, ms in res["ms"].items():
        print(f"K1 {w:2d}-word slabs: {ms:9.4f} ms")
    print(f"plain version {res['plain_ms']:.4f} ms; {res['bits']} set bits")


if __name__ == "__main__":
    main()
