"""Probe of K5's src-major forward at full bit density on the card.

Counterpart of the JAX package's ``tools/perf_bitgat_probe.py`` (P2:
``make_fwd`` :78, body ``_fwd_kernel`` :41), a dense bit-masked GAT
forward over the packing of A^T (rows = src, bit b of word j = dst b *
k32 + j):

    p = exp(lrelu(el[src] + er[dst])),  l[dst] = sum p,
    out[dst] = sum p z[src] / max(l, 1e-20),

which is the function of the port's ``bitgat_fwd_t`` (``csrc/bitgat.cu``
``bitgat_fwd_t_kernel``), in the same orientation, so nothing is repacked.
The probe's work: s_pad = k_pad = 110,592 (22% of the Reddit graph's
area), H = 4, D = 32, uniformly random bit words (half the bits set, about
53 times the Reddit graph's edges), el, er and z normal.  It times one
warm-up and two launches, and holds the kernel to its plain version on a
block of 1,024 src rows (the plain version over every row would form
terabytes of per-edge products).

Usage: ``python -m dgl_tpu_torch.tools.perf_bitgat_probe [tiny]`` (tiny:
the small check only, on the CPU).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import cuda_ms, popcount, timed_once
from ..ops.kernels import bitgat
from ..utils import resolve_device

H, D = 4, 32
SLOPE = 0.2
S_PAD = K_PAD = 110_592      # the probe's src and dst padding
BLOCK_ROWS = 1024            # src rows of the check against the plain version
PLAIN_ROWS = 64              # src rows the plain version takes at a time
RTOL, ATOL = 1e-4, 1e-3      # f32 sums of exp in another order
TINY_N, TINY_S_PAD, TINY_K_PAD = 300, 512, 8192


def tiny_inputs():
    """P2's ``tiny_check`` inputs, drawn in its order: (a (n, n) bool
    adjacency, a[s, d]; pt (s_pad, k32) int32 with bit b of word j set for
    the edge s -> b * k32 + j; el, er (n, H); z (n, H, D))."""
    rng = np.random.default_rng(0)
    n = TINY_N
    a = rng.random((n, n)) < 0.05
    el = rng.normal(size=(n, H)).astype(np.float32)
    er = rng.normal(size=(n, H)).astype(np.float32)
    z = rng.normal(size=(n, H, D)).astype(np.float32)
    k32 = TINY_K_PAD // 32
    pt = np.zeros((TINY_S_PAD, k32), np.uint32)
    srcs, dsts = np.nonzero(a)
    np.bitwise_or.at(pt, (srcs, dsts % k32),
                     np.uint32(1) << (dsts // k32).astype(np.uint32))
    return a, pt.view(np.int32), el, er, z


def tiny_oracle(a, el, er, z):
    """out (n, H, D) float64: per dst, the softmax over its in-edges of
    lrelu(el[src] + er[dst]) applied to z[src]."""
    raw = el[:, None, :].astype(np.float64) + er[None, :, :]
    p = np.where(a[:, :, None], np.exp(np.maximum(raw, SLOPE * raw)), 0.0)
    den = np.maximum(p.sum(0), 1e-20)
    return np.einsum("sdh,shf->dhf", p, z.astype(np.float64)) / den[
        :, :, None]


def tiny_check(device="cuda"):
    """``bitgat_fwd_t`` (on the CPU its plain version) on P2's tiny inputs
    against the dense oracle: (out (n, H, D) f32 on the host, max|err|)."""
    dev = resolve_device(device)
    a, pt, el, er, z = tiny_inputs()
    out, _ = bitgat.bitgat_fwd_t(
        torch.from_numpy(pt).to(dev), torch.from_numpy(el).to(dev),
        torch.from_numpy(er).to(dev), torch.from_numpy(z).to(dev), TINY_N,
        SLOPE)
    out = out.cpu().numpy()
    err = float(np.abs(out - tiny_oracle(a, el, er, z)).max())
    if err > 1e-4:
        raise AssertionError(f"bitgat_fwd_t tiny check: max|err| {err:.3g}")
    return out, err


def probe_inputs(device="cuda", seed: int = 1):
    """(packed_t (S_PAD, K_PAD / 32) int32 random words, el (S_PAD, H), er
    (K_PAD, H), z (S_PAD, H, D)) made on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    packed_t = torch.randint(-2 ** 31, 2 ** 31, (S_PAD, K_PAD // 32),
                             dtype=torch.int32, device=dev, generator=gen)
    el = torch.randn(S_PAD, H, device=dev, generator=gen)
    er = torch.randn(K_PAD, H, device=dev, generator=gen)
    z = torch.randn(S_PAD, H, D, device=dev, generator=gen)
    return packed_t, el, er, z


def plain_rows(packed_t, el, er, z, num_dst: int):
    """``bitgat_fwd_t_plain`` over PLAIN_ROWS src rows at a time: out and
    l are sums over the src rows, so each chunk's out * l and l add up."""
    num = torch.zeros(num_dst, H, D, dtype=torch.float32, device=z.device)
    l = torch.zeros(num_dst, H, dtype=torch.float32, device=z.device)
    for r0 in range(0, z.shape[0], PLAIN_ROWS):
        sl = slice(r0, r0 + PLAIN_ROWS)
        out_c, l_c = bitgat.bitgat_fwd_t_plain(packed_t[sl], el[sl], er,
                                               z[sl], num_dst, SLOPE)
        num += out_c * l_c.unsqueeze(-1)
        l += l_c
    return num / l.clamp(min=bitgat.DEN_EPS).unsqueeze(-1), l


def probe(device="cuda"):
    """The probe at full size and its check on a block of src rows.
    Returns {"launch_ms": [the two timed launches], "bits" (set bits of
    the probe), "block": {"ms" (median of 5), "plain_ms", "max_abs_err",
    "bits", "nbytes" (the block's bits, el, er, z, out, l)}}; raises if the
    block disagrees with the plain version (rtol 1e-4 / atol 1e-3)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the probe times the CUDA kernel: run it on a card")
    packed_t, el, er, z = probe_inputs(dev)

    def full():
        return bitgat.bitgat_fwd_t(packed_t, el, er, z, K_PAD, SLOPE)

    full()                                      # the warm-up launch
    launch_ms = [timed_once(full)[1] for _ in range(2)]
    blk = (packed_t[:BLOCK_ROWS], el[:BLOCK_ROWS], er, z[:BLOCK_ROWS])
    got = bitgat.bitgat_fwd_t(*blk, K_PAD, SLOPE)
    want, plain_ms = timed_once(lambda: plain_rows(*blk, K_PAD))
    err = 0.0
    for what, a, w in zip(("out", "l"), got, want):
        torch.testing.assert_close(a, w, rtol=RTOL, atol=ATOL,
                                   msg=lambda m, what=what:
                                   f"bitgat_fwd_t probe block {what}: {m}")
        err = max(err, float((a - w).abs().max()))
    del got, want
    block = {"ms": cuda_ms(lambda: bitgat.bitgat_fwd_t(*blk, K_PAD, SLOPE)),
             "plain_ms": plain_ms, "max_abs_err": err,
             "bits": popcount(blk[0]),
             "nbytes": (blk[0].numel() + BLOCK_ROWS * H * (1 + D)
                        + K_PAD * H * (2 + D)) * 4}
    return {"launch_ms": launch_ms, "bits": popcount(packed_t),
            "block": block}


def main():
    if sys.argv[1:] == ["tiny"]:
        _, err = tiny_check("cpu")
        print(f"tiny check (plain version): max|err| {err:.3g}")
        return
    print(f"tiny check on the card: max|err| {tiny_check()[1]:.3g}")
    res = probe()
    print(f"bitgat_fwd_t probe: {res['bits']} set bits, launches "
          + ", ".join(f"{t:.2f}" for t in res["launch_ms"]) + " ms")
    b = res["block"]
    print(f"block of {BLOCK_ROWS} src rows: {b['ms']:.4f} ms, plain "
          f"{b['plain_ms']:.4f} ms, max|err| {b['max_abs_err']:.3g}")


if __name__ == "__main__":
    main()
