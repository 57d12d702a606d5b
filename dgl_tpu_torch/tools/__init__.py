"""The port's measurement tools: K1's slab-width sweep
(:mod:`.perf_bitmm_variants`) and the probe of K5's src-major forward at
full bit density (:mod:`.perf_bitgat_probe`), the counterparts of the JAX
package's ``tools/perf_bitmm_variants.py`` and
``tools/perf_bitgat_probe.py``.  Each runs as ``python -m
dgl_tpu_torch.tools.<name> [tiny]``; nothing runs at import."""
import statistics

import torch


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
