"""Utilities (counterpart of ``dgl_tpu/utils/__init__.py``): the pair
splitter used by the conv layers, the device resolver behind every
entry point's ``device`` argument, and a sort-based ``np.unique``."""
from __future__ import annotations

import numpy as np
import torch

from . import config


def resolve_device(device) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    Entry points default to ``"cuda"``; the CPU is used only when the
    caller names it.  With no GPU present a CUDA device raises here
    instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dgl_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return dev


def expand_as_pair(input_, g=None):
    """Split a single feature into a (src, dst) pair (reference
    ``python/dgl/utils/internal.py expand_as_pair``): on a block the dst
    features are the first ``num_dst`` rows of the src features."""
    if isinstance(input_, tuple):
        return input_
    if g is not None and g.is_block:
        return input_, input_[: g.num_dst_nodes()]
    return input_, input_


def unique_counts(a: np.ndarray):
    """``np.unique(a, return_counts=True)`` computed by a sort.

    numpy 2.3 takes a hash table for ``np.unique`` of integers, which is
    far slower than a sort on tens of millions of int64 keys; the sorted
    uniques and their counts are the same."""
    s = np.sort(a)
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]]) if len(s) else \
        np.zeros(0, np.int64)
    return s[starts], np.diff(np.r_[starts, len(s)])
