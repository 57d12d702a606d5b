"""Utilities (counterpart of ``dgl_tpu/utils/__init__.py``): the pair
splitter used by the conv layers, the device resolver behind every
entry point's ``device`` argument, a sort-based ``np.unique`` and a row
gather for narrow rows."""
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



NARROW_ROW = 8   # rows of at most this many elements avoid the row gather
_WIDE = {8: torch.float64, 16: torch.complex128}   # row bytes -> one element


def _gather(v: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    width = v[0].numel() if v.shape[0] else 0
    if v.ndim == 1 or not 1 < width <= NARROW_ROW:
        return torch.index_select(v, 0, ids)
    rows = v.reshape(v.shape[0], width).contiguous()
    shape = (ids.shape[0],) + tuple(v.shape[1:])
    wide = _WIDE.get(width * v.element_size())
    if wide is not None and rows.data_ptr() % 16 == 0:
        # the row as one element of a type of the row's size
        out = torch.index_select(rows.view(wide).reshape(-1), 0, ids)
        return out.view(v.dtype).reshape(shape)
    out = v.new_empty(ids.shape[0], width)
    for k in range(width):
        out[:, k] = torch.index_select(rows[:, k], 0, ids)
    return out.reshape(shape)


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, v, ids):
        ctx.save_for_backward(ids)
        ctx.rows = v.shape[0]
        return _gather(v, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        dv = g.new_zeros((ctx.rows,) + tuple(g.shape[1:]))
        return dv.index_add_(0, ids, g), None


def gather_rows(v: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``v[ids]`` along dim 0, differentiable (backward: ``index_add_``).

    Narrow rows (2 to NARROW_ROW elements) avoid PyTorch's row gather, which
    spends a block on each narrow row: on an H100, ``index_select`` of
    114.8M random rows of an (N, 4) f32 tensor took 69 ms, of one column
    1 ms.  A row of 8 or 16 bytes is gathered as one float64 or complex128
    element; other narrow rows one column at a time."""
    return _GatherRows.apply(v, ids)
