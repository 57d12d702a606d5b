"""Kernel SpMM-sum entry used by the dispatcher.

Counterpart of ``spmm_sum`` in ``dgl_tpu/ops/pallas/spmm.py:182-206``.
This slice carries the bitmask branch; the tiled and hybrid branches come
with later slices, and until then a graph without a bit format takes the
gather path.
"""
from __future__ import annotations

from ...utils import config


def spmm_sum(unit, op, u_data, e_data):
    """Returns None to decline (the gather path then runs)."""
    if unit.num_edges < config.get("kernel_spmm_min_edges"):
        return None
    if op == "copy_lhs" and unit._bits is not None:
        from .bitmm import bit_spmm
        return bit_spmm(unit._bits, u_data)
    return None
