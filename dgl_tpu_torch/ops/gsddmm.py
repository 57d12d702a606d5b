"""Generalized SDDMM: edge-wise binary op between src/dst/edge data.

Counterpart of ``dgl_tpu/ops/gsddmm.py`` (reference SDDMM dispatch,
``src/array/kernel.cc``; CUDA ``src/array/cuda/sddmm.cuh:100-331``).
``op in {add, sub, mul, div, dot, copy_lhs, copy_rhs}``; operand targets
in {'u', 'v', 'e'}.  Gathers plus an elementwise op, in canonical (COO)
edge order; autograd gives the reference backward (the transpose of a
gather is a scatter-add).
"""
from __future__ import annotations

import torch

from ..graph.unitgraph import UnitGraph
from .gspmm import _apply_binary, _ensure_float, align_feat_ranks

SDDMM_OPS = ("add", "sub", "mul", "div", "dot", "copy_lhs", "copy_rhs")
TARGETS = ("u", "v", "e")


def _gather_target(unit: UnitGraph, data, target: str):
    if data is None:
        return None
    if target not in TARGETS:
        raise ValueError(f"invalid target {target!r}")
    if target == "e":
        return data
    row, col = unit.coo()
    return data[row if target == "u" else col]


def gsddmm_unit(unit: UnitGraph, op: str, lhs_data, rhs_data,
                lhs_target: str = "u", rhs_target: str = "v"):
    """g-SDDMM on one relation; returns (num_edges, *feat) in canonical
    edge order."""
    if op not in SDDMM_OPS:
        raise ValueError(f"invalid op {op}")
    if op == "copy_lhs":
        rhs_data = None
    if op == "copy_rhs":
        lhs_data = None
    lhs_data = _ensure_float(lhs_data)
    rhs_data = _ensure_float(rhs_data)
    if op not in ("copy_lhs", "copy_rhs", "dot"):
        lhs_data, rhs_data = align_feat_ranks(lhs_data, rhs_data)
    x = _gather_target(unit, lhs_data, lhs_target)
    y = _gather_target(unit, rhs_data, rhs_target)
    if op == "dot":
        return torch.sum(x * y, dim=-1, keepdim=True)
    return _apply_binary(op, x, y)


def gsddmm(g, op: str, lhs_data, rhs_data, lhs_target="u", rhs_target="v",
           etype=None):
    """Graph-level entry (reference ``python/dgl/ops/sddmm.py gsddmm``)."""
    unit = g.unit(etype) if hasattr(g, "unit") else g
    return gsddmm_unit(unit, op, lhs_data, rhs_data, lhs_target, rhs_target)
