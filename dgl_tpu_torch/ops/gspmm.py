"""Generalized SpMM: fused message + reduce over graph edges.

Counterpart of ``dgl_tpu/ops/gspmm.py`` (reference g-SpMM family,
``src/array/kernel.cc:20-44``): ``op in {add, sub, mul, div, copy_lhs,
copy_rhs}`` x ``reduce in {sum, max, min, mean}`` with trailing broadcast
between node and edge operands.

* sum/mean first ask ``ops/kernels/dispatch.py`` for a kernel (the bitmask
  SpMM for ``copy_lhs`` on a graph that has a bit format); otherwise the
  gather + ``index_add_`` path below runs.  That path is always correct
  and plays the role the XLA segment-sum plays in ``dgl_tpu``.  It walks
  the edges in canonical (COO) order, so it needs no CSC sort;
* autograd supplies the backward: the transpose of a gather is a
  scatter-add, and the gradient of ``scatter_reduce`` routes to the
  winning edges for max/min;
* zero-degree destinations produce 0 for every reduce;
* ``mean`` is ``sum`` divided by the in-degree here, never in a kernel.
"""
from __future__ import annotations

import torch

from ..graph.unitgraph import UnitGraph
from .kernels import dispatch

BINARY_OPS = ("add", "sub", "mul", "div", "copy_lhs", "copy_rhs")
REDUCE_OPS = ("sum", "max", "min", "mean")


def align_feat_ranks(x, y):
    """Pad the lower-rank operand's feature shape with leading 1s so both
    have equal ndim (``(E,)`` edge weights broadcast against ``(N, F)``;
    reference ``_sparse_ops.py:11 infer_broadcast_shape``)."""
    if x is None or y is None:
        return x, y
    while x.ndim < y.ndim:
        x = x.unsqueeze(1)
    while y.ndim < x.ndim:
        y = y.unsqueeze(1)
    return x, y


def _apply_binary(op: str, x, y):
    if op == "add":
        return x + y
    if op == "sub":
        return x - y
    if op == "mul":
        return x * y
    if op == "div":
        return x / y
    if op == "copy_lhs":
        return x
    return y


def _ensure_float(x):
    if x is None or x.is_floating_point():
        return x
    return x.float()


def _per_row(v, like):
    """A (n,) vector shaped to broadcast over ``like``'s feature dims."""
    return v.reshape((-1,) + (1,) * (like.ndim - 1)).to(like.dtype)


def gspmm_unit(unit: UnitGraph, op: str, reduce_op: str, u_data, e_data):
    """g-SpMM on one relation.

    ``u_data``: (num_src, *feat) or None; ``e_data``: (num_edges, *feat) in
    canonical edge order or None.  Returns (num_dst, *broadcast_feat).
    """
    if op not in BINARY_OPS:
        raise ValueError(f"invalid op {op}")
    if reduce_op not in REDUCE_OPS:
        raise ValueError(f"invalid reduce {reduce_op}")
    if op == "copy_lhs":
        e_data = None
    elif op == "copy_rhs":
        u_data = None
    u_data, e_data = align_feat_ranks(_ensure_float(u_data),
                                      _ensure_float(e_data))

    out = None
    if reduce_op in ("sum", "mean"):
        out = dispatch.try_spmm(unit, op, u_data, e_data)
    if out is None:
        row, col = unit.coo()
        msg = _apply_binary(op, None if u_data is None else u_data[row],
                            e_data)
        out = msg.new_zeros((unit.num_dst,) + msg.shape[1:])
        if reduce_op in ("sum", "mean"):
            out = out.index_add(0, col, msg)
        else:
            # rows that receive nothing keep the zero they start with
            idx = col.reshape((-1,) + (1,) * (msg.ndim - 1)).expand_as(msg)
            out = out.scatter_reduce(
                0, idx, msg, "amax" if reduce_op == "max" else "amin",
                include_self=False)
    if reduce_op == "mean":
        out = out / _per_row(unit.in_degrees().clamp(min=1), out)
    return out


def gspmm(g, op: str, reduce_op: str, lhs_data, rhs_data, etype=None):
    """Graph-level entry (reference ``python/dgl/ops/spmm.py:39 gspmm``)."""
    unit = g.unit(etype) if hasattr(g, "unit") else g
    return gspmm_unit(unit, op, reduce_op, lhs_data, rhs_data)
