"""Builtin message and reduce functions (counterpart of
``dgl_tpu/function``, reference ``python/dgl/function/``).

``fn.copy_u('h', 'm')``, ``fn.u_mul_e('h', 'w', 'm')``, ``fn.sum('m', 'h')``
etc. are descriptors consumed by the fuse-or-fallback dispatcher in
``dgl_tpu_torch.core``.  This slice carries the builtins of the GCN path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional


class BuiltinMessage(NamedTuple):
    """Descriptor of a builtin message function."""
    name: str           # e.g. 'u_mul_e'
    binary_op: str      # mul/copy_lhs
    lhs: str            # 'u'
    rhs: Optional[str]  # 'e' or None when unary
    lhs_field: str
    rhs_field: str      # '' when unary
    out_field: str


class BuiltinReduce(NamedTuple):
    """Descriptor of a builtin reduce function."""
    name: str           # sum/max/min/mean
    msg_field: str
    out_field: str


def copy_u(u, out):
    """Message = source node feature (reference ``fn.copy_u``)."""
    return BuiltinMessage("copy_u", "copy_lhs", "u", None, u, "", out)


def u_mul_e(lhs_field, rhs_field, out):
    """Message = source node feature times edge feature."""
    return BuiltinMessage("u_mul_e", "mul", "u", "e", lhs_field, rhs_field,
                          out)


def sum(msg, out):  # noqa: A001 - mirrors the reference name
    """Reduce by sum (reference ``fn.sum``)."""
    return BuiltinReduce("sum", msg, out)


def max(msg, out):  # noqa: A001
    return BuiltinReduce("max", msg, out)


def min(msg, out):  # noqa: A001
    return BuiltinReduce("min", msg, out)


def mean(msg, out):
    return BuiltinReduce("mean", msg, out)
