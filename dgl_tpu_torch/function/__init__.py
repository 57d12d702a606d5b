"""Builtin message and reduce functions (counterpart of
``dgl_tpu/function``, reference ``python/dgl/function/``).

``fn.copy_u('h', 'm')``, ``fn.u_mul_e('h', 'w', 'm')``, ``fn.sum('m', 'h')``
etc. are descriptors consumed by the fuse-or-fallback dispatcher in
``dgl_tpu_torch.core``.  The surface mirrors the reference: ``copy_u`` and
``copy_e``, every ordered pair ``lhs != rhs in {u, v, e}^2 x {add, sub,
mul, div, dot}`` (``function/message.py:179-186``), and the reducers
``sum/max/min/mean``.
"""
from __future__ import annotations

import sys
from typing import NamedTuple, Optional


class BuiltinMessage(NamedTuple):
    """Descriptor of a builtin message function."""
    name: str           # e.g. 'u_mul_e'
    binary_op: str      # add/sub/mul/div/dot/copy_lhs/copy_rhs
    lhs: str            # 'u' | 'v' | 'e'
    rhs: Optional[str]  # 'u' | 'v' | 'e', or None when unary
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


def copy_e(e, out):
    """Message = edge feature (reference ``fn.copy_e``)."""
    return BuiltinMessage("copy_e", "copy_rhs", "e", None, e, "", out)


def _gen_binary(lhs, op, rhs):
    name = f"{lhs}_{op}_{rhs}"

    def func(lhs_field, rhs_field, out):
        return BuiltinMessage(name, op, lhs, rhs, lhs_field, rhs_field, out)
    func.__name__ = name
    func.__doc__ = (f"Builtin message: out = {lhs}[lhs_field] {op} "
                    f"{rhs}[rhs_field] per edge.")
    return func


_mod = sys.modules[__name__]
for _op in ("add", "sub", "mul", "div", "dot"):
    for _l in ("u", "v", "e"):
        for _r in ("u", "v", "e"):
            if _l != _r:
                setattr(_mod, f"{_l}_{_op}_{_r}", _gen_binary(_l, _op, _r))
del _mod, _gen_binary, _op, _l, _r


def sum(msg, out):  # noqa: A001 - mirrors the reference name
    """Reduce by sum (reference ``fn.sum``)."""
    return BuiltinReduce("sum", msg, out)


def max(msg, out):  # noqa: A001
    return BuiltinReduce("max", msg, out)


def min(msg, out):  # noqa: A001
    return BuiltinReduce("min", msg, out)


def mean(msg, out):
    return BuiltinReduce("mean", msg, out)
