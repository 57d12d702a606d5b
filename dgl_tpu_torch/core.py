"""The message-passing engine: builtin message + reduce pairs fused into
one g-SpMM call.

Counterpart of ``dgl_tpu/core.py`` (``invoke_gspmm``, ``message_passing``,
``update_all``; reference ``python/dgl/core.py:311, 372-425``).  This slice
carries the builtin pairs; user-defined message and reduce functions come
with a later slice.
"""
from __future__ import annotations

from .function import BuiltinMessage, BuiltinReduce
from .ops import gspmm


def invoke_gspmm(g, etid, mfunc: BuiltinMessage, rfunc: BuiltinReduce):
    """Fused message+reduce (reference ``core.py:311``)."""
    unit = g._units[etid]
    st, _, _ = g.canonical_etypes[etid]
    x = g._node_frames[g.get_ntype_id(st)][mfunc.lhs_field]
    if mfunc.rhs is None:
        return gspmm(unit, mfunc.binary_op, rfunc.name, x, None)
    y = g._edge_frames[etid][mfunc.rhs_field]
    return gspmm(unit, mfunc.binary_op, rfunc.name, x, y)


def message_passing(g, mfunc, rfunc, etid: int = 0):
    """Reduced node data for one relation: {field: (num_dst, ...) tensor}."""
    if not (isinstance(mfunc, BuiltinMessage)
            and isinstance(rfunc, BuiltinReduce)):
        raise NotImplementedError(
            "dgl_tpu_torch carries builtin message/reduce pairs only; "
            "user-defined functions come with a later slice")
    return {rfunc.out_field: invoke_gspmm(g, etid, mfunc, rfunc)}


def update_all_inplace(g, mfunc, rfunc, etype=None):
    """``g.update_all`` (reference ``heterograph.py:5018``)."""
    etid = g.get_etype_id(etype)
    ndata = message_passing(g, mfunc, rfunc, etid)
    dt = g.canonical_etypes[etid][2]
    g._node_frames[g.get_ntype_id(dt)].update(ndata)
    return g


def update_all(g, mfunc, rfunc, etype=None):
    """Functional variant: returns the reduced fields without mutating
    the graph."""
    return message_passing(g, mfunc, rfunc, g.get_etype_id(etype))
