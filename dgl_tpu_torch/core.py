"""The message-passing engine: builtin message + reduce pairs fused into
one g-SpMM call, and builtin edge messages by g-SDDMM.

Counterpart of ``dgl_tpu/core.py`` (``invoke_gspmm`` with its
static-weight route, ``invoke_gsddmm``, ``message_passing``,
``update_all``, ``apply_edges``; reference ``python/dgl/core.py:273, 311,
372-425``).  This slice carries the builtins; user-defined message,
reduce and edge functions, and edge subsets, come with a later slice.
"""
from __future__ import annotations

from .function import BuiltinMessage, BuiltinReduce
from .ops import gsddmm, gspmm
from .ops.kernels import dispatch


def _fetch(g, etid, target: str, field: str):
    st, _, dt = g.canonical_etypes[etid]
    if target == "u":
        return g._node_frames[g.get_ntype_id(st)][field]
    if target == "v":
        return g._node_frames[g.get_ntype_id(dt)][field]
    if target == "e":
        return g._edge_frames[etid][field]
    raise ValueError(target)


def invoke_gsddmm(g, etid, mfunc: BuiltinMessage):
    """Builtin messages as an edge tensor (reference ``core.py:273``)."""
    unit = g._units[etid]
    x = _fetch(g, etid, mfunc.lhs, mfunc.lhs_field)
    if mfunc.rhs is None:
        if mfunc.name == "copy_u":
            return gsddmm(unit, "copy_lhs", x, None, "u", "v")
        return gsddmm(unit, "copy_rhs", None, x, "u", "e")
    y = _fetch(g, etid, mfunc.rhs, mfunc.rhs_field)
    return gsddmm(unit, mfunc.binary_op, x, y, lhs_target=mfunc.lhs,
                  rhs_target=mfunc.rhs)


def invoke_gspmm(g, etid, mfunc: BuiltinMessage, rfunc: BuiltinReduce):
    """Fused message+reduce (reference ``core.py:311``)."""
    unit = g._units[etid]
    reduce_op = rfunc.name
    x = _fetch(g, etid, mfunc.lhs, mfunc.lhs_field)
    if mfunc.rhs is None:
        if mfunc.name == "copy_u":
            return gspmm(unit, "copy_lhs", reduce_op, x, None)
        return gspmm(unit, "copy_rhs", reduce_op, None, x)
    y = _fetch(g, etid, mfunc.rhs, mfunc.rhs_field)
    op, pair = mfunc.binary_op, (mfunc.lhs, mfunc.rhs)
    if (pair == ("u", "e") and op in ("mul", "div")
            and reduce_op in ("sum", "mean") and unit._slot_weights):
        # static weights cached in slot order under the field's name
        # (UnitGraph.cache_edge_weights), while edata still holds them
        out = dispatch.try_spmm_static(unit, op, x, mfunc.rhs_field,
                                       current_w=y)
        if out is not None:
            if reduce_op == "mean":
                deg = unit.in_degrees().clamp(min=1).to(out.dtype)
                out = out / deg.reshape((-1,) + (1,) * (out.ndim - 1))
            return out
    if pair == ("u", "e") and op != "dot":
        return gspmm(unit, op, reduce_op, x, y)
    if pair == ("e", "u") and op in ("add", "mul"):
        return gspmm(unit, op, reduce_op, y, x)
    # v targets, dot, and non-commutative e-u: materialize the message,
    # then reduce it with copy_rhs (the reference's fallback)
    msg = gsddmm(unit, op, x, y, lhs_target=mfunc.lhs,
                 rhs_target=mfunc.rhs)
    return gspmm(unit, "copy_rhs", reduce_op, None, msg)


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


def _edge_messages(g, func, edges, etype):
    if not isinstance(func, BuiltinMessage):
        raise NotImplementedError(
            "dgl_tpu_torch carries builtin edge functions only; "
            "user-defined functions come with a later slice")
    if edges is not None:
        raise NotImplementedError(
            "dgl_tpu_torch: apply_edges over an edge subset comes with a "
            "later slice")
    etid = g.get_etype_id(etype)
    return etid, invoke_gsddmm(g, etid, func)


def apply_edges_inplace(g, func, edges=None, etype=None):
    """``g.apply_edges`` (reference ``heterograph.py:4597``): stores the
    builtin's messages under its output field in ``g.edata``."""
    etid, out = _edge_messages(g, func, edges, etype)
    g._edge_frames[etid][func.out_field] = out
    return g


def apply_edges(g, func, edges=None, etype=None):
    """Functional apply_edges: returns the edge tensor (num_edges, ...)
    without mutating the graph."""
    return _edge_messages(g, func, edges, etype)[1]
