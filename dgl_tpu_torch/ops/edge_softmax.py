"""Edge softmax: normalize edge scores over each node's incident edges.

Counterpart of ``dgl_tpu/ops/edge_softmax.py`` (reference
``python/dgl/ops/edge_softmax.py:12``; kernel composition max -> sub ->
exp -> sum -> div at ``src/array/kernel.cc:309-340``).

The forward walks the edges in canonical (COO) order with
``scatter_reduce`` (max) and ``index_add_`` (sum) keyed by each edge's
dst (``norm_by='dst'``) or src; no CSC sort is needed.  The backward is
the reference's memory-light rule ``out*dZ - out * sum(out*dZ)``
(``backend/pytorch/sparse.py:739-748``) in a ``torch.autograd.Function``
that saves only ``out``, as the JAX package's ``custom_vjp`` does.
Per-edge reads of node values go through ``utils.gather_rows``, which
gathers narrow rows one column at a time (far faster on the card).
"""
from __future__ import annotations

import torch

from ..graph.unitgraph import UnitGraph
from ..utils import gather_rows


def _segment_sum(v, ids, num):
    return v.new_zeros((num,) + v.shape[1:]).index_add_(0, ids, v)



class _EdgeSoftmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, score, ids, num):
        idx = ids.reshape((-1,) + (1,) * (score.ndim - 1)).expand_as(score)
        smax = score.new_full((num,) + score.shape[1:], -torch.inf)
        smax = smax.scatter_reduce(0, idx, score, "amax", include_self=True)
        smax = torch.where(torch.isfinite(smax), smax, 0.0)
        ex = torch.exp(score - gather_rows(smax, ids))
        den = _segment_sum(ex, ids, num).clamp(min=1e-38)
        out = ex / gather_rows(den, ids)
        ctx.save_for_backward(out, ids)
        ctx.num = num
        return out

    @staticmethod
    def backward(ctx, dz):
        out, ids = ctx.saved_tensors
        sds = out * dz
        return (sds - out * gather_rows(_segment_sum(sds, ids, ctx.num), ids),
                None, None)


def edge_softmax_unit(unit: UnitGraph, score, norm_by: str = "dst"):
    if norm_by == "dst":
        ids, num = unit.coo()[1], unit.num_dst
    elif norm_by == "src":
        ids, num = unit.coo()[0], unit.num_src
    else:
        raise ValueError(norm_by)
    return _EdgeSoftmax.apply(score, ids, num)


def edge_softmax(g, score, eids=None, norm_by: str = "dst", etype=None):
    """Reference ``dgl.ops.edge_softmax``: ``score`` (num_edges, ...) in
    canonical edge order, normalized over the edges that share a dst
    (``norm_by='dst'``) or a src."""
    if eids is not None:
        raise NotImplementedError(
            "dgl_tpu_torch: edge_softmax over an edge subset comes with "
            "the subgraph slice")
    unit = g.unit(etype) if hasattr(g, "unit") else g
    return edge_softmax_unit(unit, score, norm_by=norm_by)
