"""GraphConv (GCN) layer.

Counterpart of ``dgl_tpu/nn/conv/graphconv.py:22-106`` (reference
``python/dgl/nn/pytorch/conv/graphconv.py:157``): ``norm in {none, both,
right, left}``; ``both`` scales by out-deg^-1/2 before and in-deg^-1/2
after the aggregation, with degrees clamped at 1; the weight is applied
before the SpMM when ``in_feats > out_feats`` and after it otherwise, so
the SpMM runs on the narrow side.  ``weight`` is (in, out) and ``bias``
(out,), the layout of DGL's PyTorch GraphConv.  ``edge_weight`` is a
tensor of one scalar per edge, or the name of an edata field, which takes
the static slot-weight route when ``Graph.cache_edge_weights`` cached it.

``EdgeWeightNorm`` (``graphconv.py:109-132``) normalizes scalar edge
weights by weighted degrees.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ... import function as fn
from ...core import update_all
from ...ops import gspmm
from ...utils import expand_as_pair, resolve_device


class GraphConv(nn.Module):
    def __init__(self, in_feats: int, out_feats: int, norm: str = "both",
                 weight: bool = True, bias: bool = True,
                 activation: Optional[Callable] = None,
                 allow_zero_in_degree: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if norm not in ("none", "both", "right", "left"):
            raise ValueError(f"invalid norm {norm!r}")
        self.in_feats = in_feats
        self.out_feats = out_feats
        self.norm = norm
        self.activation = activation
        self.allow_zero_in_degree = allow_zero_in_degree
        dev = resolve_device(device)
        self.weight = (nn.Parameter(torch.empty(in_feats, out_feats,
                                                device=dev))
                       if weight else None)
        self.bias = (nn.Parameter(torch.zeros(out_feats, device=dev))
                     if bias else None)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Glorot-uniform weight and zero bias, as the reference."""
        if self.weight is not None:
            nn.init.xavier_uniform_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def _norm(self, degs, like, root):
        degs = degs.clamp(min=1).to(like.dtype)
        norm = degs.pow(-0.5) if root else 1.0 / degs
        return like * norm.reshape((-1,) + (1,) * (like.ndim - 1))

    def forward(self, graph, feat, weight=None, edge_weight=None):
        feat_src, feat_dst = expand_as_pair(feat, graph)
        unit = graph.unit()
        if self.norm in ("left", "both"):
            feat_src = self._norm(unit.out_degrees(), feat_src,
                                  self.norm == "both")
        if weight is None:
            weight = self.weight

        with graph.local_scope():
            msg_fn = fn.copy_u("h", "m")
            if isinstance(edge_weight, str):
                # the field's name: the static route when it is cached
                msg_fn = fn.u_mul_e("h", edge_weight, "m")
            elif edge_weight is not None:
                graph.edata["_edge_weight"] = edge_weight
                msg_fn = fn.u_mul_e("h", "_edge_weight", "m")
            if self.in_feats > self.out_feats:
                if weight is not None:
                    feat_src = feat_src @ weight
                graph.srcdata["h"] = feat_src
                rst = update_all(graph, msg_fn, fn.sum("m", "h"))["h"]
            else:
                graph.srcdata["h"] = feat_src
                rst = update_all(graph, msg_fn, fn.sum("m", "h"))["h"]
                if weight is not None:
                    rst = rst @ weight

        if self.norm in ("right", "both"):
            rst = self._norm(unit.in_degrees(), rst, self.norm == "both")
        if self.bias is not None:
            rst = rst + self.bias
        if self.activation is not None:
            rst = self.activation(rst)
        return rst

    def extra_repr(self):
        return (f"in={self.in_feats}, out={self.out_feats}, "
                f"normalization={self.norm}")


class EdgeWeightNorm(nn.Module):
    """Normalize scalar edge weights by weighted degrees (reference
    ``graphconv.py EdgeWeightNorm``): ``both`` gives w_uv / sqrt(deg_u
    deg_v), ``right`` w_uv / deg_v, with the degrees summed over the
    weights and clamped at 1e-12 after adding ``eps``."""

    def __init__(self, norm: str = "both", eps: float = 0.0):
        super().__init__()
        if norm not in ("both", "right"):
            raise ValueError(f"invalid norm {norm!r}")
        self.norm = norm
        self.eps = eps

    def forward(self, graph, edge_weight):
        unit = graph.unit()
        row, col = unit.coo()
        wdeg_in = gspmm(unit, "copy_rhs", "sum", None, edge_weight)
        if self.norm == "both":
            wdeg_out = gspmm(unit.reverse(), "copy_rhs", "sum", None,
                             edge_weight)
            norm_src = (wdeg_out + self.eps).clamp(min=1e-12).rsqrt()
            norm_dst = (wdeg_in + self.eps).clamp(min=1e-12).rsqrt()
            return edge_weight * norm_src[row] * norm_dst[col]
        return edge_weight / (wdeg_in[col] + self.eps).clamp(min=1e-12)

    def extra_repr(self):
        return f"norm={self.norm}, eps={self.eps}"
