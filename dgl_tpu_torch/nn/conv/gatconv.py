"""GATConv (graph attention) and DotGatConv layers.

GATConv: counterpart of ``dgl_tpu/nn/conv/gatconv.py:22-176`` (reference
``python/dgl/nn/pytorch/conv/gatconv.py:14``): ``fc`` projects the
features to H heads of D, el/er are the per-head dot products with
``attn_l``/``attn_r``, the edge logits lrelu(el[src] + er[dst]) are
softmax-normalized over each dst, dropped with ``attn_drop`` in training,
and weight the aggregation of the projected src features.  ``bias`` and
``attn_l``/``attn_r`` are (1, H, D) as in the JAX package; ``fc`` and
``res_fc`` are ``nn.Linear`` without bias.

Routes, chosen as ``gatconv.py:89-148`` chooses them.  With at least
``kernel_spmm_min_edges`` edges and no ``edge_weight`` or
``get_attention`` (the flat routes):

* the bitmask kernels (``ops/kernels/bitgat.py``, K5) when the graph
  carries a simple bit format, H * D <= 128 and at most 8 heads under
  attention dropout.  They clip el and er to +-20 each instead of
  subtracting a per-dst max (the JAX package's numerics contract), and
  draw the dropout mask from a hash of (src, dst, head, seed), with one
  seed per forward drawn from the module's generator;
* the slot-space kernels (``ops/kernels/gat_fused.py``, K6) when the
  graph carries a tiled format (``create_tiled_format``) and no attention
  dropout is active (eval mode, or ``attn_drop=0``), exactly under
  ``gatconv.py:106-136``'s gates.  They clip the logits to +-40 instead
  of subtracting a per-dst max; the attention never leaves slot space;
* otherwise edgeflat (``ops/edgeflat.py``): ``sddmm_flat(add)``,
  leaky_relu, ``edge_softmax_flat`` (max-subtracted), dropout from the
  module's generator, ``spmm_mul_flat`` (K4 on a tiled graph, else one
  gather-path SpMM per head).  Per edge it holds (E, H) scalars, never
  (E, H, D) messages.

Otherwise the edge chain: ``apply_edges(u_add_v)``, leaky_relu,
``edge_softmax``, dropout, ``edge_weight``, ``update_all(u_mul_e, sum)``.
It holds (E, H, D) messages, so it does not fit at Reddit scale.

DotGatConv: counterpart of ``dgl_tpu/nn/conv/gatconv.py:253-301``
(reference ``python/dgl/nn/pytorch/conv/dotgatconv.py``), dot-product
attention softmax(<ft_src[u], ft_dst[v]> / sqrt(D)) weighting ft_src.  At
``kernel_spmm_min_edges`` edges and more on a tiled graph it takes the
slot-space route (K8: K4's SDDMM, then K6's kernels); otherwise the
gather path.  Where the JAX package takes its bit-masked kernel K7 (a
simple bit format, H * D <= 128 and D >= 64, ``gatconv.py:280-285``),
K7 is not ported yet: the port takes K8 on a tiled graph, else the gather
path.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from ... import function as fn
from ...core import apply_edges, update_all
from ...ops import edge_softmax
from ...ops.edgeflat import edge_softmax_flat, sddmm_flat, spmm_mul_flat
from ...ops.kernels import bitgat
from ...ops.kernels import gat_fused
from ...ops.kernels.spmm import get_tiled_formats
from ...utils import config, expand_as_pair, resolve_device


def _dropout(x, p: float, generator: Optional[torch.Generator]):
    """Inverted dropout whose mask comes from ``generator``."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep / (1.0 - p)


class GATConv(nn.Module):
    def __init__(self, in_feats: int, out_feats: int, num_heads: int,
                 feat_drop: float = 0.0, attn_drop: float = 0.0,
                 negative_slope: float = 0.2, residual: bool = False,
                 activation: Optional[Callable] = None,
                 allow_zero_in_degree: bool = False, bias: bool = True,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_feats = in_feats
        self.out_feats = out_feats
        self.num_heads = num_heads
        self.feat_drop = feat_drop
        self.attn_drop = attn_drop
        self.negative_slope = negative_slope
        self.activation = activation
        self.allow_zero_in_degree = allow_zero_in_degree
        self.generator = generator
        dev = resolve_device(device)
        hd = num_heads * out_feats
        self.fc = nn.Linear(in_feats, hd, bias=False, device=dev)
        self.attn_l = nn.Parameter(torch.empty(1, num_heads, out_feats,
                                               device=dev))
        self.attn_r = nn.Parameter(torch.empty(1, num_heads, out_feats,
                                               device=dev))
        self.res_fc = (nn.Linear(in_feats, hd, bias=False, device=dev)
                       if residual else None)
        self.bias = (nn.Parameter(torch.zeros(1, num_heads, out_feats,
                                              device=dev))
                     if bias else None)
        self.reset_parameters()

    def reset_parameters(self):
        """Xavier-normal weights (gain of relu) and a zero bias, as the
        reference's ``reset_parameters``."""
        gain = nn.init.calculate_gain("relu")
        for w in (self.fc.weight, self.attn_l, self.attn_r) + (
                (self.res_fc.weight,) if self.res_fc is not None else ()):
            nn.init.xavier_normal_(w, gain=gain, generator=self.generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def _use_bits(self, unit, train_drop):
        bits = unit._bits
        heads, dim = self.num_heads, self.out_feats
        return (config.use_kernels() and bits is not None
                and bits.rem_src.shape[0] == 0
                and heads * dim <= bitgat.MAX_HD
                and not (train_drop and heads > 8))

    def _seed(self, device):
        """One int32 per forward from the module's generator."""
        gen = self.generator
        return torch.randint(-2**31, 2**31, (1,), generator=gen,
                             device=gen.device if gen is not None else device)

    def forward(self, graph, feat, edge_weight=None, get_attention=False):
        heads, dim = self.num_heads, self.out_feats
        feat_src, feat_dst = expand_as_pair(feat, graph)
        if self.feat_drop > 0 and self.training:
            feat_src = _dropout(feat_src, self.feat_drop, self.generator)
            feat_dst = (feat_src if feat_dst is feat
                        else _dropout(feat_dst, self.feat_drop,
                                      self.generator))
        ft_src = self.fc(feat_src).reshape(-1, heads, dim)
        ft_dst = (ft_src if feat_dst is feat_src
                  else self.fc(feat_dst).reshape(-1, heads, dim))
        train_drop = self.attn_drop > 0 and self.training
        unit = graph.unit()
        a = None
        use_flat = (unit.num_edges >= config.get("kernel_spmm_min_edges")
                    and edge_weight is None and not get_attention)
        if use_flat:
            el = (ft_src * self.attn_l).sum(-1)              # (N, H)
            er = (ft_dst * self.attn_r).sum(-1)
            use_bits = self._use_bits(unit, train_drop)
            # K6 takes no attention dropout (the bitmask kernels do)
            tf = (None if use_bits or train_drop or not config.use_kernels()
                  else get_tiled_formats(unit)[0])
            if use_bits:
                rst = bitgat.bitgat_attention_aggregate(
                    unit._bits, el, er, ft_src, self.negative_slope,
                    attn_drop=self.attn_drop if train_drop else 0.0,
                    dropout_seed=(self._seed(ft_src.device) if train_drop
                                  else None)).to(ft_src.dtype)
            elif tf is not None:
                rst = gat_fused.gat_attention_aggregate(
                    tf, el, er, ft_src, heads, dim,
                    self.negative_slope).to(ft_src.dtype)
            else:
                e = nn.functional.leaky_relu(
                    sddmm_flat(unit, "add", el, er), self.negative_slope)
                a_flat = edge_softmax_flat(unit, e, heads)
                if train_drop:
                    a_flat = _dropout(a_flat, self.attn_drop, self.generator)
                rst = spmm_mul_flat(unit, ft_src, a_flat, heads)
        else:
            el = (ft_src * self.attn_l).sum(-1, keepdim=True)   # (N, H, 1)
            er = (ft_dst * self.attn_r).sum(-1, keepdim=True)
            with graph.local_scope():
                graph.srcdata.update({"ft": ft_src, "el": el})
                graph.dstdata.update({"er": er})
                e = apply_edges(graph, fn.u_add_v("el", "er", "e"))
                e = nn.functional.leaky_relu(e, self.negative_slope)
                a = edge_softmax(graph, e)
                if train_drop:
                    a = _dropout(a, self.attn_drop, self.generator)
                if edge_weight is not None:
                    a = a * edge_weight.reshape(-1, 1, 1)
                graph.edata["a"] = a
                rst = update_all(graph, fn.u_mul_e("ft", "a", "m"),
                                 fn.sum("m", "ft"))["ft"]
        if self.res_fc is not None:
            rst = rst + self.res_fc(feat_dst).reshape(-1, heads, dim)
        if self.bias is not None:
            rst = rst + self.bias
        if self.activation is not None:
            rst = self.activation(rst)
        if get_attention:
            return rst, a
        return rst

    def extra_repr(self):
        return (f"in={self.in_feats}, out={self.out_feats}, "
                f"heads={self.num_heads}")


class DotGatConv(nn.Module):
    """Dot-product attention conv: ``fc_src``/``fc_dst`` (no bias) project
    to H heads of D, and out[v] = sum_u softmax_u(<ft_src[u], ft_dst[v]> /
    sqrt(D)) ft_src[u], (N_dst, H, D)."""

    def __init__(self, in_feats: int, out_feats: int, num_heads: int,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_feats = in_feats
        self.out_feats = out_feats
        self.num_heads = num_heads
        self.generator = generator
        dev = resolve_device(device)
        hd = num_heads * out_feats
        self.fc_src = nn.Linear(in_feats, hd, bias=False, device=dev)
        self.fc_dst = nn.Linear(in_feats, hd, bias=False, device=dev)
        self.reset_parameters()

    def reset_parameters(self):
        """Xavier-normal weights with the gain of relu, as the reference's
        ``reset_parameters``."""
        gain = nn.init.calculate_gain("relu")
        for w in (self.fc_src.weight, self.fc_dst.weight):
            nn.init.xavier_normal_(w, gain=gain, generator=self.generator)

    def forward(self, graph, feat):
        heads, dim = self.num_heads, self.out_feats
        feat_src, feat_dst = expand_as_pair(feat, graph)
        ft_src = self.fc_src(feat_src).reshape(-1, heads, dim)
        ft_dst = self.fc_dst(feat_dst).reshape(-1, heads, dim)
        unit = graph.unit()
        if (config.use_kernels()
                and unit.num_edges >= config.get("kernel_spmm_min_edges")):
            tf = get_tiled_formats(unit)[0]
            if tf is not None:
                return gat_fused.dot_gat_attention_aggregate(
                    tf, ft_dst, ft_src, ft_src, heads, dim, dim) \
                    .to(ft_src.dtype)
        with graph.local_scope():
            graph.srcdata["ft"] = ft_src
            graph.dstdata["ft_dst"] = ft_dst
            e = apply_edges(graph, fn.u_dot_v("ft", "ft_dst", "a"))
            graph.edata["sa"] = edge_softmax(graph, e / math.sqrt(dim))
            return update_all(graph, fn.u_mul_e("ft", "sa", "m"),
                              fn.sum("m", "agg_u"))["agg_u"]

    def extra_repr(self):
        return (f"in={self.in_feats}, out={self.out_feats}, "
                f"heads={self.num_heads}")
