"""GATConv (graph attention), GATv2Conv, EGATConv and DotGatConv layers.

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
attention softmax(<ft_src[u], ft_dst[v]> / sqrt(D)) weighting ft_src.
Routes, in the order of ``gatconv.py:276-299``, at ``kernel_spmm_min_edges``
edges and more: the bit-masked kernels (``ops/kernels/bitdot.py``, K7)
when the graph carries a simple bit format, H * D <= 128 and D >= 64; the
slot-space route (K8: K4's SDDMM, then K6's kernels) on a tiled graph;
otherwise the gather path.  K7 and K8 clip the scores at +-40, and K7's
gradient is 0 at saturated scores, so the routes agree while every score
lies inside the clip.

GATv2Conv (K9) and EGATConv (K11 v2): see their classes.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from ... import function as fn
from ...core import apply_edges, update_all
from ...ops import edge_softmax
from ...ops.edgeflat import edge_softmax_flat, sddmm_flat, spmm_mul_flat
from ...ops.kernels import bitdot
from ...ops.kernels import bitgat
from ...ops.kernels import gat_fused
from ...ops.kernels.spmm import get_tiled_formats
from ...utils import config, expand_as_pair, gather_rows, resolve_device


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


def _kernel_tiles(unit, get_attention: bool, train_drop: bool = False):
    """The forward tiled format when a slot-space attention kernel may take
    the layer (enough edges, kernels on, no attention asked back, no
    attention dropout active), else None."""
    if (get_attention or train_drop or not config.use_kernels()
            or unit.num_edges < config.get("kernel_spmm_min_edges")):
        return None
    return get_tiled_formats(unit)[0]


class GATv2Conv(nn.Module):
    """GATv2 (``dgl_tpu/nn/conv/gatconv.py:179-250``, reference
    ``python/dgl/nn/pytorch/conv/gatv2conv.py``): the logits are attn .
    lrelu(fc_src(h)[u] + fc_dst(h)[v]) per head, the 'dynamic attention'
    fix of GAT.  ``fc_src``/``fc_dst`` are ``nn.Linear`` with ``bias``
    (one module under ``share_weights``), ``attn`` is (1, H, D), and
    ``res_fc`` has no bias, as in the JAX package.

    Routes, under ``gatconv.py:214-242``'s gates: the slot-space kernels
    K9 (``ops/kernels/gat_fused.py`` ``gatv2_attention_aggregate``) at
    ``kernel_spmm_min_edges`` edges and more on a graph with a tiled
    format, without ``get_attention`` and with no attention dropout
    active; they clip the logits to +-40 instead of subtracting a per-dst
    max.  Otherwise the edge chain: ``apply_edges(u_add_v)`` with (E, H, D)
    messages, leaky_relu, the dot with ``attn``, ``edge_softmax``, dropout
    from the module's generator and ``update_all(u_mul_e, sum)``."""

    def __init__(self, in_feats: int, out_feats: int, num_heads: int,
                 feat_drop: float = 0.0, attn_drop: float = 0.0,
                 negative_slope: float = 0.2, residual: bool = False,
                 activation: Optional[Callable] = None,
                 allow_zero_in_degree: bool = False, bias: bool = True,
                 share_weights: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_feats = in_feats
        self.out_feats = out_feats
        self.num_heads = num_heads
        self.feat_drop = feat_drop
        self.attn_drop = attn_drop
        self.negative_slope = negative_slope
        self.activation = activation
        self.allow_zero_in_degree = allow_zero_in_degree
        self.share_weights = share_weights
        self.generator = generator
        dev = resolve_device(device)
        hd = num_heads * out_feats
        self.fc_src = nn.Linear(in_feats, hd, bias=bias, device=dev)
        self.fc_dst = (self.fc_src if share_weights else
                       nn.Linear(in_feats, hd, bias=bias, device=dev))
        self.attn = nn.Parameter(torch.empty(1, num_heads, out_feats,
                                             device=dev))
        self.res_fc = (nn.Linear(in_feats, hd, bias=False, device=dev)
                       if residual else None)
        self.reset_parameters()

    def reset_parameters(self):
        """Xavier-normal weights (gain of relu) and zero biases, as the
        reference's ``reset_parameters``."""
        gain = nn.init.calculate_gain("relu")
        for lin in [self.fc_src] + ([] if self.share_weights
                                    else [self.fc_dst]):
            nn.init.xavier_normal_(lin.weight, gain=gain,
                                   generator=self.generator)
            if lin.bias is not None:
                nn.init.zeros_(lin.bias)
        nn.init.xavier_normal_(self.attn, gain=gain, generator=self.generator)
        if self.res_fc is not None:
            nn.init.xavier_normal_(self.res_fc.weight, gain=gain,
                                   generator=self.generator)

    def forward(self, graph, feat, get_attention=False):
        heads, dim = self.num_heads, self.out_feats
        feat_src, feat_dst = expand_as_pair(feat, graph)
        if self.feat_drop > 0 and self.training:
            feat_src = _dropout(feat_src, self.feat_drop, self.generator)
            feat_dst = (feat_src if feat_dst is feat
                        else _dropout(feat_dst, self.feat_drop,
                                      self.generator))
        ft_src = self.fc_src(feat_src).reshape(-1, heads, dim)
        ft_dst = (ft_src if self.share_weights and feat_dst is feat_src
                  else self.fc_dst(feat_dst).reshape(-1, heads, dim))
        train_drop = self.attn_drop > 0 and self.training
        tf = _kernel_tiles(graph.unit(), get_attention, train_drop)
        a = None
        if tf is not None:
            rst = gat_fused.gatv2_attention_aggregate(
                tf, ft_src, ft_dst, ft_src, self.attn[0], heads, dim, dim,
                self.negative_slope).to(ft_src.dtype)
        else:
            with graph.local_scope():
                graph.srcdata.update({"el": ft_src, "ft": ft_src})
                graph.dstdata.update({"er": ft_dst})
                e = apply_edges(graph, fn.u_add_v("el", "er", "e"))
                e = nn.functional.leaky_relu(e, self.negative_slope)
                e = (e * self.attn).sum(-1, keepdim=True)       # (E, H, 1)
                a = edge_softmax(graph, e)
                if train_drop:
                    a = _dropout(a, self.attn_drop, self.generator)
                graph.edata["a"] = a
                rst = update_all(graph, fn.u_mul_e("ft", "a", "m"),
                                 fn.sum("m", "ft"))["ft"]
        if self.res_fc is not None:
            rst = rst + self.res_fc(feat_dst).reshape(-1, heads, dim)
        if self.activation is not None:
            rst = self.activation(rst)
        if get_attention:
            return rst, a
        return rst

    def extra_repr(self):
        return (f"in={self.in_feats}, out={self.out_feats}, "
                f"heads={self.num_heads}, share_weights={self.share_weights}")


EGAT_SLOPE = 0.01   # EGATConv's leaky_relu slope (flax's default)
EGAT_CHUNK = 1 << 19  # edges per chunk of the flat route's logits


def _egat_logits_chunked(f_ni, f_nj, efeats, w_fij, bias, attn, row, col,
                         heads: int, de: int, chunk: int):
    """The attention logits, flat (E * H,), without the (E, H * De) edge
    tensor (``gatconv.py:304-332``): fixed edge chunks, each recomputed in
    the backward (``torch.utils.checkpoint``, as ``jax.checkpoint``), so
    the saved tensors stay chunk-sized."""

    def body(r, c, ef):
        f = gather_rows(f_ni, r) + gather_rows(f_nj, c) + ef @ w_fij.t()
        if bias is not None:
            f = f + bias
        f = nn.functional.leaky_relu(f, EGAT_SLOPE)
        return (f.reshape(-1, heads, de) * attn).sum(-1)

    out = [torch.utils.checkpoint.checkpoint(
        body, row[e0:e0 + chunk], col[e0:e0 + chunk],
        efeats[e0:e0 + chunk], use_reentrant=False)
        for e0 in range(0, row.shape[0], chunk)]
    if not out:
        return f_ni.new_zeros(0)
    return torch.cat(out).reshape(-1)


def _check_slot_edge_feats(tf, unit, efeats, efeats_slot, fe: int):
    """Raise unless ``efeats_slot`` is (B, C, fe) in ``tf``'s slot order,
    ``efeats`` (when given) has one row per edge, and a gradient that
    ``efeats`` asks for can reach it through ``efeats_slot``."""
    want = (tf.num_buckets, tf.cap, fe)
    if tuple(efeats_slot.shape) != want:
        raise ValueError(f"efeats_slot has shape {tuple(efeats_slot.shape)}"
                         f", the graph's slot order {want}: build it with "
                         "EGATConv.slot_edge_feats(graph, efeats)")
    if efeats is None:
        return
    if efeats.shape[0] != unit.num_edges:
        raise ValueError(f"efeats has {efeats.shape[0]} rows for "
                         f"{unit.num_edges} edges")
    if efeats.requires_grad and not efeats_slot.requires_grad:
        raise ValueError("efeats needs a gradient that efeats_slot does not "
                         "carry: build efeats_slot from efeats in the step")


class EGATConv(nn.Module):
    """GAT with edge features (``dgl_tpu/nn/conv/gatconv.py:335-468``,
    reference ``python/dgl/nn/pytorch/conv/egatconv.py``): the logits are
    attn . lrelu(f_ni[u] + f_nj[v] + fc_fij(e) + bias) per head, slope
    0.01; returns the new node features (N_dst, H, Dn) and edge features
    lrelu(...) (E, H, De).  ``fc_node_src``, ``fc_ni``, ``fc_fij`` and
    ``fc_nj`` are ``nn.Linear`` without bias, ``bias`` is (H * De,) and
    ``attn`` (1, H, De), as in the JAX package.

    Routes, under ``gatconv.py:389-449``'s gates:

    * the slot-space kernels K11 v2 (``ops/kernels/gat_fused.py``
      ``egatconv_attention_aggregate_v2``) at ``kernel_spmm_min_edges``
      edges and more on a graph with a tiled format, given ``efeats_slot``
      (:meth:`slot_edge_feats`), without ``get_attention`` and with
      ``compute_edge_feats=False``; the edge transform runs in the kernels
      (the bias as the last row of its matrix) and nothing (E, H * De)
      -sized exists.  The kernels take at most ``MAX_FE_ROWS`` edge rows,
      the bias row counted; above that the flat route takes the layer,
      where the JAX package pads the rows and stays fused.  Returns ``(h,
      None)``.  This route reads the edge features only through
      ``efeats_slot``: ``efeats`` is checked against it, and a gradient
      reaches ``efeats`` only through an ``efeats_slot`` built from it in
      the step.  The JAX package also
      needs a TPU there; the port takes this route on CUDA and CPU tensors
      alike;
    * the flat route at ``kernel_spmm_min_edges`` edges and more without
      ``get_attention``: chunked logits, ``edge_softmax_flat`` and
      ``spmm_mul_flat``; the edge features only with
      ``compute_edge_feats``, else None;
    * otherwise the edge chain."""

    def __init__(self, in_node_feats: int, in_edge_feats: int,
                 out_node_feats: int, out_edge_feats: int, num_heads: int,
                 bias: bool = True, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_node_feats = in_node_feats
        self.in_edge_feats = in_edge_feats
        self.out_node_feats = out_node_feats
        self.out_edge_feats = out_edge_feats
        self.num_heads = num_heads
        self.generator = generator
        dev = resolve_device(device)
        hn, he = num_heads * out_node_feats, num_heads * out_edge_feats
        self.fc_node_src = nn.Linear(in_node_feats, hn, bias=False,
                                     device=dev)
        self.fc_ni = nn.Linear(in_node_feats, he, bias=False, device=dev)
        self.fc_fij = nn.Linear(in_edge_feats, he, bias=False, device=dev)
        self.fc_nj = nn.Linear(in_node_feats, he, bias=False, device=dev)
        self.attn = nn.Parameter(torch.empty(1, num_heads, out_edge_feats,
                                             device=dev))
        self.bias = (nn.Parameter(torch.zeros(he, device=dev)) if bias
                     else None)
        self.reset_parameters()

    def reset_parameters(self):
        """Xavier-normal weights (gain of relu) and a zero bias, as the
        reference's ``reset_parameters``."""
        gain = nn.init.calculate_gain("relu")
        for w in (self.fc_node_src.weight, self.fc_ni.weight,
                  self.fc_fij.weight, self.fc_nj.weight, self.attn):
            nn.init.xavier_normal_(w, gain=gain, generator=self.generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    @staticmethod
    def slot_edge_feats(graph, efeats):
        """Canonical (E, Fe) edge features in the slot order of the graph's
        tiled format (built if missing), for ``efeats_slot=``; once, at
        set-up."""
        return gat_fused.slot_edge_tensor(graph.unit().tiled_format()[0],
                                          efeats)

    def forward(self, graph, nfeats, efeats, get_attention=False,
                compute_edge_feats=True, efeats_slot=None):
        heads = self.num_heads
        dn, de = self.out_node_feats, self.out_edge_feats
        feat_src, feat_dst = expand_as_pair(nfeats, graph)
        f_ni = self.fc_ni(feat_src)
        f_nj = self.fc_nj(feat_dst)
        unit = graph.unit()
        rows = self.in_edge_feats + (self.bias is not None)
        tf = (None if efeats_slot is None or compute_edge_feats
              or not gat_fused.fe_rows_fit(rows)
              else _kernel_tiles(unit, get_attention))
        if tf is not None:
            _check_slot_edge_feats(tf, unit, efeats, efeats_slot,
                                   self.in_edge_feats)
            wf = self.fc_fij.weight.t()
            if self.bias is not None:
                wf = torch.cat([wf, self.bias.unsqueeze(0)])
            x3 = self.fc_node_src(feat_src).reshape(-1, heads, dn)
            h = gat_fused.egatconv_attention_aggregate_v2(
                tf, f_ni.reshape(-1, heads, de), f_nj.reshape(-1, heads, de),
                efeats_slot, wf, self.attn[0], x3, heads, de, dn,
                EGAT_SLOPE).to(x3.dtype)
            return h, None

        if unit.num_edges >= config.get("kernel_spmm_min_edges") and \
                not get_attention:
            row, col = unit.coo()
            logits = _egat_logits_chunked(f_ni, f_nj, efeats,
                                          self.fc_fij.weight, self.bias,
                                          self.attn, row, col, heads, de,
                                          EGAT_CHUNK)
            a_flat = edge_softmax_flat(unit, logits, heads)
            x3 = self.fc_node_src(feat_src).reshape(-1, heads, dn)
            h = spmm_mul_flat(unit, x3, a_flat, heads)
            f_out = None
            if compute_edge_feats:
                f_tmp = (gather_rows(f_ni, row) + gather_rows(f_nj, col)
                         + self.fc_fij(efeats))
                if self.bias is not None:
                    f_tmp = f_tmp + self.bias
                f_out = nn.functional.leaky_relu(
                    f_tmp, EGAT_SLOPE).reshape(-1, heads, de)
            return h, f_out

        with graph.local_scope():
            graph.srcdata["f_ni"] = f_ni
            graph.dstdata["f_nj"] = f_nj
            f_out = apply_edges(graph, fn.u_add_v("f_ni", "f_nj", "f_tmp"))
            f_out = f_out + self.fc_fij(efeats)
            if self.bias is not None:
                f_out = f_out + self.bias
            f_out = nn.functional.leaky_relu(f_out, EGAT_SLOPE)
            f_out = f_out.reshape(-1, heads, de)
            a = edge_softmax(graph, (f_out * self.attn).sum(-1, keepdim=True))
            graph.srcdata["h_out"] = self.fc_node_src(feat_src).reshape(
                -1, heads, dn)
            graph.edata["a"] = a
            h = update_all(graph, fn.u_mul_e("h_out", "a", "m"),
                           fn.sum("m", "h_out"))["h_out"]
        if get_attention:
            return h, f_out, a
        return h, f_out

    def extra_repr(self):
        return (f"in_node={self.in_node_feats}, in_edge={self.in_edge_feats}, "
                f"out_node={self.out_node_feats}, "
                f"out_edge={self.out_edge_feats}, heads={self.num_heads}")


# DotGatConv takes K7 from this head width up, the JAX package's gate
# (gatconv.py:281-282), set by the TPU's matrix unit
DOT_BITS_MIN_D = 64


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
            bits = unit._bits
            if (bits is not None and bits.rem_src.shape[0] == 0
                    and heads * dim <= bitdot.MAX_HD
                    and dim >= DOT_BITS_MIN_D):
                return bitdot.bitdot_attention_aggregate(
                    bits, ft_dst, ft_src).to(ft_src.dtype)
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
