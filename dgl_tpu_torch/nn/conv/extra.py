"""EdgeGATConv, graph attention with edge features in the logits and the
messages.

Counterpart of ``dgl_tpu/nn/conv/extra.py:110-297`` (reference
``python/dgl/nn/pytorch/conv/edgegatconv.py``).  Per edge u -> v and head
h, with ft = fc(h), fe = fc_edge(ef):

    e   = lrelu(<ft[u], attn_l[h]> + <ft[v], attn_r[h]> + <fe, attn_edge[h]>)
    a   = softmax of e over the in-edges of v
    out = sum a (ft[u] + fe)  (+ res_fc(h[v])) (+ bias)

``fc``, ``fc_dst``, ``fc_edge`` and ``res_fc`` are ``nn.Linear`` without
bias; ``attn_l``, ``attn_r``, ``attn_edge`` and ``bias`` are (1, H, D), as
in the JAX package.  Routes, under ``extra.py:222-286``'s gates:

* the fused route on the slot-space kernels K10 v2
  (``ops/kernels/gat_fused.py`` ``edgegat_attention_aggregate_v2``) at
  ``kernel_spmm_min_edges`` edges and more on a graph with a tiled format,
  given ``efeats_slot`` (:meth:`EdgeGATConv.slot_edge_feats`), without
  ``get_attention`` and with neither attention nor feature dropout active.
  The logits are clipped to +-40 instead of subtracting a per-dst max, and
  the edge message fe is never formed.  The edge features are read only
  through ``efeats_slot``, checked against ``edge_feat``.  The JAX package
  also needs a TPU there; the port takes this route on CUDA and CPU tensors
  alike.  The scores kernel holds an (Fe, H) matrix in shared memory: above
  ``edgegat_fits`` the flat route takes the layer;
* the flat route at ``kernel_spmm_min_edges`` edges and more without
  ``get_attention`` or active attention dropout (``_edge_gat_flat``):
  chunked logits, ``edge_softmax_flat``, ``spmm_mul_flat`` for the node
  messages and ``edge_term_sum_flat`` for the edge messages;
* otherwise the edge chain: (E, H, D) messages through ``apply_edges``,
  ``edge_softmax``, dropout and ``update_all(copy_e, sum)``.

Every route works inside ``graph.local_scope()``, where the JAX edge chain
writes its fields into the caller's graph.  Feature dropout draws one mask
for a tensor that is both the src and the dst features, as DGL does; the
JAX module draws two and then projects the dst side with ``fc_dst``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from ... import function as fn
from ...core import apply_edges, update_all
from ...ops import edge_softmax
from ...ops.edgeflat import edge_softmax_flat, edge_term_sum_flat, \
    spmm_mul_flat
from ...ops.kernels import gat_fused
from ...utils import config, expand_as_pair, gather_rows, resolve_device
from .gatconv import _check_slot_edge_feats, _dropout, _kernel_tiles

EDGEGAT_CHUNK = 1 << 18   # edges per chunk of the flat route (extra.py:111)


def _edgegat_logits_chunked(el2, er2, edge_feat, We, attn_e, row, col,
                            heads: int, dim: int, slope: float, chunk: int):
    """lrelu(el2[u] + er2[v] + <ef We, attn_e>) flat (E * H,), in fixed
    edge chunks, each recomputed in the backward: no (E, H, D) tensor is
    kept (``extra.py:131-143``)."""

    def body(r, c, ef):
        fe = (ef @ We).reshape(-1, heads, dim)
        e = gather_rows(el2, r) + gather_rows(er2, c) + (fe * attn_e).sum(-1)
        return nn.functional.leaky_relu(e, slope)

    out = [torch.utils.checkpoint.checkpoint(
        body, row[e0:e0 + chunk], col[e0:e0 + chunk],
        edge_feat[e0:e0 + chunk], use_reentrant=False)
        for e0 in range(0, row.shape[0], chunk)]
    if not out:
        return el2.new_zeros(0)
    return torch.cat(out).reshape(-1)


def _edge_gat_flat(unit, ft_src, edge_feat, We, el2, er2, attn_e, heads: int,
                   dim: int, slope: float):
    """EdgeGAT at scale (``extra.py:110-167``): out[v] = sum_e a_e (ft[u] +
    ef_e We) with the node term by ``spmm_mul_flat`` and the edge term by
    ``edge_term_sum_flat``."""
    row, col = unit.coo()
    logits = _edgegat_logits_chunked(el2, er2, edge_feat, We, attn_e, row,
                                     col, heads, dim, slope, EDGEGAT_CHUNK)
    a_flat = edge_softmax_flat(unit, logits, heads)
    return (spmm_mul_flat(unit, ft_src, a_flat, heads)
            + edge_term_sum_flat(unit, edge_feat, We, a_flat, heads, dim,
                                 EDGEGAT_CHUNK))


class EdgeGATConv(nn.Module):
    """GAT with edge features in both attention and message
    (``dgl_tpu/nn/conv/extra.py:170-297``); see the module docstring for
    the routes.  ``forward(graph, feat, edge_feat, get_attention=False,
    efeats_slot=None)`` returns (N_dst, H, D), and the attention (E, H, 1)
    beside it with ``get_attention`` (the edge chain)."""

    def __init__(self, in_feats: int, edge_feats: int, out_feats: int,
                 num_heads: int, feat_drop: float = 0.0,
                 attn_drop: float = 0.0, negative_slope: float = 0.2,
                 residual: bool = True, activation: Optional[Callable] = None,
                 allow_zero_in_degree: bool = False, bias: bool = True,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_feats = in_feats
        self.edge_feats = edge_feats
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

        def head_param():
            return nn.Parameter(torch.empty(1, num_heads, out_feats,
                                            device=dev))

        self.fc = nn.Linear(in_feats, hd, bias=False, device=dev)
        # the dst side's projection of a (src, dst) feature pair
        self.fc_dst = nn.Linear(in_feats, hd, bias=False, device=dev)
        self.fc_edge = nn.Linear(edge_feats, hd, bias=False, device=dev)
        self.attn_l, self.attn_r, self.attn_edge = (head_param(),
                                                    head_param(),
                                                    head_param())
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
        for w in (self.fc.weight, self.fc_dst.weight, self.fc_edge.weight,
                  self.attn_l, self.attn_r, self.attn_edge) + (
                (self.res_fc.weight,) if self.res_fc is not None else ()):
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

    def forward(self, graph, feat, edge_feat, get_attention=False,
                efeats_slot=None):
        heads, dim = self.num_heads, self.out_feats
        feat_src, feat_dst = expand_as_pair(feat, graph)
        train_feat = self.feat_drop > 0 and self.training
        if train_feat:
            shared = feat_dst is feat_src
            feat_src = _dropout(feat_src, self.feat_drop, self.generator)
            feat_dst = (feat_src if shared else
                        _dropout(feat_dst, self.feat_drop, self.generator))
        ft_src = self.fc(feat_src).reshape(-1, heads, dim)
        if graph.is_block:
            ft_dst = ft_src[: graph.num_dst_nodes()]
        elif feat_dst is feat_src:
            ft_dst = ft_src
        else:
            ft_dst = self.fc_dst(feat_dst).reshape(-1, heads, dim)
        el2 = (ft_src * self.attn_l).sum(-1)                   # (N, H)
        er2 = (ft_dst * self.attn_r).sum(-1)
        We = self.fc_edge.weight.t()                            # (Fe, H*D)
        train_attn = self.attn_drop > 0 and self.training
        unit = graph.unit()
        a = None
        tf = (_kernel_tiles(unit, get_attention, train_attn or train_feat)
              if efeats_slot is not None
              and gat_fused.edgegat_fits(heads, self.edge_feats) else None)
        if tf is not None:
            _check_slot_edge_feats(tf, unit, edge_feat, efeats_slot,
                                   self.edge_feats)
            rst = gat_fused.edgegat_attention_aggregate_v2(
                tf, el2, er2, efeats_slot, We, self.attn_edge[0], ft_src,
                heads, dim, self.negative_slope).to(ft_src.dtype)
        elif (unit.num_edges >= config.get("kernel_spmm_min_edges")
              and not get_attention and not train_attn):
            rst = _edge_gat_flat(unit, ft_src, edge_feat, We, el2, er2,
                                 self.attn_edge[0], heads, dim,
                                 self.negative_slope)
        else:
            ft_edge = self.fc_edge(edge_feat).reshape(-1, heads, dim)
            ee = (ft_edge * self.attn_edge).sum(-1, keepdim=True)
            with graph.local_scope():
                graph.srcdata.update({"ft": ft_src,
                                      "el": el2.unsqueeze(-1)})
                graph.dstdata["er"] = er2.unsqueeze(-1)
                e = apply_edges(graph, fn.u_add_v("el", "er", "e")) + ee
                e = nn.functional.leaky_relu(e, self.negative_slope)
                a = edge_softmax(graph, e)
                if train_attn:
                    a = _dropout(a, self.attn_drop, self.generator)
                graph.edata["ft_edge"] = ft_edge
                ft_comb = apply_edges(graph,
                                      fn.u_add_e("ft", "ft_edge", "m"))
                graph.edata["m"] = ft_comb * a
                rst = update_all(graph, fn.copy_e("m", "m"),
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
        return (f"in={self.in_feats}, edge={self.edge_feats}, "
                f"out={self.out_feats}, heads={self.num_heads}")
