"""Flat (E*H,) edge data for attention at scale.

Counterpart of ``dgl_tpu/ops/edgeflat.py``.  The JAX package keeps per-edge
per-head scalars flat because a TPU pads an (E, H, 1) array's last two
axes to (8, 128) tiles.  A CUDA tensor has no such padding, so inside
these functions the flat data is viewed as (E, H), and edges are indexed
with the (E,) ``row``/``col`` ids on (N, H) node data: no E*H-long index
is made (at Reddit scale with H = 4 one would take 3.7 GB in int64).  The
gathers are ``utils.gather_rows``, one head at a time: PyTorch's gather
of (N, 4) rows took 69 ms a call at Reddit scale on an H100, and the
backward of ``x[row]`` sorts the indices.  The functions keep the JAX
package's flat (E*H,) contract, edge-major and head-minor:

* ``sddmm_flat``        edge-wise binary op on (N, H) node data;
* ``edge_softmax_flat`` per-(dst, head) softmax over the incoming edges;
* ``spmm_mul_flat``     attention-weighted aggregation: one multihead
  tiled SpMM (K4) for all heads when the graph carries a tiled format,
  else one gather-path g-SpMM per head;
* ``edge_term_sum_flat`` the attention-weighted sum of a linear edge
  message, (ef_e We) per head, over each dst's in-edges, in fixed edge
  chunks (``dgl_tpu/nn/conv/extra.py:150-166``).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from ..graph.unitgraph import UnitGraph
from ..utils import config, gather_rows
from .edge_softmax import edge_softmax_unit
from .gspmm import gspmm_unit
from .kernels import spmm as kspmm
from .kernels import tiled_spmm as ts


def sddmm_flat(unit: UnitGraph, op: str, lhs, rhs, lhs_target: str = "u",
               rhs_target: str = "v"):
    """lhs/rhs: (N, H) node data (or (E*H,) for target 'e').  Returns
    (E*H,) in edge-major, head-minor order."""
    row, col = unit.coo()

    def pick(data, target):
        if data is None:
            return None
        if target == "u":
            return gather_rows(data, row).reshape(-1)
        if target == "v":
            return gather_rows(data, col).reshape(-1)
        return data.reshape(-1)

    x = pick(lhs, lhs_target)
    y = pick(rhs, rhs_target)
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
    if op == "copy_rhs":
        return y
    raise ValueError(op)


def edge_softmax_flat(unit: UnitGraph, scores, H: int,
                      norm_by: str = "dst"):
    """scores (E*H,) -> the softmax over each node's incoming edges
    (``norm_by='dst'``) or outgoing ones, per head, (E*H,)."""
    e = unit.num_edges
    return edge_softmax_unit(unit, scores.reshape(e, H),
                             norm_by=norm_by).reshape(-1)


def _w_slot_from_flat(tf: ts.TiledFormat, w_flat, H: int):
    """(E*H,) canonical-order weights -> (B, H, C) slot-order weights,
    0 at padded slots, one head at a time."""
    b, c = tf.num_buckets, tf.cap
    w2 = w_flat.reshape(-1, H)
    eid = tf.eid.clamp(min=0)
    valid = tf.valid.reshape(b, c)
    out = torch.empty(b, H, c, dtype=torch.float32, device=w_flat.device)
    for h in range(H):
        out[:, h] = torch.index_select(w2[:, h], 0, eid).view(b, c) * valid
    return out


class _SpmmMultihead(torch.autograd.Function):
    """out[d, h] = sum_e w[e, h] x[src_e, h] over the tiled formats:
    forward by K4's SpMM, dX by K4's SpMM on the reverse format with the
    same weights, dW by K4's SDDMM-dot gathered back to edge order."""

    @staticmethod
    def forward(ctx, x, w_flat, tf_fwd, tf_rev, H, Fh):
        ctx.save_for_backward(x, w_flat)
        ctx.tf_fwd, ctx.tf_rev, ctx.H, ctx.Fh = tf_fwd, tf_rev, H, Fh
        w_slot = _w_slot_from_flat(tf_fwd, w_flat, H)
        return ts.tiled_spmm_multihead(tf_fwd, x, w_slot, H, Fh)

    @staticmethod
    def backward(ctx, dz):
        x, w_flat = ctx.saved_tensors
        tf_fwd, tf_rev, H, Fh = ctx.tf_fwd, ctx.tf_rev, ctx.H, ctx.Fh
        dx = dw = None
        if ctx.needs_input_grad[0]:
            w_slot = _w_slot_from_flat(tf_rev, w_flat, H)
            dx = ts.tiled_spmm_multihead(tf_rev, dz, w_slot, H, Fh)
            del w_slot
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            e_slot = ts.tiled_sddmm_dot_multihead(tf_fwd, x, dz, H, Fh)
            slot = tf_fwd.edge_slot()
            dw = torch.empty(slot.shape[0], H, dtype=torch.float32,
                             device=dz.device)
            for h in range(H):
                dw[:, h] = torch.index_select(e_slot[:, h].reshape(-1), 0,
                                              slot)
            dw = dw.reshape(-1).to(w_flat.dtype)
        return dx, dw, None, None, None, None


def spmm_mul_flat(unit: UnitGraph, x, w_flat, H: int):
    """Attention aggregation: out[d, h] = sum_e w[e, h] * x[src_e, h].

    ``x`` (N, H, F); ``w_flat`` (E*H,).  One K4 SpMM for all heads when
    the graph carries a tiled format (``create_tiled_format``), else one
    gather-path g-SpMM per head.  Returns (num_dst, H, F)."""
    e = unit.num_edges
    if config.use_kernels() and e >= config.get("kernel_spmm_min_edges"):
        tf_fwd, tf_rev = kspmm.get_tiled_formats(unit)
        if tf_fwd is not None:
            return _SpmmMultihead.apply(x, w_flat, tf_fwd, tf_rev, int(H),
                                        int(x.shape[-1]))
    w2 = w_flat.reshape(e, H)
    return torch.stack([gspmm_unit(unit, "mul", "sum", x[:, h, :],
                                   w2[:, h].unsqueeze(1))
                        for h in range(H)], dim=1)


def edge_term_sum_flat(unit: UnitGraph, edge_feat, We, a_flat, H: int,
                       D: int, chunk: int):
    """out[d, h] = sum_e a[e, h] * (edge_feat[e] @ We)[h] over the in-edges
    of d, (num_dst, H, D).  ``edge_feat`` (E, Fe) in canonical order, ``We``
    (Fe, H * D), ``a_flat`` (E*H,).  The (E, H, D) messages exist ``chunk``
    edges at a time, each recomputed in the backward
    (``torch.utils.checkpoint``, as the JAX package's ``jax.checkpoint``),
    so the saved tensors stay chunk-sized."""
    col = unit.coo()[1]
    e, num_dst = col.shape[0], unit.num_dst
    a2 = a_flat.reshape(e, H)

    def term(c, ef, a):
        fe = (ef @ We).reshape(-1, H, D)
        return fe.new_zeros(num_dst, H, D).index_add_(0, c,
                                                      fe * a.unsqueeze(-1))

    out = We.new_zeros(num_dst, H, D)
    for e0 in range(0, e, chunk):
        out = out + torch.utils.checkpoint.checkpoint(
            term, col[e0:e0 + chunk], edge_feat[e0:e0 + chunk],
            a2[e0:e0 + chunk], use_reentrant=False)
    return out
