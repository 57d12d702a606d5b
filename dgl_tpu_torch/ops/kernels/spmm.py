"""Kernel SpMM-sum entries used by the dispatcher, with their gradients.

Counterpart of ``dgl_tpu/ops/pallas/spmm.py``.  ``spmm_sum`` takes, in
the JAX package's order, the bitmask (K1/K2) for ``copy_lhs`` when the
graph has a bit format, else the hybrid format (K12 with K3) for
``copy_lhs`` when it has one, else the tiled format (K3) for ``copy_lhs``,
``mul`` and ``div`` by a scalar per edge; ``spmm_sum_static`` serves
weights cached in slot order (``UnitGraph.cache_edge_weights``).  Each
returns None to decline, and the gather path then runs: so ``mul`` and
``div`` on a graph with no tiled format take it.

Gradients follow the SpMM/SDDMM duality (reference
``backend/pytorch/sparse.py:195-249``): dX of a sum-SpMM is the same SpMM
on the reverse format with the same weights, and dW of the ``mul`` op is
the SDDMM-dot <x[src_e], dZ[dst_e]>.
"""
from __future__ import annotations

import torch

from . import tiled_spmm as ts
from ...utils import config

SDDMM_CHUNK = 1 << 20        # edges per chunk of the SDDMM-dot


def get_tiled_formats(unit):
    """(forward, reverse) tiled formats of a unit graph, or (None, None)
    when ``create_tiled_format`` was not called: the port never builds
    the format on its own (the JAX package's ``pallas_auto_build_tiled``
    has no counterpart).  Both carry ``src_order`` and ``src_ptr``
    (``UnitGraph.tiled_format``), so no step sorts buckets."""
    if unit._tiled is not None and unit._tiled_rev is not None:
        return unit._tiled, unit._tiled_rev
    return None, None


class _SpmmTiledCopy(torch.autograd.Function):
    """copy_lhs sum over the tiled format (``_spmm_tiled_vjp`` with no
    weights): dX by K3 on the reverse format."""

    @staticmethod
    def forward(ctx, x, tf_fwd, tf_rev):
        ctx.tf_rev = tf_rev
        ctx.x_dtype = x.dtype
        return ts.tiled_spmm(tf_fwd, x)

    @staticmethod
    def backward(ctx, dz):
        return ts.tiled_spmm(ctx.tf_rev, dz).to(ctx.x_dtype), None, None


def _sddmm_dot(x, dz, row, col):
    """dEw[e] = <x[src_e], dZ[dst_e]> in SDDMM_CHUNK-edge chunks, so no
    (E, F) gather is held at once (6 GB at Reddit scale)."""
    out = torch.empty(row.shape[0], dtype=torch.float32, device=x.device)
    for e0 in range(0, row.shape[0], SDDMM_CHUNK):
        r, c = row[e0:e0 + SDDMM_CHUNK], col[e0:e0 + SDDMM_CHUNK]
        out[e0:e0 + SDDMM_CHUNK] = (torch.index_select(x, 0, r).float()
                                    * torch.index_select(dz, 0, c).float()
                                    ).sum(-1)
    return out


class _SpmmTiledMul(torch.autograd.Function):
    """Sum of x[src] times a scalar per edge (``_spmm_tiled_mul``): dX by
    K3 on the reverse format with the same weights, dEw by the SDDMM-dot
    over the canonical edges (``row``, ``col``)."""

    @staticmethod
    def forward(ctx, x, ew, tf_fwd, tf_rev, row, col):
        ctx.save_for_backward(x, ew)
        ctx.tf_rev, ctx.row, ctx.col = tf_rev, row, col
        return ts.tiled_spmm(tf_fwd, x, ew)

    @staticmethod
    def backward(ctx, dz):
        x, ew = ctx.saved_tensors
        dx = dew = None
        if ctx.needs_input_grad[0]:
            dx = ts.tiled_spmm(ctx.tf_rev, dz, ew).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dew = _sddmm_dot(x, dz, ctx.row, ctx.col).reshape(ew.shape) \
                .to(ew.dtype)
        return dx, dew, None, None, None, None


class _SpmmTiledStatic(torch.autograd.Function):
    """Sum of x[src] times static weights given in slot order, forward
    ``wsf`` and reverse ``wsr`` (``_spmm_tiled_static``); no gradient to
    the weights."""

    @staticmethod
    def forward(ctx, x, tf_fwd, tf_rev, wsf, wsr):
        ctx.tf_rev, ctx.wsr, ctx.x_dtype = tf_rev, wsr, x.dtype
        return ts.tiled_spmm(tf_fwd, x, slot_weights=wsf)

    @staticmethod
    def backward(ctx, dz):
        dx = ts.tiled_spmm(ctx.tf_rev, dz, slot_weights=ctx.wsr)
        return dx.to(ctx.x_dtype), None, None, None, None


def spmm_tiled_copy(tf_fwd, tf_rev, x):
    """out = A x over the tiled formats, differentiable in x."""
    return _SpmmTiledCopy.apply(x, tf_fwd, tf_rev)


def spmm_tiled_mul(tf_fwd, tf_rev, row, col, x, ew):
    """out[d] = sum_e ew[e] x[src_e], differentiable in x and ew (E,);
    ``row``/``col`` are the canonical edges' src and dst."""
    return _SpmmTiledMul.apply(x, ew, tf_fwd, tf_rev, row, col)


def spmm_tiled_static(tf_fwd, tf_rev, wsf, wsr, x):
    """out = A_w x with slot-order weights, differentiable in x only."""
    return _SpmmTiledStatic.apply(x, tf_fwd, tf_rev, wsf, wsr)


def spmm_sum_static(unit, op, u_data, field, current_w=None):
    """Static-weight SpMM from the slot weights cached under ``field``;
    None if ineligible.

    ``current_w`` is the live ``edata[field]`` at dispatch: the cached
    weights serve only while it is the very tensor that was cached, at the
    version counter it had then.  A field replaced since (or a weight that
    needs a gradient, which is a new tensor) or edited in place takes the
    general path instead of stale weights."""
    if u_data is None or u_data.ndim != 2:
        return None
    if unit.num_edges < config.get("kernel_spmm_min_edges"):
        return None
    cached = unit._slot_weights.get(field)
    if cached is None:
        return None
    wsf, wsr, ref, version = cached
    if current_w is not None and (current_w is not ref
                                  or current_w._version != version):
        return None
    tf_fwd, tf_rev = get_tiled_formats(unit)
    if tf_fwd is None:
        return None
    if op == "div":
        wsf = torch.where(tf_fwd.valid > 0, 1.0 / wsf, 0.0)
        wsr = torch.where(tf_rev.valid > 0, 1.0 / wsr, 0.0)
    elif op != "mul":
        return None
    return spmm_tiled_static(tf_fwd, tf_rev, wsf, wsr, u_data)


def spmm_sum(unit, op, u_data, e_data):
    """Returns None to decline (the gather path then runs)."""
    if unit.num_edges < config.get("kernel_spmm_min_edges"):
        return None
    if op == "copy_lhs" and unit._bits is not None:
        from .bitmm import bit_spmm
        return bit_spmm(unit._bits, u_data)
    if op == "copy_lhs" and unit._hybrid is not None:
        from .hybrid import hybrid_spmm
        return hybrid_spmm(unit._hybrid, u_data)
    tf_fwd, tf_rev = get_tiled_formats(unit)
    if tf_fwd is None:
        return None
    if op == "copy_lhs":
        return spmm_tiled_copy(tf_fwd, tf_rev, u_data)
    if op in ("mul", "div"):
        row, col = unit.coo()
        ew = e_data.reshape(-1)
        if op == "div":
            ew = 1.0 / ew
        return spmm_tiled_mul(tf_fwd, tf_rev, row, col, u_data, ew)
    return None
