"""Mesh-sharded dense bit-masked attention (GAT over several devices).

Counterpart of ``dgl_tpu/parallel/bitgat_spmd.py``: the sharded bitmask
SpMM's layout (``bitspmd.py``) carries GAT attention.  Destination
sharding keeps every in-edge of a local dst on its owner, so the softmax
is entirely local; only the src-side operands and gradients cross ranks.

  forward:  all-gather el (P npp, H) and z (P npp, H, D), then K5's
            forward over the A^T packing (``bitgat_fwd_t``: the listed
            walk by dst) on the rank's shard, read through its dst-major
            view (:func:`shard_fwd_view`): out and l of the npp local dst;
  backward: all-gather el and z again, then K13 (:func:`bit_shard_gat_bwd`,
            the listed walk, its rows claimed hubs first) on the same
            shard: dz and del as full-length partials, zero-padded from
            kp to P npp rows and reduce-scattered to their owners; der
            is local.

One shard set serves both passes, symmetric or not: the column shard of
the A^T packing holds every in-edge of the local dst range.  The forward
walks it by dst, through the shard's bit transpose (rows = the npp local
dst, kp / 32 words, bit b of word j = src b kp / 32 + j), which is local
to the rank: no collective builds it.  Where the format is symmetric and
npp == kp (one part, as the Reddit graph's), that view is the shard
itself; otherwise it is built once, on the shard's device, and costs one
more shard a device.  K13 is K5's
backward kernel launched on the shard, src-major as the JAX kernel is:
rows = the kp gathered src rows, bit columns = the npp local dst.  The
JAX package streams dz lane-major, (H, D, total), for the TPU's layout;
here it stays (rows, H, D) and the scatter runs along dim 0.

Numerics, the JAX package's: el and er are clipped to +-20 before the
kernels, and the clip's VJP zeroes the gradient where an input is not
strictly inside (-20, 20); no dropout.  Simple graphs only (a multi-edge
remainder cannot ride a softmax), H * D <= 128.
"""
from __future__ import annotations

import torch

from ..ops.kernels import bitgat
from ..ops.kernels.bitgat import DEN_EPS, MAX_HD
from ..ops.kernels.dispatch import on_cuda
from . import comm
from .bitspmd import BitShardedFormat, local_view

CLIP = 20.0   # the per-operand clip of bitgat


def bit_shard_gat_bwd_plain(shard, elg, er_l, zg, g_l, linv_l, rho_l,
                            npp: int, slope: float):
    """K13's function (JAX ``_bwd_src_kernel``, ``bitgat_spmd.py:63-132``)
    on one shard (kp src rows, bit columns = the npp local dst): (del
    (kp, H), der (npp, H), dz (kp, H, D)), f32.  For every edge s -> d and
    head h:

        alpha = exp(lrelu(el[s] + er[d])) * linv[d];  u = g[d] . z[s]
        de = alpha * (u - rho[d]);  draw = raw > 0 ? de : slope de
        dz[s] += alpha * g[d];  del[s] += draw;  der[d] += draw
    """
    kp, heads, _ = zg.shape
    elg, er_l, zg, g_l = elg.float(), er_l.float(), zg.float(), g_l.float()
    d_el = elg.new_zeros(kp, heads)
    d_er = elg.new_zeros(npp, heads)
    dz = torch.zeros_like(zg)
    for src, dst in bitgat.bit_edges(shard, kp):
        raw = elg[src] + er_l[dst]
        sc = torch.maximum(raw, slope * raw)
        alpha = torch.exp(sc) * linv_l[dst]
        gd = g_l[dst]
        u = (gd * zg[src]).sum(-1)
        de = alpha * (u - rho_l[dst])
        draw = torch.where(raw > 0, de, slope * de)
        dz.index_add_(0, src, alpha.unsqueeze(-1) * gd)
        d_el.index_add_(0, src, draw)
        d_er.index_add_(0, dst, draw)
    return d_el, d_er, dz


def bit_shard_gat_bwd(shard, elg, er_l, zg, g_l, linv_l, rho_l, npp: int,
                      slope: float, order=None):
    """K13: (del (kp, H), der (npp, H), dz (kp, H, D)) f32 on one shard,
    by K5's backward kernel (the listed walk) without dropout; its plain
    version for CPU tensors.  ``order``: the claim order of the shard's kp
    rows (:func:`shard_claim_order`; built anew for each call when
    None)."""
    bitgat.check_bwd(shard, elg, er_l, zg, g_l, linv_l, rho_l, npp)
    if not on_cuda(shard, elg, er_l, zg, g_l, linv_l, rho_l):
        return bit_shard_gat_bwd_plain(shard, elg, er_l, zg, g_l, linv_l,
                                       rho_l, npp, slope)
    out = bitgat.launch_bwd(shard, elg, er_l, zg, g_l, linv_l, rho_l, npp,
                            slope, order=order)
    if zg.shape[0] and zg.shape[1] * zg.shape[2]:
        bit_shard_gat_bwd.launches += 1
    return out


bit_shard_gat_bwd.launches = 0


def shard_claim_order(fmt: BitShardedFormat, shard) -> torch.Tensor:
    """K13's claim order of ``shard``'s kp rows (``bitgat.claim_order``:
    hub rows first), built at first use and kept on ``fmt``, by the
    shard's device, address and shape (``shard`` is one of ``fmt``'s, which
    keeps it alive)."""
    if fmt._claim_orders is None:
        fmt._claim_orders = {}
    key = (str(shard.device), shard.data_ptr(), tuple(shard.shape))
    if key not in fmt._claim_orders:
        fmt._claim_orders[key] = bitgat.claim_order(shard, fmt.kp)
    return fmt._claim_orders[key]


def shard_fwd_view(fmt: BitShardedFormat, shard):
    """(view, order): ``shard``'s dst-major view for the forward (rows =
    the npp local dst, bit columns = the kp src; ``bitgat.transpose_bits``)
    and the view's claim order (hub rows first), built at first use and
    kept on ``fmt``, keyed as :func:`shard_claim_order`.  Where ``fmt`` is
    symmetric and npp == kp the view is ``shard`` itself, and its order
    K13's."""
    if fmt._fwd_views is None:
        fmt._fwd_views = {}
    key = (str(shard.device), shard.data_ptr(), tuple(shard.shape))
    if key not in fmt._fwd_views:
        if fmt.symmetric and fmt.npp == fmt.kp:
            view, order = shard, shard_claim_order(fmt, shard)
        else:
            view = bitgat.transpose_bits(shard, fmt.kp, fmt.npp)
            order = bitgat.claim_order(view, fmt.npp)
        fmt._fwd_views[key] = (view, order)
    return fmt._fwd_views[key]


def _gathered(fmt, el_l, z_l, group):
    """el (kp, H) and z (kp, H, D) of every src row, gathered."""
    return (comm.all_gather_rows(el_l, group)[:fmt.kp],
            comm.all_gather_rows(z_l, group)[:fmt.kp])


def _scatter_src(fmt, part, group):
    """Full-length (kp, ...) per-rank partials -> this rank's npp rows of
    their sum over ranks."""
    full = part.new_zeros((fmt.num_parts * fmt.npp,) + tuple(part.shape[1:]))
    full[:fmt.kp] = part
    return comm.reduce_scatter_rows(full, group)


class _BitShardedGAT(torch.autograd.Function):

    @staticmethod
    def forward(ctx, el_l, er_l, z_l, fmt, group, slope):
        elc = el_l.clamp(-CLIP, CLIP)
        erc = er_l.clamp(-CLIP, CLIP)
        shard = local_view(fmt, fmt.shards, group)
        elg, zg = _gathered(fmt, elc, z_l, group)
        # the plain version on the CPU reads the shard itself
        rows, order = (shard_fwd_view(fmt, shard) if shard.is_cuda
                       else (None, None))
        out, l = bitgat.bitgat_fwd_t(shard, elg, erc, zg, fmt.npp, slope,
                                     rows, order)
        ctx.save_for_backward(el_l, er_l, elc, erc, z_l, l, out)
        ctx.fmt, ctx.group, ctx.slope = fmt, group, slope
        return out

    @staticmethod
    def backward(ctx, g):
        el_l, er_l, elc, erc, z_l, l, out = ctx.saved_tensors
        fmt, group = ctx.fmt, ctx.group
        g = g.float().contiguous()
        rho = (g * out).sum(-1)
        linv = 1.0 / l.clamp(min=DEN_EPS)
        shard = local_view(fmt, fmt.shards, group)
        elg, zg = _gathered(fmt, elc, z_l, group)
        order = shard_claim_order(fmt, shard) if g.is_cuda else None
        d_el, d_er, dz = bit_shard_gat_bwd(shard, elg, erc, zg, g, linv, rho,
                                           fmt.npp, ctx.slope, order)
        dz = _scatter_src(fmt, dz, group)
        d_el = _scatter_src(fmt, d_el, group)
        # the clip's VJP: zero where the input is not strictly inside
        d_el = torch.where((el_l > -CLIP) & (el_l < CLIP), d_el, 0.0)
        d_er = torch.where((er_l > -CLIP) & (er_l < CLIP), d_er, 0.0)
        return (d_el.to(el_l.dtype), d_er.to(er_l.dtype), dz.to(z_l.dtype),
                None, None, None)


def bit_sharded_gat(fmt: BitShardedFormat, el_l, er_l, z_l, group=None,
                    negative_slope: float = 0.2) -> torch.Tensor:
    """GAT attention + aggregation over the ranks of ``group`` on the
    bitmask shards.

    ``el_l``/``er_l`` (npp, H) and ``z_l`` (npp, H, D): this rank's rows
    of the padded (P npp, ...) logits and projected features
    (``bitspmd.pad_nodes``, ``bitspmd.local_rows``); returns this rank's
    (npp, H, D) f32 softmax-weighted aggregation, differentiable in el,
    er and z.  Every rank must call it, and its backward, together.
    Requires a simple graph and H * D <= 128."""
    if fmt.has_remainder:
        raise ValueError(
            "bit_sharded_gat requires a simple graph (the sharded format "
            "has a multi-edge remainder); deduplicate the edge list")
    if z_l.ndim != 3 or z_l.shape[0] != fmt.npp or \
            el_l.shape != z_l.shape[:2] or er_l.shape != z_l.shape[:2]:
        raise ValueError(f"el {tuple(el_l.shape)}, er {tuple(er_l.shape)} "
                         f"and z {tuple(z_l.shape)} must be ({fmt.npp}, H) "
                         f"and ({fmt.npp}, H, D)")
    if z_l.shape[1] * z_l.shape[2] > MAX_HD:
        raise ValueError(f"bit_sharded_gat takes H * D <= {MAX_HD}, got "
                         f"{z_l.shape[1]} x {z_l.shape[2]}")
    return _BitShardedGAT.apply(el_l, er_l, z_l, fmt, group,
                                float(negative_slope))
