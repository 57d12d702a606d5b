"""Degree-stratified hybrid SpMM: dense rows for the hub nodes (K12), tiles
for the rest (K3).

Counterpart of ``dgl_tpu/ops/pallas/hybrid.py``.  On a heavy-tailed graph
the k highest in-degree dst rows become a dense (k, N_pad) block of edge
multiplicities, multiplied by x in one stream (``int8mm.py``), and the
remaining edges go through the tiled format (``tiled_spmm.py``), possibly
at several (tile, cap) geometries whose outputs add.  The block is int8
when every multiplicity fits (<= 127); otherwise (multiplicities over 127,
or static edge weights) it is held in bf16, widened from its f16 wire
form as the JAX package does.

With ``symmetric=True`` (A == A^T) the same block also serves the hub
columns: the remainder holds only edges whose two endpoints are both not
hubs, the forward adds A^T x[hubs] at the non-hub rows, and the backward
is the forward applied to dZ.

Which product runs where:

* an int8 block goes through K12 (``int8_matmul``) on the card, and its
  plain versions on the CPU;
* a bf16 block is multiplied with ``torch.matmul`` on every device, x
  rounded to bf16, as ``_dense_rows``/``_dense_cols_t`` of the JAX package
  call XLA's dot outside any Pallas kernel (``hybrid.py:283-307``).

The build runs on the host (numpy) except for the scatter of the counts
into the block, which runs on the format's device; a disk cache
(``cache_path``) holds the JAX package's npz layout, so a file written by
either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import os
import zipfile
from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import tiled_spmm as ts
from .int8mm import dense_cols_t, dense_rows, int8_matmul
from ...utils import resolve_device, unique_counts

Levels = Union[ts.TiledFormat, Tuple[ts.TiledFormat, ...]]


@dataclasses.dataclass
class HybridFormat:
    """``tf_fwd``/``tf_rev``: tiled format(s) of the remainder edges, one
    TiledFormat or a tuple of them under multi-resolution routing (each
    level its own (tile, cap); outputs add).  ``a_dense``: (k, N_pad) hub
    rows of the adjacency, int8 multiplicities or bf16.  ``dense_ids``:
    (k,) int64 hub dst ids, sorted.  Every tensor lies on one device."""
    tf_fwd: Levels
    tf_rev: Levels
    a_dense: torch.Tensor
    dense_ids: torch.Tensor
    num_src: int
    num_dst: int
    k: int
    # A == A^T: the block serves the hub rows and the hub columns, the
    # remainder is symmetric (tf_rev is tf_fwd) and the backward is the
    # forward
    symmetric: bool = False

    @property
    def device(self) -> torch.device:
        return self.a_dense.device


def _levels(tf) -> tuple:
    """A single format or a multi-resolution tuple, as a tuple."""
    return tf if isinstance(tf, tuple) else (tf,)


def _route_density(row, col, num_src, num_dst, tile, cap,
                   fill_min: float) -> np.ndarray:
    """Mask of the edges whose (dst tile, src tile) pair at geometry
    ``(tile, cap)`` holds at least ``fill_min * cap`` edges (the JAX
    package's rule, ``hybrid.py:89``)."""
    n_st = -(-num_src // tile)
    key = (col // tile) * n_st + (row // tile)
    cnt = np.bincount(key, minlength=n_st * (-(-num_dst // tile)))
    return cnt[key] >= fill_min * cap


def _device_block(a_wire, device) -> torch.Tensor:
    """Wire block (int8, or f16) -> the device operand: int8 stays int8,
    not padded; f16 widens to bf16 (``hybrid.py:38``)."""
    a = torch.as_tensor(a_wire).to(device)
    return a if a.dtype == torch.int8 else a.to(torch.bfloat16)


def _load_levels(z, prefix, device):
    """The tiled levels ``{prefix}{i}_*`` (or the older ``{prefix}_*``)
    of an npz."""
    def level(p):
        return ts.tiled_from_host({k[len(p):]: z[k] for k in z.files
                                   if k.startswith(p)},
                                  device).with_src_first()

    if any(k.startswith(prefix + "_") for k in z.files):
        return level(prefix + "_")
    out = []
    while any(k.startswith(f"{prefix}{len(out)}_") for k in z.files):
        out.append(level(f"{prefix}{len(out)}_"))
    return out[0] if len(out) == 1 else tuple(out)


def load_hybrid_format(path: str, device="cuda") -> Optional[HybridFormat]:
    """A HybridFormat on ``device`` from an npz written by
    :func:`build_hybrid_format` (of either package) with ``cache_path``;
    None if the file is absent or unreadable."""
    device = resolve_device(device)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            sym = bool(z["symmetric"]) if "symmetric" in z.files else False
            tf_fwd = _load_levels(z, "fwd", device)
            tf_rev = tf_fwd if sym else _load_levels(z, "rev", device)
            return HybridFormat(
                tf_fwd=tf_fwd, tf_rev=tf_rev,
                a_dense=_device_block(z["a_wire"], device),
                dense_ids=torch.as_tensor(z["top"].astype(np.int64)).to(
                    device),
                num_src=int(z["num_src"]), num_dst=int(z["num_dst"]),
                k=int(z["k"]), symmetric=sym)
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None


def _count_block(key, k: int, n_pad: int, device) -> torch.Tensor:
    """The (k, n_pad) block of multiplicities from the flat keys
    ``row_in_block * n_pad + src`` of the hub edges: int8 when every count
    is at most 127, else f16 (the wire dtypes of ``hybrid.py:186-199``).
    Counted on the host by a sort, scattered on ``device``."""
    uk, cnt = unique_counts(key)
    counts = torch.from_numpy(cnt.astype(
        np.int8 if cnt.max(initial=0) <= 127 else np.float16))
    a = torch.zeros(k * n_pad, dtype=counts.dtype, device=device)
    a[torch.from_numpy(uk).to(device)] = counts.to(device)
    return a.view(k, n_pad)


def build_hybrid_format(row, col, num_src: int, num_dst: int,
                        k_dense: int = 8192, weights=None,
                        tile: int = ts.DEFAULT_TILE,
                        cap: int = ts.DEFAULT_CAP, min_degree: int = 256,
                        cache_path: Optional[str] = None,
                        multires: Optional[tuple] = None,
                        fill_min: float = 0.7, symmetric: bool = False,
                        device="cuda") -> HybridFormat:
    """Split the edges into hub-dst rows (dense) and a tiled remainder, as
    the JAX package's builder does, with the same arrays.

    ``k_dense`` caps the hub rows; a row below ``min_degree`` never goes
    dense.  ``weights`` (E,): static per-edge weights summed into a float
    block.  ``multires``: (tile, cap) geometries for the remainder; each
    level but the last takes the edges of the tile pairs holding at least
    ``fill_min * cap`` of them at its geometry, the last takes the rest.
    ``symmetric``: A == A^T, one block serves rows and columns.
    ``cache_path``: an npz loaded instead of building when it exists, and
    written after a build (the caller keeps the path's name tied to the
    graph and the parameters)."""
    device = resolve_device(device)
    if cache_path is not None:
        hf = load_hybrid_format(cache_path, device)
        if hf is not None:
            return hf
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    deg = np.bincount(col, minlength=num_dst)
    k = min(k_dense, num_dst)
    top = np.argpartition(deg, num_dst - k)[num_dst - k:]
    top = top[deg[top] >= min_degree]
    k = len(top)
    if k == 0:
        raise ValueError("no dst row reaches min_degree; use the plain "
                         "tiled format")
    top = np.sort(top)
    dmap = np.full(num_dst, -1, np.int64)
    dmap[top] = np.arange(k)

    n_src_pad = max(128, -(-num_src // 128) * 128)
    dense_edge = dmap[col] >= 0
    if weights is None:
        wire = _count_block(dmap[col[dense_edge]] * np.int64(n_src_pad)
                            + row[dense_edge], k, n_src_pad, device)
    else:
        w = np.asarray(weights, np.float32).reshape(-1)
        a = np.zeros((k, n_src_pad), np.float32)
        np.add.at(a, (dmap[col[dense_edge]], row[dense_edge]),
                  w[dense_edge])
        wire = torch.from_numpy(a.astype(np.float16)).to(device)

    if symmetric:
        if num_src != num_dst:
            raise ValueError("symmetric hybrid needs a square adjacency")
        if weights is not None:
            raise ValueError("symmetric hybrid: weights must also be "
                             "symmetric; unsupported, pass "
                             "symmetric=False")
        # the remainder: both endpoints not hubs; hub-src edges ride the
        # block transposed
        rest = ~dense_edge & (dmap[row] < 0)
    else:
        rest = ~dense_edge
    r_row, r_col = row[rest], col[rest]

    def build_levels(rr, cc, n_src, n_dst):
        """The remainder's levels: (format or tuple, host arrays)."""
        geoms = multires if multires is not None else ((tile, cap),)
        tfs, hosts = [], []
        for li, (t, c) in enumerate(geoms):
            if li < len(geoms) - 1:
                take = _route_density(rr, cc, n_src, n_dst, t, c, fill_min)
                lr, lc = rr[take], cc[take]
                rr, cc = rr[~take], cc[~take]
            else:
                lr, lc = rr, cc
            if len(lr) == 0:
                continue
            h = {}
            tfs.append(ts.build_tiled_format(lr, lc, n_src, n_dst, t, c,
                                             device=device, host_out=h)
                       .with_src_first())
            hosts.append(h)
        return (tfs[0] if len(tfs) == 1 else tuple(tfs)), hosts

    tf_fwd, h_fwd = build_levels(r_row, r_col, num_src, num_dst)
    if symmetric:
        tf_rev, h_rev = tf_fwd, h_fwd
    else:
        tf_rev, h_rev = build_levels(r_col, r_row, num_dst, num_src)
    if cache_path is not None and h_fwd and h_rev:
        payload = dict(a_wire=wire.cpu().numpy(), top=top.astype(np.int32),
                       num_src=num_src, num_dst=num_dst, k=k,
                       symmetric=symmetric)
        for i, h in enumerate(h_fwd):
            payload.update({f"fwd{i}_" + kk: vv for kk, vv in h.items()})
        if not symmetric:
            for i, h in enumerate(h_rev):
                payload.update({f"rev{i}_" + kk: vv for kk, vv in h.items()})
        tmp = cache_path + ".tmp"
        with open(tmp, "wb") as f:   # publish whole: savez keeps the name
            np.savez(f, **payload)
        os.replace(tmp, cache_path)
    return HybridFormat(
        tf_fwd=tf_fwd, tf_rev=tf_rev,
        a_dense=wire if wire.dtype == torch.int8
        else wire.to(torch.bfloat16),
        dense_ids=torch.from_numpy(top).to(device), num_src=num_src,
        num_dst=num_dst, k=k, symmetric=symmetric)


# -- the SpMM and its gradient -------------------------------------------------

def _dense_rows(hf: HybridFormat, x: torch.Tensor) -> torch.Tensor:
    """(k, F) f32 = A @ x: the hub-dst rows."""
    if hf.a_dense.dtype == torch.int8:
        return int8_matmul(hf.a_dense, x.float().contiguous())
    return dense_rows(hf.a_dense, x.to(torch.bfloat16))


def _dense_cols_t(hf: HybridFormat, zk: torch.Tensor) -> torch.Tensor:
    """(N_pad, F) f32 = A^T @ zk for zk (k, F): the block's columns."""
    if hf.a_dense.dtype == torch.int8:
        return int8_matmul(hf.a_dense, zk.float().contiguous(),
                           contract_rows=True)
    return dense_cols_t(hf.a_dense, zk.to(torch.bfloat16))


def _tiled_sum(levels: tuple, x: torch.Tensor, rows: int) -> torch.Tensor:
    """Sum of K3 over the remainder's levels; zeros when every edge touches
    a hub."""
    if not levels:
        return torch.zeros(rows, x.shape[1], dtype=torch.float32,
                           device=x.device)
    out = ts.tiled_spmm(levels[0], x)
    for tf in levels[1:]:
        out += ts.tiled_spmm(tf, x)
    return out


def _hybrid_fwd(hf: HybridFormat, x: torch.Tensor) -> torch.Tensor:
    out = _tiled_sum(_levels(hf.tf_fwd), x, hf.num_dst)
    out.index_add_(0, hf.dense_ids, _dense_rows(hf, x))   # ids are unique
    if hf.symmetric:
        # hub-src columns through the same block transposed; the hub rows
        # already hold their whole sums
        cols = _dense_cols_t(hf, torch.index_select(x, 0, hf.dense_ids))
        cols = cols[:hf.num_dst].index_fill_(0, hf.dense_ids, 0.0)
        out += cols
    return out


class _HybridSpMM(torch.autograd.Function):
    """A @ x over the hybrid format; dX = A^T dZ: the forward itself when
    symmetric, else K3 on the reverse remainder plus A^T dZ[hubs]."""

    @staticmethod
    def forward(ctx, x, hf):
        ctx.hf = hf
        ctx.x_dtype = x.dtype
        return _hybrid_fwd(hf, x)

    @staticmethod
    def backward(ctx, dz):
        hf = ctx.hf
        if hf.symmetric:
            return _hybrid_fwd(hf, dz).to(ctx.x_dtype), None
        dx = _tiled_sum(_levels(hf.tf_rev), dz, hf.num_src)
        cols = _dense_cols_t(hf, torch.index_select(dz, 0, hf.dense_ids))
        dx += cols[:hf.num_src]
        return dx.to(ctx.x_dtype), None


def hybrid_spmm(hf: HybridFormat, x: torch.Tensor) -> torch.Tensor:
    """out (num_dst, F) f32: out[d] = sum_{e: dst(e) = d} x[src(e)], the
    copy_u/sum of the hybrid format (multiplicities, or the static weights
    given at build)."""
    return _HybridSpMM.apply(x, hf)
