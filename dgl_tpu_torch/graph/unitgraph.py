"""Unit graph: one (bipartite) relation as lazily built sparse formats.

Counterpart of ``dgl_tpu/graph/unitgraph.py`` (reference
``src/graph/unit_graph.h:41``): COO is canonical (edge id ``i`` is position
``i`` of ``(row, col)``), and CSR/CSC are built from it on first request,
each with an ``eids`` permutation back to canonical order.  Every array is
an int64 ``torch.Tensor`` on the graph's device, so no format build leaves
the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

ALL_FORMATS = ("coo", "csr", "csc")


def as_idtensor(x, device) -> torch.Tensor:
    """int64 id tensor on ``device`` from a numpy array, list or tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x), dtype=torch.int64, device=device)


@dataclasses.dataclass
class CSR:
    """Compressed sparse rows: ``indptr`` (n+1,), ``indices`` (nnz,), ``eids``
    (nnz,) mapping position -> canonical (COO-order) edge id."""

    indptr: torch.Tensor
    indices: torch.Tensor
    eids: torch.Tensor


def coo_to_csr(row, col, num_rows: int) -> CSR:
    """COO -> CSR by stable sort on the row index."""
    eids = torch.argsort(row, stable=True)
    counts = torch.bincount(row, minlength=num_rows)
    indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return CSR(indptr=indptr, indices=col[eids], eids=eids)


def _auto_cap(num_edges: int, tiles2: int, default: int,
              bucket_budget: int = 120_000) -> int:
    """Slot capacity of the tiled format, exactly as the JAX package picks
    it (``dgl_tpu/graph/unitgraph.py:125-139``), since the cap changes the
    format's arrays: double ``default`` up to 2048 while the estimated
    bucket count exceeds ``bucket_budget`` (a TPU scalar-prefetch limit of
    the JAX kernels, kept here for parity)."""
    c = default
    while c < 2048 and num_edges // c + min(tiles2, num_edges) > \
            bucket_budget:
        c *= 2
    return c


class UnitGraph:
    """One (srctype, etype, dsttype) relation.

    ``formats`` restricts which representations may be materialized
    (reference ``UnitGraph::formats_``, ``src/graph/unit_graph.cc:771``)."""

    def __init__(self, num_src: int, num_dst: int, num_edges: int,
                 coo: Optional[Tuple] = None, csr: Optional[CSR] = None,
                 csc: Optional[CSR] = None,
                 formats: Tuple[str, ...] = ALL_FORMATS):
        self.num_src = int(num_src)
        self.num_dst = int(num_dst)
        self.num_edges = int(num_edges)
        self._coo = coo
        self._csr = csr
        self._csc = csc
        self._in_deg = None
        self._out_deg = None
        self._bits = None        # bit-packed full-dense format (BitFormat)
        self._tiled = None       # tile-bucketed format (TiledFormat)
        self._tiled_rev = None   # and the reverse graph's
        self._hybrid = None      # hub block + tiled remainder (HybridFormat)
        # {field: (w_slot_fwd, w_slot_rev, source tensor, its _version)}:
        # static edge weights in slot order (see cache_edge_weights)
        self._slot_weights = {}
        self.formats = tuple(formats)

    @classmethod
    def from_coo(cls, num_src, num_dst, row, col, formats=ALL_FORMATS,
                 device="cuda"):
        row = as_idtensor(row, device)
        col = as_idtensor(col, device)
        if row.shape != col.shape or row.ndim != 1:
            raise ValueError("row and col must be 1-D and of equal length")
        return cls(num_src, num_dst, row.shape[0], coo=(row, col),
                   formats=formats)

    @property
    def device(self) -> torch.device:
        for sp in (self._coo, self._csr, self._csc):
            if sp is not None:
                return (sp[0] if isinstance(sp, tuple) else sp.indices).device
        raise ValueError("graph has no materialized format")

    # -- format access (lazy, cached) --------------------------------------
    def coo(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(row, col) in canonical edge order."""
        if self._coo is None:
            if "coo" not in self.formats:
                raise ValueError("COO format is restricted on this graph")
            if self._csr is not None:
                sp, swap = self._csr, False
            elif self._csc is not None:
                sp, swap = self._csc, True
            else:
                raise ValueError("graph has no materialized format")
            counts = sp.indptr[1:] - sp.indptr[:-1]
            major = torch.repeat_interleave(
                torch.arange(counts.shape[0], device=counts.device), counts)
            inv = torch.empty_like(sp.eids)
            inv[sp.eids] = torch.arange(self.num_edges, device=inv.device)
            row, col = (sp.indices, major) if swap else (major, sp.indices)
            self._coo = (row[inv], col[inv])
        return self._coo

    def csr(self) -> CSR:
        """Out-CSR: rows = src nodes, indices = dst nodes."""
        if self._csr is None:
            if "csr" not in self.formats:
                raise ValueError("CSR format is restricted on this graph")
            row, col = self.coo()
            self._csr = coo_to_csr(row, col, self.num_src)
        return self._csr

    def csc(self) -> CSR:
        """In-CSR (CSC): rows = dst nodes, indices = src nodes."""
        if self._csc is None:
            if "csc" not in self.formats:
                raise ValueError("CSC format is restricted on this graph")
            row, col = self.coo()
            self._csc = coo_to_csr(col, row, self.num_dst)
        return self._csc

    def create_bitmask_format(self, symmetric: bool = False,
                              on_device: bool = False,
                              assume_simple: bool = False) -> None:
        """Build the bit-packed full-dense SpMM format (see
        ``ops/kernels/bitmm.py``): the whole boolean adjacency at 1
        bit/entry, N_src*N_dst/8 bytes on the graph's device.
        ``symmetric=True`` (A == A^T) shares one packed matrix between the
        forward and the backward.

        ``on_device=True`` packs with a scatter-add on the graph's device
        instead of on the host; ``assume_simple=True`` additionally skips
        the host duplicate-edge scan (for graphs simple by construction).
        """
        from ..ops.kernels import bitmm
        row, col = self.coo()
        if on_device:
            self._bits = bitmm.build_bit_format_device(
                row, col, self.num_src, self.num_dst, symmetric=symmetric,
                assume_simple=assume_simple, device=row.device)
        else:
            self._bits = bitmm.build_bit_format(
                row.cpu().numpy(), col.cpu().numpy(), self.num_src,
                self.num_dst, symmetric=symmetric, device=row.device)

    def tiled_format(self, tile: int = None, cap: int = None):
        """Build (once) and return the tile-bucketed format and its
        reverse (``ops/kernels/tiled_spmm.py``), sorted and scattered on
        the graph's device, each with its src-major bucket order
        (``with_src_first``, as the JAX unit's); ``cap=None`` picks
        :func:`_auto_cap`."""
        from ..ops.kernels import tiled_spmm as ts
        if self._tiled is None:
            row, col = self.coo()
            t = tile or ts.DEFAULT_TILE
            if cap is None:
                tiles2 = (-(-self.num_src // t)) * (-(-self.num_dst // t))
                cap = _auto_cap(self.num_edges, tiles2, ts.DEFAULT_CAP)
            build = ts.build_tiled_format_device
            self._tiled = build(row, col, self.num_src, self.num_dst, t,
                                cap, device=row.device).with_src_first()
            self._tiled_rev = build(col, row, self.num_dst, self.num_src, t,
                                    cap, device=row.device).with_src_first()
        return self._tiled, self._tiled_rev

    def cache_edge_weights(self, field: str, edge_weights) -> None:
        """Put static per-edge scalar weights in the tiled format's slot
        order, forward and reverse, once.

        ``update_all(fn.u_mul_e('h', field), fn.sum(...))`` then reads the
        cached slots instead of gathering the weights into slot order at
        every call (``core.invoke_gspmm``), while ``edata[field]`` is still
        ``edge_weights`` and not edited in place since (its ``_version``).
        No gradient flows to cached weights."""
        from ..ops.kernels.tiled_spmm import slot_edge_weights
        tf_fwd, tf_rev = self.tiled_format()
        ew = torch.as_tensor(edge_weights).reshape(-1).detach()
        self._slot_weights[field] = (slot_edge_weights(tf_fwd, ew),
                                     slot_edge_weights(tf_rev, ew),
                                     edge_weights,
                                     getattr(edge_weights, "_version", None))

    def uncache_edge_weights(self, field: str) -> None:
        self._slot_weights.pop(field, None)

    def create_hybrid_format(self, k_dense: int = 8192,
                             min_degree: int = 256, weights=None,
                             tile: int = None, cap: int = None,
                             cache_path: str = None, multires: tuple = None,
                             fill_min: float = 0.7,
                             symmetric: bool = False) -> None:
        """Build the degree-stratified hybrid SpMM format on the graph's
        device (``ops/kernels/hybrid.py``): the hub dst rows as a dense
        (k, N_pad) int8 block for K12, the rest tiled for K3.  The defaults
        are the JAX package's (``DEFAULT_TILE``/``DEFAULT_CAP``, not the
        auto cap).  ``cache_path``: an npz disk cache in the JAX package's
        layout (the caller ties its name to the graph and the
        parameters)."""
        from ..ops.kernels import hybrid
        from ..ops.kernels import tiled_spmm as ts
        row, col = self.coo()
        if isinstance(weights, torch.Tensor):
            weights = weights.detach().cpu().numpy()
        self._hybrid = hybrid.build_hybrid_format(
            row.cpu().numpy(), col.cpu().numpy(), self.num_src, self.num_dst,
            k_dense=k_dense, min_degree=min_degree, weights=weights,
            tile=tile or ts.DEFAULT_TILE, cap=cap or ts.DEFAULT_CAP,
            cache_path=cache_path, multires=multires, fill_min=fill_min,
            symmetric=symmetric, device=row.device)

    def _auto_format_choice(self, hbm_budget_bytes: int = 12 << 30,
                            symmetric: bool = None) -> dict:
        """What :meth:`auto_format` decides, and the numbers it decides on:
        ``family``, ``bits_bytes`` (the bitmask's bytes, doubled when it is
        not symmetric), ``symmetric``, ``density``, ``edges`` and
        ``top_edges`` (the edges into the 8,192 highest in-degree rows;
        None when the bitmask is taken).  Computed on the graph's
        device."""
        row, col = self.coo()
        e = row.shape[0]
        bits_bytes = (-(-max(self.num_dst, 1) // 1024) * 1024 *
                      (-(-max(self.num_src, 1) // 8192) * 8192) // 8)
        if symmetric is None:
            symmetric = False
            if self.num_src == self.num_dst and e <= 50_000_000:
                fwd = torch.sort(col * self.num_src + row).values
                rev = torch.sort(row * self.num_src + col).values
                symmetric = bool(torch.equal(fwd, rev))
        if not symmetric:
            bits_bytes *= 2
        density = e / max(self.num_src * self.num_dst, 1)
        out = dict(bits_bytes=bits_bytes, symmetric=symmetric,
                   density=density, edges=e, top_edges=None)
        if (bits_bytes <= hbm_budget_bytes and e >= 1_000_000
                and density >= 1e-4):
            return dict(out, family="bitmask")
        # a heavy tail: the 8,192 highest in-degree rows carry >= 30%
        top = 0
        if self.num_dst > 8192:
            deg = torch.bincount(col, minlength=self.num_dst)
            top = int(torch.topk(deg, 8192).values.sum())
        hybrid = e >= 1_000_000 and top >= 0.3 * e
        return dict(out, top_edges=top,
                    family="hybrid" if hybrid else "tiled")

    def auto_format(self, hbm_budget_bytes: int = 12 << 30,
                    symmetric: bool = None, cache_path: str = None) -> str:
        """Pick and build a kernel SpMM format by the JAX package's rules
        (``dgl_tpu/graph/unitgraph.py:408-459``), unchanged, and return
        the family's name:

        * ``"bitmask"`` when the 1-bit adjacency (doubled unless symmetric)
          fits ``hbm_budget_bytes``, with at least 1M edges at a density
          of at least 1e-4;
        * ``"hybrid"`` (:meth:`create_hybrid_format`'s defaults) when the
          8,192 highest in-degree rows carry at least 30% of at least 1M
          edges;
        * ``"tiled"`` (:meth:`tiled_format`, the auto cap) otherwise.

        ``symmetric=None`` checks A == A^T exactly on square graphs of up
        to 50M edges and takes False above.  ``cache_path`` serves the
        hybrid format only: the port's bitmask has no disk cache."""
        choice = self._auto_format_choice(hbm_budget_bytes, symmetric)
        if choice["family"] == "bitmask":
            self.create_bitmask_format(symmetric=choice["symmetric"])
        elif choice["family"] == "hybrid":
            self.create_hybrid_format(symmetric=choice["symmetric"],
                                      cache_path=cache_path)
        else:
            self.tiled_format()
        return choice["family"]

    def materialized_formats(self) -> Tuple[str, ...]:
        return tuple(name for name, sp in (("coo", self._coo),
                                           ("csr", self._csr),
                                           ("csc", self._csc))
                     if sp is not None)

    # -- queries -----------------------------------------------------------
    def in_degrees(self, v=None):
        """In-degree per dst node, from a bincount over the COO (the same
        numbers as the CSC indptr, without the CSC sort)."""
        if self._in_deg is None:
            if self._csc is not None:
                self._in_deg = self._csc.indptr[1:] - self._csc.indptr[:-1]
            else:
                self._in_deg = torch.bincount(self.coo()[1],
                                              minlength=self.num_dst)
        return self._in_deg if v is None else self._in_deg[v]

    def out_degrees(self, u=None):
        if self._out_deg is None:
            if self._csr is not None:
                self._out_deg = self._csr.indptr[1:] - self._csr.indptr[:-1]
            else:
                self._out_deg = torch.bincount(self.coo()[0],
                                               minlength=self.num_src)
        return self._out_deg if u is None else self._out_deg[u]

    def reverse(self) -> "UnitGraph":
        """Swap src/dst.  CSR<->CSC swap; COO swaps row/col.  O(1)."""
        coo = None if self._coo is None else (self._coo[1], self._coo[0])
        return UnitGraph(self.num_dst, self.num_src, self.num_edges,
                         coo=coo, csr=self._csc, csc=self._csr,
                         formats=self.formats)

    def __repr__(self):
        return (f"UnitGraph(num_src={self.num_src}, num_dst={self.num_dst}, "
                f"num_edges={self.num_edges}, formats={self.formats})")
