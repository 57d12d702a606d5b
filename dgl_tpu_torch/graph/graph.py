"""The user-facing ``Graph`` object.

Counterpart of ``dgl_tpu/graph/graph.py`` (reference ``DGLGraph``,
``python/dgl/heterograph.py:40``): node types, canonical edge types, one
:class:`UnitGraph` per relation and per-type feature frames (plain dicts
of tensors).  This slice of the port carries homogeneous graphs: one node
type and one edge type.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .unitgraph import UnitGraph
from .view import HeteroEdgeDataView, HeteroNodeDataView

DEFAULT_NTYPE = "_N"
DEFAULT_ETYPE = "_E"

CanonicalEtype = Tuple[str, str, str]


class Graph:
    """Node types, canonical edge types, one :class:`UnitGraph` per
    relation, per-type feature frames."""

    def __init__(self, ntypes: Sequence[str],
                 canonical_etypes: Sequence[CanonicalEtype],
                 num_nodes_per_type: Sequence[int],
                 units: Sequence[UnitGraph],
                 node_frames: Optional[List[Dict[str, torch.Tensor]]] = None,
                 edge_frames: Optional[List[Dict[str, torch.Tensor]]] = None):
        self.ntypes = list(ntypes)
        self._canonical_etypes = [tuple(c) for c in canonical_etypes]
        self._num_nodes = [int(n) for n in num_nodes_per_type]
        self._units = list(units)
        self._node_frames = ([dict() for _ in self.ntypes]
                             if node_frames is None
                             else [dict(f) for f in node_frames])
        self._edge_frames = ([dict() for _ in self._canonical_etypes]
                             if edge_frames is None
                             else [dict(f) for f in edge_frames])
        self._ntype_id = {nt: i for i, nt in enumerate(self.ntypes)}
        self._etype_id = {ct: i for i, ct in enumerate(self._canonical_etypes)}

    # -- schema ------------------------------------------------------------
    @property
    def canonical_etypes(self) -> List[CanonicalEtype]:
        return list(self._canonical_etypes)

    @property
    def etypes(self) -> List[str]:
        return [c[1] for c in self._canonical_etypes]

    @property
    def is_block(self) -> bool:
        return False

    @property
    def is_homogeneous(self) -> bool:
        return len(self.ntypes) == 1 and len(self._canonical_etypes) == 1

    def get_ntype_id(self, ntype: Optional[str]) -> int:
        if ntype is None:
            if len(self.ntypes) != 1:
                raise ValueError(
                    "Node type name must be specified on a graph with "
                    f"multiple node types {self.ntypes}")
            return 0
        if ntype not in self._ntype_id:
            raise KeyError(f"unknown node type {ntype!r}; have {self.ntypes}")
        return self._ntype_id[ntype]

    def to_canonical_etype(self, etype) -> CanonicalEtype:
        if etype is None:
            if len(self._canonical_etypes) != 1:
                raise ValueError(
                    "Edge type name must be specified on a graph with "
                    f"multiple edge types {self.etypes}")
            return self._canonical_etypes[0]
        if isinstance(etype, tuple):
            if tuple(etype) not in self._etype_id:
                raise KeyError(f"unknown edge type {etype!r}")
            return tuple(etype)
        matches = [c for c in self._canonical_etypes if c[1] == etype]
        if len(matches) != 1:
            raise KeyError(f"edge type {etype!r} matches {matches}")
        return matches[0]

    def get_etype_id(self, etype=None) -> int:
        return self._etype_id[self.to_canonical_etype(etype)]

    def unit(self, etype=None) -> UnitGraph:
        """The UnitGraph of a relation."""
        return self._units[self.get_etype_id(etype)]

    # -- sizes -------------------------------------------------------------
    def num_nodes(self, ntype: Optional[str] = None) -> int:
        if ntype is None and len(self.ntypes) > 1:
            return sum(self._num_nodes)
        return self._num_nodes[self.get_ntype_id(ntype)]

    def num_edges(self, etype=None) -> int:
        if etype is None and len(self._canonical_etypes) > 1:
            return sum(u.num_edges for u in self._units)
        return self.unit(etype).num_edges

    def num_src_nodes(self, ntype=None) -> int:
        return self.num_nodes(ntype)

    def num_dst_nodes(self, ntype=None) -> int:
        return self.num_nodes(ntype)

    def in_degrees(self, v=None, etype=None):
        return self.unit(etype).in_degrees(v)

    def out_degrees(self, u=None, etype=None):
        return self.unit(etype).out_degrees(u)

    @property
    def device(self) -> torch.device:
        return self._units[0].device

    # -- features ----------------------------------------------------------
    @property
    def ndata(self):
        return HeteroNodeDataView(self, self.get_ntype_id(None))

    @property
    def edata(self):
        return HeteroEdgeDataView(self, self.get_etype_id(None))

    @property
    def srcdata(self):
        return HeteroNodeDataView(
            self, self.get_ntype_id(self.to_canonical_etype(None)[0]))

    @property
    def dstdata(self):
        return HeteroNodeDataView(
            self, self.get_ntype_id(self.to_canonical_etype(None)[2]))

    @contextlib.contextmanager
    def local_scope(self):
        """Frame mutations inside the block are discarded on exit
        (reference ``DGLGraph.local_scope``)."""
        saved_n = [dict(f) for f in self._node_frames]
        saved_e = [dict(f) for f in self._edge_frames]
        try:
            yield self
        finally:
            self._node_frames = saved_n
            self._edge_frames = saved_e

    # -- kernel formats ------------------------------------------------------
    def create_tiled_format(self, tile=None, cap=None):
        """Build the tile-bucketed SpMM format (and its reverse) of every
        relation (``UnitGraph.tiled_format``)."""
        for u in self._units:
            u.tiled_format(tile, cap)
        return self

    def create_hybrid_format(self, k_dense: int = 8192,
                             min_degree: int = 256, etype=None):
        """Build the hybrid SpMM format of one relation: hub dst rows
        dense (K12), the rest tiled (``UnitGraph.create_hybrid_format``)."""
        self._units[self.get_etype_id(etype)].create_hybrid_format(
            k_dense=k_dense, min_degree=min_degree)
        return self

    def auto_format(self, hbm_budget_bytes: int = 12 << 30,
                    symmetric: bool = None, cache_path: str = None):
        """Pick and build a kernel SpMM format for every relation
        (``UnitGraph.auto_format``); returns {canonical etype: family}.
        With several relations each gets its own cache file,
        ``<root>.rel<i><ext>``: a builder returns an existing cache as it
        is, so a shared path would hand one relation another's."""
        out = {}
        for i, (et, u) in enumerate(zip(self.canonical_etypes,
                                        self._units)):
            cp = cache_path
            if cp is not None and len(self._units) > 1:
                root, ext = os.path.splitext(cp)
                cp = f"{root}.rel{i}{ext}"
            out[et] = u.auto_format(hbm_budget_bytes=hbm_budget_bytes,
                                    symmetric=symmetric, cache_path=cp)
        return out

    def cache_edge_weights(self, field: str, etype=None):
        """Put the static per-edge weights ``edata[field]`` in the tiled
        format's slot order, so a weighted SpMM skips its gather into slot
        order (``UnitGraph.cache_edge_weights``).  Call again after
        replacing the field; no gradient flows to cached weights."""
        etid = self.get_etype_id(etype)
        self._units[etid].cache_edge_weights(
            field, self._edge_frames[etid][field])
        return self

    # -- message passing and transforms -------------------------------------
    def update_all(self, message_func, reduce_func, etype=None):
        from .. import core
        return core.update_all_inplace(self, message_func, reduce_func,
                                       etype=etype)

    def apply_edges(self, func, edges=None, etype=None):
        from .. import core
        return core.apply_edges_inplace(self, func, edges=edges, etype=etype)

    def add_self_loop(self, etype=None):
        from ..transforms.functional import add_self_loop
        return add_self_loop(self, etype=etype)

    def remove_self_loop(self, etype=None):
        from ..transforms.functional import remove_self_loop
        return remove_self_loop(self, etype=etype)

    def __repr__(self):
        return (f"Graph(num_nodes={self.num_nodes()}, "
                f"num_edges={self.num_edges()})")
