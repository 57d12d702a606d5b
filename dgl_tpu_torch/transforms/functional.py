"""Functional graph transforms (counterpart of
``dgl_tpu/transforms/functional.py``, reference
``python/dgl/transforms/functional.py``).  This slice carries the two that
the GCN path uses."""
from __future__ import annotations

import torch

from ..graph.graph import Graph
from ..graph.unitgraph import UnitGraph


def _with_unit(g: Graph, etid: int, unit: UnitGraph, edge_frame) -> Graph:
    units = list(g._units)
    units[etid] = unit
    edge_frames = [dict(f) for f in g._edge_frames]
    edge_frames[etid] = edge_frame
    return Graph(g.ntypes, g.canonical_etypes, g._num_nodes, units,
                 node_frames=g._node_frames, edge_frames=edge_frames)


def add_self_loop(g: Graph, edge_feat_names=None, fill_data=1.0,
                  etype=None) -> Graph:
    """Append an edge (i, i) for every node (reference ``add_self_loop``);
    the new edges' features are ``fill_data`` for the fields named in
    ``edge_feat_names`` (all when None) and zero for the others."""
    etid = g.get_etype_id(etype)
    cet = g.canonical_etypes[etid]
    if cet[0] != cet[2]:
        raise ValueError("add_self_loop requires srctype == dsttype")
    unit = g._units[etid]
    n = unit.num_src
    row, col = unit.coo()
    loop = torch.arange(n, dtype=row.dtype, device=row.device)
    new_unit = UnitGraph.from_coo(n, n, torch.cat([row, loop]),
                                  torch.cat([col, loop]),
                                  formats=unit.formats, device=row.device)
    frame = {}
    for k, v in g._edge_frames[etid].items():
        fill = (fill_data if edge_feat_names is None or k in edge_feat_names
                else 0)
        frame[k] = torch.cat([v, v.new_full((n,) + v.shape[1:], fill)])
    return _with_unit(g, etid, new_unit, frame)


def remove_self_loop(g: Graph, etype=None) -> Graph:
    """Remove the edges (i, i) (reference ``remove_self_loop``)."""
    etid = g.get_etype_id(etype)
    unit = g._units[etid]
    row, col = unit.coo()
    keep = torch.nonzero(row != col).squeeze(1)
    new_unit = UnitGraph.from_coo(unit.num_src, unit.num_dst, row[keep],
                                  col[keep], formats=unit.formats,
                                  device=row.device)
    frame = {k: v[keep] for k, v in g._edge_frames[etid].items()}
    return _with_unit(g, etid, new_unit, frame)
