"""Graph construction (counterpart of ``dgl_tpu/graph/convert.py``,
reference ``python/dgl/convert.py``)."""
from __future__ import annotations

from typing import Optional

from .graph import DEFAULT_ETYPE, DEFAULT_NTYPE, Graph
from .unitgraph import ALL_FORMATS, UnitGraph, as_idtensor
from ..utils import resolve_device


def graph(data, num_nodes: Optional[int] = None, formats=ALL_FORMATS,
          device="cuda") -> Graph:
    """Create a homogeneous graph from ``(u, v)`` edge endpoints (reference
    ``dgl.graph``).  The structure lives on ``device``: the card unless the
    caller asks for the CPU."""
    dev = resolve_device(device)
    u, v = (as_idtensor(a, dev) for a in data)
    if num_nodes is None:
        num_nodes = max((int(a.max()) + 1 for a in (u, v)
                         if a.shape[0] > 0), default=0)
    unit = UnitGraph.from_coo(num_nodes, num_nodes, u, v, formats=formats,
                              device=dev)
    return Graph([DEFAULT_NTYPE],
                 [(DEFAULT_NTYPE, DEFAULT_ETYPE, DEFAULT_NTYPE)],
                 [num_nodes], [unit])
