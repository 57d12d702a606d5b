"""ndata/edata dict-like views (counterpart of ``dgl_tpu/graph/view.py``,
reference ``python/dgl/view.py``)."""
from __future__ import annotations

from collections.abc import MutableMapping


class _FrameView(MutableMapping):
    """A live view of one feature frame (a dict of tensors) of a graph."""

    __slots__ = ("_graph", "_index")

    def __init__(self, graph, index: int):
        self._graph = graph
        self._index = index

    def _frames(self):
        raise NotImplementedError

    @property
    def _frame(self):
        return self._frames()[self._index]

    def __getitem__(self, key):
        return self._frame[key]

    def __setitem__(self, key, value):
        self._frame[key] = value

    def __delitem__(self, key):
        del self._frame[key]

    def __iter__(self):
        return iter(self._frame)

    def __len__(self):
        return len(self._frame)

    def __repr__(self):
        return repr({k: tuple(v.shape) for k, v in self._frame.items()})


class HeteroNodeDataView(_FrameView):
    """``g.ndata`` / ``g.srcdata`` / ``g.dstdata`` for one node type."""

    __slots__ = ()

    def _frames(self):
        return self._graph._node_frames


class HeteroEdgeDataView(_FrameView):
    """``g.edata`` for one canonical edge type."""

    __slots__ = ()

    def _frames(self):
        return self._graph._edge_frames
