"""Operator namespace: fused message-passing ops (counterpart of
``dgl_tpu/ops``)."""
from .gspmm import gspmm, gspmm_unit
from .gsddmm import gsddmm, gsddmm_unit
from .edge_softmax import edge_softmax, edge_softmax_unit

__all__ = ["gspmm", "gspmm_unit", "gsddmm", "gsddmm_unit", "edge_softmax",
           "edge_softmax_unit"]
