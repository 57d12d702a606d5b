"""Operator namespace: fused message-passing ops (counterpart of
``dgl_tpu/ops``)."""
from .gspmm import gspmm, gspmm_unit

__all__ = ["gspmm", "gspmm_unit"]
