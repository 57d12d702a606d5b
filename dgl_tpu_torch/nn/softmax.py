"""edge_softmax re-export at the reference's module path
(``python/dgl/nn/pytorch/softmax.py``; counterpart of
``dgl_tpu/nn/softmax.py``)."""
from ..ops import edge_softmax

__all__ = ["edge_softmax"]
