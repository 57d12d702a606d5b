"""Graph convolution layers (counterpart of ``dgl_tpu/nn/conv``)."""
from .graphconv import GraphConv
