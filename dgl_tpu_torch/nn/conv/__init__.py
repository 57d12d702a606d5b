"""Graph convolution layers (counterpart of ``dgl_tpu/nn/conv``)."""
from .gatconv import DotGatConv, GATConv
from .graphconv import EdgeWeightNorm, GraphConv
