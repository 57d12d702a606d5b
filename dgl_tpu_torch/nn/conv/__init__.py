"""Graph convolution layers (counterpart of ``dgl_tpu/nn/conv``)."""
from .extra import EdgeGATConv
from .gatconv import DotGatConv, EGATConv, GATConv, GATv2Conv
from .graphconv import EdgeWeightNorm, GraphConv
