"""Neural network modules, ``torch.nn.Module``s (counterpart of
``dgl_tpu/nn``)."""
from .conv import (DotGatConv, EdgeGATConv, EdgeWeightNorm, EGATConv,
                   GATConv, GATv2Conv, GraphConv)
from . import softmax
