"""Neural network modules, ``torch.nn.Module``s (counterpart of
``dgl_tpu/nn``)."""
from .conv import (DotGatConv, EdgeWeightNorm, EGATConv, GATConv,
                   GATv2Conv, GraphConv)
