"""Graph structure (counterpart of ``dgl_tpu/graph``)."""
from .unitgraph import CSR, UnitGraph, coo_to_csr
from .graph import Graph
from .convert import graph
