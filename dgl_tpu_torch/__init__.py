"""dgl_tpu_torch: the PyTorch/CUDA port of ``dgl_tpu``.

A second package beside the JAX one, with the same public names and
semantics.  Plain tensor code is PyTorch; every TPU kernel on a ported
path is a kernel written by hand for Hopper (``csrc/``), with a plain
PyTorch version beside it that the CPU runs.  Entry points take a
``device`` argument that defaults to ``"cuda"``; the CPU is used only
when the caller passes it.

Slices so far: full-graph GCN training on the bitmask SpMM kernels,
full-graph GAT training on the bitmask attention kernels, both on the
tiled format's SpMM and SDDMM kernels (GAT through ``ops.edgeflat``), the
slot-space and bit-masked attention layers, and the GCN on the hybrid
format's int8 hub-block kernels, with ``auto_format`` choosing a format.
"""

__version__ = "0.1.0"

from .graph import Graph, UnitGraph, graph
from . import function
from . import ops
from . import core
from .core import apply_edges, update_all
from .transforms import add_self_loop, remove_self_loop
from . import nn
from . import data
