"""Graph transforms (counterpart of ``dgl_tpu/transforms``)."""
from .functional import add_self_loop, remove_self_loop
