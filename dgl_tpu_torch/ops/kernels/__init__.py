"""Hand-written CUDA kernels for Hopper and their dispatch (counterpart of
``dgl_tpu/ops/pallas``).  Sources live in ``dgl_tpu_torch/csrc``; they are
built at first use (``build.py``), never at import."""
