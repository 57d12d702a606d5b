"""Global runtime configuration flags.

Counterpart of ``dgl_tpu/utils/config.py``.  The toggles select the
hand-written CUDA kernels (``dgl_tpu_torch.ops.kernels``) versus the
always-correct gather + ``index_add_`` path of ``ops/gspmm.py``.
"""
from __future__ import annotations

import os

_FLAGS = {
    "use_kernels": os.environ.get("DGL_TPU_TORCH_USE_KERNELS", "1") != "0",
    # graphs with fewer edges than this take the gather path (the
    # counterpart of ``pallas_spmm_min_edges``)
    "kernel_spmm_min_edges": int(
        os.environ.get("DGL_TPU_TORCH_KERNEL_SPMM_MIN_EDGES", "65536")),
}


def use_kernels() -> bool:
    return _FLAGS["use_kernels"]


def set_use_kernels(flag: bool) -> None:
    _FLAGS["use_kernels"] = bool(flag)


def get(name: str):
    return _FLAGS[name]


def set(name: str, value) -> None:
    if name not in _FLAGS:
        raise KeyError(name)
    _FLAGS[name] = value
