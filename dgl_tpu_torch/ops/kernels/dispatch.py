"""Dispatch to the hand-written CUDA kernels.

Counterpart of ``dgl_tpu/ops/pallas/dispatch.py``.  The gather +
``index_add_`` path in ``ops/gspmm.py`` is the always-correct path; this
module routes the hot (op, reduce) pairs to a kernel when the graph
carries a format that one serves.  Where the TPU package checked for the
TPU backend, the port checks where the operands lie: CUDA tensors launch
the kernel, and a build or launch failure raises; CPU tensors take the
kernel's plain PyTorch version, so the CPU tests walk the same route.
"""
from __future__ import annotations

import torch

from ...utils import config


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every operand is a CUDA tensor, False if every one is on
    the CPU; operands on both raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel operands lie on several devices: {kinds}")


def try_spmm(unit, op, u_data, e_data):
    """Result of a kernel SpMM-sum, or None to take the gather path."""
    if not config.use_kernels():
        return None
    # 2-D node features, copied or times one scalar per edge
    if u_data is None or u_data.ndim != 2:
        return None
    if op == "copy_lhs":
        pass
    elif op in ("mul", "div") and e_data is not None and (
            e_data.ndim == 1 or (e_data.ndim == 2 and e_data.shape[1] == 1)):
        pass
    else:
        return None
    from . import spmm
    return spmm.spmm_sum(unit, op, u_data, e_data)


def try_spmm_static(unit, op, u_data, field, current_w=None):
    """Static-weight SpMM from the slot weights cached under ``field``
    (``UnitGraph.cache_edge_weights``), or None to take the general path;
    ``current_w`` is the live edata value, checked against the cached
    one."""
    if not config.use_kernels():
        return None
    from . import spmm
    return spmm.spmm_sum_static(unit, op, u_data, field,
                                current_w=current_w)
