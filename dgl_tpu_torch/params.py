"""Carry weights from the JAX package's flax modules into the port's
``nn.Module``s.

Flax ``GraphConv`` (``dgl_tpu/nn/conv/graphconv.py``) stores ``weight`` as
(in, out) and ``bias`` as (out,), the layout of DGL's PyTorch GraphConv,
so the arrays cross unchanged.  The input is any mapping of arrays that
numpy can read; nothing of JAX is imported here.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def graphconv_state_dict(flax_params: Mapping):
    """``state_dict`` for :class:`dgl_tpu_torch.nn.GraphConv` from one flax
    GraphConv's params (``{"weight": ..., "bias": ...}``, or the same
    nested under ``"params"``).  The tensors are f32 on the host, as a
    loaded checkpoint's are; ``load_state_dict`` copies them to the
    module's device."""
    if "params" in flax_params:
        flax_params = flax_params["params"]
    return {name: torch.tensor(np.asarray(flax_params[name]),
                               dtype=torch.float32)
            for name in ("weight", "bias") if name in flax_params}
