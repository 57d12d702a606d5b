"""Carry weights from the JAX package's flax modules into the port's
``nn.Module``s.

Flax ``GraphConv`` (``dgl_tpu/nn/conv/graphconv.py``) stores ``weight`` as
(in, out) and ``bias`` as (out,), the layout of DGL's PyTorch GraphConv,
so the arrays cross unchanged.  Flax ``GATConv``'s and ``DotGatConv``'s
Dense kernels are (in, out), the transpose of ``nn.Linear.weight``.  The
input is any mapping of arrays that numpy can read; nothing of JAX is
imported here.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _f32(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _unwrap(flax_params: Mapping) -> Mapping:
    return flax_params["params"] if "params" in flax_params else flax_params


def graphconv_state_dict(flax_params: Mapping):
    """``state_dict`` for :class:`dgl_tpu_torch.nn.GraphConv` from one flax
    GraphConv's params (``{"weight": ..., "bias": ...}``, or the same
    nested under ``"params"``).  The tensors are f32 on the host, as a
    loaded checkpoint's are; ``load_state_dict`` copies them to the
    module's device."""
    flax_params = _unwrap(flax_params)
    return {name: _f32(flax_params[name])
            for name in ("weight", "bias") if name in flax_params}


def gatconv_state_dict(flax_params: Mapping):
    """``state_dict`` for :class:`dgl_tpu_torch.nn.GATConv` from one flax
    GATConv's params: ``fc.kernel`` (in, H*D) becomes ``fc.weight``
    (H*D, in), ``res_fc`` likewise; ``attn_l``, ``attn_r`` and ``bias``
    (1, H, D) cross as they are."""
    flax_params = _unwrap(flax_params)
    sd = {name: _f32(flax_params[name])
          for name in ("attn_l", "attn_r", "bias") if name in flax_params}
    for name in ("fc", "res_fc"):
        if name in flax_params:
            sd[f"{name}.weight"] = _f32(flax_params[name]["kernel"]).T \
                .contiguous()
    return sd


def dotgatconv_state_dict(flax_params: Mapping):
    """``state_dict`` for :class:`dgl_tpu_torch.nn.DotGatConv` from one
    flax DotGatConv's params: ``fc_src.kernel`` and ``fc_dst.kernel``
    (in, H*D) become ``fc_src.weight`` and ``fc_dst.weight`` (H*D, in)."""
    flax_params = _unwrap(flax_params)
    return {f"{name}.weight": _f32(flax_params[name]["kernel"]).T
            .contiguous() for name in ("fc_src", "fc_dst")}
