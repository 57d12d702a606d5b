"""Carry weights from the JAX package's flax modules into the port's
``nn.Module``s.

Flax ``GraphConv`` (``dgl_tpu/nn/conv/graphconv.py``) stores ``weight`` as
(in, out) and ``bias`` as (out,), the layout of DGL's PyTorch GraphConv,
so the arrays cross unchanged.  Flax ``GATConv``'s, ``DotGatConv``'s,
``GATv2Conv``'s, ``EGATConv``'s and ``EdgeGATConv``'s Dense kernels are
(in, out), the transpose of ``nn.Linear.weight``.  The
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


def _dense(params: Mapping, name: str):
    """``{name}.weight`` (out, in) and, where flax has one, ``{name}.bias``
    from one flax Dense's params."""
    sd = {f"{name}.weight": _f32(params["kernel"]).T.contiguous()}
    if "bias" in params:
        sd[f"{name}.bias"] = _f32(params["bias"])
    return sd


def gatv2conv_state_dict(flax_params: Mapping):
    """``state_dict`` for :class:`dgl_tpu_torch.nn.GATv2Conv` from one
    flax GATv2Conv's params: ``fc_src``/``fc_dst`` (kernel (in, H*D), bias
    (H*D,)) become ``nn.Linear`` weights and biases, ``res_fc`` likewise
    without bias; ``attn`` (1, H, D) crosses as it is.  Under
    ``share_weights`` flax has no ``fc_dst``, and the port's ``fc_dst`` is
    its ``fc_src``: both names get ``fc_src``'s arrays."""
    flax_params = _unwrap(flax_params)
    sd = {"attn": _f32(flax_params["attn"])}
    sd.update(_dense(flax_params["fc_src"], "fc_src"))
    sd.update(_dense(flax_params.get("fc_dst", flax_params["fc_src"]),
                     "fc_dst"))
    if "res_fc" in flax_params:
        sd.update(_dense(flax_params["res_fc"], "res_fc"))
    return sd


def egatconv_state_dict(flax_params: Mapping):
    """``state_dict`` for :class:`dgl_tpu_torch.nn.EGATConv` from one flax
    EGATConv's params: the kernels of ``fc_node_src``, ``fc_ni``,
    ``fc_fij`` and ``fc_nj`` become ``nn.Linear`` weights; ``attn`` (1, H,
    De) and ``bias`` (H*De,) cross as they are."""
    flax_params = _unwrap(flax_params)
    sd = {name: _f32(flax_params[name])
          for name in ("attn", "bias") if name in flax_params}
    for name in ("fc_node_src", "fc_ni", "fc_fij", "fc_nj"):
        sd.update(_dense(flax_params[name], name))
    return sd


def edgegatconv_state_dict(flax_params: Mapping):
    """``state_dict`` for :class:`dgl_tpu_torch.nn.EdgeGATConv` from one
    flax EdgeGATConv's params: the kernels of ``fc``, ``fc_dst``,
    ``fc_edge`` and ``res_fc`` become ``nn.Linear`` weights; ``attn_l``,
    ``attn_r``, ``attn_edge`` and ``bias`` (1, H, D) cross as they are.
    Flax makes ``fc_dst`` only when the module is called on a (src, dst)
    feature pair; without it the port's ``fc_dst``, which a single feature
    tensor never reaches, gets ``fc``'s arrays."""
    flax_params = _unwrap(flax_params)
    sd = {name: _f32(flax_params[name])
          for name in ("attn_l", "attn_r", "attn_edge", "bias")
          if name in flax_params}
    sd.update(_dense(flax_params["fc"], "fc"))
    sd.update(_dense(flax_params.get("fc_dst", flax_params["fc"]), "fc_dst"))
    sd.update(_dense(flax_params["fc_edge"], "fc_edge"))
    if "res_fc" in flax_params:
        sd.update(_dense(flax_params["res_fc"], "res_fc"))
    return sd
