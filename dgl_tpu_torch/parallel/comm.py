"""Collectives of the sharded formats over ``torch.distributed``.

The counterpart of the ``jax.lax`` collectives that ``dgl_tpu/parallel/``
calls inside ``shard_map``: ``all_gather(..., tiled=True)`` becomes
:func:`all_gather_rows` and ``psum_scatter(..., tiled=True)``
:func:`reduce_scatter_rows`, both along dim 0, and ``psum``
:func:`all_reduce_sum`.  A rank is one process:
NCCL carries CUDA tensors, gloo CPU tensors, and a tensor whose device
does not match the group's backend raises (a card's tensors never go
through gloo).  The group is found by a ``file://`` rendezvous, so no
network address is needed.  At world size 1 the collectives are still
real calls on a real group.

:func:`run_ranks` starts one process per rank with
``torch.multiprocessing.spawn``; each opens the group and calls a
function of the caller's.
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist

from ..utils import resolve_device

# the names of torch 2.13; older releases call them *_into_tensor and
# *_tensor, with the same arguments
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def init_group(world_size: int, rank: int, device, init_file: str):
    """Open the default process group of ``world_size`` ranks as
    ``rank``: NCCL for a CUDA ``device`` (rank r on card r), gloo for the
    CPU; ``init_file`` is the rendezvous file, the same path for every
    rank.  Returns the group."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("torch.distributed has no NCCL backend: the "
                               "sharded formats cannot run on the card")
        if rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} has no card: "
                               f"{torch.cuda.device_count()} visible")
        torch.cuda.set_device(rank)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no backend for device {dev}")
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world_size, rank=rank)
    return dist.group.WORLD


def _check(x: torch.Tensor, group):
    if not dist.is_initialized():
        raise RuntimeError("no process group is initialised: call "
                           "init_group first")
    backend = dist.get_backend(group)
    want = "cuda" if backend == "nccl" else "cpu"
    if x.device.type != want:
        raise ValueError(f"a {x.device.type} tensor cannot go through the "
                         f"{backend} group")


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """(P * rows, ...) from each rank's (rows, ...) ``x``, rank order along
    dim 0."""
    _check(x, group)
    world = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
    _ALL_GATHER(out, x, group=group)
    return out


def reduce_scatter_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's (rows / P, ...) block of the sum over ranks of each
    rank's (rows, ...) ``x``."""
    _check(x, group)
    world = dist.get_world_size(group)
    if x.shape[0] % world:
        raise ValueError(f"{x.shape[0]} rows do not split over {world} "
                         f"ranks")
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // world,) + tuple(x.shape[1:]))
    _REDUCE_SCATTER(out, x, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks of each rank's ``x`` (the counterpart of
    ``psum``: the gradient of weights that every rank holds)."""
    _check(x, group)
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _rank_entry(rank, fn, world_size, device, init_file, args):
    group = init_group(world_size, rank, device, init_file)
    try:
        fn(rank, world_size, group, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, device, *args):
    """Run ``fn(rank, world_size, group, *args)`` in ``world_size`` new
    processes, one per rank, each in a group opened by
    :func:`init_group`; returns when every rank has ended and raises if
    one failed.  ``fn`` and ``args`` must pickle (a function of a
    module, not a closure); results come back through files."""
    dev = resolve_device(device)
    if dev.type == "cuda" and world_size > torch.cuda.device_count():
        raise RuntimeError(f"{world_size} ranks need {world_size} cards, "
                           f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        torch.multiprocessing.spawn(
            _rank_entry, args=(fn, world_size, dev.type, init_file, args),
            nprocs=world_size, join=True)
