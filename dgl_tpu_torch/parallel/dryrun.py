"""One sharded training step on ``world_size`` devices: the port's
counterpart of ``__graft_entry__.dryrun_multichip``'s dense-bitmask
strategies.

* strategy 2, the mesh-sharded bitmask SpMM (``bitspmd``): one forward
  and backward of (A x)^2 mean over the sharded format of the clustered
  graph, multi-edges and all;
* strategy 7, the mesh-sharded dense attention (``bitgat_spmd``): the
  gradient of (out)^2 mean in el, er and z over the deduplicated graph,
  2 heads of 16.

The graph (64 P nodes, 8 P edges, 90% inside a rank's block) and every
input are drawn from ``numpy.random.default_rng(0)`` in the JAX dry run's
order, the draws of its other strategies included, so both packages see
the same arrays.  Its strategies 1 and 3-6 (the halo planes, the hetero
mesh, the sampled minibatch) wait for their own slices.

One process per rank (``comm.run_ranks``): on ``"cuda"`` one rank per
visible card, NCCL; on ``"cpu"`` gloo ranks.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..utils import resolve_device, unique_counts
from . import comm
from .bitgat_spmd import bit_sharded_gat
from .bitspmd import (bit_sharded_spmm, build_bit_sharded_format,
                      local_rows, pad_nodes, shard_format)

FEAT, CLASSES = 32, 8
HEADS, DH = 2, 16


def dryrun_inputs(world_size: int) -> dict:
    """The JAX dry run's graph and inputs of strategies 2 and 7, drawn in
    its order (host numpy)."""
    n = 64 * world_size
    rng = np.random.default_rng(0)
    block = n // world_size
    src = rng.integers(0, n, n * 8)
    intra = rng.uniform(size=len(src)) < 0.9
    dst = np.where(intra,
                   (src // block) * block + rng.integers(0, block, len(src)),
                   rng.integers(0, n, len(src)))
    x = rng.normal(size=(n, FEAT)).astype(np.float32)
    rng.integers(0, CLASSES, n)                          # y
    rng.normal(size=(FEAT, 64), scale=0.1)               # strategy 1
    rng.normal(size=(64, CLASSES), scale=0.1)
    rng.normal(size=(len(src),))                         # strategy 3
    n_user, n_item = 48 * world_size, 24 * world_size    # strategy 5
    for hi, size in ((n_user, 600), (n_user, 600), (n_item, 400),
                     (n_user, 400), (n_user, 300), (n_item, 300)):
        rng.integers(0, hi, size)
    rng.normal(size=(n_user, FEAT))
    rng.normal(size=(n_item, FEAT))
    rng.integers(0, CLASSES, n_user)
    gh_gd = HEADS * DH                                   # strategy 6
    for shape in ((FEAT, gh_gd), (HEADS, DH), (HEADS, DH),
                  (gh_gd, CLASSES)):
        rng.normal(size=shape, scale=0.2)
    el = rng.normal(size=(n, HEADS)).astype(np.float32)  # strategy 7
    er = rng.normal(size=(n, HEADS)).astype(np.float32)
    z = rng.normal(size=(n, HEADS, DH)).astype(np.float32)
    return {"num_nodes": n, "src": src, "dst": dst, "x": x, "el": el,
            "er": er, "z": z}


def _gathered(t, group):
    return comm.all_gather_rows(t.detach().contiguous(), group)


def _rank_main(rank, world_size, group, device, out_path):
    dev = torch.device(device, rank) if device == "cuda" else \
        torch.device(device)
    inp = dryrun_inputs(world_size)
    n = inp["num_nodes"]
    src, dst = inp["src"], inp["dst"]

    # strategy 2: the sharded bitmask SpMM, multi-edges and all
    fmt = build_bit_sharded_format(src, dst, n, world_size, symmetric=False,
                                   device="cpu")
    fmt = shard_format(fmt, rank, dev)
    xb = local_rows(fmt, pad_nodes(fmt, torch.from_numpy(inp["x"])),
                    rank).to(dev).requires_grad_()
    out = bit_sharded_spmm(fmt, xb, group)
    total = fmt.num_parts * fmt.npp * out.shape[1]
    part = out.square().sum() / total
    part.backward()
    bl = float(_gathered(part.reshape(1), group).sum())
    bg = _gathered(xb.grad, group)
    if not (np.isfinite(bl) and torch.isfinite(bg).all()):
        raise AssertionError("non-finite bitmask-sharded step")
    if rank == 0:
        print(f"dryrun_multichip({world_size}) ok (bitmask-sharded): "
              f"{fmt.bytes_per_device} adjacency bytes/device", flush=True)

    # strategy 7: the sharded dense attention on the deduplicated graph
    key, _ = unique_counts((src % n) * n + dst % n)
    su, du = key // n, key % n
    gfmt = build_bit_sharded_format(su, du, n, world_size, device="cpu")
    gfmt = shard_format(gfmt, rank, dev)
    ins = [local_rows(gfmt, pad_nodes(gfmt, torch.from_numpy(inp[k])),
                      rank).to(dev).requires_grad_()
           for k in ("el", "er", "z")]
    out = bit_sharded_gat(gfmt, *ins, group)
    part = out.square().sum() / (gfmt.num_parts * gfmt.npp * HEADS * DH)
    part.backward()
    al = float(_gathered(part.reshape(1), group).sum())
    grads = [_gathered(t.grad, group) for t in ins]
    if not (np.isfinite(al) and all(torch.isfinite(g).all() for g in grads)):
        raise AssertionError("non-finite sharded attention step")
    if rank == 0:
        print(f"dryrun_multichip({world_size}) ok (sharded dense attention): "
              f"bit-masked flash GAT, {gfmt.bytes_per_device} adjacency "
              f"bytes/device, loss={al:.4f}", flush=True)
        np.savez(out_path, spmm_loss=bl, spmm_grad=bg.cpu().numpy(),
                 gat_loss=al, gat_out=_gathered(out, group).cpu().numpy(),
                 **{f"gat_grad_{k}": g.cpu().numpy()
                    for k, g in zip(("el", "er", "z"), grads)})
    else:
        _gathered(out, group)


def dryrun_multichip(world_size: int, device="cuda") -> dict:
    """Run strategies 2 and 7 on ``world_size`` ranks and print the JAX dry
    run's two "ok" lines.  Returns the inputs (``dryrun_inputs``) and what
    the ranks computed: ``spmm_loss``, ``spmm_grad`` (P npp, F),
    ``gat_loss``, ``gat_out`` (P npp, H, D) and ``gat_grad_el``/``_er``/
    ``_z``, all padded to the sharded layout."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dryrun.npz")
        comm.run_ranks(_rank_main, world_size, dev, dev.type, path)
        with np.load(path) as res:
            out = {k: res[k] for k in res.files}
    out["spmm_loss"] = float(out["spmm_loss"])
    out["gat_loss"] = float(out["gat_loss"])
    return {**dryrun_inputs(world_size), **out}
