"""Rank functions of the sharded-format tests (``test_torch_bitspmd.py``,
``test_torch_bitgat_spmd.py``) and the numpy inputs both packages take.

``dgl_tpu_torch.parallel.run_ranks`` runs each function in one process
per gloo rank; the processes import this module, so it imports nothing
of JAX: numpy, torch and ``dgl_tpu_torch`` only.  Rank 0 gathers what the
ranks computed and writes it to an ``.npz`` file for the test.
"""
import numpy as np
import torch
import torch.nn.functional as F

from dgl_tpu_torch.parallel import bitgat_spmd, bitspmd, comm

WORLD = 4
GAT_HEADS, GAT_DIM = 2, 16
GCN_STEPS = 15


# -- inputs (numpy, from seeds) ----------------------------------------------

def rand_graph(rng, n, e, symmetric):
    """tests/test_bitspmd.py's random graph."""
    if symmetric:
        r0 = rng.integers(0, n, e // 2).astype(np.int64)
        c0 = rng.integers(0, n, e // 2).astype(np.int64)
        return np.r_[r0, c0], np.r_[c0, r0]
    return (rng.integers(0, n, e).astype(np.int64),
            rng.integers(0, n, e).astype(np.int64))


def spmm_case(symmetric):
    """tests/test_bitspmd.py::test_bit_sharded_matches_dense's graph (with
    forced multi-edges) and features."""
    rng = np.random.default_rng(3)
    n, e, f = 500, 6000, 5
    row, col = rand_graph(rng, n, e, symmetric)
    row[:40] = row[0]
    col[:40] = col[0]
    if symmetric:
        row[e // 2:e // 2 + 40] = col[0]
        col[e // 2:e // 2 + 40] = row[0]
    x = rng.normal(size=(n, f)).astype(np.float32)
    return row, col, n, x


def gcn_case():
    """tests/test_bitspmd.py::test_bit_sharded_train_step's graph, data and
    initial weights."""
    rng = np.random.default_rng(5)
    n, e, f, c = 480, 5000, 8, 4
    row, col = rand_graph(rng, n, e, True)
    y = (np.arange(n) * c // n).astype(np.int32)
    x = (rng.normal(size=(n, f)) +
         np.eye(c)[y] @ rng.normal(size=(c, f)) * 2).astype(np.float32)
    w1 = rng.normal(size=(f, 16), scale=0.3).astype(np.float32)
    w2 = rng.normal(size=(16, c), scale=0.3).astype(np.float32)
    return row, col, n, x, y, w1, w2


def gat_case():
    """A simple graph on the dry run's 256 nodes with logits inside,
    exactly on and beyond the +-20 clip, and a loss weight w."""
    rng = np.random.default_rng(11)
    n, e = 256, 3000
    key = np.unique(rng.integers(0, n, e) * n + rng.integers(0, n, e))
    row, col = key % n, key // n
    el = rng.normal(size=(n, GAT_HEADS)).astype(np.float32)
    er = rng.normal(size=(n, GAT_HEADS)).astype(np.float32)
    for v in (el, er):
        v[:6, 0] = (25.0, -25.0, 20.0, -20.0, 19.5, -19.5)
        v[6:9, 1] = (21.0, -30.0, 19.0)
    z = rng.normal(size=(n, GAT_HEADS, GAT_DIM)).astype(np.float32)
    w = rng.normal(size=(n, GAT_HEADS, GAT_DIM)).astype(np.float32)
    return row, col, n, el, er, z, w


# -- rank functions -----------------------------------------------------------

def _local(fmt, a, rank):
    """This rank's rows of the padded ``a`` (numpy)."""
    return bitspmd.local_rows(fmt, bitspmd.pad_nodes(
        fmt, torch.from_numpy(np.ascontiguousarray(a))), rank)


def _gathered(t, group):
    return comm.all_gather_rows(t.detach().contiguous(), group).numpy()


def spmm_ranks(rank, world, group, path):
    """Forward and gradient of (A x)^2 sum on both graphs of
    ``spmm_case``, then ``GCN_STEPS`` Adam steps of the sharded GCN."""
    res = {}
    for sym in (True, False):
        row, col, n, x = spmm_case(sym)
        fmt = bitspmd.shard_format(bitspmd.build_bit_sharded_format(
            row, col, n, world, symmetric=sym, device="cpu"), rank, "cpu")
        xl = _local(fmt, x, rank).requires_grad_()
        out = bitspmd.bit_sharded_spmm(fmt, xl, group)
        out.square().sum().backward()
        res[f"out_{sym}"] = _gathered(out, group)
        res[f"grad_{sym}"] = _gathered(xl.grad, group)

    row, col, n, x, y, w1, w2 = gcn_case()
    fmt = bitspmd.shard_format(bitspmd.build_bit_sharded_format(
        row, col, n, world, symmetric=True, device="cpu"), rank, "cpu")
    xl = _local(fmt, x, rank)
    yl = _local(fmt, y.astype(np.int64), rank)
    mask = _local(fmt, np.ones(n, np.float32), rank)
    deg = bitspmd.local_rows(fmt, bitspmd.sharded_in_degrees(
        fmt, row, col, device="cpu"), rank).clamp(min=1.0)[:, None]
    params = [torch.tensor(w, requires_grad=True) for w in (w1, w2)]
    opt = torch.optim.Adam(params, lr=2e-2)
    losses = []
    for _ in range(GCN_STEPS):
        opt.zero_grad()
        h = torch.relu(bitspmd.bit_sharded_spmm(fmt, xl @ params[0], group)
                       / deg)
        logits = bitspmd.bit_sharded_spmm(fmt, h, group) / deg @ params[1]
        ls = F.cross_entropy(logits, yl, reduction="none")
        part = (ls * mask).sum() / n
        part.backward()
        for p in params:
            p.grad = comm.all_reduce_sum(p.grad, group)
        opt.step()
        losses.append(float(comm.all_reduce_sum(part.detach(), group)))
    res["gcn_losses"] = np.array(losses)
    res["gcn_w1"], res["gcn_w2"] = (p.detach().numpy() for p in params)
    if rank == 0:
        np.savez(path, **res)


def gat_ranks(rank, world, group, path):
    """Forward and gradients of sum(out * w) of ``bit_sharded_gat`` on
    ``gat_case``'s graph over the ranks, then on rank 0 alone in a group
    of one rank with the one-part format."""
    row, col, n, el, er, z, w = gat_case()
    res = {}
    fmt = bitspmd.shard_format(bitspmd.build_bit_sharded_format(
        row, col, n, world, device="cpu"), rank, "cpu")
    ins = [_local(fmt, a, rank).requires_grad_() for a in (el, er, z)]
    out = bitgat_spmd.bit_sharded_gat(fmt, *ins, group)
    (out * _local(fmt, w, rank)).sum().backward()
    res["out"] = _gathered(out, group)
    for name, t in zip(("el", "er", "z"), ins):
        res[f"grad_{name}"] = _gathered(t.grad, group)
    one = torch.distributed.new_group([0])
    if rank == 0:
        fmt1 = bitspmd.build_bit_sharded_format(row, col, n, 1,
                                                device="cpu")
        ins = [_local(fmt1, a, 0).requires_grad_() for a in (el, er, z)]
        out = bitgat_spmd.bit_sharded_gat(fmt1, *ins, one)
        (out * _local(fmt1, w, 0)).sum().backward()
        res["one_out"] = out.detach().numpy()
        for name, t in zip(("el", "er", "z"), ins):
            res[f"one_grad_{name}"] = t.grad.numpy()
        np.savez(path, **res)
