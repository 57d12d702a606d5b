"""Parity of the port's mesh-sharded bit-masked GAT
(dgl_tpu_torch/parallel/bitgat_spmd.py) and its two local kernels'
plain versions with the JAX package on identical inputs.

* ``bitgat_fwd_t_plain`` against JAX ``_fwd_call`` and
  ``bit_shard_gat_bwd_plain`` (K13) against JAX ``_bwd_src_call`` on one
  shard, both interpreted with f32 operands: rtol 1e-4 / atol 1e-5, f32
  sums over each node's edges in another order (the TPU kernels sum
  plane by plane, the plain versions edge by edge);
* ``bit_sharded_gat`` on 4 gloo ranks (``torch_ranks.gat_ranks``,
  spawned once for the module) against the JAX op on a 4-device CPU mesh,
  forward and the VJP in el, er and z with logits inside, on and beyond
  the +-20 clip: the same tolerance;
* the op on a group of one rank against ``bitgat_attention_aggregate``
  (both the port's plain versions, summing in another order): rtol 1e-5 /
  atol 1e-6, away from logits of exactly +-20, where the sharded clip's
  VJP gives 0 (JAX ``bitgat_spmd.py:302-303``) and ``torch.clamp``'s
  passes the gradient;
* ``dryrun_multichip(4, device="cpu")`` against the JAX ops on the dry
  run's inputs: the same tolerance as the kernels.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dgl_tpu.ops.pallas import bitgat as jbg
from dgl_tpu.parallel import bitgat_spmd as jgs
from dgl_tpu.parallel import bitspmd as jbs
from dgl_tpu_torch.ops.kernels import bitgat as tbg
from dgl_tpu_torch.ops.kernels import bitmm as tbm
from dgl_tpu_torch.parallel import bitgat_spmd as tgs
from dgl_tpu_torch.parallel import bitspmd as tbs
from dgl_tpu_torch.parallel import comm, dryrun_multichip

import torch_ranks as tr

RTOL, ATOL = 1e-4, 1e-5
SLOPE = 0.2


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:tr.WORLD]), ("data",))


@pytest.fixture(scope="module")
def jax_gat(mesh):
    """(out, (d_el, d_er, d_z)) of sum(out * w) of the JAX op, jitted once
    for every call of the module (the same shapes throughout)."""
    sh = NamedSharding(mesh, P("data"))

    @jax.jit
    def run(fmt, el, er, z, w):
        def loss(a, b, c):
            out = jgs.bit_sharded_gat(fmt, a, b, c, mesh, "data", SLOPE)
            return (out * w).sum(), out
        (_, out), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(el, er, z)
        return out, grads

    def call(row, col, n, el, er, z, w):
        fmt = jbs.shard_format(jgs.build_bit_sharded_format(
            row, col, n, tr.WORLD), mesh)
        put = lambda a: jax.device_put(  # noqa: E731
            jbs.pad_nodes(fmt, jnp.asarray(a)), sh)
        out, grads = run(fmt, put(el), put(er), put(z), put(w))
        return (np.asarray(out),) + tuple(np.asarray(g) for g in grads)
    return call


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What the 4 gloo ranks of ``gat_ranks`` computed."""
    path = os.path.join(tmp_path_factory.mktemp("gat"), "ranks.npz")
    comm.run_ranks(tr.gat_ranks, tr.WORLD, "cpu", path)
    with np.load(path) as res:
        return {k: res[k] for k in res.files}


def _shard_inputs(seed, heads, dim, part=1):
    """One shard of ``gat_case``'s graph on 4 parts and shard-level
    inputs: el/z of every src row, er/g/linv/rho of the local dst."""
    row, col, n = tr.gat_case()[:3]
    fmt = tbs.build_bit_sharded_format(row, col, n, tr.WORLD, device="cpu")
    shard = fmt.shards[part]
    kp, npp = fmt.kp, fmt.npp
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    el, er, z, g = f(kp, heads), f(npp, heads), f(kp, heads, dim), \
        f(npp, heads, dim)
    linv = rng.uniform(0.05, 1.0, size=(npp, heads)).astype(np.float32)
    rho = f(npp, heads)
    return shard, npp, el, er, z, g, linv, rho


@pytest.mark.parametrize("heads,dim", [(2, 16), (1, 41)])
def test_fwd_t_plain_matches_jax_fwd_call(heads, dim):
    shard, npp, el, er, z = _shard_inputs(heads * 7 + dim, heads, dim)[:5]
    out_t, l_t = jbg._fwd_call(jnp.asarray(shard.numpy()), jnp.asarray(el),
                               jbg._plane_major_node(jnp.asarray(er), npp),
                               jnp.asarray(z).transpose(1, 2, 0), SLOPE)
    want_out = jbg._unplane_feat(out_t, npp)
    want_l = jbg._unplane_node(l_t, npp)
    args = (shard, torch.from_numpy(el), torch.from_numpy(er),
            torch.from_numpy(z), npp, SLOPE)
    for fn in (tbg.bitgat_fwd_t_plain, tbg.bitgat_fwd_t):
        out, l = fn(*args)
        assert out.shape == (npp, heads, dim) and l.shape == (npp, heads)
        _close(out, want_out, f"{fn.__name__} out")
        _close(l, want_l, f"{fn.__name__} l")
    assert (np.asarray(want_l) == 0).any()       # dst with no in-edge: 0
    assert not out[(l == 0).all(-1)].any()


@pytest.mark.parametrize("heads,dim", [(2, 16), (1, 41)])
def test_shard_bwd_plain_matches_jax_bwd_src_call(heads, dim):
    shard, npp, el, er, z, g, linv, rho = _shard_inputs(
        heads * 11 + dim, heads, dim, part=2)
    pfn = lambda v: jbg._plane_first_node(jnp.asarray(v), npp)  # noqa
    gp = jnp.asarray(g).reshape(32, npp // 32, heads, dim).transpose(
        2, 0, 3, 1)
    dzt, delc, der_part = jgs._bwd_src_call(
        jnp.asarray(shard.numpy()), jnp.asarray(el), pfn(er), pfn(linv),
        pfn(rho), jnp.asarray(z).transpose(1, 2, 0), gp, SLOPE)
    # the test's own layout changes: dz (H, D, kp) -> (kp, H, D); der's
    # per-src-block partials summed, plane-major -> natural node order
    want_dz = np.asarray(dzt).transpose(2, 0, 1)
    want_der = np.asarray(der_part).sum(0).transpose(0, 2, 1).reshape(
        npp, heads)
    args = (shard,) + tuple(torch.from_numpy(a)
                            for a in (el, er, z, g, linv, rho)) + (npp, SLOPE)
    for fn in (tgs.bit_shard_gat_bwd_plain, tgs.bit_shard_gat_bwd):
        d_el, d_er, dz = fn(*args)
        _close(d_el, delc, f"{fn.__name__} del")
        _close(d_er, want_der, f"{fn.__name__} der")
        _close(dz, want_dz, f"{fn.__name__} dz")


def test_sharded_gat_matches_jax(ranks, jax_gat):
    want = jax_gat(*tr.gat_case())
    for name, got, w in zip(("out", "d_el", "d_er", "d_z"),
                            (ranks["out"], ranks["grad_el"], ranks["grad_er"],
                             ranks["grad_z"]), want):
        _close(got, w, name)
    # the clip: saturated logits get no gradient
    el, er = tr.gat_case()[3:5]
    for grad, v in ((ranks["grad_el"], el), (ranks["grad_er"], er)):
        sat = np.abs(v) >= tgs.CLIP
        assert sat.sum() == 6 and not grad[:len(v)][sat].any()
        assert grad[:len(v)][~sat].any()


def test_sharded_gat_padded_rows_are_zero(ranks):
    n = tr.gat_case()[2]
    for key in ("out", "grad_el", "grad_er", "grad_z", "one_out"):
        assert not ranks[key][n:].any(), key


def test_sharded_gat_rejects_multigraph():
    row = np.array([0, 0, 1], np.int64)
    col = np.array([5, 5, 7], np.int64)     # duplicate (0, 5)
    fmt = tbs.build_bit_sharded_format(row, col, 16, 1, device="cpu")
    z = torch.zeros(fmt.npp, 1, 8)
    with pytest.raises(ValueError, match="simple"):
        tgs.bit_sharded_gat(fmt, z[..., 0], z[..., 0], z)


def test_sharded_gat_guards():
    row, col, n = tr.gat_case()[:3]
    fmt = tbs.build_bit_sharded_format(row, col, n, 1, device="cpu")
    z = torch.zeros(fmt.npp, 4, 33)
    with pytest.raises(ValueError, match="H \\* D"):
        tgs.bit_sharded_gat(fmt, z[..., 0], z[..., 0], z)
    with pytest.raises(ValueError, match="must be"):
        tgs.bit_sharded_gat(fmt, z[:5, :, 0], z[:5, :, 0], z[:5])


def test_world_size_one_matches_bitgat_attention_aggregate(ranks):
    row, col, n, el, er, z, w = tr.gat_case()
    bf = tbm.build_bit_format(row, col, n, n, device="cpu")
    ins = [torch.from_numpy(a).requires_grad_() for a in (el, er, z)]
    out = tbg.bitgat_attention_aggregate(bf, *ins, SLOPE)
    (out * torch.from_numpy(w)).sum().backward()
    for name, got, want in zip(
            ("out", "d_el", "d_er", "d_z"),
            ("one_out", "one_grad_el", "one_grad_er", "one_grad_z"),
            (out.detach(),) + tuple(t.grad for t in ins)):
        got, want = ranks[got][:n], want.numpy()
        if name in ("d_el", "d_er"):
            edge = np.abs(el if name == "d_el" else er) == tgs.CLIP
            assert edge.sum() == 2 and not got[edge].any()
            got, want = got[~edge], want[~edge]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_dryrun_multichip_matches_jax(mesh, jax_gat, capfd):
    res = dryrun_multichip(tr.WORLD, device="cpu")
    printed = capfd.readouterr().out
    assert f"dryrun_multichip({tr.WORLD}) ok (bitmask-sharded)" in printed
    assert f"dryrun_multichip({tr.WORLD}) ok (sharded dense attention)" \
        in printed
    n, src, dst = res["num_nodes"], res["src"], res["dst"]

    # strategy 2 against the JAX op on the same inputs
    fmt = jbs.shard_format(jbs.build_bit_sharded_format(
        src, dst, n, tr.WORLD, symmetric=False), mesh)
    xb = jax.device_put(jbs.pad_nodes(fmt, jnp.asarray(res["x"])),
                        NamedSharding(mesh, P("data")))
    bl, bg = jax.jit(jax.value_and_grad(lambda xb: (jbs.bit_sharded_spmm(
        fmt, xb, mesh, "data") ** 2).mean()))(xb)
    np.testing.assert_allclose(res["spmm_loss"], float(bl), rtol=RTOL)
    _close(res["spmm_grad"], bg, "spmm grad")

    # strategy 7: the gradient of mean(out^2) is the VJP of 2 out / size
    key = np.unique((src % n) * n + dst % n)
    su, du = key // n, key % n
    args = (su, du, n, res["el"], res["er"], res["z"])
    out = jax_gat(*args, np.zeros_like(res["z"]))[0]
    want = jax_gat(*args, 2 * out[:n] / out.size)
    np.testing.assert_allclose(res["gat_loss"], float((out ** 2).mean()),
                               rtol=RTOL)
    for name, w in zip(("out", "grad_el", "grad_er", "grad_z"), want):
        _close(res[f"gat_{name}"], w, f"dryrun {name}")
