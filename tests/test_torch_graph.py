"""Parity of the port's graph structure (dgl_tpu_torch.graph, .transforms)
with the JAX package on identical COO input, on the CPU."""
import numpy as np
import pytest
import torch

import dgl_tpu as dgl
import dgl_tpu_torch as dgt
from dgl_tpu_torch.graph.unitgraph import UnitGraph


def _coo(seed, n=120, e=900):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, e)
    col = rng.integers(0, n - 7, e)      # the last 7 nodes get no in-edge
    row[:40], col[:40] = row[40:80], col[40:80]   # multi-edges
    row[80:90] = col[80:90]                        # self-loops
    return row, col, n


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("seed", [0, 1])
def test_formats_and_degrees_match(seed):
    row, col, n = _coo(seed)
    uj = dgl.graph((row, col), num_nodes=n).unit()
    ut = dgt.graph((row, col), num_nodes=n, device="cpu").unit()
    for name in ("csr", "csc"):
        a, b = getattr(uj, name)(), getattr(ut, name)()
        for field in ("indptr", "indices", "eids"):
            np.testing.assert_array_equal(_np(getattr(a, field)),
                                          _np(getattr(b, field)))
    np.testing.assert_array_equal(_np(uj.in_degrees()), _np(ut.in_degrees()))
    np.testing.assert_array_equal(_np(uj.out_degrees()),
                                  _np(ut.out_degrees()))
    assert ut.materialized_formats() == ("coo", "csr", "csc")


def test_coo_rebuilt_from_csr_and_csc_and_reverse():
    row, col, n = _coo(2)
    ut = dgt.graph((row, col), num_nodes=n, device="cpu").unit()
    from_csr = UnitGraph(n, n, len(row), csr=ut.csr())
    from_csc = UnitGraph(n, n, len(row), csc=ut.csc())
    for u in (from_csr, from_csc):
        r, c = u.coo()
        np.testing.assert_array_equal(_np(r), row)
        np.testing.assert_array_equal(_np(c), col)
    rev = ut.reverse()
    np.testing.assert_array_equal(_np(rev.coo()[0]), col)
    np.testing.assert_array_equal(_np(rev.in_degrees()),
                                  _np(ut.out_degrees()))
    # degrees read from a materialized CSC equal the bincount ones
    np.testing.assert_array_equal(_np(from_csc.in_degrees()),
                                  _np(ut.in_degrees()))


def test_self_loop_transforms_match():
    row, col, n = _coo(3)
    w = np.random.default_rng(3).normal(size=(len(row), 2)).astype(np.float32)
    gj = dgl.graph((row, col), num_nodes=n)
    gt = dgt.graph((row, col), num_nodes=n, device="cpu")
    gj.edata["w"] = w
    gt.edata["w"] = torch.from_numpy(w)
    gj2 = dgl.add_self_loop(dgl.remove_self_loop(gj))
    gt2 = dgt.add_self_loop(dgt.remove_self_loop(gt))
    assert gt2.num_edges() == gj2.num_edges()
    for a, b in zip(gj2.unit().coo(), gt2.unit().coo()):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(_np(gj2.edata["w"]), _np(gt2.edata["w"]))
    for name in ("csr", "csc"):
        a, b = getattr(gj2.unit(), name)(), getattr(gt2.unit(), name)()
        np.testing.assert_array_equal(_np(a.eids), _np(b.eids))
    # the method forms are the same transforms
    np.testing.assert_array_equal(
        _np(gt.remove_self_loop().add_self_loop().unit().coo()[0]),
        _np(gt2.unit().coo()[0]))


def test_graph_schema_and_frames():
    row, col, n = _coo(4)
    g = dgt.graph((row, col), device="cpu")
    assert g.num_nodes() == int(max(row.max(), col.max())) + 1
    assert g.num_edges() == len(row)
    assert g.canonical_etypes == [("_N", "_E", "_N")]
    assert g.get_etype_id("_E") == 0 and g.is_homogeneous
    assert g.device == torch.device("cpu")
    g.ndata["x"] = torch.ones(g.num_nodes(), 3)
    assert g.srcdata["x"] is g.ndata["x"] and "x" in g.dstdata
    with g.local_scope():
        g.ndata["y"] = torch.zeros(g.num_nodes())
        assert len(g.ndata) == 2
    assert list(g.ndata) == ["x"]
    with pytest.raises(KeyError):
        g.get_etype_id("nope")


def test_synth_reddit_same_arrays():
    """The port's copy of the generator gives the JAX package's arrays."""
    from dgl_tpu.data.synth_reddit import reddit_like_graph_sym as gen_j
    a = gen_j(3000, 120_000, seed=5)
    b = dgt.data.reddit_like_graph_sym(3000, 120_000, seed=5)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n", [0, 1, 1000])
def test_unique_counts_is_np_unique(n):
    from dgl_tpu_torch.utils import unique_counts
    a = np.random.default_rng(n).integers(-50, 50, n)
    for got, want in zip(unique_counts(a), np.unique(a, return_counts=True)):
        np.testing.assert_array_equal(got, want)
