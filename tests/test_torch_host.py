"""PyTorch port, host code: the port's numpy copies produce the reference's
arrays bitwise — graphs, GCN weights, the in-edge CSR, BCSR blocks,
request batches (every field, both block families, the pads), the fused
gather plan, stale closures and the serve plan's buckets and pads."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")
import _torch_threads  # noqa: E402  one torch thread a test process

from repro.core import delta as r_delta
from repro.core import gas as r_gas
from repro.core import serve as r_serve
from repro.data import graphs as r_graphs
from repro.gnn.model import GNNSpec as RSpec
from repro.kernels import fused as r_fused
from repro.kernels import ops as r_ops

from repro_torch.core import delta as t_delta
from repro_torch.core import gas as t_gas
from repro_torch.core import serve as t_serve
from repro_torch.data import graphs as t_graphs
from repro_torch.gnn.model import GNNSpec as TSpec
from repro_torch.kernels import fused as t_fused
from repro_torch.kernels import ops as t_ops

N, F, C, L = 260, 20, 3, 3


def _graphs(seed=1, n=N):
    kw = dict(num_nodes=n, avg_degree=4.5, num_features=F, num_classes=C,
              seed=seed)
    return r_graphs.citation_graph(**kw), t_graphs.citation_graph(**kw)


def _assert_graph_equal(a, b):
    for f in ("indptr", "indices", "x", "y", "train_mask", "val_mask",
              "test_mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.num_classes == b.num_classes


@pytest.mark.parametrize("seed", [0, 3])
def test_citation_graph_bitwise(seed):
    _assert_graph_equal(*_graphs(seed))


def test_sbm_cluster_graph_bitwise():
    kw = dict(num_nodes=240, num_communities=4, seed=2)
    _assert_graph_equal(r_graphs.sbm_cluster_graph(**kw),
                        t_graphs.sbm_cluster_graph(**kw))


def test_edge_weights_and_in_csr_bitwise():
    rg, tg = _graphs()
    for a, b in zip(r_gas.gcn_edge_weights(rg), t_gas.gcn_edge_weights(tg)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(r_gas.weighted_in_csr(rg), t_gas.weighted_in_csr(tg)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_rows,n_cols", [(200, 200), (130, 300), (5, 9)])
def test_build_bcsr_rect_bitwise(n_rows, n_cols):
    rng = np.random.default_rng(n_rows)
    e = 4 * n_rows
    dst = rng.integers(0, n_rows, e).astype(np.int32)
    src = rng.integers(0, n_cols, e).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    for a, b in zip(r_ops.build_bcsr_rect(dst, src, w, n_rows, n_cols),
                    t_ops.build_bcsr_rect(dst, src, w, n_rows, n_cols)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(r_ops.build_bcsr(dst, src % n_rows, w, n_rows),
                    t_ops.build_bcsr(dst, src % n_rows, w, n_rows)):
        np.testing.assert_array_equal(a, b)
    empty = np.zeros(0, np.int32)
    for a, b in zip(r_ops.build_bcsr_rect(empty, empty, empty[:0] * 1.0,
                                          n_rows, n_cols),
                    t_ops.build_bcsr_rect(empty, empty, empty[:0] * 1.0,
                                          n_rows, n_cols)):
        np.testing.assert_array_equal(a, b)


_BATCH_FIELDS = ("batch_nodes", "batch_mask", "halo_nodes", "halo_mask",
                 "edge_dst", "edge_src", "edge_w")


def _assert_batch_equal(rb, tb):
    for f in _BATCH_FIELDS:
        a, b = getattr(rb, f), getattr(tb, f)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("max_b", "max_h", "max_e", "bn"):
        assert getattr(rb, f) == getattr(tb, f), f
    for fam in ("forward", "transposed"):
        ra, ta = getattr(rb, fam), getattr(tb, fam)
        assert (ra is None) == (ta is None), fam
        if ra is not None:
            np.testing.assert_array_equal(ra.vals, ta.vals, err_msg=fam)
            np.testing.assert_array_equal(ra.cols, ta.cols, err_msg=fam)


@pytest.mark.parametrize("pads", [None, (64, 300, 900)])
@pytest.mark.parametrize("build_blocks", [False, True])
def test_subgraph_batch_bitwise(pads, build_blocks):
    rg, tg = _graphs()
    csr = t_gas.weighted_in_csr(tg)
    nodes = np.sort(np.random.default_rng(4).choice(N, 40, replace=False))
    kw = {} if pads is None else dict(zip(("max_b", "max_h", "max_e"), pads))
    rb = r_gas.subgraph_batch(*csr, N, nodes, build_blocks=build_blocks,
                              **kw)
    tb = t_gas.subgraph_batch(*csr, N, nodes, build_blocks=build_blocks,
                              **kw)
    _assert_batch_equal(rb, tb)
    if build_blocks:
        # monotone K floors pad the block families with zero blocks
        rb = r_gas.subgraph_batch(*csr, N, nodes, build_blocks=True,
                                  pad_k=7, pad_k_t=5, **kw)
        tb = t_gas.subgraph_batch(*csr, N, nodes, build_blocks=True,
                                  pad_k=7, pad_k_t=5, **kw)
        _assert_batch_equal(rb, tb)


def test_subgraph_batch_device_copy():
    _, tg = _graphs()
    csr = t_gas.weighted_in_csr(tg)
    b = t_gas.subgraph_batch(*csr, N, np.arange(10), build_blocks=True)
    d = b.to("cpu")
    for f in _BATCH_FIELDS:
        t = getattr(d, f)
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), getattr(b, f))
    np.testing.assert_array_equal(d.forward.vals.numpy(), b.forward.vals)
    assert d.blocks[1].dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_plan_bitwise(seed):
    rng = np.random.default_rng(seed)
    R, K, bn = 3, 4, 128
    n_in, max_h, n_table = 200, 150, 500
    cols = rng.integers(0, 4, (R, K)).astype(np.int32)
    halo = rng.integers(0, n_table + 3, max_h).astype(np.int32)
    hmask = rng.random(max_h) < 0.7
    ref = r_fused.gather_plan(jnp.asarray(cols), jnp.asarray(halo),
                              jnp.asarray(hmask), n_in, n_table, bn)
    got = t_fused.gather_plan(torch.from_numpy(cols), torch.from_numpy(halo),
                              torch.from_numpy(hmask), n_in, n_table, bn)
    for a, b in zip(ref, got):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert set(np.unique(got[0].numpy())) == {0, 1, 2}


def test_csr_neighbors_bitwise():
    _, tg = _graphs()
    indptr, src, _ = t_gas.weighted_in_csr(tg)
    for nodes in (np.array([3, 9, 200]), np.zeros(0, np.int64),
                  np.arange(N)):
        np.testing.assert_array_equal(
            r_delta.csr_neighbors(indptr, src, nodes),
            t_delta.csr_neighbors(indptr, src, nodes))


@pytest.mark.parametrize("slo", [0, 2, None])
def test_stale_closure_and_serve_plan_bitwise(slo):
    rg, tg = _graphs()
    buckets = (8, 32, 50)
    rspec = RSpec(op="gcn", d_in=F, d_hidden=16, num_classes=C, num_layers=L)
    tspec = TSpec(op="gcn", d_in=F, d_hidden=16, num_classes=C, num_layers=L)
    rplan = r_serve.build_serve_plan(rg, rspec, r_serve.ServeConfig(
        staleness_slo=slo, buckets=buckets, backend="jnp"))
    tplan = t_serve.build_serve_plan(tg, tspec, t_serve.ServeConfig(
        staleness_slo=slo, buckets=buckets), device="cpu")
    assert rplan.query_buckets == tplan.query_buckets
    assert rplan.refresh_buckets == tplan.refresh_buckets
    assert rplan.pads == tplan.pads
    for f in ("indptr", "src", "w"):
        np.testing.assert_array_equal(getattr(rplan, f), getattr(tplan, f))
    np.testing.assert_array_equal(tplan.x.numpy(), rg.x)
    rng = np.random.default_rng(7)
    age = rng.integers(0, 5, N + 1).astype(np.int32)
    for _ in range(3):
        q = rng.choice(N, 30, replace=False)
        for a, b in zip(r_serve.stale_closure(rplan, age, q, slo),
                        t_serve.stale_closure(tplan, age, q, slo)):
            np.testing.assert_array_equal(a, b)


def test_request_batch_matches_reference():
    """The serve plan's request batches carry the reference's arrays and
    forward blocks; serving builds no transposed family (backward-only)."""
    rg, tg = _graphs()
    rspec = RSpec(op="gcn", d_in=F, d_hidden=16, num_classes=C, num_layers=L)
    tspec = TSpec(op="gcn", d_in=F, d_hidden=16, num_classes=C, num_layers=L)
    rplan = r_serve.build_serve_plan(rg, rspec, r_serve.ServeConfig(
        buckets=(32,), backend="interpret"))
    tplan = t_serve.build_serve_plan(tg, tspec, t_serve.ServeConfig(
        buckets=(32,)), device="cpu")
    for nodes in (np.arange(5, 30), np.arange(100, 132)):
        rb = r_serve.build_request_batch(rplan, nodes, 32)
        tb = t_serve.build_request_batch(tplan, nodes, 32)
        assert tb.transposed is None
        _assert_batch_equal(dataclasses.replace(rb, transposed=None), tb)
    assert {b: k for b, (k, _) in rplan._pad_k.items()} == tplan._pad_k
