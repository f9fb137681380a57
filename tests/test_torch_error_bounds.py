"""PyTorch port, the paper's error analysis on the port's code paths (the
counterpart of tests/test_error_bounds.py):

 - Lemma 1: per-layer output error <= δk2 + (δ+ε)k1k2|N(v)| for linear
   MESSAGE/UPDATE maps with known Lipschitz constants, the aggregation
   computed by the port's block path (`bcsr_spmm`'s plain version over
   blocks `kernels.ops.build_bcsr_rect` builds) on the CPU.
 - Theorem 2 (qualitatively): with fixed params, staleness-driven error
   falls epoch over epoch through the port's `gas_batch_forward` over an
   f32 store, to the exact full-graph forward.
 - Quantized histories add an error floor: `hist_quant_err` from the
   port's `train_epoch` under each precision's analytic bound (0 for f32,
   2^-8 for bf16, sqrt(d)/254 for int8, below 1 for vq), and a vq
   round-trip through the port's store within the codebook distortion on
   ragged pushes with exact-zero rows (hypothesis where installed, the
   reference's fixed grid otherwise).

Proposition 3 on the port's GIN is in tests/test_torch_zoo.py.
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")
import _torch_threads  # noqa: E402  one torch thread a test process

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

from repro_torch.core import gas as G
from repro_torch.core import history as H
from repro_torch.core import runtime as R
from repro_torch.core.partition import metis_like_partition
from repro_torch.data.graphs import citation_graph
from repro_torch.gnn.model import (GNNSpec, full_forward, gas_batch_forward,
                                   init_gnn)
from repro_torch.kernels import ops
from repro_torch.kernels.bcsr_spmm import bcsr_spmm

T = torch.from_numpy


def test_lemma1_bound_holds_on_block_path():
    """Linear MESSAGE (W1, k1 = ||W1||) + sum aggregation over the BCSR
    blocks + linear UPDATE (W2, k2 = ||W2||): inputs off by delta and
    neighbor (historical) inputs off by delta + eps stay within the
    bound, row by row."""
    rng = np.random.default_rng(0)
    n, d = 40, 8
    W1 = rng.normal(size=(d, d)).astype(np.float32) * 0.3
    W2 = rng.normal(size=(d, d)).astype(np.float32) * 0.3
    k1 = np.linalg.norm(W1, 2)
    k2 = np.linalg.norm(W2, 2)
    A = (rng.random((n, n)) < 0.2).astype(np.float32)
    np.fill_diagonal(A, 0)
    deg = A.sum(1)
    dst, src = np.nonzero(A)
    vals, cols, _, _ = ops.build_bcsr_rect(dst.astype(np.int32),
                                           src.astype(np.int32),
                                           A[dst, src], n, n)
    vals, cols = T(vals), T(cols)

    def f(h_self, h_all):
        msg = T(h_all) @ T(W1)
        return ((T(h_self) + bcsr_spmm(msg, vals, cols)[:n]) @ T(W2)).numpy()

    h = rng.normal(size=(n, d)).astype(np.float32)
    # the block path is the aggregation A @ x
    np.testing.assert_allclose(bcsr_spmm(T(h), vals, cols)[:n].numpy(),
                               A @ h, rtol=1e-5, atol=1e-5)
    delta, eps = 0.05, 0.1
    dh = rng.normal(size=(n, d))
    dh = (dh / np.linalg.norm(dh, axis=1, keepdims=True) * delta)
    de = rng.normal(size=(n, d))
    de = (de / np.linalg.norm(de, axis=1, keepdims=True) * eps)
    exact = f(h, h)
    approx = f((h + dh).astype(np.float32), (h + dh + de).astype(np.float32))
    err = np.linalg.norm(exact - approx, axis=1)
    bound = delta * k2 + (delta + eps) * k1 * k2 * deg
    assert np.all(err <= bound + 1e-5), (err.max(), bound.min())
    assert np.all(err > 0)


def test_staleness_decays_with_epochs():
    """With fixed params, the port's history-based forward approaches the
    exact full-graph forward epoch over epoch (Theorem 2's ε^(ℓ)
    shrinking): after 4 epochs within 1e-3, and closer than after the
    first. The store is pinned to f32, so the error is staleness alone."""
    g = citation_graph(num_nodes=400, num_features=16, num_classes=4, seed=3)
    spec = GNNSpec(op="gcn", d_in=16, d_hidden=16, num_classes=4,
                   num_layers=4)
    params = init_gnn(spec, seed=0, device="cpu")
    dst, src, w = G.gcn_edge_weights(g)
    x = T(g.x)
    with torch.no_grad():
        full = full_forward(params, spec, x, (T(dst), T(src)), T(w),
                            g.num_nodes).numpy()
        part = metis_like_partition(g.indptr, g.indices, 5, seed=0)
        batches = G.build_batches(g, part, build_blocks=True)
        stack = batches.to("cpu")
        hist = H.HistoryStore.create(g.num_nodes + 1, spec.hist_dims(),
                                     history_dtype="f32", device="cpu")
        errs = []
        for _ in range(4):
            outs = np.zeros_like(full)
            for b in range(batches.num_batches):
                batch = stack[b]
                logits, hist, _ = gas_batch_forward(params, spec, x, batch,
                                                    hist)
                nodes = batch.batch_nodes.numpy()
                mask = batch.batch_mask.numpy()
                outs[nodes[mask]] = logits.numpy()[mask]
            errs.append(float(np.abs(outs - full).max()))
    assert errs[-1] < 1e-3, errs
    assert errs[0] > errs[-1], errs


@pytest.mark.parametrize("hd", H.HISTORY_DTYPES)
def test_measured_hist_quant_err_within_analytic_bound(hd):
    """`train_epoch`'s `hist_quant_err` (the mean per-row relative L2
    error of the pushed rows) under each precision's analytic bound:
    exactly 0 for f32; <= 2^-8 for bf16's mantissa rounding; <=
    sqrt(d)/254 for int8's per-row absmax scaling (amax <= ||v||); < 1
    for vq, whose centroid 0 is pinned to zero."""
    g = citation_graph(num_nodes=200, num_features=16, num_classes=4,
                       seed=5)
    spec = GNNSpec(op="gcn", d_in=16, d_hidden=16, num_classes=4,
                   num_layers=3)
    plan = R.build_plan(g, spec, R.GASConfig(num_parts=3, history_dtype=hd,
                                             epochs=2, seed=0),
                        device="cpu")
    state = R.init_state(plan)
    for e in range(2):
        state, m = R.train_epoch(plan, state, e)
        err = m["hist_quant_err"]
        assert np.isfinite(err)
        if hd == "f32":
            assert err == 0.0
        elif hd == "bf16":
            assert 0.0 < err <= 2.0 ** -8
        elif hd == "int8":
            assert 0.0 < err <= spec.d_hidden ** 0.5 / 254
        else:
            assert 0.0 < err < 1.0


def _check_vq_roundtrip_distortion_bound(S, M, seed, scale_log):
    """For a ragged push (width d = S * VQ_SUBDIM, magnitudes across six
    decades, masked rows, exact-zero rows) the port's vq round-trip error
    per row is at most the codebook distortion sqrt(sum_s min_c ||u_s -
    c||^2) * scale and at most ||v|| (the pinned zero centroid), and the
    masked rows read back exactly zero."""
    d = S * H.VQ_SUBDIM
    rng = np.random.default_rng(seed)
    vals = (rng.normal(size=(M, d)) * 10.0 ** scale_log).astype(np.float32)
    vals[rng.random(M) < 0.2] = 0.0
    mask = rng.random(M) < 0.7
    N = M + 5
    idx = rng.choice(N - 1, M, replace=False).astype(np.int32)

    store = H.HistoryStore.create(N, [d], history_dtype="vq", device="cpu")
    store.push(0, T(idx), T(vals), T(mask))
    got = store.pull(0, T(idx)).numpy()
    cb = store.layer_codebook(0).numpy()
    amax = np.abs(vals).max(axis=1)
    scale = np.where(amax > 0, amax, 1.0)
    u = (vals / scale[:, None]).reshape(M, S, 1, H.VQ_SUBDIM)
    dist = scale * np.sqrt(((u - cb[None]) ** 2).sum(-1).min(-1).sum(-1))
    err = np.linalg.norm(got - vals, axis=1)
    norm = np.linalg.norm(vals, axis=1)
    assert (err[mask] <= dist[mask] * (1 + 1e-4) + 1e-5).all(), \
        (float(err[mask].max()), float(dist[mask].max()))
    assert (err[mask] <= norm[mask] * (1 + 1e-4) + 1e-6).all()
    np.testing.assert_array_equal(got[~mask], 0.0)


# tests/test_error_bounds.py's grid: (S, M, seed, scale_log)
_VQ_GRID = [(1, 1, 0, -3.0), (1, 12, 1, 0.0), (2, 7, 2, 3.0),
            (3, 5, 3, -1.5), (4, 9, 4, 1.5), (5, 12, 5, 0.5),
            (2, 3, 6, -2.5), (5, 1, 7, 2.5), (3, 11, 8, 0.0),
            (4, 6, 9, -0.5)]

if HAVE_HYPOTHESIS:
    @settings(max_examples=15, deadline=None)
    @given(S=st.integers(1, 5), M=st.integers(1, 12),
           seed=st.integers(0, 2 ** 16), scale_log=st.floats(-3.0, 3.0))
    def test_vq_roundtrip_respects_codebook_distortion_bound(
            S, M, seed, scale_log):
        _check_vq_roundtrip_distortion_bound(S, M, seed, scale_log)
else:
    @pytest.mark.parametrize("S,M,seed,scale_log", _VQ_GRID)
    def test_vq_roundtrip_respects_codebook_distortion_bound(
            S, M, seed, scale_log):
        _check_vq_roundtrip_distortion_bound(S, M, seed, scale_log)
