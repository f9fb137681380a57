"""PyTorch port, kernels: each kernel's plain PyTorch version against the
JAX package's Pallas kernel in interpret mode, on the same numpy inputs.

Row moves (gather_rows, scatter_rows) compare bitwise, duplicates (last
writer wins) and masked rows included. The block contractions
(bcsr_spmm, the f32 gather_spmm) compare at f32 rtol=atol=1e-5: the
reference contracts 128x128 tiles in the interpreter's dot, the plain
version in one einsum, so the sums are taken in another order. Ragged D
(not a multiple of 128) goes through the ops, which pad on the reference
side and not on the port's. On the card, chip_smoke.py holds each CUDA
kernel against these plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")
import _torch_threads  # noqa: E402  one torch thread a test process

from repro.kernels import bcsr_spmm as r_bcsr
from repro.kernels import fused as r_fused
from repro.kernels import gather as r_gather
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.kernels import scatter as r_scatter

from repro_torch.core import gas as t_gas
from repro_torch.data.graphs import citation_graph
from repro_torch.kernels import _build
from repro_torch.kernels import bcsr_spmm as t_bcsr
from repro_torch.kernels import fused as t_fused
from repro_torch.kernels import gather as t_gather
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import scatter as t_scatter

TOL = dict(rtol=1e-5, atol=1e-5)
T = torch.from_numpy
J = jnp.asarray


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("d", [128, 256])
def test_gather_rows_bitwise(d):
    rng = _rng(d)
    table = rng.standard_normal((70, d)).astype(np.float32)
    idx = rng.integers(0, 70, 33).astype(np.int32)
    want = np.asarray(r_gather.gather_rows(J(table), J(idx), interpret=True))
    got = t_gather.gather_rows(T(table), T(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(r_ref.gather_rows_ref(J(table), J(idx))))


@pytest.mark.parametrize("d", [20, 500])
def test_pull_rows_ragged_bitwise(d):
    """Ragged D and out-of-range ids (clipped), through the ops."""
    rng = _rng(d)
    table = rng.standard_normal((90, d)).astype(np.float32)
    idx = rng.integers(-5, 95, 41).astype(np.int32)
    want = np.asarray(r_ops.pull_rows(J(table), J(idx), backend="interpret"))
    got = t_ops.pull_rows(T(table), T(idx))
    assert got.shape == (41, d)
    np.testing.assert_array_equal(got.numpy(), want)


def _push_case(seed, n, m, d):
    rng = _rng(seed)
    table = rng.standard_normal((n, d)).astype(np.float32)
    vals = rng.standard_normal((m, d)).astype(np.float32)
    idx = rng.integers(0, n - 1, m).astype(np.int32)
    idx[5::6] = idx[0:-5:6][:len(idx[5::6])]       # duplicate valid ids
    mask = rng.random(m) < 0.8
    return table, vals, idx, mask


def test_scatter_rows_bitwise_last_writer():
    """Duplicates resolve to the last writer; masked rows land on the
    sacrificial row N, whose contents are unspecified ([:N] compared)."""
    n, m, d = 60, 48, 128
    table, vals, idx, mask = _push_case(0, n + 1, m, d)
    safe = np.where(mask, idx, n).astype(np.int32)
    want = np.asarray(r_scatter.scatter_rows(J(table), J(safe), J(vals),
                                             interpret=True))
    got = t_scatter.scatter_rows(T(table.copy()), T(safe), T(vals))
    np.testing.assert_array_equal(got.numpy()[:n], want[:n])
    oracle = np.asarray(r_ref.scatter_rows_ref(J(table), J(idx), J(vals),
                                               J(mask)))
    np.testing.assert_array_equal(got.numpy()[:n], oracle[:n])
    assert len(np.unique(idx[mask])) < mask.sum()      # duplicates present


def test_scatter_rows_drops_out_of_range_in_place():
    table = np.zeros((5, 3), np.float32)
    vals = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([1, 7, -1, 1], np.int32)
    t = T(table.copy())
    out = t_scatter.scatter_rows(t, T(idx), T(vals))
    assert out is t
    want = table.copy()
    want[1] = vals[3]
    np.testing.assert_array_equal(t.numpy(), want)


def test_scatter_rows_scan_limit_matches_the_launcher():
    """`scatter_rows`, `scatter_rows_q`, `scatter_rows_vq` and
    `scatter_rows_raw` of at most SCAN_MAX_ROWS rows run the one-launch
    scan (no winner scratch), a larger push the claim passes; the limit
    is the launchers' own (`csrc/scatter.cu` refuses a scan past it in
    all four), and the serving refresh push (4,096 rows) is within it."""
    assert t_scatter.SCAN_MAX_ROWS >= 4096
    src = (_build.CSRC / "scatter.cu").read_text()
    assert (f"constexpr int64_t kScanMax = {t_scatter.SCAN_MAX_ROWS};"
            in src)
    assert src.count("if (winner == nullptr && m > kScanMax)") == 4
    n = 7
    for m in (1, 4096, t_scatter.SCAN_MAX_ROWS):
        assert t_scatter._winner(m, n, torch.device("cpu")) is None
    scratch = t_scatter._winner(t_scatter.SCAN_MAX_ROWS + 1, n,
                                torch.device("cpu"))
    assert scratch.shape == (n,) and scratch.dtype == torch.int32


def test_scatter_rows_vq_plan_matches_the_launcher():
    """The plan's limits are the kernel's: 256 entries a subvector, at
    most 16 warps a CTA, the lane splits it is built for."""
    src = (_build.CSRC / "scatter.cu").read_text()
    assert f"constexpr int kCodes = {t_scatter.VQ_CODES};" in src
    assert f"constexpr int kVqMaxWarps = {t_scatter.VQ_MAX_WARPS};" in src
    for lanes in t_scatter.VQ_LANES:
        assert f"case {lanes}: return launch_vq<{lanes}>" in src


@pytest.mark.parametrize("n_sm", [132, 1])
@pytest.mark.parametrize("m,s_n", [(4096, 32), (194, 8), (179, 8), (1, 32),
                                   (4097, 32), (220, 256), (1024, 8),
                                   (2501, 8)])
def test_scatter_rows_vq_plan_covers_every_entry(m, s_n, n_sm):
    """The encoding push's plan (lanes per (row, subvector) pair, warps
    per CTA, CTAs): the lanes' entry ranges cover the 256 entries once
    and in increasing order, the warps every subvector once, the CTAs
    every row once. On 132 SMs the serving refresh push (4,096 x 32)
    takes one lane per pair and one wave of CTAs, one per SM; the
    training pushes (179-194 rows x 8) and 1,024 rows x 8 (the most the
    plan splits) 8 lanes per pair, the GCN refit push (2,501 x 8) one
    lane, all but 1,024 rows within one CTA per SM. With one SM only a
    single row is split."""
    lanes, warps, ctas = t_scatter.scatter_rows_vq_plan(m, s_n, n_sm)
    assert lanes in t_scatter.VQ_LANES and 32 % lanes == 0
    per = t_scatter.VQ_CODES // lanes
    entries = [c for k in range(lanes) for c in range(k * per, (k + 1) * per)]
    assert entries == list(range(t_scatter.VQ_CODES))
    assert 1 <= warps <= min(s_n, t_scatter.VQ_MAX_WARPS)
    subs = sorted(s for w in range(warps) for s in range(w, s_n, warps))
    assert subs == list(range(s_n))
    rows = 32 // lanes
    assert (ctas - 1) * rows < m <= ctas * rows
    want_132 = {(4096, 32): 1, (194, 8): 8, (179, 8): 8, (1024, 8): 8,
                (2501, 8): 1}
    if n_sm == 132 and (m, s_n) in want_132:
        assert lanes == want_132[(m, s_n)]
        if m != 1024:
            assert ctas <= n_sm
    if n_sm == 1:
        assert lanes == (8 if m == 1 else 1)


@pytest.mark.parametrize("scratch", [True, False])
@pytest.mark.parametrize("d", [20, 128])
def test_push_rows_matches_reference(scratch, d):
    n = 61                                   # table rows incl. the sentinel
    table, vals, idx, mask = _push_case(d, n, 40, d)
    idx = np.minimum(idx, n - 2)
    want = np.asarray(r_ops.push_rows(J(table), J(idx), J(vals), J(mask),
                                      backend="interpret",
                                      scratch_last_row=scratch))
    t = T(table.copy())
    got = t_ops.push_rows(t, T(idx), T(vals), T(mask),
                          scratch_last_row=scratch)
    assert got is t
    rows = n - 1 if scratch else n
    np.testing.assert_array_equal(got.numpy()[:rows], want[:rows])


def _batch(seed=0, n=300, f=20, n_q=60, drop_halo=0.25):
    """A real request batch (forward blocks) with some halo slots masked,
    so the gather plan routes rows from x_in, the table, and zeros."""
    g = citation_graph(num_nodes=n, avg_degree=4.5, num_features=f,
                       num_classes=3, seed=seed)
    csr = t_gas.weighted_in_csr(g)
    nodes = np.sort(_rng(seed).choice(n, n_q, replace=False))
    b = t_gas.subgraph_batch(*csr, n, nodes, build_blocks=True)
    hm = b.halo_mask & (_rng(seed + 1).random(b.max_h) > drop_halo)
    return g, b.replace(halo_mask=hm)


@pytest.mark.parametrize("d", [128, 256])
def test_bcsr_spmm_matches_pallas(d):
    _, b = _batch()
    vals, cols = b.forward.vals, b.forward.cols
    n_x = (int(cols.max()) + 1) * 128
    x = _rng(d).standard_normal((n_x, d)).astype(np.float32)
    want = np.asarray(r_bcsr.bcsr_spmm(J(x), J(vals), J(cols),
                                       interpret=True))
    got = t_bcsr.bcsr_spmm(T(x), T(vals), T(cols))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(r_ref.bcsr_spmm_ref(J(x), J(vals), J(cols))),
        **TOL)


@pytest.mark.parametrize("d", [20, 130])
def test_gcn_aggregate_blocks_ragged(d):
    """Ragged D and an x_all whose rows stop short of a whole block: the
    reference pads both, the port's op passes x_all as it is."""
    _, b = _batch(seed=2)
    m = b.max_b + b.max_h + 1
    x_all = _rng(d).standard_normal((m, d)).astype(np.float32)
    edges = (J(b.edge_dst), J(b.edge_src))
    want = np.asarray(r_ops.gcn_aggregate(
        J(x_all), edges, J(b.edge_w), b.max_b,
        (J(b.forward.vals), J(b.forward.cols)), backend="interpret"))
    got = t_ops.gcn_aggregate(T(x_all), (T(b.edge_dst), T(b.edge_src)),
                              T(b.edge_w), b.max_b,
                              (T(b.forward.vals), T(b.forward.cols)))
    assert got.shape == (b.max_b, d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the COO path (full-graph forward) sums the same edges
    coo = t_ops.gcn_aggregate(T(x_all), (T(b.edge_dst), T(b.edge_src)),
                              T(b.edge_w), b.max_b)
    np.testing.assert_allclose(coo.numpy(), want, **TOL)


def test_gather_spmm_matches_pallas():
    _, b = _batch(seed=3)
    d, n_table = 128, 301
    rng = _rng(5)
    x_in = rng.standard_normal((b.max_b, d)).astype(np.float32)
    table = rng.standard_normal((n_table, d)).astype(np.float32)
    vals, cols = b.forward.vals, b.forward.cols
    plan = t_fused.gather_plan(T(cols), T(b.halo_nodes), T(b.halo_mask),
                               b.max_b, n_table)
    sel = plan[0].numpy()
    assert set(np.unique(sel)) == {0, 1, 2}
    want = np.asarray(r_fused.gather_spmm(
        J(x_in), J(table), J(vals), J(cols), *(J(p.numpy()) for p in plan),
        interpret=True))
    got = t_fused.gather_spmm(T(x_in), T(table), T(vals), T(cols), *plan)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    oracle = np.asarray(r_ref.gather_spmm_ref(
        J(x_in), J(table), J(b.halo_nodes), J(b.halo_mask), J(vals),
        J(cols)))
    np.testing.assert_allclose(got.numpy(), oracle, **TOL)


@pytest.mark.parametrize("d", [20, 256])
def test_gas_aggregate_matches_reference(d):
    _, b = _batch(seed=4)
    n_table = 301
    rng = _rng(d)
    x_in = rng.standard_normal((b.max_b, d)).astype(np.float32)
    table = rng.standard_normal((n_table, d)).astype(np.float32)
    blocks = (b.forward.vals, b.forward.cols, b.transposed.vals,
              b.transposed.cols)
    want = np.asarray(r_ops.gas_aggregate(
        J(x_in), J(table), J(b.halo_nodes), J(b.halo_mask), b.max_b,
        tuple(J(a) for a in blocks), backend="interpret"))
    got = t_ops.gas_aggregate(T(x_in), T(table), T(b.halo_nodes),
                              T(b.halo_mask), b.max_b,
                              (T(b.forward.vals), T(b.forward.cols)))
    assert got.shape == (b.max_b, d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_wrappers_launch_or_raise_off_cpu():
    """No quiet fallback: off the CPU a wrapper launches its kernel or
    raises (here on the meta device, which has no kernel), and the CPU
    path never counts a launch."""
    before = dict(_build.launch_counts)
    t_gather.gather_rows(torch.zeros(4, 8), torch.zeros(2, dtype=torch.int32))
    assert _build.launch_counts == before
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        t_gather.gather_rows(torch.zeros(4, 8, **meta),
                             torch.zeros(2, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        t_scatter.scatter_rows(torch.zeros(4, 8, **meta),
                               torch.zeros(2, dtype=torch.int32, **meta),
                               torch.zeros(2, 8, **meta))
    with pytest.raises(ValueError, match="tensors on"):
        t_bcsr.bcsr_spmm(torch.zeros(128, 8, **meta),
                         torch.zeros(1, 1, 128, 128),
                         torch.zeros(1, 1, dtype=torch.int32))
    assert _build.launch_counts == before
