"""PyTorch port, quantized (int8 and bf16) history stores against the JAX
reference.

The same numpy inputs go through both packages; the reference's Pallas
kernels run in interpret mode, as tests/test_quantized_history.py runs
them. Tolerances:

* bitwise: the int8 codec (`row_scales`, `quantize_rows`,
  `dequantize_rows`: one max, one division rounded as IEEE, rounding half
  to even, one multiply), the dequantizing pull and the quantizing push
  (codes and scales), the bf16 push and pull, the stores' push/pull, and
  checkpoints crossing between the packages;
* f32, rtol = atol = 1e-5: the block contractions over int8 and bf16
  tables and their gradient (the sums are taken in another order);
* the forward of a whole batch, 1e-4: logits, and `hist_quant_err` (a
  mean of row norms, summed in another order); pushed tables as
  dequantized values within one quantization step s_i per row (bf16: one
  bf16 ulp), with at least 99.9% of the codes equal, since a pushed value
  that lies a rounding away from a code's .5 boundary may round to either
  side.

Serving over an int8 store and two training epochs are in
test_torch_serve.py and test_torch_train.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")

from repro.core import history as r_hist
from repro.kernels import fused as r_fused
from repro.kernels import gather as r_gather
from repro.kernels import ops as r_ops
from repro.kernels import scatter as r_scatter

from repro_torch.core import gas as t_gas
from repro_torch.core import history as t_hist
from repro_torch.core.config import HistoryExecConfig
from repro_torch.data.graphs import citation_graph
from repro_torch.kernels import fused as t_fused
from repro_torch.kernels import gather as t_gather
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import scatter as t_scatter

TOL = dict(rtol=1e-5, atol=1e-5)
T = torch.from_numpy
J = jnp.asarray


def _rng(seed):
    return np.random.default_rng(seed)


def _tricky_rows(seed, m, d):
    """Rows that exercise the codec's edges: an all-zero row, a row of
    negative zeros with one value, rows whose v / s land exactly on .5
    (ties to even) and on +-127, a row that is max|v| everywhere, huge
    and tiny magnitudes, and normal rows."""
    rng = _rng(seed)
    v = rng.standard_normal((m, d)).astype(np.float32)
    v[0] = 0.0
    v[1] = -0.0
    v[1, d // 2] = 2.0
    v[2] = (rng.integers(-127, 127, d) + 0.5).astype(np.float32)
    v[2, 0] = 127.0                          # s = 1: v / s = v exactly
    v[3] = -127.0
    v[3, ::2] = 127.0
    v[4] *= 1e30
    v[5] *= 1e-30
    v[6] = 3.0 * (rng.integers(-127, 128, d) + 0.5).astype(np.float32)
    v[6, 0] = 381.0                          # s = 3: ties after division
    return v


# ---------------------------------------------------------------------------
# The codec registry and the int8 math
# ---------------------------------------------------------------------------

def test_codec_registry_matches_reference():
    """The same names, the same flags, storage types and table widths,
    and the reference's ValueError text for an unknown name."""
    assert t_hist.HISTORY_DTYPES == r_hist.HISTORY_DTYPES
    for name in ("f32", "bf16", "int8", "vq"):
        t, r = t_hist.get_codec(name), r_hist.get_codec(name)
        assert (t.lossless, t.scaled, t.vq) == (r.lossless, r.scaled, r.vq)
        assert t.storage.itemsize == jnp.dtype(r.storage).itemsize
        assert t.storage.is_floating_point == \
            jnp.issubdtype(r.storage, jnp.floating)
        assert t.table_width(64) == r.table_width(64)
    for bad in ("f16", "fp8", ""):
        with pytest.raises(ValueError) as want:
            r_hist.get_codec(bad)
        with pytest.raises(ValueError) as got:
            t_hist.get_codec(bad)
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError) as got:
            HistoryExecConfig(history_dtype=bad)
        assert str(got.value) == str(want.value)
    HistoryExecConfig(history_dtype="vq")


@pytest.mark.parametrize("seed,d", [(0, 8), (1, 20), (2, 128), (3, 257)])
def test_row_scales_and_quantize_rows_bitwise(seed, d):
    v = _tricky_rows(seed, 40, d)
    want_s = np.asarray(r_hist.row_scales(J(v)))
    want_q, want_qs = (np.asarray(a) for a in r_hist.quantize_rows(J(v)))
    got_s = t_hist.row_scales(T(v)).numpy()
    got_q, got_qs = (a.numpy() for a in t_hist.quantize_rows(T(v)))
    np.testing.assert_array_equal(got_s.view(np.int32),
                                  want_s.view(np.int32))
    np.testing.assert_array_equal(got_qs.view(np.int32),
                                  want_qs.view(np.int32))
    assert got_q.dtype == want_q.dtype == np.int8
    np.testing.assert_array_equal(got_q, want_q)
    assert got_s[0] == 1.0 and got_q[0].max() == 0           # zero row
    assert np.abs(got_q[2]).max() == 127 and np.abs(got_q[3]).min() == 127
    # the ties are rounded half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
    half = (v[2] % 1.0) == 0.5
    np.testing.assert_array_equal(got_q[2][half] % 2, 0)
    back = t_hist.dequantize_rows(T(got_q), T(got_s)).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(r_hist.dequantize_rows(J(want_q), J(want_s))))


@pytest.mark.parametrize("history_dtype", ["f32", "bf16", "int8"])
def test_quantization_error_matches_reference(history_dtype):
    v = _tricky_rows(4, 60, 32)
    v[4] = _rng(9).standard_normal(32)          # keep the norms finite
    mask = _rng(5).random(60) > 0.2
    want = float(r_hist.quantization_error(J(v), J(mask), history_dtype))
    got = float(t_hist.quantization_error(T(v), T(mask), history_dtype))
    if history_dtype == "f32":
        assert got == want == 0.0
    else:
        assert got > 0
        np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _int8_table(seed, n, d):
    rng = _rng(seed)
    q = rng.integers(-127, 128, (n, d)).astype(np.int8)
    s = (rng.random(n) * 0.1).astype(np.float32)
    return q, s


@pytest.mark.parametrize("d", [128, 256])
def test_gather_rows_dq_matches_pallas(d):
    """Bitwise, with duplicate ids and the sentinel row."""
    n = 71
    q, s = _int8_table(d, n, d)
    idx = _rng(d + 1).integers(0, n, 45).astype(np.int32)
    idx[::7] = n - 1
    idx[1::5] = idx[0]
    want = np.asarray(r_gather.gather_rows_dq(J(q), J(s), J(idx),
                                              interpret=True))
    got = t_gather.gather_rows_dq(T(q), T(s), T(idx))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [20, 256])
def test_pull_rows_dequantizes_like_reference(d):
    """Through the ops: out-of-range ids clipped, ragged D (the reference
    pads to 128 lanes, the port does not)."""
    n = 90
    q, s = _int8_table(d + 2, n, d)
    idx = _rng(d).integers(-5, 95, 41).astype(np.int32)
    want = np.asarray(r_ops.pull_rows(J(q), J(idx), scales=J(s),
                                      backend="interpret"))
    got = t_ops.pull_rows(T(q), T(idx), scales=T(s))
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_rows_q_matches_pallas():
    """The kernel's plain version against the reference's
    `scatter_rows_q` (codes) fed `row_scales`, and its scales against the
    reference's scale scatter: bitwise, with duplicate ids (last writer
    wins, codes and scale from the same row), ties and zero rows, and the
    sentinel row taking masked rows."""
    n, m, d = 61, 48, 128
    v = _tricky_rows(7, m, d)
    idx = _rng(8).integers(0, n - 1, m).astype(np.int32)
    idx[20:30] = idx[0:10]                         # duplicates
    idx[30:35] = n - 1                             # masked -> sentinel
    q0, s0 = _int8_table(9, n, d)
    want_q = np.asarray(r_scatter.scatter_rows_q(
        J(q0), J(idx), J(v), r_hist.row_scales(J(v)), interpret=True))
    want_s = np.asarray(J(s0).at[J(idx)].set(r_hist.row_scales(J(v))))
    q, s = T(q0.copy()), T(s0.copy())
    got_q, got_s, got_e = t_scatter.scatter_rows_q(q, s, T(idx), T(v))
    assert got_q is q and got_s is s
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    # every pushed row's relative error, duplicates and sentinel rows too:
    # each row alone is the reference's quantization_error of that row
    assert got_e.shape == (m,)
    one = np.ones(1, bool)
    for i in range(m):
        np.testing.assert_allclose(
            float(got_e[i]), float(r_hist.quantization_error(
                J(v[i:i + 1]), J(one), "int8")), rtol=1e-6, atol=1e-12)
    # one owner per target: each written row is the last pusher's codes
    for t in np.unique(idx):
        last = np.flatnonzero(idx == t)[-1]
        wq, ws = (a.numpy() for a in t_ref.quantize_rows(T(v[last:last + 1])))
        np.testing.assert_array_equal(got_q.numpy()[t], wq[0])
        assert got_s.numpy()[t] == ws[0]


@pytest.mark.parametrize("scratch", [True, False])
@pytest.mark.parametrize("d", [20, 128])
def test_push_rows_q_matches_reference(scratch, d):
    """The quantizing push through the ops, masked rows dropped or sent to
    the sacrificial last row, against the reference's interpret kernel
    path; the pushes' codes and scales compare bitwise."""
    n = 61
    v = _tricky_rows(d, 40, d)
    rng = _rng(d + 3)
    idx = rng.integers(0, n - 2, 40).astype(np.int32)
    idx[25:30] = idx[0:5]
    mask = rng.random(40) < 0.8
    q0, s0 = _int8_table(d, n, d)
    want_q, want_s = (np.asarray(a) for a in r_ops.push_rows_q(
        J(q0), J(s0), J(idx), J(v), J(mask), backend="interpret",
        scratch_last_row=scratch))
    got_q, got_s, _ = t_ops.push_rows_q(T(q0.copy()), T(s0.copy()), T(idx),
                                        T(v), T(mask),
                                        scratch_last_row=scratch)
    rows = n - 1 if scratch else n
    np.testing.assert_array_equal(got_q.numpy()[:rows], want_q[:rows])
    np.testing.assert_array_equal(got_s.numpy()[:rows], want_s[:rows])


def test_bf16_push_and_pull_match_reference():
    """A bf16 table: the push rounds to bf16 as the reference's astype
    (nearest, ties to even), the pull returns bf16 rows; bitwise."""
    n, d = 61, 128
    rng = _rng(11)
    table = rng.standard_normal((n, d)).astype(np.float32)
    v = rng.standard_normal((40, d)).astype(np.float32)
    v[0, :8] = [1.00390625, 1.01171875, -1.00390625, 3e38, 1e-40, 0.0,
                -0.0, 65504.0]                 # ties, overflow, subnormals
    idx = rng.integers(0, n - 2, 40).astype(np.int32)
    idx[30:35] = idx[0:5]
    mask = rng.random(40) < 0.8
    want = r_ops.push_rows(J(table).astype(jnp.bfloat16), J(idx), J(v),
                           J(mask), backend="interpret",
                           scratch_last_row=True)
    got = t_ops.push_rows(T(table).to(torch.bfloat16), T(idx), T(v),
                          T(mask), scratch_last_row=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy()[:n - 1],
                                  np.asarray(want, np.float32)[:n - 1])
    pidx = rng.integers(0, n, 33).astype(np.int32)
    want_p = r_ops.pull_rows(want, J(pidx), backend="interpret")
    got_p = t_ops.pull_rows(got, T(pidx))
    assert got_p.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_p[:, :].float().numpy()[pidx < n - 1],
                                  np.asarray(want_p, np.float32)[pidx < n - 1])


def _batch(seed=0, n=300, f=20, n_q=60, drop_halo=0.25):
    """A real training-style batch (forward and transposed blocks) with
    some halo slots masked, so the gather plan routes rows from x_in, the
    table, and zeros."""
    g = citation_graph(num_nodes=n, avg_degree=4.5, num_features=f,
                       num_classes=3, seed=seed)
    csr = t_gas.weighted_in_csr(g)
    nodes = np.sort(_rng(seed).choice(n, n_q, replace=False))
    b = t_gas.subgraph_batch(*csr, n, nodes, build_blocks=True)
    hm = b.halo_mask & (_rng(seed + 1).random(b.max_h) > drop_halo)
    return b.replace(halo_mask=hm)


def _quantized(dtype, rows):
    """(table, scales) of f32 rows stored as `dtype`: numpy for the
    reference (bf16 as jnp), torch for the port."""
    if dtype == "int8":
        q, s = (a.numpy() for a in t_ref.quantize_rows(T(rows)))
        return (J(q), J(s)), (T(q), T(s))
    if dtype == "bf16":
        return ((J(rows).astype(jnp.bfloat16), None),
                (T(rows).to(torch.bfloat16), None))
    return (J(rows), None), (T(rows), None)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_gather_spmm_quantized_matches_pallas(dtype):
    """The plain version's int8 body and bf16 table against the
    reference's fused kernel (int8 body `_make_kernel_dq`; the f32 body
    over a bf16 table) in interpret mode, f32 tolerance."""
    b = _batch(seed=3)
    d, n_table = 128, 301
    rng = _rng(5)
    x_in = rng.standard_normal((b.max_b, d)).astype(np.float32)
    rows = rng.standard_normal((n_table, d)).astype(np.float32)
    (rt, rs), (tt, ts) = _quantized(dtype, rows)
    vals, cols = b.forward.vals, b.forward.cols
    plan = t_fused.gather_plan(T(cols), T(b.halo_nodes), T(b.halo_mask),
                               b.max_b, n_table)
    assert set(np.unique(plan[0].numpy())) == {0, 1, 2}
    want = np.asarray(r_fused.gather_spmm(
        J(x_in), rt, J(vals), J(cols), *(J(p.numpy()) for p in plan),
        rs, interpret=True))
    got = t_fused.gather_spmm(T(x_in), tt, T(vals), T(cols), *plan,
                              scales=ts)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("d", [20, 256])
def test_gas_aggregate_int8_matches_reference(d):
    """`gas_aggregate` over an int8 table against the reference's
    interpret backend, and its gradient with respect to x_in against
    `jax.grad` (the table and its scales get none)."""
    b = _batch(seed=4)
    n_table = 301
    rng = _rng(d)
    x_in = rng.standard_normal((b.max_b, d)).astype(np.float32)
    q, s = (a.numpy() for a in t_ref.quantize_rows(
        T(rng.standard_normal((n_table, d)).astype(np.float32))))
    g_out = rng.standard_normal((b.max_b, d)).astype(np.float32)
    blocks = (b.forward.vals, b.forward.cols, b.transposed.vals,
              b.transposed.cols)

    def r_fn(x):
        out = r_ops.gas_aggregate(x, J(q), J(b.halo_nodes), J(b.halo_mask),
                                  b.max_b, tuple(J(a) for a in blocks),
                                  scales=J(s), backend="interpret")
        return jnp.sum(out * J(g_out)), out

    (_, want), want_g = jax.value_and_grad(r_fn, has_aux=True)(J(x_in))
    x = T(x_in.copy()).requires_grad_(True)
    got = t_ops.gas_aggregate(x, T(q), T(b.halo_nodes), T(b.halo_mask),
                              b.max_b, tuple(T(a) for a in blocks),
                              scales=T(s))
    (got_g,) = torch.autograd.grad((got * T(g_out)).sum(), (x,))
    assert got.shape == (b.max_b, d)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)


# ---------------------------------------------------------------------------
# HistoryStore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("history_dtype", ["int8", "bf16"])
def test_history_store_matches_reference(history_dtype):
    """create / push / pull / bytes / clone against the reference's store
    on "jnp", bitwise: three pushes with duplicates and masked rows, then
    pulls of every row (the sentinel row, which takes masked pushes, left
    out)."""
    n, dims = 50, [16, 24]
    rs = r_hist.HistoryStore.create(n + 1, dims, backend="jnp",
                                    history_dtype=history_dtype)
    ts = t_hist.HistoryStore.create(n + 1, dims, history_dtype, "cpu")
    assert ts.bytes() == rs.bytes()
    assert (ts.scales is None) == (rs.scales is None)
    rng = _rng(2)
    for step in range(3):
        for ell, d in enumerate(dims):
            v = _tricky_rows(step * 7 + ell, 30, d)
            v[4:6] = rng.standard_normal((2, d))
            idx = rng.integers(0, n, 30).astype(np.int32)
            idx[20:25] = idx[:5]
            mask = rng.random(30) > 0.2
            rs = rs.push(ell, J(idx), J(v), J(mask))
            assert ts.push(ell, T(idx), T(v), T(mask)) is ts
    every = np.arange(n, dtype=np.int32)
    for ell in range(len(dims)):
        want = np.asarray(rs.pull(ell, J(every)).astype(jnp.float32))
        got = ts.pull(ell, T(every))
        assert got.dtype == (torch.bfloat16 if history_dtype == "bf16"
                             else torch.float32)
        np.testing.assert_array_equal(got.float().numpy(), want)
        if history_dtype == "int8":
            np.testing.assert_array_equal(ts.tables[ell].numpy()[:n],
                                          np.asarray(rs.tables[ell])[:n])
            np.testing.assert_array_equal(ts.layer_scales(ell).numpy()[:n],
                                          np.asarray(rs.scales[ell])[:n])
    copy = ts.clone()
    ts.push(0, T(every[:3]), T(np.ones((3, 16), np.float32)),
            T(np.ones(3, bool)))
    assert not torch.equal(copy.pull(0, T(every[:3])),
                           ts.pull(0, T(every[:3])))
    v = _rng(3).standard_normal((20, 16)).astype(np.float32)
    m = np.ones(20, bool)
    np.testing.assert_allclose(float(ts.quant_error(T(v), T(m))),
                               float(rs.quant_error(J(v), J(m))), rtol=1e-5)


@pytest.mark.parametrize("history_dtype", ["f32", "bf16", "int8"])
def test_push_measured_matches_reference_quant_error(history_dtype):
    """`push_measured` pushes as `push` does (the same tables, bitwise)
    and returns the reference's `quant_error` of the pushed rows over the
    mask (rtol 1e-6: the int8 row errors come from the push's own pass);
    None for an f32 store, whose term is exactly 0."""
    n, d = 40, 24
    rs = r_hist.HistoryStore.create(n + 1, [d], backend="jnp",
                                    history_dtype=history_dtype)
    ts = t_hist.HistoryStore.create(n + 1, [d], history_dtype, "cpu")
    twin = t_hist.HistoryStore.create(n + 1, [d], history_dtype, "cpu")
    # activation-sized rows and a zero row (the tricky rows' huge values
    # square past f32's range: the error is NaN in both packages)
    v = _rng(5).standard_normal((30, d)).astype(np.float32)
    v[3] = 0.0
    idx = _rng(6).integers(0, n, 30).astype(np.int32)
    idx[20:25] = idx[:5]
    mask = _rng(7).random(30) > 0.3
    got = ts.push_measured(0, T(idx), T(v), T(mask))
    twin.push(0, T(idx), T(v), T(mask))
    rs = rs.push(0, J(idx), J(v), J(mask))
    every = T(np.arange(n, dtype=np.int32))
    assert torch.equal(ts.pull(0, every), twin.pull(0, every))
    want = float(rs.quant_error(J(v), J(mask)))
    if history_dtype == "f32":
        assert got is None and want == 0.0
    else:
        assert want > 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# gas_batch_forward over quantized stores
# ---------------------------------------------------------------------------

def _forward_case(op, history_dtype, fuse_halo):
    from repro.core import runtime as r_rt
    from repro.data.graphs import citation_graph as r_citation
    from repro.gnn import model as r_model
    from repro_torch.core import runtime as t_rt
    from repro_torch.gnn import model as t_model
    from repro_torch.train.checkpoint import params_from_numpy

    kw = dict(num_nodes=300, num_features=12, num_classes=3, seed=0)
    spec_kw = dict(op=op, d_in=12, d_hidden=16, num_classes=3, num_layers=3,
                   heads=2)
    rplan = r_rt.build_plan(r_citation(**kw), r_model.GNNSpec(**spec_kw),
                            r_rt.GASConfig(num_parts=4, backend="interpret",
                                           history_dtype=history_dtype,
                                           fuse_halo=fuse_halo))
    tplan = t_rt.build_plan(citation_graph(**kw), t_model.GNNSpec(**spec_kw),
                            t_rt.GASConfig(num_parts=4, fuse_halo=fuse_halo,
                                           history_dtype=history_dtype),
                            device="cpu")
    rstate = r_rt.init_state(rplan)
    flat = {f"layers/{i}/{k}": np.asarray(v)
            for i, layer in enumerate(rstate.params["layers"])
            for k, v in layer.items()}
    tstate = t_rt.init_state(tplan, params=params_from_numpy(flat, "cpu"))
    return r_model, t_model, rplan, rstate, tplan, tstate


def _assert_store_close(rs, ts, n):
    """Pushed tables as dequantized values within one step per row (int8:
    s_i, and 1e-5 of it for the scales' rounding; bf16: one bf16 step at
    the larger magnitude plus 1e-4 for the f32 sums under the rounding),
    and >= 99.9% of the stored codes equal."""
    every = np.arange(n, dtype=np.int32)
    for ell in range(ts.num_layers):
        want = np.asarray(rs.pull(ell, J(every)).astype(jnp.float32))
        got = ts.pull(ell, T(every)).float().numpy()
        step = (np.asarray(rs.scales[ell])[:n, None] if rs.scales is not None
                else np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7 + 1e-4)
        # one step, and the scale's own rounding (its row max is a sum of
        # products taken in another order): 1e-5 of a step
        assert np.all(np.abs(got - want) <= step * (1 + 1e-5))
        same = np.mean(ts.tables[ell].float().numpy()[:n]
                       == np.asarray(rs.tables[ell], np.float32)[:n])
        assert same >= 0.999, same


@pytest.mark.parametrize("history_dtype", ["int8", "bf16"])
@pytest.mark.parametrize("op,fuse_halo", [("gcn", True), ("gcn", False),
                                          ("gat", True)])
def test_gas_batch_forward_quantized_matches_reference(op, fuse_halo,
                                                       history_dtype):
    """Three layers (two history tables) over every batch in turn: the
    fused (GCN), materialized (GCN, fuse_halo=False) and halo-split (GAT)
    routes, each reading the tables the earlier batches pushed. Logits
    and `hist_quant_err` at 1e-4, tables per `_assert_store_close`."""
    r_model, t_model, rplan, rstate, tplan, tstate = _forward_case(
        op, history_dtype, fuse_halo)
    rs, ts = rstate.histories, tstate.histories
    with torch.no_grad():
        for b in range(tplan.batches.num_batches):
            rl, rs, _, rd = r_model.gas_batch_forward(
                rstate.params, rplan.spec, rplan.x, rplan.batch(b), rs,
                backend="interpret", fuse_halo=fuse_halo)
            tl, ts, td = t_model.gas_batch_forward(
                tstate.params, tplan.spec, tplan.x, tplan.batch(b), ts,
                fuse_halo=fuse_halo)
            np.testing.assert_allclose(tl.numpy(), np.asarray(rl),
                                       rtol=1e-4, atol=1e-4)
            assert float(td["hist_quant_err"]) > 0
            np.testing.assert_allclose(float(td["hist_quant_err"]),
                                       float(rd["hist_quant_err"]),
                                       rtol=1e-4)
            np.testing.assert_array_equal(ts.age.numpy(), np.asarray(rs.age))
    _assert_store_close(rs, ts, tplan.graph.num_nodes)


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("history_dtype", ["int8", "bf16"])
def test_quantized_checkpoints_cross_both_ways(history_dtype, tmp_path):
    """A reference int8 or bf16 checkpoint read by the port, and the
    port's written back and read by the reference, bitwise (bf16 widened
    to f32 on disk by both)."""
    from repro.core import runtime as r_rt
    from repro.train import checkpoint as r_ckpt
    from repro_torch.core import runtime as t_rt
    from repro_torch.train import checkpoint as t_ckpt

    r_model, _, rplan, rstate, tplan, tstate = _forward_case(
        "gcn", history_dtype, True)
    rstate, _ = r_rt.train_step(rplan, rstate, rplan.batch(1))
    path = str(tmp_path / "ref.npz")
    meta = {"args": {"history_dtype": history_dtype}}
    r_ckpt.save_gas_state(path, rstate, step=3, meta=meta)
    back, step = t_ckpt.load_gas_state(path, device="cpu")
    assert step == 3 and back.histories.history_dtype == history_dtype
    for ell, t in enumerate(back.histories.tables):
        assert t.dtype == t_hist.get_codec(history_dtype).storage
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(rstate.histories.tables[ell],
                                          np.float32))
    if history_dtype == "int8":
        for a, b in zip(back.histories.scales, rstate.histories.scales):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the port's writer, read by the reference's loader: the same arrays
    out = str(tmp_path / "port.npz")
    t_rt.train_step(tplan, back, tplan.batch(2))
    t_ckpt.save_gas_state(out, back, step=4, meta=meta)
    restored, step = r_ckpt.load_gas_state(out, r_rt.init_state(rplan))
    assert step == 4
    want = {k: np.asarray(v) for k, v in r_ckpt._flatten(restored).items()}
    with np.load(out) as data:
        keys = [k for k in data.files if k.startswith("state/")]
        assert sorted(k[6:] for k in keys) == sorted(want)
        for k in keys:
            assert data[k].dtype == want[k[6:]].dtype, k
            np.testing.assert_array_equal(data[k], want[k[6:]], err_msg=k)
    # without meta, an int8 file is told by its scale tables
    t_ckpt.save_gas_state(out, back, step=4)
    _, store, _ = t_ckpt.load_gas_state_npz(out, device="cpu")
    assert store.history_dtype == ("int8" if history_dtype == "int8"
                                   else "f32")
    with pytest.raises(ValueError, match="scale tables"):
        t_ckpt.load_gas_state_npz(out, device="cpu",
                                  history_dtype="bf16" if history_dtype ==
                                  "int8" else "int8")


def test_store_bytes_and_compression():
    """bytes() counts the scale tables, as the reference's
    `bytes_per_table`: bf16 halves the f32 store, int8 with its scales
    comes to ~3.9x at d = 64."""
    n, dims = 2500, [64]
    sizes = {hd: t_hist.HistoryStore.create(n + 1, dims, hd, "cpu").bytes()
             for hd in ("f32", "bf16", "int8")}
    for hd, b in sizes.items():
        assert b == r_hist.HistoryStore.create(
            n + 1, dims, backend="jnp", history_dtype=hd).bytes()
    assert sizes["f32"] == 2 * sizes["bf16"]
    assert 3.7 < sizes["f32"] / sizes["int8"] < 4.0

