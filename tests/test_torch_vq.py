"""PyTorch port, vq (codebook-quantized) history stores against the JAX
reference.

The same numpy inputs go through both packages; the reference's Pallas
kernels run in interpret mode, as tests/test_quantized_history.py runs
them, and its initial codebooks are carried across (they are drawn from
`jax.random`; the port's `vq_init_codebook` draws the same distribution
from a `torch.Generator`). Tolerances:

* bitwise: the codec (`vq_row_scales`, `vq_encode_rows`, `vq_decode_rows`:
  one max, one division, distances summed left to right over the 8
  components, the first minimum, one multiply), the decoding pull and the
  encoding push (codes and scales, with duplicates, masked rows, zero
  rows and rows a few ulps from a two-entry tie), the store's pushes and
  pulls, a refit from the same statistics, and checkpoints crossing
  between the packages;
* the k-means statistics: counts exact, sums at 1e-5 (the one-hot sums
  are taken in another order); the refit codebook at 1e-6 from the
  reference's statistics, entry 0 exactly zero;
* f32, rtol = atol = 1e-5: the block contraction over a vq table and its
  gradient;
* training steps (GCN, GAT, PNA; two steps from the reference's params
  and codebook): loss and gradients at 1e-4, the pushed codes >= 99.9%
  equal, and every code that differs a near-tie: its two entries'
  distances within 1e-6 of each other for the pushed row (a pushed value
  that differs in its last bits may land on either side);
* serving at SLO=0 against the reference's `serve_request` on the same vq
  store: logits at 1e-4, the store's codes >= 99.9% equal."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")
import _torch_threads  # noqa: E402  one torch thread a test process

from repro.core import history as r_hist
from repro.core import runtime as r_rt
from repro.core import serve as r_serve
from repro.data.graphs import citation_graph as r_citation
from repro.gnn import model as r_model
from repro.kernels import fused as r_fused
from repro.kernels import gather as r_gather
from repro.kernels import ops as r_ops
from repro.kernels import scatter as r_scatter
from repro.train import checkpoint as r_ckpt

from repro_torch.core import gas as t_gas
from repro_torch.core import history as t_hist
from repro_torch.core import runtime as t_rt
from repro_torch.core import serve as t_serve
from repro_torch.data.graphs import citation_graph as t_citation
from repro_torch.gnn import model as t_model
from repro_torch.kernels import fused as t_fused
from repro_torch.kernels import gather as t_gather
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import scatter as t_scatter
from repro_torch.train import checkpoint as t_ckpt
from test_torch_train import _carry, _plans, _ref_grads

TOL = dict(rtol=1e-5, atol=1e-5)
STEP = dict(rtol=1e-4, atol=1e-4)
T = torch.from_numpy
J = jnp.asarray


def _rng(seed):
    return np.random.default_rng(seed)


def _codebook(d):
    """The reference's initial codebook for width d, as numpy."""
    return np.asarray(r_hist.vq_init_codebook(d))


def _rows(seed, m, d, cb):
    """Rows that exercise the encode: random rows, an all-zero row, a row
    of negative zeros with one value, huge and tiny magnitudes, and rows
    whose subvectors sit at the midpoint of two entries (the row's max is
    1.0 in its last subvector, so v / s = v exactly), moved by 0 to 3 ulps
    per component."""
    rng = _rng(seed)
    s_n = d // 8
    v = rng.standard_normal((m, d)).astype(np.float32)
    v[0] = 0.0
    v[1] = -0.0
    v[1, d // 2] = -3.0
    v[2] *= 1e30
    v[3] *= 1e-30
    for i in range(4, m, 2):
        a, b = rng.choice(256, size=(2, s_n), replace=True)
        mid = ((cb[np.arange(s_n), a] + cb[np.arange(s_n), b]) / 2.0
               ).astype(np.float32)
        for _ in range(i % 4):                  # 0 or 2 ulps, per row
            step = np.where(rng.random(mid.shape) < 0.5, -np.inf, np.inf)
            mid = np.nextafter(mid, step.astype(np.float32))
        row = mid.reshape(d)
        row[-1] = 1.0
        v[i] = row
    return v


def _near_tie(u, cb, a, b):
    """|d(u, cb[a]) - d(u, cb[b])| per subvector, distances summed left to
    right in f32 as the encode sums them."""
    def dist(c):
        acc = np.zeros(u.shape[0], np.float32)
        for j in range(u.shape[1]):
            diff = (u[:, j] - c[:, j]).astype(np.float32)
            acc = (acc + diff * diff).astype(np.float32)
        return acc
    return np.abs(dist(a) - dist(b))


# ---------------------------------------------------------------------------
# The codec and its helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [16, 48, 64])
def test_vq_encode_decode_bitwise(d):
    """Codes and scales of the encode, and the decode, bitwise against the
    reference's `vq_encode_rows` / `vq_decode_rows`, on random rows, zero
    rows, extreme magnitudes and rows within a few ulps of a tie."""
    cb = _codebook(d)
    v = _rows(d, 300, d, cb)
    want_q, want_s = (np.asarray(a) for a in r_hist.vq_encode_rows(J(v),
                                                                    J(cb)))
    got_q, got_s = t_hist.vq_encode_rows(T(v), T(cb))
    assert got_q.dtype == torch.uint8 and got_q.shape == (300, d // 8)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  want_s.view(np.int32))
    np.testing.assert_array_equal(
        t_hist.vq_row_scales(T(v)).numpy(),
        np.asarray(r_hist.vq_row_scales(J(v))))
    assert got_s[0] == 1.0 and int(got_q[0].max()) == 0     # zero row
    # the tie rows split between the two entries, both ways
    assert len(np.unique(want_q[4::2])) > 1
    back = t_hist.vq_decode_rows(got_q, T(cb), got_s).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(r_hist.vq_decode_rows(J(want_q), J(cb),
                                               J(want_s))))
    assert np.all(back[0] == 0.0)               # entry 0 is the zero row


def test_vq_table_width_and_init_codebook():
    """The reference's error text word for word; the initial codebook's
    shape, range and pinned zero entry, the same for every call."""
    for d in (4, 12, 20):
        with pytest.raises(ValueError) as want:
            r_hist.vq_table_width(d)
        with pytest.raises(ValueError) as got:
            t_hist.vq_table_width(d)
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError) as got:
            t_hist.HistoryStore.create(8, [d], "vq", "cpu")
        assert str(got.value) == str(want.value)
    assert t_hist.vq_table_width(48) == r_hist.vq_table_width(48) == 6
    assert (t_hist.VQ_SUBDIM, t_hist.VQ_CODES, t_hist.VQ_SEED) == \
        (r_hist.VQ_SUBDIM, r_hist.VQ_CODES, r_hist.VQ_SEED)
    cb = t_hist.vq_init_codebook(64, device="cpu")
    assert cb.shape == _codebook(64).shape == (8, 256, 8)
    assert cb.dtype == torch.float32
    assert torch.all(cb[:, 0] == 0) and cb.abs().max() <= 1.0
    assert cb[:, 1:].abs().min() > 0
    assert torch.equal(cb, t_hist.vq_init_codebook(64, device="cpu"))


def test_vq_accumulate_stats_matches_reference():
    """Counts exact, sums at 1e-5, with masked rows and duplicate codes."""
    rng = _rng(3)
    m, d = 120, 48
    cb = _codebook(d)
    v = _rows(4, m, d, cb)
    v[2] = rng.standard_normal(d)               # keep the values finite
    codes, scales = r_hist.vq_encode_rows(J(v), J(cb))
    mask = rng.random(m) > 0.25
    counts0 = rng.integers(0, 5, (d // 8, 256)).astype(np.float32)
    sums0 = rng.standard_normal((d // 8, 256, 8)).astype(np.float32)
    want_c, want_s = r_hist.vq_accumulate_stats(
        codes, J(v), scales, J(mask), J(counts0), J(sums0))
    got_c, got_s = t_hist.vq_accumulate_stats(
        T(np.asarray(codes)), T(v), T(np.asarray(scales)), T(mask),
        T(counts0), T(sums0))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


def test_vq_refit_codebook_matches_reference():
    """The M-step from the reference's statistics at 1e-6 (entries
    without assignments stay put), entry 0 exactly zero."""
    rng = _rng(5)
    cb = _codebook(32)
    counts = rng.integers(0, 4, (4, 256)).astype(np.float32)
    counts[:, 0] = 3.0                          # entry 0 hit, still pinned
    sums = rng.standard_normal((4, 256, 8)).astype(np.float32)
    want = np.asarray(r_hist.vq_refit_codebook(J(cb), J(counts), J(sums)))
    got = t_hist.vq_refit_codebook(T(cb), T(counts), T(sums)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.all(got[:, 0] == 0.0)
    np.testing.assert_array_equal(got[counts == 0], cb[counts == 0])


def test_vq_codec_registry_and_quantization_error():
    t, r = t_hist.get_codec("vq"), r_hist.get_codec("vq")
    assert (t.lossless, t.scaled, t.vq) == (r.lossless, r.scaled, r.vq)
    assert t.table_width(64) == r.table_width(64) == 8
    cb = _codebook(32)
    v = _rng(6).standard_normal((50, 32)).astype(np.float32)
    mask = _rng(7).random(50) > 0.2
    q, s = t_hist.vq_encode_rows(T(v), T(cb))
    wq, ws = r.encode(J(v), J(cb))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(t.roundtrip(T(v), T(cb)).numpy(),
                                  np.asarray(r.roundtrip(J(v), J(cb))))
    np.testing.assert_allclose(
        float(t_hist.quantization_error(T(v), T(mask), "vq", T(cb))),
        float(r_hist.quantization_error(J(v), J(mask), "vq", J(cb))),
        rtol=1e-5)


# ---------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _vq_table(seed, n, d):
    rng = _rng(seed)
    q = rng.integers(0, 256, (n, d // 8)).astype(np.uint8)
    s = (rng.random(n) * 3.0).astype(np.float32)
    return q, s


@pytest.mark.parametrize("d", [16, 64])
def test_gather_rows_vq_matches_pallas(d):
    """Bitwise, with duplicate ids and the sentinel row; the port's rows
    are exactly d wide (the reference pads them to 128 lanes). Through
    the ops too, with out-of-range ids clipped."""
    n = 71
    cb = _codebook(d)
    q, s = _vq_table(d, n, d)
    idx = _rng(d + 1).integers(0, n, 45).astype(np.int32)
    idx[::7] = n - 1
    idx[1::5] = idx[0]
    want = np.asarray(r_gather.gather_rows_vq(J(q), J(cb), J(s), J(idx),
                                              interpret=True))
    assert want.shape[1] % 128 == 0 and np.all(want[:, d:] == 0)
    got = t_gather.gather_rows_vq(T(q), T(cb), T(s), T(idx))
    assert got.shape == (45, d) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want[:, :d])
    idx = _rng(d).integers(-5, 80, 41).astype(np.int32)
    want = np.asarray(r_ops.pull_rows(J(q), J(idx), scales=J(s),
                                      codebook=J(cb), backend="interpret"))
    got = t_ops.pull_rows(T(q), T(idx), scales=T(s), codebook=T(cb))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [16, 64])
def test_scatter_rows_vq_matches_pallas(d):
    """The plain version's table codes against the reference's
    `scatter_rows_vq` fed `vq_row_scales`, and its scales against the
    reference's scale scatter: bitwise, with duplicate ids (last writer
    wins, codes and scale from one row), zero rows, extreme magnitudes and
    the sentinel row taking masked rows. Every pushed row's codes are the
    reference's `vq_encode_rows`; its error the reference's quantization
    error of that row (rtol 1e-6)."""
    n, m = 61, 48
    cb = _codebook(d)
    v = _rng(d + 7).standard_normal((m, d)).astype(np.float32)
    v[0] = 0.0
    v[1, :] = -0.0
    v[1, 3] = 2.0
    v[2] *= 1e15                                # squares stay normal
    v[3] *= 1e-15
    idx = _rng(8).integers(0, n - 1, m).astype(np.int32)
    idx[20:30] = idx[0:10]                      # duplicates
    idx[30:35] = n - 1                          # masked -> sentinel
    q0, s0 = _vq_table(9, n, d)
    scales = r_hist.vq_row_scales(J(v))
    want_q = np.asarray(r_scatter.scatter_rows_vq(
        J(q0), J(idx), J(v), scales, J(cb), interpret=True))
    want_s = np.asarray(J(s0).at[J(idx)].set(scales))
    q, s = T(q0.copy()), T(s0.copy())
    got_q, got_s, codes, err = t_scatter.scatter_rows_vq(q, s, T(idx), T(v),
                                                         T(cb))
    assert got_q is q and got_s is s
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(r_hist.vq_encode_rows(J(v), J(cb))[0]))
    one = np.ones(1, bool)
    for i in range(m):
        np.testing.assert_allclose(
            float(err[i]), float(r_hist.quantization_error(
                J(v[i:i + 1]), J(one), "vq", J(cb))), rtol=1e-6,
            atol=1e-12)


def test_scatter_rows_vq_at_ties_follows_the_reference_encode():
    """Rows built within a few ulps of two-entry ties: the plain version's
    codes are bitwise the reference's `vq_encode_rows` (distances summed
    left to right). The reference's Pallas kernel in interpret mode sums
    its [S, C, 8] distances in another order and disagrees with its own
    `vq_encode_rows` on a few of these codes: each such code is a tie to
    within 1e-6 under the left-to-right sums, and on every other code the
    two kernels agree."""
    d, m = 64, 120
    cb = _codebook(d)
    v = _rows(71, m, d, cb)[4:]
    idx = np.arange(v.shape[0], dtype=np.int32)
    scales = r_hist.vq_row_scales(J(v))
    q0 = np.zeros((v.shape[0] + 1, d // 8), np.uint8)
    pallas = np.asarray(r_scatter.scatter_rows_vq(
        J(q0), J(idx), J(v), scales, J(cb), interpret=True))[:-1]
    encode = np.asarray(r_hist.vq_encode_rows(J(v), J(cb))[0])
    got = t_scatter.scatter_rows_vq(T(q0.copy()), T(np.ones(len(q0),
                                                            np.float32)),
                                    T(idx), T(v), T(cb))[0].numpy()[:-1]
    np.testing.assert_array_equal(got, encode)
    rows, subs = np.nonzero(pallas != encode)
    assert len(rows) < 0.05 * encode.size
    u = (v / np.asarray(scales)[:, None]).reshape(len(v), -1, 8)
    for r, s in zip(rows, subs):
        gap = _near_tie(u[r, s][None], cb[s], cb[s, pallas[r, s]][None],
                        cb[s, encode[r, s]][None])
        assert gap[0] <= 1e-6, (r, s, gap)


@pytest.mark.parametrize("scratch", [True, False])
def test_push_rows_vq_matches_reference(scratch):
    """The encoding push through the ops, masked rows dropped or sent to
    the sacrificial last row, against the reference's interpret kernel
    path; codes and scales bitwise."""
    n, d = 61, 48
    cb = _codebook(d)
    v = _rows(11, 40, d, cb)
    v[2:4] = 1.0
    rng = _rng(12)
    idx = rng.integers(0, n - 2, 40).astype(np.int32)
    idx[25:30] = idx[0:5]
    mask = rng.random(40) < 0.8
    q0, s0 = _vq_table(13, n, d)
    want_q, want_s = (np.asarray(a) for a in r_ops.push_rows_vq(
        J(q0), J(s0), J(idx), J(v), J(mask), J(cb), backend="interpret",
        scratch_last_row=scratch))
    got_q, got_s, codes, err = t_ops.push_rows_vq(
        T(q0.copy()), T(s0.copy()), T(idx), T(v), T(mask), T(cb),
        scratch_last_row=scratch)
    rows = n - 1 if scratch else n
    np.testing.assert_array_equal(got_q.numpy()[:rows], want_q[:rows])
    np.testing.assert_array_equal(got_s.numpy()[:rows], want_s[:rows])
    assert codes.shape == (40, d // 8) and err.shape == (40,)


def _batch(seed=0, n=300, f=20, n_q=60, drop_halo=0.25):
    """A training-style batch (forward and transposed blocks) with some
    halo slots masked, so the gather plan routes rows from x_in, the
    table and zeros."""
    g = t_citation(num_nodes=n, avg_degree=4.5, num_features=f,
                   num_classes=3, seed=seed)
    csr = t_gas.weighted_in_csr(g)
    nodes = np.sort(_rng(seed).choice(n, n_q, replace=False))
    b = t_gas.subgraph_batch(*csr, n, nodes, build_blocks=True)
    hm = b.halo_mask & (_rng(seed + 1).random(b.max_h) > drop_halo)
    return b.replace(halo_mask=hm)


@pytest.mark.parametrize("d", [48, 64])
def test_gather_spmm_vq_matches_pallas(d):
    """The plain version's vq body against the reference's fused kernel
    (`_make_kernel_vq`) in interpret mode at f32 tolerance; the reference
    takes x_in padded to 128 lanes, and its extra columns are zeros."""
    b = _batch(seed=3)
    n_table = 301
    rng = _rng(5)
    cb = _codebook(d)
    x_in = rng.standard_normal((b.max_b, d)).astype(np.float32)
    q, s = _vq_table(6, n_table, d)
    vals, cols = b.forward.vals, b.forward.cols
    plan = t_fused.gather_plan(T(cols), T(b.halo_nodes), T(b.halo_mask),
                               b.max_b, n_table)
    assert set(np.unique(plan[0].numpy())) == {0, 1, 2}
    x_pad = np.pad(x_in, ((0, 0), (0, 128 - d)))
    want = np.asarray(r_fused.gather_spmm(
        J(x_pad), J(q), J(vals), J(cols), *(J(p.numpy()) for p in plan),
        J(s), J(cb), interpret=True))
    assert np.all(want[:, d:] == 0)
    got = t_fused.gather_spmm(T(x_in), T(q), T(vals), T(cols), *plan,
                              scales=T(s), codebook=T(cb))
    assert got.shape == (vals.shape[0] * 128, d)
    np.testing.assert_allclose(got.numpy(), want[:, :d], **TOL)


@pytest.mark.parametrize("d", [16, 64])
def test_gas_aggregate_vq_matches_reference(d):
    """`gas_aggregate` over a vq table against the reference's interpret
    backend, and its gradient with respect to x_in against `jax.grad` (the
    table, its scales and the codebook get none: the reference's zero
    cotangents)."""
    b = _batch(seed=4)
    n_table = 301
    rng = _rng(d)
    cb = _codebook(d)
    x_in = rng.standard_normal((b.max_b, d)).astype(np.float32)
    q, s = _vq_table(d + 1, n_table, d)
    g_out = rng.standard_normal((b.max_b, d)).astype(np.float32)
    blocks = (b.forward.vals, b.forward.cols, b.transposed.vals,
              b.transposed.cols)

    def r_fn(x, codebook):
        out = r_ops.gas_aggregate(x, J(q), J(b.halo_nodes), J(b.halo_mask),
                                  b.max_b, tuple(J(a) for a in blocks),
                                  scales=J(s), codebook=codebook,
                                  backend="interpret")
        return jnp.sum(out * J(g_out)), out

    (_, want), (want_g, want_cb) = jax.value_and_grad(
        r_fn, argnums=(0, 1), has_aux=True)(J(x_in), J(cb))
    assert not np.any(np.asarray(want_cb))
    x = T(x_in.copy()).requires_grad_(True)
    got = t_ops.gas_aggregate(x, T(q), T(b.halo_nodes), T(b.halo_mask),
                              b.max_b, tuple(T(a) for a in blocks),
                              scales=T(s), codebook=T(cb))
    (got_g,) = torch.autograd.grad((got * T(g_out)).sum(), (x,))
    assert got.shape == (b.max_b, d)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)


# ---------------------------------------------------------------------------
# HistoryStore
# ---------------------------------------------------------------------------

def _carry_codebooks(rs, ts):
    """The reference store's codebooks into the port's store."""
    ts.codebooks = [T(np.array(cb)) for cb in rs.codebooks]
    return ts


def test_history_store_vq_matches_reference():
    """create / push / pull / bytes / clone / statistics / refit against
    the reference's store on "jnp", from the same codebooks: three pushes
    per layer with duplicates and masked rows; tables and scales bitwise
    (the sentinel row, which takes masked pushes, left out), counts
    exact, sums at 1e-5; then a refit from the same statistics, bitwise."""
    n, dims = 50, [16, 24]
    rs = r_hist.HistoryStore.create(n + 1, dims, backend="jnp",
                                    history_dtype="vq")
    ts = _carry_codebooks(rs, t_hist.HistoryStore.create(n + 1, dims, "vq",
                                                         "cpu"))
    assert ts.bytes() == rs.bytes()
    assert ts.f32_bytes() == (n + 1) * sum(dims) * 4
    assert [t.shape for t in ts.tables] == [(n + 1, 2), (n + 1, 3)]
    rng = _rng(2)
    for step in range(3):
        for ell, d in enumerate(dims):
            v = rng.standard_normal((30, d)).astype(np.float32)
            v[3] = 0.0
            idx = rng.integers(0, n, 30).astype(np.int32)
            idx[20:25] = idx[:5]
            mask = rng.random(30) > 0.2
            rs = rs.push(ell, J(idx), J(v), J(mask))
            assert ts.push(ell, T(idx), T(v), T(mask)) is ts
    every = np.arange(n, dtype=np.int32)
    for ell in range(len(dims)):
        np.testing.assert_array_equal(ts.pull(ell, T(every)).numpy(),
                                      np.asarray(rs.pull(ell, J(every))))
        np.testing.assert_array_equal(ts.tables[ell].numpy()[:n],
                                      np.asarray(rs.tables[ell])[:n])
        np.testing.assert_array_equal(ts.scales[ell].numpy()[:n],
                                      np.asarray(rs.scales[ell])[:n])
        np.testing.assert_array_equal(ts.cb_counts[ell].numpy(),
                                      np.asarray(rs.cb_counts[ell]))
        np.testing.assert_allclose(ts.cb_sums[ell].numpy(),
                                   np.asarray(rs.cb_sums[ell]), **TOL)
    v = _rng(3).standard_normal((20, 24)).astype(np.float32)
    m = np.ones(20, bool)
    np.testing.assert_allclose(float(ts.quant_error(T(v), T(m), 1)),
                               float(rs.quant_error(J(v), J(m), 1)),
                               rtol=1e-5)
    copy = ts.clone()
    ts.push(0, T(every[:3]), T(np.ones((3, 16), np.float32)),
            T(np.ones(3, bool)))
    assert not torch.equal(copy.pull(0, T(every[:3])),
                           ts.pull(0, T(every[:3])))
    assert not torch.equal(copy.cb_counts[0], ts.cb_counts[0])
    # a refit from the same statistics (the reference's, carried over):
    # the same codebooks, codes and scales, statistics zeroed
    copy.cb_sums = [T(np.array(a)) for a in rs.cb_sums]
    copy.tables[0][n] = T(np.asarray(rs.tables[0])[n])
    copy.tables[1][n] = T(np.asarray(rs.tables[1])[n])
    copy.scales[0][n] = float(rs.scales[0][n])
    copy.scales[1][n] = float(rs.scales[1][n])
    rs = rs.refit_codebooks()
    assert copy.refit_codebooks() is copy
    for ell in range(len(dims)):
        np.testing.assert_array_equal(copy.codebooks[ell].numpy(),
                                      np.asarray(rs.codebooks[ell]))
        np.testing.assert_array_equal(copy.tables[ell].numpy(),
                                      np.asarray(rs.tables[ell]))
        np.testing.assert_array_equal(copy.scales[ell].numpy(),
                                      np.asarray(rs.scales[ell]))
        assert not copy.cb_counts[ell].any() and not copy.cb_sums[ell].any()
        assert not torch.equal(copy.codebooks[ell], ts.codebooks[ell])


def test_vq_store_bytes_match_reference():
    """bytes() counts the codes, scales, codebooks and statistics as the
    reference's `bytes_per_table` does."""
    for n, dims in ((2500, [64]), (19717, [256, 256]), (40, [8, 48])):
        rs = r_hist.HistoryStore.create(n + 1, dims, backend="jnp",
                                        history_dtype="vq")
        ts = t_hist.HistoryStore.create(n + 1, dims, "vq", "cpu")
        assert ts.bytes() == rs.bytes()


# ---------------------------------------------------------------------------
# Training over a vq store
# ---------------------------------------------------------------------------

def _vq_state(rstate):
    """The reference's state carried over: params, optimizer and its vq
    store (codes, scales, codebooks, statistics, clock)."""
    h = rstate.histories
    store = t_hist.HistoryStore(
        tables=[T(np.array(t)) for t in h.tables], age=T(np.array(h.age)),
        history_dtype="vq", scales=[T(np.array(s)) for s in h.scales],
        codebooks=[T(np.array(c)) for c in h.codebooks],
        cb_counts=[T(np.array(c)) for c in h.cb_counts],
        cb_sums=[T(np.array(c)) for c in h.cb_sums])
    return dataclasses.replace(_carry(rstate), histories=store)


def _flips_are_ties(ts, r_tables, pushes, n):
    """The share of equal codes in each table (>= 99.9%), and every code
    that differs a near-tie for the row pushed into it last (its two
    entries' distances within 1e-6). Returns the share."""
    shares = []
    for ell, rt in enumerate(r_tables):
        got, want = ts.tables[ell].numpy()[:n], np.asarray(rt)[:n]
        shares.append(float(np.mean(got == want)))
        rows, subs = np.nonzero(got != want)
        cb = ts.codebooks[ell].numpy()
        for r, s in zip(rows, subs):
            idx, v, mask = pushes[ell]
            last = np.flatnonzero((idx == r) & mask)[-1]
            u = (v[last] / np.abs(v[last]).max()).reshape(-1, 8)[s:s + 1]
            gap = _near_tie(u, cb[s], cb[s, got[r, s]][None],
                            cb[s, want[r, s]][None])
            assert gap[0] <= 1e-6, (ell, r, s, gap)
    assert min(shares) >= 0.999, shares
    return min(shares)


@pytest.mark.parametrize("op", ["gcn", "gat", "pna"])
def test_vq_two_steps_match_reference(op):
    """Two steps (batches 0 and 2) over a vq store, from the reference's
    params and codebook: the loss, every gradient, `hist_quant_err` and
    the scales at 1e-4, the pushed codes >= 99.9% equal with every flip a
    near-tie; the clock exactly."""
    rplan, rstate, tplan, tstate = _plans(op, history_dtype="vq")
    tstate = _vq_state(rstate)
    n = tplan.graph.num_nodes
    for b in (0, 2):
        pushes = {}
        real = tstate.histories.push_measured

        def record(ell, idx, values, mask, stats=True, _real=real):
            pushes[ell] = (idx.numpy(), values.numpy(), mask.numpy())
            return _real(ell, idx, values, mask, stats)

        tstate.histories.push_measured = record
        r_loss, r_g, r_store = _ref_grads(rplan, rstate, rplan.batch(b))
        t_g, t_m = t_rt.grads_and_metrics(tplan, tstate, tplan.batch(b))
        del tstate.histories.push_measured
        np.testing.assert_allclose(float(t_m["loss"]), float(r_loss), **STEP)
        r_leaves = jax.tree_util.tree_leaves(r_g)
        assert len(t_g) == len(r_leaves)
        for a, g in zip(t_g, r_leaves):
            np.testing.assert_allclose(a.numpy(), np.asarray(g), **STEP)
        assert float(t_m["hist_quant_err"]) > 0
        ts = tstate.histories
        _flips_are_ties(ts, r_store.tables, pushes, n)
        for a, s in zip(r_store.scales, ts.scales):
            np.testing.assert_allclose(s.numpy()[:n], np.asarray(a)[:n],
                                       **STEP)
        for a, c in zip(r_store.cb_counts, ts.cb_counts):
            np.testing.assert_allclose(c.numpy(), np.asarray(a), atol=2)
        np.testing.assert_array_equal(ts.age.numpy(), np.asarray(r_store.age))
        rstate, _ = r_rt.train_step(rplan, rstate, rplan.batch(b))
        tstate = _vq_state(rstate)


def test_vq_refit_cadence():
    """`vq_refit_every=2` over 4 epochs (the reference's cadence test):
    the codebooks move away from the initial one, entry 0 stays zero, the
    statistics stay finite and non-negative, the losses finite; and the
    refits happen at epochs 2 (the statistics of epochs 0-1) and nowhere
    else."""
    g = t_citation(num_nodes=300, num_features=12, num_classes=3, seed=0)
    spec = t_model.GNNSpec(op="gcn", d_in=12, d_hidden=16, num_classes=3,
                           num_layers=3)
    plan = t_rt.build_plan(g, spec, t_rt.GASConfig(
        num_parts=4, history_dtype="vq", vq_refit_every=2), device="cpu")
    state = t_rt.init_state(plan)
    init = t_hist.vq_init_codebook(16, device="cpu")
    seen = []
    for epoch in range(4):
        before = [c.clone() for c in state.histories.codebooks]
        state, m = t_rt.train_epoch(plan, state, epoch)
        assert np.isfinite(m["loss"]) and m["hist_quant_err"] > 0
        seen.append(not all(torch.equal(a, b) for a, b in
                            zip(before, state.histories.codebooks)))
    assert seen == [False, False, True, False]
    hist = state.histories
    for cb in hist.codebooks:
        assert not torch.equal(cb, init)
        assert torch.all(cb[:, 0] == 0)
    for cnt in hist.cb_counts:
        assert (cnt >= 0).all() and torch.isfinite(cnt).all()
        assert cnt.sum() > 0                    # epoch 3's pushes


@pytest.mark.parametrize("threshold,expect_refit", ((1e-9, True),
                                                    (1e9, False)))
def test_vq_refit_drift_threshold(threshold, expect_refit):
    """With cadence refits off, the drift gate alone decides
    (tests/test_dynamic.py:452): a tiny threshold refits on the next
    epoch, a huge one never does (codebooks bitwise frozen)."""
    g = t_citation(num_nodes=110, num_features=8, num_classes=3, seed=7)
    spec = t_model.GNNSpec(op="gcn", d_in=8, d_hidden=16, num_classes=3,
                           num_layers=2)
    plan = t_rt.build_plan(g, spec, t_rt.GASConfig(
        num_parts=3, seed=0, history_dtype="vq", vq_refit_every=0,
        vq_refit_drift=threshold), device="cpu")
    state = t_rt.init_state(plan)
    state, _ = t_rt.train_epoch(plan, state, epoch=0)
    assert plan._last_qerr is not None and plan._last_qerr > 0
    cb0 = [c.clone() for c in state.histories.codebooks]
    state, _ = t_rt.train_epoch(plan, state, epoch=1)
    changed = any(not torch.equal(a, b)
                  for a, b in zip(cb0, state.histories.codebooks))
    assert changed == expect_refit


# ---------------------------------------------------------------------------
# Serving over a vq store
# ---------------------------------------------------------------------------

SN, SF, SD, SC, SL = 280, 20, 24, 3, 3


def _serve_pair(seed=0):
    kw = dict(num_nodes=SN, avg_degree=4.5, num_features=SF, num_classes=SC,
              seed=seed)
    spec_kw = dict(op="gcn", d_in=SF, d_hidden=SD, num_classes=SC,
                   num_layers=SL)
    rspec, tspec = r_model.GNNSpec(**spec_kw), t_model.GNNSpec(**spec_kw)
    rparams = r_model.init_gnn(jax.random.PRNGKey(0), rspec)
    tparams = t_ckpt.params_from_numpy(
        {f"layers/{i}/{k}": np.asarray(v)
         for i, layer in enumerate(rparams["layers"])
         for k, v in layer.items()}, device="cpu")
    rstore = r_hist.HistoryStore.create(SN + 1, [SD] * (SL - 1),
                                        backend="interpret",
                                        history_dtype="vq")
    tstore = _carry_codebooks(rstore, t_hist.HistoryStore.create(
        SN + 1, [SD] * (SL - 1), "vq", "cpu"))
    rplan = r_serve.build_serve_plan(r_citation(**kw), rspec,
                                     r_serve.ServeConfig(
                                         staleness_slo=0, buckets=(8, 32),
                                         backend="interpret",
                                         history_dtype="vq"))
    tplan = t_serve.build_serve_plan(t_citation(**kw), tspec,
                                     t_serve.ServeConfig(
                                         staleness_slo=0, buckets=(8, 32),
                                         history_dtype="vq"), device="cpu")
    rstate = r_serve.init_serve_state(
        rplan, SimpleNamespace(params=rparams, histories=rstore))
    tstate = t_serve.init_serve_state(tplan,
                                      t_serve.ServeState(tparams, tstore))
    return rplan, rstate, tplan, tstate


def test_serve_vq_slo0_matches_reference():
    """SLO=0 requests over a fresh vq store (every refresh push encodes)
    against the reference's `serve_request` on the same store and
    codebooks: logits and `hist_quant_err` at 1e-4, the request
    diagnostics and the clock exactly, the stores' codes >= 99.9% equal
    and their scales at 1e-4."""
    rplan, rstate, tplan, tstate = _serve_pair()
    rng = _rng(11)
    for q in (rng.choice(SN, 20, replace=False),
              rng.choice(SN, 45, replace=False)):
        rl, rstate, rd = r_serve.serve_request(rplan, rstate, q)
        tl, tstate, td = t_serve.serve_request(tplan, tstate, q)
        np.testing.assert_allclose(tl, rl, **STEP)
        for k in ("refreshed", "num_steps", "num_chunks", "halo_age_max"):
            assert td[k] == rd[k], (k, td[k], rd[k])
        assert td["hist_quant_err"] > 0
        np.testing.assert_allclose(td["hist_quant_err"],
                                   rd["hist_quant_err"], rtol=1e-4)
        np.testing.assert_array_equal(tstate.histories.age.numpy(),
                                      np.asarray(rstate.histories.age))
    rs, ts = rstate.histories, tstate.histories
    for ell in range(SL - 1):
        same = np.mean(ts.tables[ell].numpy()[:SN]
                       == np.asarray(rs.tables[ell])[:SN])
        assert same >= 0.999, same
        np.testing.assert_allclose(ts.scales[ell].numpy()[:SN],
                                   np.asarray(rs.scales[ell])[:SN], **STEP)


def test_serving_leaves_vq_codebooks_and_stats_unchanged():
    """Serving pushes encode against the bound codebook and gather no
    statistics (tests/test_serve.py:560): after two trained epochs and
    three SLO=0 requests the codebooks and both statistics are bitwise
    what they were, while the tables moved."""
    g = t_citation(num_nodes=140, num_features=8, num_classes=3, seed=21)
    spec = t_model.GNNSpec(op="gcn", d_in=8, d_hidden=16, num_classes=3,
                           num_layers=3)
    plan = t_rt.build_plan(g, spec, t_rt.GASConfig(
        num_parts=3, history_dtype="vq"), device="cpu")
    state = t_rt.init_state(plan)
    for e in range(2):
        state, _ = t_rt.train_epoch(plan, state, e)
    splan = t_serve.build_serve_plan(g, spec, t_serve.ServeConfig(
        staleness_slo=0, buckets=(16,)), device="cpu")
    st = t_serve.init_serve_state(splan, state)
    store = st.histories
    snap = {k: [t.clone() for t in getattr(store, k)]
            for k in ("codebooks", "cb_counts", "cb_sums", "tables")}
    assert snap["cb_counts"][0].sum() > 0
    rng = _rng(10)
    for _ in range(3):
        q = rng.choice(g.num_nodes, size=12, replace=False)
        _, st, diags = t_serve.serve_request(splan, st, q)
        assert diags["halo_age_max"] == 0.0
    for k in ("codebooks", "cb_counts", "cb_sums"):
        for a, b in zip(snap[k], getattr(st.histories, k)):
            assert torch.equal(a, b), k
    assert any(not torch.equal(a, b)
               for a, b in zip(snap["tables"], st.histories.tables))


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

def test_vq_checkpoint_crosses_both_ways(tmp_path):
    """A reference vq checkpoint read by the port (codes, scales,
    codebooks and statistics bitwise), and the port's written back and
    read by the reference: the same keys, types and arrays. Without meta
    the port tells a vq file by its codebooks."""
    rplan, rstate, tplan, tstate = _plans("gcn", history_dtype="vq")
    rstate, _ = r_rt.train_step(rplan, rstate, rplan.batch(1))
    path = str(tmp_path / "ref.npz")
    meta = {"args": {"history_dtype": "vq"}}
    r_ckpt.save_gas_state(path, rstate, step=3, meta=meta)
    back, step = t_ckpt.load_gas_state(path, device="cpu")
    assert step == 3 and back.histories.history_dtype == "vq"
    h = rstate.histories
    for name in ("tables", "scales", "codebooks", "cb_counts", "cb_sums"):
        for a, b in zip(getattr(back.histories, name), getattr(h, name)):
            assert a.dtype == (torch.uint8 if name == "tables"
                               else torch.float32)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert back.histories.cb_counts[0].sum() > 0
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
    t_ckpt.save_gas_state(out, back, step=4)
    _, store, _ = t_ckpt.load_gas_state_npz(out, device="cpu")
    assert store.history_dtype == "vq"
    with pytest.raises(ValueError, match="codebooks"):
        t_ckpt.load_gas_state_npz(out, device="cpu", history_dtype="int8")


def test_launcher_smokes_vq():
    """Both launchers take `--history-dtype vq` and print the store's
    bytes and ratio."""
    from repro_torch.launch import serve_gas, train_gas
    out = train_gas.main(["--smoke", "--device", "cpu", "--history-dtype",
                          "vq"])
    assert out["epochs"][-1]["hist_quant_err"] > 0
    serve_gas.main(["--smoke", "--device", "cpu", "--history-dtype", "vq"])
