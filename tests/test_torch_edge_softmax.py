"""PyTorch port, GAT's edge softmax and the GCN backward: plain versions and
autograd against the JAX package, on the same numpy inputs.

The plain versions of the three edge-softmax kernels (`kernels/ref.py`)
are held against the Pallas kernels in interpret mode, which take
head-major operands padded to whole blocks and 128 lanes (padded here on
the reference side only). The forward compares at rtol = atol = 1e-5 and
the row max M bitwise (a max over the same f32 scores); the backward
passes at 1e-4, since they sum products of recomputed softmax weights in
another order than the tiled Pallas kernels. The autograd.Functions of
`kernels/ops.py` are held against `jax.grad` of the reference: the edge
softmax against its per-edge ("jnp", segment) route and the GCN
aggregations against its kernel route on backend="interpret", at 1e-4.
On the card, chip_smoke.py holds each CUDA kernel against these plain
versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")

from repro.kernels import edge_softmax as r_esk
from repro.kernels import ops as r_ops

from repro_torch.kernels import edge_softmax as t_esk
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

BN = 128
FWD = dict(rtol=1e-5, atol=1e-5)
BWD = dict(rtol=1e-4, atol=1e-4)
T = torch.from_numpy
J = jnp.asarray


def _problem(seed=0, n_out=300, M=600, ne=2500, empty_from=None):
    """A ragged GAS-shaped edge set: duplicate edges (multiplicity 2),
    padding edges (weight 0, pointing at sources 560.. that no valid edge
    names), and optionally destinations >= `empty_from` left without any
    edge. Returns the COO, the weights and the unit-weight blocks."""
    rng = np.random.default_rng(seed)
    hi = n_out if empty_from is None else empty_from
    dst = rng.integers(0, hi, ne).astype(np.int32)
    src = rng.integers(0, 560, ne).astype(np.int32)
    dst[:150], src[:150] = dst[150:300], src[150:300]   # duplicate edges
    w = np.ones(ne, np.float32)
    w[-60:] = 0.0                                       # padding edges
    src[-60:] = rng.integers(560, M, 60)
    v = w > 0
    ones = np.ones(int(v.sum()), np.float32)
    uv, uc, _, _ = t_ops.build_bcsr_rect(dst[v], src[v], ones, n_out, M)
    uvt, uct, _, _ = t_ops.build_bcsr_rect(src[v], dst[v], ones, M, n_out)
    assert uv.max() >= 2                                # multiplicities
    return (dst, src), w, (uv, uc, uvt, uct), rng


def _inputs(rng, n_out, M, H, F):
    wx = rng.normal(size=(M, H, F)).astype(np.float32)
    ad = rng.normal(size=(n_out, H)).astype(np.float32)
    as_ = rng.normal(size=(M, H)).astype(np.float32)
    g = rng.normal(size=(n_out, H, F)).astype(np.float32)
    return wx, ad, as_, g


def _head_major(x, rows):
    """[n, H(, F)] -> [H, rows(, Fp)] zero-padded, the reference kernels'
    layout (Fp: F up to a multiple of 128)."""
    x = np.moveaxis(x, 0, 1)
    pad = [(0, 0), (0, rows - x.shape[1])]
    if x.ndim == 3:
        pad.append((0, -(-x.shape[2] // 128) * 128 - x.shape[2]))
    return J(np.pad(x, pad))


@pytest.mark.parametrize("H,F", [(2, 8), (1, 7), (1, 160), (8, 8)])
def test_edge_softmax_kernels_match_pallas(H, F):
    """All three plain versions against the three Pallas kernels: ragged F
    (8 and 7, padded 16x and 18x on the reference side), F > 128 (two
    reference feature tiles), duplicate and padding edges."""
    n_out, M = 300, 600
    _, _, (uv, uc, uvt, uct), rng = _problem(seed=H * 100 + F)
    wx, ad, as_, g = _inputs(rng, n_out, M, H, F)
    R, C = uv.shape[0], uvt.shape[0]
    rad, ras = _head_major(ad, R * BN), _head_major(as_, C * BN)
    rwx, rg = _head_major(wx, C * BN), _head_major(g, R * BN)

    out, mm, ll = t_esk.edge_softmax_fwd(T(ad), T(as_), T(wx), T(uv), T(uc))
    r_out, r_m, r_l = r_esk.edge_softmax_fwd(rad, ras, rwx, J(uv), J(uc),
                                             interpret=True)
    r_out = np.moveaxis(np.asarray(r_out), 0, 1)[:n_out, :, :F]
    np.testing.assert_allclose(out.numpy(), r_out, **FWD)
    np.testing.assert_array_equal(mm.numpy(), np.asarray(r_m).T[:n_out])
    np.testing.assert_allclose(ll.numpy(), np.asarray(r_l).T[:n_out], **FWD)

    delta = (g * out.numpy()).sum(-1)
    rdelta = _head_major(delta, R * BN)
    dad = t_esk.edge_softmax_bwd_row(T(ad), T(as_), T(wx), T(g), mm, ll,
                                     T(delta), T(uv), T(uc))
    r_dad = r_esk.edge_softmax_bwd_row(rad, ras, rwx, rg, r_m, r_l, rdelta,
                                       J(uv), J(uc), interpret=True)
    np.testing.assert_allclose(dad.numpy(), np.asarray(r_dad).T[:n_out],
                               **BWD)
    dwx, das = t_esk.edge_softmax_bwd_col(T(ad), T(as_), T(wx), T(g), mm, ll,
                                          T(delta), T(uvt), T(uct))
    r_dwx, r_das = r_esk.edge_softmax_bwd_col(
        rad, ras, rwx, rg, r_m, r_l, rdelta, J(uvt), J(uct), interpret=True)
    np.testing.assert_allclose(
        dwx.numpy(), np.moveaxis(np.asarray(r_dwx), 0, 1)[:M, :, :F], **BWD)
    np.testing.assert_allclose(das.numpy(), np.asarray(r_das).T[:M], **BWD)


def test_edge_softmax_empty_rows_and_poisoned_sources():
    """Destinations without edges aggregate to exactly 0; sources reached
    only through padding edges are poisoned (values 1e30, logit halves
    50) and must not leak into any output, forward or backward."""
    n_out, M, H, F = 300, 600, 2, 8
    edges, w, (uv, uc, uvt, uct), rng = _problem(seed=7, empty_from=250)
    wx, ad, as_, g = _inputs(rng, n_out, M, H, F)
    wx_p, as_p = wx.copy(), as_.copy()
    wx_p[560:] = 1e30
    as_p[560:] = 50.0
    out, mm, ll = t_esk.edge_softmax_fwd(T(ad), T(as_p), T(wx_p), T(uv),
                                         T(uc))
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_array_equal(out.numpy()[250:], 0.0)
    np.testing.assert_array_equal(ll.numpy()[250:], 0.0)
    np.testing.assert_array_equal(mm.numpy()[250:], np.float32(-1e30))
    clean, _, _ = t_esk.edge_softmax_fwd(T(ad), T(as_), T(wx), T(uv), T(uc))
    np.testing.assert_array_equal(out.numpy(), clean.numpy())
    delta = (g * out.numpy()).sum(-1)
    dad = t_esk.edge_softmax_bwd_row(T(ad), T(as_p), T(wx_p), T(g), mm, ll,
                                     T(delta), T(uv), T(uc))
    dwx, das = t_esk.edge_softmax_bwd_col(T(ad), T(as_p), T(wx_p), T(g), mm,
                                          ll, T(delta), T(uvt), T(uct))
    for t in (dad, dwx, das):
        assert np.isfinite(t.numpy()).all()
    np.testing.assert_array_equal(dad.numpy()[250:], 0.0)
    np.testing.assert_array_equal(dwx.numpy()[560:], 0.0)
    np.testing.assert_array_equal(das.numpy()[560:], 0.0)
    # and the COO route (the exact evaluation's) agrees on clean inputs
    coo = t_ref.edge_softmax_coo(T(wx), T(np.pad(ad, ((0, M - n_out),
                                                      (0, 0)))),
                                 T(as_), (T(edges[0]), T(edges[1])), T(w),
                                 n_out)
    np.testing.assert_allclose(coo.numpy(), clean.numpy(), **BWD)


@pytest.mark.parametrize("H,F", [(2, 8), (1, 7)])
def test_edge_softmax_aggregate_grads_match_jax(H, F):
    """`ops.edge_softmax_aggregate` on the blocks (the autograd.Function
    over the three kernels' plain versions): output and the gradients of
    wx, ad and as_ against jax.grad of the reference's segment route."""
    n_out, M = 300, 600
    edges, w, ublocks, rng = _problem(seed=11 + F)
    wx, ad_o, as_, _ = _inputs(rng, n_out, M, H, F)
    ad = np.concatenate([ad_o, rng.normal(size=(M - n_out, H))
                         .astype(np.float32)])
    cot = rng.normal(size=(n_out, H, F)).astype(np.float32)

    def r_loss(wx, ad, as_):
        out = r_ops.edge_softmax_aggregate(wx, ad, as_, tuple(map(J, edges)),
                                           J(w), n_out, backend="jnp")
        return jnp.sum(out * cot), out

    (_, r_out), r_g = jax.value_and_grad(r_loss, argnums=(0, 1, 2),
                                         has_aux=True)(J(wx), J(ad), J(as_))
    tw, ta, ts = (T(a).requires_grad_(True) for a in (wx, ad, as_))
    out = t_ops.edge_softmax_aggregate(tw, ta, ts, (T(edges[0]),
                                                    T(edges[1])),
                                       T(w), n_out,
                                       tuple(T(a) for a in ublocks))
    assert out.shape == (n_out, H, F)
    t_g = torch.autograd.grad((out * T(cot)).sum(), (tw, ta, ts))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(r_out),
                               **BWD)
    for a, b, name in zip(t_g, r_g, ("dwx", "dad", "das")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **BWD)
    # the COO route differentiates too (the full-batch baseline's)
    c_g = torch.autograd.grad(
        (t_ops.edge_softmax_aggregate(tw, ta, ts, (T(edges[0]),
                                                   T(edges[1])),
                                      T(w), n_out) * T(cot)).sum(),
        (tw, ta, ts))
    for a, b, name in zip(c_g, r_g, ("dwx", "dad", "das")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **BWD)


def _gcn_problem(seed=3, n_out=260, max_h=300, d=20):
    """A GCN-weighted local adjacency [n_out, n_out + max_h + 1] with its
    forward and transposed blocks, some halo slots masked."""
    rng = np.random.default_rng(seed)
    m = n_out + max_h + 1
    ne = 1500
    dst = rng.integers(0, n_out, ne).astype(np.int32)
    src = rng.integers(0, m - 1, ne).astype(np.int32)
    w = rng.random(ne).astype(np.float32) + 0.1
    v, c, _, _ = t_ops.build_bcsr_rect(dst, src, w, n_out, m)
    vt, ct, _, _ = t_ops.build_bcsr_rect(src, dst, w, m, n_out)
    halo = rng.integers(0, 500, max_h).astype(np.int32)
    hmask = rng.random(max_h) < 0.8
    return (v, c, vt, ct), halo, hmask, rng


def test_gcn_aggregate_grad_matches_jax():
    blocks, _, _, rng = _gcn_problem()
    n_out, m, d = 260, 561, 20
    x_all = rng.normal(size=(m, d)).astype(np.float32)
    cot = rng.normal(size=(n_out, d)).astype(np.float32)

    def r_loss(x):
        out = r_ops.gcn_aggregate(x, None, None, n_out, tuple(map(J, blocks)),
                                  backend="interpret")
        return jnp.sum(out * cot)

    r_dx = jax.grad(r_loss)(J(x_all))
    tx = T(x_all).requires_grad_(True)
    out = t_ops.gcn_aggregate(tx, None, None, n_out,
                              tuple(T(a) for a in blocks))
    (t_dx,) = torch.autograd.grad((out * T(cot)).sum(), (tx,))
    np.testing.assert_allclose(t_dx.numpy(), np.asarray(r_dx), **BWD)


def test_gas_aggregate_grad_matches_jax_and_keeps_no_table():
    """The fused aggregation's x_in gradient, and the in-place push rule:
    overwriting the table between forward and backward must not make
    autograd raise, since the Function saves no table; then a float
    table's gradient."""
    blocks, halo, hmask, rng = _gcn_problem(seed=5)
    n_out, d, n_table = 260, 20, 501
    x_in = rng.normal(size=(n_out, d)).astype(np.float32)
    table = rng.normal(size=(n_table, d)).astype(np.float32)
    cot = rng.normal(size=(n_out, d)).astype(np.float32)

    def r_loss(x):
        out = r_ops.gas_aggregate(x, J(table), J(halo), J(hmask), n_out,
                                  tuple(map(J, blocks)), backend="interpret")
        return jnp.sum(out * cot)

    r_dx = jax.grad(r_loss)(J(x_in))
    tx = T(x_in).requires_grad_(True)
    tt = T(table.copy())
    out = t_ops.gas_aggregate(tx, tt, T(halo), T(hmask), n_out,
                              tuple(T(a) for a in blocks))
    t_ops.push_rows(tt, T(np.arange(5, dtype=np.int32)),
                    torch.ones(5, d), torch.ones(5, dtype=torch.bool))
    (t_dx,) = torch.autograd.grad((out * T(cot)).sum(), (tx,))
    np.testing.assert_allclose(t_dx.numpy(), np.asarray(r_dx), **BWD)
    # a float table that requires grad gets the reference's table
    # gradient (`_gather_spmm_bwd`'s index-add at the halo ids), and the
    # Function still saves no table
    r_dt = jax.grad(lambda t: jnp.sum(r_ops.gas_aggregate(
        J(x_in), t, J(halo), J(hmask), n_out, tuple(map(J, blocks)),
        backend="interpret") * cot))(J(table))
    tg = T(table.copy()).requires_grad_(True)
    out = t_ops.gas_aggregate(tx, tg, T(halo), T(hmask), n_out,
                              tuple(T(a) for a in blocks))
    with torch.no_grad():
        t_ops.push_rows(tg, T(np.arange(5, dtype=np.int32)),
                        torch.zeros(5, d), torch.ones(5, dtype=torch.bool))
    (t_dt,) = torch.autograd.grad((out * T(cot)).sum(), (tg,))
    np.testing.assert_allclose(t_dt.numpy(), np.asarray(r_dt), **BWD)
