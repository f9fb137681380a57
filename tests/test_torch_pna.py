"""PyTorch port, PNA: the reduction's plain versions, its autograd.Function,
the layer and the model against the JAX package, on the same numpy inputs.

The plain versions of the three `pna_reduce` kernels (`kernels/ref.py`)
are held against the Pallas kernels in interpret mode, which take
operands padded to whole blocks and 128 lanes (padded here on the
reference side only): mn, mx, cnt and the tie counts cmin, cmax bitwise
(one f32 add and a max per message, and sums of small integers), s, dxd
and dxs at rtol = atol = 1e-5 (the same products summed in another
order). Inputs on a coarse grid force ties beside the ReLU's zeros and
the duplicate edges. `ops.pna_reduce`, on the blocks and on the COO, is
held against `jax.grad` of the reference's, the layer's transforms at
1e-6 (the readout at 1e-5), and `gas_batch_forward` / `full_forward` from the reference's
params at 1e-5 over f32 and int8 stores, and one epoch of training at
1e-4. Training steps and two epochs run in `tests/test_torch_train.py`
(its op lists hold "pna"). On the card, chip_smoke.py and
`tests/test_torch_cuda.py` hold each CUDA kernel against these plain
versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")

from repro.core import runtime as r_rt
from repro.data.graphs import citation_graph as r_citation
from repro.gnn import layers as r_layers
from repro.gnn import model as r_model
from repro.kernels import ops as r_ops
from repro.kernels import pna_reduce as r_pnk
from repro.train import checkpoint as r_ckpt

from repro_torch.core import runtime as t_rt
from repro_torch.data.graphs import citation_graph as t_citation
from repro_torch.gnn import layers as t_layers
from repro_torch.gnn import model as t_model
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import pna_reduce as t_pnk
from repro_torch.kernels import ref as t_ref
from repro_torch.launch import train_gas
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train.optimizer import tree_leaves

BN = 128
TOL = dict(rtol=1e-5, atol=1e-5)
T = torch.from_numpy
J = jnp.asarray
LOG_DEG_MEAN = 1.8


def _problem(seed, n_out, M, ne, F, ties):
    """A ragged GAS-shaped edge set over n_out destinations and M sources:
    duplicate edges (multiplicity 2), padding edges (weight 0), the last
    20 destinations without any edge; xd and xs on a 0.5 grid when `ties`
    (so equal messages are common beside the ReLU's zeros). Returns the
    COO, the weights, the unit-weight blocks and xd [M, F], xs [M, F]."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n_out - 20, ne).astype(np.int32)
    src = rng.integers(0, M, ne).astype(np.int32)
    q = ne // 8
    dst[:q], src[:q] = dst[q:2 * q], src[q:2 * q]       # duplicate edges
    w = np.ones(ne, np.float32)
    w[-30:] = 0.0                                       # padding edges
    v = w > 0
    ones = np.ones(int(v.sum()), np.float32)
    uv, uc, _, _ = t_ops.build_bcsr_rect(dst[v], src[v], ones, n_out, M)
    uvt, uct, _, _ = t_ops.build_bcsr_rect(src[v], dst[v], ones, M, n_out)
    assert uv.max() >= 2
    xd = rng.normal(size=(M, F)).astype(np.float32)
    xs = rng.normal(size=(M, F)).astype(np.float32)
    if ties:
        xd, xs = np.round(xd * 2) / 2, np.round(xs * 2) / 2
    return (dst, src), w, (uv, uc, uvt, uct), xd, xs, rng


def _lanes(x, rows):
    """[n, F] -> [rows, Fp] zero-padded, the Pallas kernels' layout."""
    fp = -(-x.shape[1] // BN) * BN
    return J(np.pad(x, ((0, rows - x.shape[0]), (0, fp - x.shape[1]))))


@pytest.mark.parametrize("n_out,M,ne,F,ties", [
    (120, 250, 700, 16, True),       # R=1, K=2
    (250, 300, 1500, 48, True),      # R=2, K=3: the table-5 width
    (200, 240, 900, 130, False),     # F past one 128-lane tile
])
def test_pna_kernels_match_pallas(n_out, M, ne, F, ties):
    """All three plain versions against the three Pallas kernels:
    duplicate and padding edges, destinations without edges, ragged F,
    forced ties. The stats and the tie counts bitwise, s and the two
    gradients at 1e-5."""
    _, _, (uv, uc, uvt, uct), xd, xs, rng = _problem(n_out + F, n_out, M,
                                                     ne, F, ties)
    xd = xd[:n_out]
    R, C = uc.shape[0], uct.shape[0]
    assert R <= 2 and uc.shape[1] <= 3
    got = t_pnk.pna_reduce_fwd(T(xd), T(xs), T(uv), T(uc))
    want = r_pnk.pna_reduce_fwd(_lanes(xd, R * BN), _lanes(xs, C * BN),
                                J(uv), J(uc), interpret=True)
    want = [np.asarray(a)[:n_out, :F] if a.ndim == 2 else
            np.asarray(a)[:n_out] for a in want]
    names = ("s", "mn", "mx", "cnt", "cmin", "cmax")
    for a, b, name in zip(got, want, names):
        assert a.shape == b.shape, name
        if name == "s":
            np.testing.assert_allclose(a.numpy(), b, err_msg=name, **TOL)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    s, mn, mx, cnt, cmin, cmax = got
    assert float(cnt[-20:].abs().sum()) == 0.0
    assert float(mn[-20:].abs().sum()) == float(mx[-20:].abs().sum()) == 0.0
    if ties:   # the split is exercised: ties past one, at the min and max
        assert float(cmin.max()) >= 3 and float(cmax.max()) >= 2

    gs, gmn, gmx = (rng.normal(size=(n_out, F)).astype(np.float32)
                    for _ in range(3))
    stats = [T(gs), T(gmn), T(gmx), mn, mx, cmin, cmax]
    r_stats = [_lanes(a, R * BN) for a in
               (gs, gmn, gmx, mn.numpy(), mx.numpy(), cmin.numpy(),
                cmax.numpy())]
    dxd = t_pnk.pna_reduce_bwd_row(T(xd), T(xs), *stats, T(uv), T(uc))
    r_dxd = r_pnk.pna_reduce_bwd_row(_lanes(xd, R * BN), _lanes(xs, C * BN),
                                     *r_stats, J(uv), J(uc), interpret=True)
    np.testing.assert_allclose(dxd.numpy(), np.asarray(r_dxd)[:n_out, :F],
                               **TOL)
    dxs = t_pnk.pna_reduce_bwd_col(T(xd), T(xs), *stats, T(uvt), T(uct))
    r_dxs = r_pnk.pna_reduce_bwd_col(_lanes(xd, R * BN), _lanes(xs, C * BN),
                                     *r_stats, J(uvt), J(uct),
                                     interpret=True)
    np.testing.assert_allclose(dxs.numpy(), np.asarray(r_dxs)[:M, :F], **TOL)


def test_pna_kernels_mask_sources_without_edges():
    """Sources that no valid edge names carry poisoned values (1e30 and
    -1e30): they reach no output of the forward and get no gradient."""
    n_out, M, F = 120, 250, 16
    _, _, (uv, uc, uvt, uct), xd, xs, rng = _problem(5, n_out, M, 700, F,
                                                     True)
    xd = xd[:n_out]
    src_hit = np.zeros(M, bool)            # sources some valid edge names
    for r in range(uv.shape[0]):
        for k in range(uv.shape[1]):
            cols = np.nonzero(uv[r, k].sum(0))[0] + uc[r, k] * BN
            src_hit[cols[cols < M]] = True
    assert (~src_hit).any()
    xs_p = xs.copy()
    xs_p[~src_hit] = np.where(rng.random(((~src_hit).sum(), F)) < 0.5,
                              1e30, -1e30)
    clean = t_pnk.pna_reduce_fwd(T(xd), T(xs), T(uv), T(uc))
    dirty = t_pnk.pna_reduce_fwd(T(xd), T(xs_p), T(uv), T(uc))
    for a, b in zip(clean, dirty):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    s, mn, mx, cnt, cmin, cmax = clean
    g = [T(rng.normal(size=(n_out, F)).astype(np.float32)) for _ in range(3)]
    dxs = t_pnk.pna_reduce_bwd_col(T(xd), T(xs_p), *g, mn, mx, cmin, cmax,
                                   T(uvt), T(uct))
    assert np.isfinite(dxs.numpy()).all()
    np.testing.assert_array_equal(dxs.numpy()[~src_hit], 0.0)


@pytest.mark.parametrize("route", ["blocks", "coo"])
@pytest.mark.parametrize("F,ties", [(16, True), (48, False)])
def test_pna_reduce_grads_match_jax(route, F, ties):
    """`ops.pna_reduce` on the blocks (the autograd.Function over the
    three kernels' plain versions) against the reference's kernel route
    on "interpret", and on the COO (`ref.pna_reduce_coo`) against its
    segment route ("jnp"): (s, mn, mx, cnt) and the gradients of xd and
    xs under one seeded cotangent per output, at 1e-5."""
    n_out, M = 200, 240
    edges, w, ublocks, xd, xs, rng = _problem(11 + F, n_out, M, 900, F, ties)
    cots = [rng.normal(size=(n_out, F)).astype(np.float32) for _ in range(3)]
    backend = "interpret" if route == "blocks" else "jnp"
    blk = ublocks if route == "blocks" else None

    def r_loss(xd, xs):
        s, mn, mx, cnt = r_ops.pna_reduce(
            xd, xs, tuple(map(J, edges)), J(w), n_out,
            None if blk is None else tuple(map(J, blk)), backend=backend)
        return sum(jnp.sum(a * c) for a, c in zip((s, mn, mx), cots)), \
            (s, mn, mx, cnt)

    (_, r_out), r_g = jax.value_and_grad(r_loss, argnums=(0, 1),
                                         has_aux=True)(J(xd), J(xs))
    txd, txs = (T(a).requires_grad_(True) for a in (xd, xs))
    out = t_ops.pna_reduce(txd, txs, (T(edges[0]), T(edges[1])), T(w),
                           n_out, None if blk is None else
                           tuple(T(a) for a in blk))
    loss = sum((a * T(c)).sum() for a, c in zip(out[:3], cots))
    t_g = torch.autograd.grad(loss, (txd, txs))
    for a, b, name in zip(out, r_out, ("s", "mn", "mx", "cnt")):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   err_msg=name, **TOL)
    for a, b, name in zip(t_g, r_g, ("dxd", "dxs")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
    assert not out[3].requires_grad


def _pna_params(seed, d_in, f):
    rng = np.random.default_rng(seed)
    return {"w1": rng.normal(size=(2 * d_in, f)).astype(np.float32) * 0.3,
            "b1": rng.normal(size=(f,)).astype(np.float32),
            "w2": rng.normal(size=(d_in + 9 * f, f)).astype(np.float32) * 0.1,
            "b2": rng.normal(size=(f,)).astype(np.float32)}


def test_pna_layer_transforms_match_reference():
    """`pna_transform` and `pna_transform_split` (the reference's at 128
    lanes from a lane-padded pull, the port's at the width f) at 1e-6;
    `pna_combine` (empty destinations included) at 1e-5: its readout is a
    444-term f32 dot product, which the two frameworks sum in other orders
    (6.7e-6 apart at outputs up to 15 on this input)."""
    d, f, n_b, n_h = 12, 48, 70, 30
    p = _pna_params(0, d, f)
    rp = {k: J(v) for k, v in p.items()}
    tp = {k: T(v) for k, v in p.items()}
    rng = np.random.default_rng(1)
    x_b = rng.normal(size=(n_b, d)).astype(np.float32)
    xh = rng.normal(size=(n_h, d)).astype(np.float32)
    x_all = np.concatenate([x_b, xh, np.zeros((1, d), np.float32)])
    tol = dict(rtol=1e-6, atol=1e-6)
    for a, b in zip(t_layers.pna_transform(tp, T(x_all)),
                    r_layers.pna_transform(rp, J(x_all))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    xh_pad = np.pad(xh, ((0, 0), (0, BN - d)))
    r_xd, r_xs = r_layers.pna_transform_split(rp, J(x_b), J(xh_pad), BN)
    t_xd, t_xs = t_layers.pna_transform_split(tp, T(x_b), T(xh))
    np.testing.assert_allclose(t_xd.numpy(), np.asarray(r_xd)[:, :f], **tol)
    np.testing.assert_allclose(t_xs.numpy(), np.asarray(r_xs)[:, :f], **tol)
    np.testing.assert_array_equal(t_xs.numpy()[-1], p["b1"])
    s, mn, mx = (rng.normal(size=(n_b, f)).astype(np.float32)
                 for _ in range(3))
    cnt = rng.integers(0, 9, n_b).astype(np.float32)
    cnt[:5] = 0.0
    got = t_layers.pna_combine(tp, T(x_b), T(s), T(mn), T(mx), T(cnt),
                               LOG_DEG_MEAN)
    want = r_layers.pna_combine(rp, J(x_b), J(s), J(mn), J(mx), J(cnt),
                                LOG_DEG_MEAN)
    assert got.shape == (n_b, f)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _flat(params):
    flat = {f"layers/{i}/{k}": np.asarray(v)
            for i, layer in enumerate(params["layers"])
            for k, v in layer.items()}
    flat.update({f"head/{k}": np.asarray(v)
                 for k, v in params.get("head", {}).items()})
    return flat


def _pna_case(history_dtype, num_layers=3, backend="interpret", **cfg):
    kw = dict(num_nodes=300, num_features=12, num_classes=3, seed=0)
    spec_kw = dict(op="pna", d_in=12, d_hidden=16, num_classes=3,
                   num_layers=num_layers, log_deg_mean=LOG_DEG_MEAN)
    rplan = r_rt.build_plan(r_citation(**kw), r_model.GNNSpec(**spec_kw),
                            r_rt.GASConfig(num_parts=4, backend=backend,
                                           history_dtype=history_dtype,
                                           **cfg))
    tplan = t_rt.build_plan(t_citation(**kw), t_model.GNNSpec(**spec_kw),
                            t_rt.GASConfig(num_parts=4,
                                           history_dtype=history_dtype,
                                           **cfg),
                            device="cpu")
    rstate = r_rt.init_state(rplan)
    tstate = t_rt.init_state(tplan, params=t_ckpt.params_from_numpy(
        _flat(rstate.params), "cpu"))
    return rplan, rstate, tplan, tstate


@pytest.mark.parametrize("history_dtype", ["f32", "int8"])
def test_pna_forward_matches_reference(history_dtype):
    """Three PNA layers (two history tables) over every batch in turn,
    from the reference's params carried across: the materialized layer 0
    and the halo-split layers >= 1 on the blocks, each reading the tables
    the earlier batches pushed; logits at 1e-5 and the pushed tables (f32
    at 1e-5; int8 dequantized within one quantization step per row, >=
    99.9% of the codes equal). Then `full_forward` on the COO at 1e-5."""
    rplan, rstate, tplan, tstate = _pna_case(history_dtype)
    rs, ts = rstate.histories, tstate.histories
    n = tplan.graph.num_nodes
    with torch.no_grad():
        for b in range(tplan.batches.num_batches):
            rl, rs, _, rd = r_model.gas_batch_forward(
                rstate.params, rplan.spec, rplan.x, rplan.batch(b), rs,
                backend="interpret")
            tl, ts, td = t_model.gas_batch_forward(
                tstate.params, tplan.spec, tplan.x, tplan.batch(b), ts)
            assert tl.shape == (tplan.batches.max_b, 3)
            np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
            np.testing.assert_allclose(float(td["hist_quant_err"]),
                                       float(rd["hist_quant_err"]),
                                       rtol=1e-4, atol=1e-9)
            np.testing.assert_array_equal(ts.age.numpy(), np.asarray(rs.age))
        every = np.arange(n, dtype=np.int32)
        for ell in range(ts.num_layers):
            want = np.asarray(rs.pull(ell, J(every)))
            got = ts.pull(ell, T(every)).numpy()
            if history_dtype == "f32":
                np.testing.assert_allclose(got, want, **TOL)
                continue
            step = np.asarray(rs.scales[ell])[:n, None]
            assert np.all(np.abs(got - want) <= step * (1 + 1e-5))
            same = (ts.tables[ell][:n].numpy() ==
                    np.asarray(rs.tables[ell])[:n]).mean()
            assert same >= 0.999, same
        g = tplan.graph
        logits = t_model.full_forward(tstate.params, tplan.spec, tplan.x,
                                      tplan.eval_edges, tplan.eval_w, n)
    want = r_model.full_forward(rstate.params, rplan.spec, rplan.x,
                                rplan.eval_edges, rplan.eval_w, g.num_nodes)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fuse_halo", [True, False])
def test_pna_forward_without_history_matches_reference(fuse_halo):
    """`GASConfig(use_history=False)`: every layer materializes its halo
    from the layer's own inputs, no table is read, whatever `fuse_halo`
    says. Two PNA layers over two batches, from the reference's params
    carried across, each package run with its plan's `use_history` and
    `fuse_halo`: logits at 1e-5."""
    rplan, rstate, tplan, tstate = _pna_case(
        "f32", num_layers=2, use_history=False, fuse_halo=fuse_halo)
    rs, ts = rstate.histories, tstate.histories
    with torch.no_grad():
        for b in range(2):
            rl, rs, _, _ = r_model.gas_batch_forward(
                rstate.params, rplan.spec, rplan.x, rplan.batch(b), rs,
                use_history=rplan.config.use_history, backend="interpret",
                fuse_halo=rplan.config.fuse_halo)
            tl, ts, _ = t_model.gas_batch_forward(
                tstate.params, tplan.spec, tplan.x, tplan.batch(b), ts,
                use_history=tplan.config.use_history,
                fuse_halo=tplan.config.fuse_halo)
            np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)


def test_pna_epoch_matches_reference():
    """One shuffled epoch of PNA training (4 steps, two layers, the f32
    store) from the reference's params against the reference's segment
    ("jnp") route: the epoch's mean loss, every param after it and the
    pushed history table at 1e-4. (The two-step test at 1e-4 and the
    two-epoch one at 1e-3 are `tests/test_torch_train.py`'s, for every
    ported op.)"""
    rplan, rstate, tplan, tstate = _pna_case("f32", num_layers=2,
                                             backend="jnp")
    rstate, rm = r_rt.train_epoch(rplan, rstate, 0)
    tstate, tm = t_rt.train_epoch(tplan, tstate, 0)
    step = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tm["loss"], float(rm["loss"]), **step)
    r_leaves = jax.tree_util.tree_leaves(rstate.params)
    t_leaves = tree_leaves(tstate.params)
    assert len(t_leaves) == len(r_leaves) == 10
    for a, b in zip(t_leaves, r_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **step)
    n = tplan.graph.num_nodes
    np.testing.assert_allclose(tstate.histories.tables[0].numpy()[:n],
                               np.asarray(rstate.histories.tables[0])[:n],
                               **step)


def test_pna_checkpoint_roundtrips_through_reference(tmp_path):
    """A PNA training state (layers/{i}/{w1,b1,w2,b2} and head/{w,b}, the
    AdamW moments of both) written by the port is read by the reference's
    `load_gas_state` bitwise, and the reference's is read by the port."""
    rplan, rstate, tplan, tstate = _pna_case("f32", num_layers=2)
    tstate, _ = t_rt.train_step(tplan, tstate, tplan.batch(1))
    path = str(tmp_path / "port.npz")
    t_ckpt.save_gas_state(path, tstate, step=1, meta={"op": "pna"})
    restored, step = r_ckpt.load_gas_state(path, r_rt.init_state(rplan))
    assert step == 1
    want = {k: np.asarray(v) for k, v in r_ckpt._flatten(restored).items()}
    with np.load(path) as data:
        assert "state/params/head/w" in data.files
        assert "state/opt_state/v/layers/1/w2" in data.files
        for k in data.files:
            if k.startswith("state/"):
                np.testing.assert_array_equal(data[k], want[k[6:]], err_msg=k)
    rstate, _ = r_rt.train_step(rplan, rstate, rplan.batch(0))
    path = str(tmp_path / "ref.npz")
    r_ckpt.save_gas_state(path, rstate, step=2)
    back, step = t_ckpt.load_gas_state(path, device="cpu")
    assert step == 2 and sorted(back.params) == ["head", "layers"]
    flat = {k: np.asarray(v) for k, v in r_ckpt._flatten(rstate).items()}
    with pytest.raises(KeyError, match="unsupported param key"):
        t_ckpt.params_from_numpy({"params/tail/w": flat["params/head/w"]},
                                 "cpu")
    for tree, prefix in ((back.params, "params/"),
                         (back.opt_state.m, "opt_state/m/"),
                         (back.opt_state.v, "opt_state/v/")):
        keys = sorted(k for k in flat if k.startswith(prefix))
        for k, t in zip(keys, tree_leaves(tree)):
            np.testing.assert_array_equal(t.numpy(), flat[k], err_msg=k)


def test_train_gas_launcher_smoke_pna(capsys):
    out = train_gas.main(["--op", "pna", "--device", "cpu", "--smoke"])
    text = capsys.readouterr().out
    assert "smoke OK" in text and "GAS PNA" in text
    assert 0.0 <= out["gas"]["test_acc"] <= 1.0
    assert all(np.isfinite(m["loss"]) for m in out["epochs"])
