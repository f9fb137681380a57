"""PyTorch port, the rest of the operator zoo (GIN, GCNII, APPNP) against
the JAX reference.

Small sizes (a 240-node citation graph, 3 parts, d_hidden=16, 3 layers),
every input made from a seed with numpy, each op's params made by the
reference's `init_gnn` and carried across with `params_from_numpy`. The
reference runs on its "jnp" backend (segment sums over the COO, the
materialized route for every layer); the port on the CPU runs its
kernels' plain versions over the batch's blocks, on the fused and on
the materialized route. Layers and forwards hold at 1e-5,
`gas_aggregate`'s gradients (a float table's included) at 1e-5 against
`jax.grad`, two training steps per op at 1e-4, the Eq. 3 step at 1e-5
with the reference's noise carried across (the port's draw,
`gnn.model.reg_noise`, replaced by the reference's per-layer
`jax.random.normal` draws), `halo_age_decay` against the reference's
forward, `core.gas.gas_forward` with and without its fused hook,
`wl_counterexample` bitwise with Proposition 3's property on the port's
GIN, and each op's reference checkpoint loaded by the port. Then two
paths that had no parity test: `use_history=False` (GCN and GAT, fused
on and off, and GIN), and the full-batch trainer for table 1's APPNP
and GCNII.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")

from repro.core import gas as r_gas
from repro.core import history as r_hist
from repro.core import runtime as r_rt
from repro.data.graphs import citation_graph as r_citation
from repro.data.graphs import wl_counterexample as r_wl
from repro.gnn import layers as r_layers
from repro.gnn import model as r_model
from repro.kernels import ops as r_ops
from repro.train import checkpoint as r_ckpt
from repro.train import gas_trainer as r_trainer
from repro.train import optimizer as r_opt

from repro_torch.core import gas as t_gas
from repro_torch.core import runtime as t_rt
from repro_torch.core.history import HistoryStore
from repro_torch.data.graphs import citation_graph as t_citation
from repro_torch.data.graphs import wl_counterexample as t_wl
from repro_torch.gnn import layers as t_layers
from repro_torch.gnn import model as t_model
from repro_torch.kernels import ops as t_ops
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import gas_trainer as t_trainer
from repro_torch.train import optimizer as t_opt

N, F, D, C, K = 240, 10, 16, 4, 3
ZOO = ("gin", "gcnii", "appnp")
FWD = dict(rtol=1e-5, atol=1e-5)
STEP = dict(rtol=1e-4, atol=1e-4)
T = torch.from_numpy


def _graphs(n=N, seed=3):
    kw = dict(num_nodes=n, num_features=F, num_classes=C, homophily=0.7,
              feature_noise=1.5, seed=seed)
    return r_citation(**kw), t_citation(**kw)


def _spec_kw(op, **kw):
    return dict(op=op, d_in=F, d_hidden=D, num_classes=C, num_layers=K,
                heads=2, alpha=0.2, lam=0.7, **kw)


def _to_port(params):
    """A reference params tree carried across (`params_from_numpy`)."""
    flat = {k: np.asarray(v) for k, v in r_ckpt._flatten(params).items()}
    return t_ckpt.params_from_numpy(flat, device="cpu")


def _plans(op, history_dtype="f32", spec_kw=None, **cfg):
    """Both packages' plans and states on one partition, the port's
    params carried across from the reference's `init_gnn`."""
    rg, tg = _graphs()
    kw = _spec_kw(op, **(spec_kw or {}))
    rplan = r_rt.build_plan(rg, r_model.GNNSpec(**kw), r_rt.GASConfig(
        num_parts=3, backend="jnp", history_dtype=history_dtype, **cfg))
    tplan = t_rt.build_plan(tg, t_model.GNNSpec(**kw), t_rt.GASConfig(
        num_parts=3, history_dtype=history_dtype, **cfg), device="cpu")
    rstate = r_rt.init_state(rplan)
    tstate = t_rt.init_state(tplan, params=_to_port(rstate.params))
    return rplan, rstate, tplan, tstate


def _filled(rplan, rstate, tstate, seed=0):
    """Both states with the same random history tables and ages, so that
    the halo rows of layers >= 1 carry values."""
    rng = np.random.default_rng(seed)
    tabs = [rng.normal(size=t.shape).astype(np.float32)
            for t in rstate.histories.tables]
    age = rng.integers(0, 5, rstate.histories.age.shape).astype(np.int32)
    rh = dataclasses.replace(rstate.histories,
                             tables=tuple(jnp.asarray(t) for t in tabs),
                             age=jnp.asarray(age))
    tstate.histories = HistoryStore(tables=[T(t.copy()) for t in tabs],
                                    age=T(age.copy()), history_dtype="f32")
    return rstate.replace(histories=rh), tstate


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _layer_case(seed=0):
    """A 24-row x_all (20 destinations, 3 halo rows, the zero row), 70
    random edges with GCN-like weights (a tenth of them padding, weight 0,
    pointing at the trash segment) and their BCSR blocks."""
    rng = np.random.default_rng(seed)
    n_out, M, E = 20, 24, 70
    x = rng.normal(size=(M, D)).astype(np.float32)
    x[-1] = 0.0
    dst = rng.integers(0, n_out, E).astype(np.int32)
    src = rng.integers(0, M - 1, E).astype(np.int32)
    w = rng.uniform(0.1, 1.0, E).astype(np.float32)
    pad = rng.random(E) < 0.1
    dst[pad], src[pad], w[pad] = n_out, M - 1, 0.0
    valid = ~pad
    blocks = []
    for wv in (w, np.ones_like(w)):
        v, c, _, _ = t_ops.build_bcsr_rect(dst[valid], src[valid],
                                           wv[valid], n_out, M, bn=128)
        vt, ct, _, _ = t_ops.build_bcsr_rect(src[valid], dst[valid],
                                             wv[valid], M, n_out, bn=128)
        blocks.append(tuple(T(a) for a in (v, c, vt, ct)))
    h0 = rng.normal(size=(n_out, D)).astype(np.float32)
    return x, (dst, src), w, n_out, blocks, h0


@pytest.mark.parametrize("op", ZOO)
@pytest.mark.parametrize("route", ["coo", "blocks"])
def test_layers_match_reference(op, route):
    """Each layer over the COO and over the batch's blocks (GIN over the
    unit-weight family) against the reference layer over the COO, 1e-5;
    then its gradients on the block route against `jax.grad`."""
    x, (dst, src), w, n_out, (blocks, ublocks), h0 = _layer_case()
    redges, tedges = (jnp.asarray(dst), jnp.asarray(src)), (T(dst), T(src))
    key = jax.random.key(1)
    if op == "gin":
        rp = r_layers.init_gin(key, D, D)
        rp["eps"] = jnp.asarray(0.3, jnp.float32)
        r_fn = lambda p, xa: r_layers.gin(p, xa, redges, jnp.asarray(w),
                                          n_out)
        t_fn = lambda p, xa: t_layers.gin(
            p, xa, tedges, T(w), n_out,
            blocks=ublocks if route == "blocks" else None)
    elif op == "gcnii":
        rp = r_layers.init_gcnii(key, D)
        r_fn = lambda p, xa: r_layers.gcnii(p, xa, redges, jnp.asarray(w),
                                            n_out, jnp.asarray(h0), 0.1,
                                            0.4)
        t_fn = lambda p, xa: t_layers.gcnii(
            p, xa, tedges, T(w), n_out, T(h0), 0.1, 0.4,
            blocks=blocks if route == "blocks" else None)
    else:
        rp = {}
        r_fn = lambda p, xa: r_layers.appnp_prop(xa, redges, jnp.asarray(w),
                                                 n_out, jnp.asarray(h0),
                                                 0.1)
        t_fn = lambda p, xa: t_layers.appnp_prop(
            xa, tedges, T(w), n_out, T(h0), 0.1,
            blocks=blocks if route == "blocks" else None)
    tp = {k: T(np.array(v)).requires_grad_(True) for k, v in rp.items()}
    tx = T(x.copy()).requires_grad_(True)
    got = t_fn(tp, tx)
    want = r_fn(rp, jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    cot = np.random.default_rng(5).normal(size=want.shape).astype(np.float32)
    r_g = jax.grad(lambda p, xa: jnp.sum(r_fn(p, xa) * cot),
                   argnums=(0, 1))(rp, jnp.asarray(x))
    names = sorted(tp)
    t_g = torch.autograd.grad((got * T(cot)).sum(),
                              [tp[k] for k in names] + [tx])
    for a, b, name in zip(t_g, [r_g[0][k] for k in names] + [r_g[1]],
                          names + ["x_all"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **FWD)


# ---------------------------------------------------------------------------
# gas_aggregate: the table's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gas_aggregate_table_gradient(dtype):
    """x_in's and a float table's gradients of the fused aggregation
    against `jax.grad(..., argnums=(0, 1))` of the reference's (the
    `_gather_spmm_bwd` split of one transposed product; masked halo slots
    and duplicate halo ids included), f32 at 1e-5; the bf16 table's
    gradient is index-added in bf16 as the reference adds it, so within
    one bf16 step of it."""
    rng = np.random.default_rng(4)
    n_in, max_h, n_table, d, n_out = 18, 9, 30, 6, 18
    x_in = rng.normal(size=(n_in, d)).astype(np.float32)
    table = rng.normal(size=(n_table, d)).astype(np.float32)
    halo = rng.integers(0, n_table - 1, max_h).astype(np.int32)
    halo[3] = halo[5]
    hmask = rng.random(max_h) < 0.75
    hmask[3] = hmask[5] = True
    M = n_in + max_h + 1
    E = 60
    dst = rng.integers(0, n_out, E)
    src = rng.integers(0, M - 1, E)
    w = rng.uniform(0.1, 1.0, E).astype(np.float32)
    v, c, _, _ = t_ops.build_bcsr_rect(dst, src, w, n_out, M, bn=128)
    vt, ct, _, _ = t_ops.build_bcsr_rect(src, dst, w, M, n_out, bn=128)
    cot = rng.normal(size=(n_out, d)).astype(np.float32)
    rdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16

    def r_loss(xi, tb):
        out = r_ops.gas_aggregate(xi, tb, jnp.asarray(halo),
                                  jnp.asarray(hmask), n_out,
                                  (jnp.asarray(v), jnp.asarray(c)),
                                  backend="jnp")
        return jnp.sum(out.astype(jnp.float32) * cot)

    r_dx, r_dt = jax.grad(r_loss, argnums=(0, 1))(
        jnp.asarray(x_in), jnp.asarray(table).astype(rdt))
    tx = T(x_in.copy()).requires_grad_(True)
    tt = T(table.copy()).to(tdt).requires_grad_(True)
    out = t_ops.gas_aggregate(tx, tt, T(halo), T(hmask), n_out,
                              tuple(T(a) for a in (v, c, vt, ct)))
    t_dx, t_dt = torch.autograd.grad((out.float() * T(cot)).sum(), (tx, tt))
    assert t_dt.dtype == tdt
    np.testing.assert_allclose(t_dx.numpy(), np.asarray(r_dx), **FWD)
    want = np.asarray(r_dt.astype(jnp.float32))
    got = t_dt.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **FWD)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-5)
    # rows no valid halo slot names get exactly zero
    untouched = np.setdiff1d(np.arange(n_table), halo[hmask])
    assert not got[untouched].any()


# ---------------------------------------------------------------------------
# gas_batch_forward over its routes
# ---------------------------------------------------------------------------

def _ref_forward(rplan, rstate, batch, **kw):
    logits, store, reg, diags = r_model.gas_batch_forward(
        rstate.params, rplan.spec, rplan.x, batch, rstate.histories,
        backend="jnp", **kw)
    return logits, store, reg, diags


@pytest.mark.parametrize("op,fuse", [(op, f) for op in ZOO
                                     for f in (True, False)])
def test_gas_batch_forward_routes_match_reference(op, fuse, monkeypatch):
    """The port's forward on the fused route (layers >= 1 through
    `gather_spmm`, GIN over the unit-weight blocks) and on the
    materialized route against the reference's over the COO, from the
    same filled history store: logits and every pushed table at 1e-5,
    the clock bitwise, and the route each layer took."""
    rplan, rstate, tplan, tstate = _plans(op)
    rstate, tstate = _filled(rplan, rstate, tstate)
    calls = []
    for name in ("_fused_prop", "_prop"):
        real = getattr(t_model, name)
        monkeypatch.setattr(t_model, name, lambda *a, _n=name, _f=real, **k:
                            calls.append(_n) or _f(*a, **k))
    r_logits, r_store, _, r_diags = _ref_forward(rplan, rstate,
                                                 rplan.batch(1))
    with torch.no_grad():
        t_logits, t_store, t_diags = t_model.gas_batch_forward(
            tstate.params, tplan.spec, tplan.x, tplan.batch(1),
            tstate.histories, fuse_halo=fuse)
    assert calls == ["_prop"] + ["_fused_prop" if fuse else "_prop"] * (K - 1)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits), **FWD)
    for a, b in zip(t_store.tables, r_store.tables):
        np.testing.assert_allclose(a.numpy()[:N], np.asarray(b)[:N], **FWD)
    np.testing.assert_array_equal(t_store.age.numpy(), np.asarray(r_store.age))
    for k in ("halo_age_mean", "halo_age_max"):
        assert float(t_diags[k]) == pytest.approx(float(r_diags[k]))
    assert float(t_diags["reg"]) == 0.0


@pytest.mark.parametrize("op", ZOO)
def test_halo_age_decay_matches_reference(op, monkeypatch):
    """`halo_age_decay=0.5` over a store whose halo rows have ages 0-4:
    the forward against the reference's at 1e-5, every layer on the
    materialized route; the damping moves the logits; in `predict` too."""
    rplan, rstate, tplan, tstate = _plans(op)
    rstate, tstate = _filled(rplan, rstate, tstate, seed=1)
    calls = []
    real = t_model._fused_prop
    monkeypatch.setattr(t_model, "_fused_prop",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    r_logits, _, _, _ = _ref_forward(rplan, rstate, rplan.batch(0),
                                     halo_age_decay=0.5)
    r_plain, _, _, _ = _ref_forward(rplan, rstate, rplan.batch(0))
    with torch.no_grad():
        t_logits, _, _ = t_model.gas_batch_forward(
            tstate.params, tplan.spec, tplan.x, tplan.batch(0),
            tstate.histories.clone(), halo_age_decay=0.5)
    assert not calls
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits), **FWD)
    assert not np.allclose(np.asarray(r_logits), np.asarray(r_plain),
                           atol=1e-4)
    cfg = dataclasses.replace(tplan.config, halo_age_decay=0.5)
    rcfg = dataclasses.replace(rplan.config, halo_age_decay=0.5)
    rplan2 = dataclasses.replace(rplan, config=rcfg, _predict=None)
    got = t_rt.predict(dataclasses.replace(tplan, config=cfg), tstate)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(r_rt.predict(rplan2, rstate)),
                               **FWD)


# ---------------------------------------------------------------------------
# The Eq. 3 regularizer
# ---------------------------------------------------------------------------

def _ref_step_grads(rplan, rstate, batch, rng=None, halo_age_decay=0.0):
    """The reference step's loss (ce + reg_weight * reg), reg, gradients
    and store (its `_make_step_fn_ex` loss, without the update)."""
    spec = rplan.spec

    def loss_fn(p):
        logits, store, reg, _ = r_model.gas_batch_forward(
            p, spec, rplan.x, batch, rstate.histories, rng=rng,
            backend="jnp", halo_age_decay=halo_age_decay)
        labels = jnp.take(rplan.y, batch.batch_nodes, mode="clip")
        m = jnp.take(rplan.train_mask, batch.batch_nodes, mode="clip")
        m = m & batch.batch_mask
        logz = jax.scipy.special.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, labels[:, None], axis=-1)[:, 0]
        ce = jnp.sum((logz - gold) * m) / jnp.maximum(jnp.sum(m), 1)
        return ce + spec.reg_weight * reg, (reg, store)

    (loss, (reg, store)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(rstate.params)
    return loss, reg, grads, store


def _replay_reference_noise(monkeypatch, step_key, num_layers):
    """Feed the port's per-layer draws (`gnn.model.reg_noise`) the
    reference's: the step's subkey, split once per layer, one
    `jax.random.normal` of the layer's x_all shape each."""
    keys = []
    r = step_key
    for _ in range(num_layers):
        r, s = jax.random.split(r)
        keys.append(s)
    it = iter(keys)
    monkeypatch.setattr(
        t_model, "reg_noise", lambda gen, shape, device: T(np.array(
            jax.random.normal(next(it), shape))).to(device))
    return keys


@pytest.mark.parametrize("op", ZOO)
@pytest.mark.parametrize("delta", [0.0, 0.1])
def test_eq3_step_matches_reference(op, delta, monkeypatch):
    """One step with `reg_weight=0.5`: at `reg_delta=0` the noise is zero
    and the term deterministic; at 0.1 the reference's draws are replayed
    through the port's noise function. Loss, reg and every gradient at
    1e-5, the pushed tables too; the fused route is off."""
    rplan, rstate, tplan, tstate = _plans(
        op, spec_kw=dict(reg_delta=delta, reg_weight=0.5))
    rstate, tstate = _filled(rplan, rstate, tstate, seed=2)
    _, sub = jax.random.split(rstate.rng)
    _replay_reference_noise(monkeypatch, sub, K)
    r_loss, r_reg, r_g, r_store = _ref_step_grads(rplan, rstate,
                                                  rplan.batch(2), rng=sub)
    t_g, t_m = t_rt.grads_and_metrics(tplan, tstate, tplan.batch(2))
    assert float(r_reg) > 0
    np.testing.assert_allclose(float(t_m["reg"]), float(r_reg), **FWD)
    np.testing.assert_allclose(float(t_m["loss"]), float(r_loss), **FWD)
    for a, b in zip(t_g, _leaves(r_g)):
        np.testing.assert_allclose(a.numpy(), b, **FWD)
    for a, b in zip(tstate.histories.tables, r_store.tables):
        np.testing.assert_allclose(a.numpy()[:N], np.asarray(b)[:N], **FWD)


def test_eq3_noise_comes_from_the_state_generator():
    """Without the replay, the port draws its noise from the state's
    generator: two states seeded alike give the same step, a step moves
    the generator, and `reg_weight=0` leaves the loss at ce."""
    _, _, tplan, tstate = _plans("gin", spec_kw=dict(reg_delta=0.1,
                                                     reg_weight=0.5))
    _, _, _, tstate2 = _plans("gin", spec_kw=dict(reg_delta=0.1,
                                                  reg_weight=0.5))
    g1, m1 = t_rt.grads_and_metrics(tplan, tstate, tplan.batch(0))
    g2, m2 = t_rt.grads_and_metrics(tplan, tstate2, tplan.batch(0))
    assert float(m1["reg"]) == float(m2["reg"]) > 0
    assert float(m1["loss"]) == pytest.approx(
        float(m1["ce"]) + 0.5 * float(m1["reg"]), rel=1e-6)
    _, m3 = t_rt.grads_and_metrics(tplan, tstate, tplan.batch(0))
    assert float(m3["reg"]) != float(m1["reg"])
    _, _, oplan, ostate = _plans("gin")
    _, m0 = t_rt.grads_and_metrics(oplan, ostate, oplan.batch(0))
    assert float(m0["reg"]) == 0.0 and float(m0["loss"]) == float(m0["ce"])


# ---------------------------------------------------------------------------
# Training steps
# ---------------------------------------------------------------------------

def _carry(rstate):
    """The reference state's params, moments and f32 tables as the
    port's."""
    flat = {k: np.asarray(v) for k, v in r_ckpt._flatten(rstate).items()}

    def tree(prefix):
        return t_ckpt.params_from_numpy(
            {k: v for k, v in flat.items() if k.startswith(prefix)}, "cpu")

    opt = t_opt.AdamWState(step=T(flat["opt_state/step"].astype(np.int32)),
                           m=tree("opt_state/m/"), v=tree("opt_state/v/"))
    store = HistoryStore(
        tables=[T(np.array(t)) for t in rstate.histories.tables],
        age=T(np.array(rstate.histories.age)), history_dtype="f32")
    rng = np.asarray(flat["rng"], np.uint32)
    return t_rt.GASState(params=tree("params/"), opt_state=opt,
                         histories=store, rng=rng)


@pytest.mark.parametrize("op,extra", [
    ("gin", {}), ("gcnii", {}), ("appnp", {}),
    ("gin", dict(reg_delta=0.05, reg_weight=0.05, halo_age_decay=0.3))])
def test_two_steps_match_reference(op, extra, monkeypatch):
    """Two steps (batches 0 then 2, the second after the first filled the
    tables): loss, every gradient, the pushed tables and the clock at
    1e-4, then the update from the reference's gradients at 1e-6; the
    reference's full step, carried across, starts the next. The last
    case turns on the regularizer (the reference's noise replayed) and
    the staleness decay together."""
    decay = extra.pop("halo_age_decay", 0.0)
    rplan, rstate, tplan, tstate = _plans(op, spec_kw=extra,
                                          halo_age_decay=decay)
    for b in (0, 2):
        rng, sub = jax.random.split(rstate.rng)
        _replay_reference_noise(monkeypatch, sub, K)
        r_loss, _, r_g, r_store = _ref_step_grads(
            rplan, rstate, rplan.batch(b),
            rng=sub if rplan.spec.reg_weight else None,
            halo_age_decay=decay)
        t_g, t_m = t_rt.grads_and_metrics(tplan, tstate, tplan.batch(b))
        np.testing.assert_allclose(float(t_m["loss"]), float(r_loss), **STEP)
        r_leaves = _leaves(r_g)
        assert len(t_g) == len(r_leaves)
        for a, g in zip(t_g, r_leaves):
            np.testing.assert_allclose(a.numpy(), g, **STEP)
        for a, t in zip(r_store.tables, tstate.histories.tables):
            np.testing.assert_allclose(t.numpy()[:N], np.asarray(a)[:N],
                                       **STEP)
        np.testing.assert_array_equal(tstate.histories.age.numpy(),
                                      np.asarray(r_store.age))
        cfg = rplan.config
        r_clip, _ = r_opt.clip_by_global_norm(r_g, cfg.grad_clip)
        r_p, _ = r_opt.adamw_update(
            r_clip, rstate.opt_state, rstate.params, lr=cfg.lr, b1=0.9,
            b2=0.999, weight_decay=cfg.weight_decay)
        t_rt.apply_update(tplan, tstate, [T(g.copy()) for g in r_leaves])
        for a, p in zip(t_opt.tree_leaves(tstate.params), _leaves(r_p)):
            np.testing.assert_allclose(a.numpy(), p, rtol=1e-6, atol=1e-6)
        rstate, _ = r_rt.train_step(rplan, rstate, rplan.batch(b))
        assert np.array_equal(np.asarray(jax.random.key_data(rstate.rng)),
                              np.asarray(jax.random.key_data(rng)))
        tstate = _carry(rstate)


# ---------------------------------------------------------------------------
# gas_forward, the layer-callback executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_gas_forward_matches_reference(fused):
    """Three GCN-style layers through `core.gas.gas_forward`, with and
    without its fused hook, against the reference's executor (the
    materialized route): outputs, pushed tables and diagnostics at
    1e-5."""
    rg, tg = _graphs(n=200, seed=2)
    part = np.random.default_rng(0).integers(0, 2, rg.num_nodes)
    part = np.unique(part, return_inverse=True)[1].astype(np.int32)
    rb = r_gas.build_batches(rg, part, build_blocks=True)
    tb = t_gas.build_batches(tg, part, build_blocks=True).to("cpu")
    ws = [np.random.default_rng(i).normal(size=(F if i == 0 else D, D))
          .astype(np.float32) * 0.3 for i in range(3)]
    rstore = r_hist.HistoryStore.create(rg.num_nodes + 1, [D, D],
                                        backend="jnp")
    tstore = HistoryStore.create(tg.num_nodes + 1, [D, D], device="cpu")
    rbatch, tbatch = rb.device_batch(1), tb[1]
    redges = (rbatch.edge_dst, rbatch.edge_src)

    def r_apply(ell, x_all, bt):
        agg = r_ops.gcn_aggregate(x_all, redges, bt.edge_w, rb.max_b,
                                  backend="jnp")
        return jnp.tanh(agg @ ws[ell])

    def t_apply(ell, x_all, bt):
        return torch.tanh(t_ops.gcn_aggregate(
            x_all, None, None, tb.max_b, bt.blocks) @ T(ws[ell]))

    def t_fused(ell, x_cur, halo_src, bt):
        table, scales, codebook, hn, hm = halo_src
        agg = t_ops.gas_aggregate(x_cur, table, hn, hm, tb.max_b, bt.blocks,
                                  scales=scales, codebook=codebook)
        return torch.tanh(agg @ T(ws[ell]))

    for step in range(2):   # the second pass reads the first's pushes
        r_out, rstore, r_diags = r_gas.gas_forward(
            r_apply, 3, jnp.asarray(rg.x), rbatch, rstore, backend="jnp")
        t_out, tstore, t_diags = t_gas.gas_forward(
            t_apply, 3, T(tg.x), tbatch, tstore,
            fused_layer_apply=t_fused if fused else None)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(r_out), **FWD)
        for a, b in zip(tstore.tables, rstore.tables):
            np.testing.assert_allclose(a.numpy()[:-1], np.asarray(b)[:-1],
                                       **FWD)
        assert set(t_diags) == set(r_diags)
        for k in r_diags:
            assert float(t_diags[k]) == pytest.approx(float(r_diags[k]))


# ---------------------------------------------------------------------------
# Proposition 3
# ---------------------------------------------------------------------------

def test_wl_counterexample_bitwise_and_proposition3():
    """The pair of graphs bitwise the reference's; on the port's GIN,
    nodes 0 and 2 (WL-equivalent) get identical embeddings under full
    message passing and different ones under the degree-rescaled
    sampled adjacency (`tests/test_error_bounds.py`'s property)."""
    for rg, tg in zip(r_wl(), t_wl()):
        for f in ("indptr", "indices", "x", "y", "train_mask", "val_mask",
                  "test_mask"):
            a, b = getattr(rg, f), getattr(tg, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert rg.num_classes == tg.num_classes
    params = t_layers.init_gin(torch.Generator().manual_seed(0), 3, 8)

    def run(graph):
        dst, src = graph.coo()
        n = graph.num_nodes
        deg = np.bincount(dst, minlength=n).astype(np.float32).clip(1)
        w = T((2.0 / deg[dst]).astype(np.float32))
        x_all = torch.cat([T(graph.x), torch.zeros((1, 3))], 0)
        with torch.no_grad():
            return t_layers.gin(params, x_all, (T(dst), T(src)), w,
                                n).numpy()

    g_full, g_samp = t_wl()
    h_full, h_samp = run(g_full), run(g_samp)
    assert np.allclose(h_full[0], h_full[2], atol=1e-5)
    assert not np.allclose(h_samp[0], h_samp[2], atol=1e-5)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ZOO)
def test_reference_checkpoint_loads(op, tmp_path):
    """A reference checkpoint of each op (after one step) read by the
    port's `load_gas_state_npz` and `load_gas_state`: params (GIN's 0-d
    eps, GCNII's w_in, APPNP's mlp and no layers), moments and tables
    bitwise; the port's own `save_gas_state` is read back by the
    reference; and the port predicts from the loaded state."""
    rplan, rstate, tplan, _ = _plans(op)
    rstate, _ = r_rt.train_step(rplan, rstate, rplan.batch(0))
    path = str(tmp_path / "ref.npz")
    r_ckpt.save_gas_state(path, rstate, step=1)
    params, store, step = t_ckpt.load_gas_state_npz(path, device="cpu")
    assert step == 1
    want = _leaves(rstate.params)
    got = t_opt.tree_leaves(params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b)
    if op == "gin":
        assert params["layers"][0]["eps"].dim() == 0
    state, _ = t_ckpt.load_gas_state(path, device="cpu")
    for a, b in zip(t_opt.tree_leaves(state.opt_state.m),
                    _leaves(rstate.opt_state.m)):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(store.tables[0].numpy(),
                                  np.asarray(rstate.histories.tables[0]))
    out = str(tmp_path / "port.npz")
    t_ckpt.save_gas_state(out, state, step=1)
    back, _ = r_ckpt.load_gas_state(out, r_rt.init_state(rplan))
    for a, b in zip(_leaves(back.params), want):
        np.testing.assert_array_equal(a, b)
    logits = t_rt.predict(tplan, state)
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# Paths without a parity test before: use_history=False, full batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,fuse", [("gcn", True), ("gcn", False),
                                     ("gat", True), ("gat", False),
                                     ("gin", True)])
def test_without_history_matches_reference(op, fuse):
    """`GASConfig(use_history=False)` (CLUSTER-GCN: halo rows of layers
    >= 1 are zeros, no route reads a table): one step's loss and
    gradients at 1e-4 against the reference's, fused on and off, from a
    filled store that must not leak in."""
    rplan, rstate, tplan, tstate = _plans(op, use_history=False,
                                          fuse_halo=fuse)
    rstate, tstate = _filled(rplan, rstate, tstate, seed=3)
    spec = rplan.spec

    def loss_fn(p):
        logits, store, _, _ = r_model.gas_batch_forward(
            p, spec, rplan.x, rplan.batch(1), rstate.histories,
            use_history=False, backend="jnp")
        labels = jnp.take(rplan.y, rplan.batch(1).batch_nodes, mode="clip")
        m = jnp.take(rplan.train_mask, rplan.batch(1).batch_nodes,
                     mode="clip") & rplan.batch(1).batch_mask
        logz = jax.scipy.special.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, labels[:, None], axis=-1)[:, 0]
        return jnp.sum((logz - gold) * m) / jnp.maximum(jnp.sum(m), 1)

    r_loss, r_g = jax.value_and_grad(loss_fn)(rstate.params)
    t_g, t_m = t_rt.grads_and_metrics(tplan, tstate, tplan.batch(1))
    np.testing.assert_allclose(float(t_m["loss"]), float(r_loss), **STEP)
    for a, g in zip(t_g, _leaves(r_g)):
        np.testing.assert_allclose(a.numpy(), g, **STEP)


@pytest.mark.parametrize("op,layers", [("appnp", 5), ("gcnii", 8)])
def test_full_batch_trainer_matches_reference(op, layers):
    """Table 1's full-batch baseline at a small size: the port's
    `FullBatchTrainer` from the reference trainer's params, three steps'
    losses at 1e-4, the params after them at 1e-4 and the exact
    accuracies at 1 node."""
    rg, tg = _graphs(n=300, seed=10)
    kw = dict(op=op, d_in=F, d_hidden=D, num_classes=C, num_layers=layers,
              alpha=0.1)
    tcfg = dict(epochs=3, lr=0.01, seed=0)
    rt = r_trainer.FullBatchTrainer(rg, r_model.GNNSpec(**kw),
                                    r_trainer.TrainConfig(**tcfg))
    tt = t_trainer.FullBatchTrainer(tg, t_model.GNNSpec(**kw),
                                    t_trainer.TrainConfig(**tcfg),
                                    device="cpu")
    tt.params = _to_port(rt.params)
    tt.opt_state = t_opt.adamw_init(tt.params)
    r_hist_ = rt.fit()
    t_hist_ = tt.fit()
    for a, b in zip(t_hist_, r_hist_):
        np.testing.assert_allclose(a["loss"], b["loss"], **STEP)
    for a, b in zip(t_opt.tree_leaves(tt.params), _leaves(rt.params)):
        np.testing.assert_allclose(a.numpy(), b, **STEP)
    ra, ta = rt.evaluate(), tt.evaluate()
    n = int(rg.test_mask.sum())
    for k in ra:
        assert abs(ra[k] - ta[k]) <= 1.0 / n, (k, ra, ta)
