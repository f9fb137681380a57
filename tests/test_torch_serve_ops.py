"""PyTorch port, serving every operator against the JAX reference.

Both packages get the same graph (bitwise, see test_torch_host.py), the
same initial weights (the reference's `init_gnn` carried across with
`params_from_numpy`) and the same history tables and clock (numpy), and
serve the same requests, threading their states: the reference on its
plain `jnp` backend, the port on the CPU (its kernels' plain versions,
over forward-only block families: the weighted one for GCN, GCNII and
APPNP, the unit-weight one for GIN, GAT and PNA).

Floats compare at rtol=1e-5, atol=2e-5 (the reference's kernel-backend
tolerance: the block sums are taken in another order); ages, versions,
the refresh/step/chunk counts and the halo-age diagnostics exactly; int8
codes and scales, bf16 table bits and vq codes bitwise, where the pushed
rows come from the same requests. Also here: `hop_closure` and
`apply_feature_update` against the reference, the deprecated shims, the
unit-weight serve blocks bitwise, and a host store served bitwise the
device store."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")

from repro.core import delta as r_delta
from repro.core import gas as r_gas
from repro.core import history as r_hist
from repro.core import serve as r_serve
from repro.data.graphs import citation_graph as r_citation
from repro.gnn import model as r_model

from repro_torch.core import delta as t_delta
from repro_torch.core import gas as t_gas
from repro_torch.core import history as t_hist
from repro_torch.core import serve as t_serve
from repro_torch.data.graphs import citation_graph as t_citation
from repro_torch.gnn import model as t_model
from repro_torch.train.checkpoint import params_from_numpy

N, F, D, C, L, HEADS = 150, 8, 8, 3, 3, 2
OPS = ("gcn", "gin", "gat", "gcnii", "appnp", "pna")
TOL = dict(rtol=1e-5, atol=2e-5)
BUCKETS = (8, 32)
# logits over a bf16 store: a table entry that rounded one bf16 step apart
# (2^-8 relative) moves the logits by as much, relative
BF16_RTOL = 2.0 ** -8


def _graphs(seed=0):
    kw = dict(num_nodes=N, num_features=F, num_classes=C, seed=seed)
    return r_citation(**kw), t_citation(**kw)


def _specs(op):
    kw = dict(op=op, d_in=F, d_hidden=D, num_classes=C, num_layers=L,
              heads=HEADS)
    return r_model.GNNSpec(**kw), t_model.GNNSpec(**kw)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


_PARAMS = {}


def _params(op):
    if op not in _PARAMS:
        rspec, _ = _specs(op)
        rp = r_model.init_gnn(jax.random.PRNGKey(0), rspec)
        _PARAMS[op] = (rp, _flat(rp))
    rp, flat = _PARAMS[op]
    return rp, params_from_numpy(flat, device="cpu")


def _stores(spec, history_dtype="f32", seed=None):
    """Both packages' stores of `history_dtype` over `spec`'s tables: zero
    (seed None), or f32 tables and ages drawn from `seed` (f32 stores)."""
    dims = spec.hist_dims()
    rs = r_hist.HistoryStore.create(N + 1, dims, backend="jnp",
                                    history_dtype=history_dtype)
    ts = t_hist.HistoryStore.create(N + 1, dims, history_dtype, "cpu")
    if history_dtype == "vq":
        ts.codebooks = [torch.from_numpy(np.array(c)) for c in rs.codebooks]
    if seed is not None:
        rng = np.random.default_rng(seed)
        tables = [rng.standard_normal((N + 1, d)).astype(np.float32)
                  for d in dims]
        age = rng.integers(0, 5, N + 1).astype(np.int32)
        rs = dataclasses.replace(rs, tables=tuple(map(jnp.asarray, tables)),
                                 age=jnp.asarray(age))
        ts.tables = [torch.from_numpy(t.copy()) for t in tables]
        ts.age = torch.from_numpy(age.copy())
    return rs, ts


def _serving(op, slo, rstore, tstore, seed=0):
    rg, tg = _graphs(seed)
    rspec, tspec = _specs(op)
    rparams, tparams = _params(op)
    rplan = r_serve.build_serve_plan(rg, rspec, r_serve.ServeConfig(
        staleness_slo=slo, buckets=BUCKETS, backend="jnp"))
    tplan = t_serve.build_serve_plan(tg, tspec, t_serve.ServeConfig(
        staleness_slo=slo, buckets=BUCKETS), device="cpu")
    rstate = r_serve.init_serve_state(
        rplan, SimpleNamespace(params=rparams, histories=rstore))
    tstate = t_serve.init_serve_state(tplan,
                                      t_serve.ServeState(tparams, tstore))
    return rplan, rstate, tplan, tstate


def _requests():
    rng = np.random.default_rng(11)
    q1 = rng.choice(N, 20, replace=False)
    q2 = rng.choice(N, 45, replace=False)          # two chunks of <= 32
    return [q1, q2, q1]


def _assert_tables(rstate, tstate, exact):
    """Clock and version bitwise; f32 tables at TOL, or with `exact` the
    stores' codes (int8, vq) bitwise, their scales (max |v| / 127 or max
    |v| of rows summed in another order) at TOL, and bf16 entries within
    one bf16 step, 2^-7 of the value (a row value a few f32 ulps from a
    rounding boundary rounds to either side), >= 99% of them equal."""
    rs, ts = rstate.histories, tstate.histories
    np.testing.assert_array_equal(ts.age.numpy(), np.asarray(rs.age))
    assert tstate.version == int(rstate.version)
    for ell, (a, b) in enumerate(zip(rs.tables, ts.tables)):
        want = np.asarray(a.astype(jnp.float32))[:N]
        got = b.float().numpy()[:N]
        if not exact:
            np.testing.assert_allclose(got, want, **TOL)
        elif b.dtype == torch.bfloat16:
            step = np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7
            assert np.all(np.abs(got - want) <= step)
            assert np.mean(got == want) >= 0.99
        else:
            np.testing.assert_array_equal(got, want)
        if rs.scales is not None:
            np.testing.assert_allclose(ts.scales[ell].numpy()[:N],
                                       np.asarray(rs.scales[ell])[:N], **TOL)


def _serve_both(op, slo, rstore, tstore, tol=TOL, exact_tables=False):
    rplan, rstate, tplan, tstate = _serving(op, slo, rstore, tstore)
    for q in _requests():
        rl, rstate, rd = r_serve.serve_request(rplan, rstate, q)
        tl, tstate, td = t_serve.serve_request(tplan, tstate, q)
        np.testing.assert_allclose(tl, np.asarray(rl), **tol)
        for k in ("refreshed", "num_steps", "num_chunks", "halo_age_mean",
                  "halo_age_max"):
            assert td[k] == rd[k], (k, td[k], rd[k])
        if slo is not None:
            assert td["halo_age_max"] <= slo
        _assert_tables(rstate, tstate, exact_tables)
    return tplan, tstate


@pytest.mark.parametrize("op", OPS)
def test_serve_slo0_every_op_matches_reference(op):
    """SLO=0 over f32 tables and ages drawn at random: the refreshes and
    the query batches of each operator, on its block family."""
    rspec, _ = _specs(op)
    tplan, tstate = _serve_both(op, 0, *_stores(rspec, seed=1))
    assert tplan.unit_weights == (op in t_model.UNIT_BLOCK_OPS)
    assert tstate.version >= 6           # 3 requests, each refreshes


@pytest.mark.parametrize("history_dtype", ("bf16", "int8"))
@pytest.mark.parametrize("op", ("gin", "gat", "pna"))
def test_serve_unit_ops_quantized_match_reference(op, history_dtype):
    """GIN, GAT and PNA over zero bf16 and int8 stores at SLO=0: every
    refresh pushes rounded or quantized rows, which both packages compute
    from the same sums in another order; the int8 codes come out bitwise
    the reference's (`_assert_tables`)."""
    rspec, _ = _specs(op)
    _serve_both(op, 0, *_stores(rspec, history_dtype),
                tol=dict(rtol=BF16_RTOL if history_dtype == "bf16" else 1e-4,
                         atol=1e-4), exact_tables=True)


@pytest.mark.parametrize("slo", (2, None))
def test_serve_vq_bounded_slo_matches_reference(slo):
    """vq serving under SLO 2 (refresh pushes encode against the bound
    codebook) and SLO None (no refresh; the query pushes still encode),
    from the reference's codebooks and random codes and scales: codes,
    scales and clock bitwise, logits within the tolerance, the codebooks
    untouched."""
    op = "gcn"
    rspec, _ = _specs(op)
    rstore, tstore = _stores(rspec, "vq")
    rng = np.random.default_rng(5)
    codes = [rng.integers(0, 256, t.shape).astype(np.uint8)
             for t in tstore.tables]
    scales = [rng.uniform(0.5, 2.0, N + 1).astype(np.float32)
              for _ in codes]
    age = rng.integers(0, 5, N + 1).astype(np.int32)
    rstore = dataclasses.replace(
        rstore, tables=tuple(map(jnp.asarray, codes)),
        scales=tuple(map(jnp.asarray, scales)), age=jnp.asarray(age))
    tstore.tables = [torch.from_numpy(c.copy()) for c in codes]
    tstore.scales = [torch.from_numpy(s.copy()) for s in scales]
    tstore.age = torch.from_numpy(age.copy())
    cb0 = [c.clone() for c in tstore.codebooks]
    _, tstate = _serve_both(op, slo, rstore, tstore, exact_tables=True)
    for a, b in zip(cb0, tstate.histories.codebooks):
        assert torch.equal(a, b)


def test_hop_closure_matches_reference():
    _, tg = _graphs()
    indptr, src, _ = t_gas.weighted_in_csr(tg)
    rng = np.random.default_rng(3)
    for hops in (0, 1, 2, 4):
        seeds = rng.choice(N, 5, replace=False)
        np.testing.assert_array_equal(
            t_delta.hop_closure(indptr, src, seeds, hops),
            r_delta.hop_closure(indptr, src, seeds, hops))
    assert t_delta.hop_closure(indptr, src, np.zeros(0, np.int64),
                               2).size == 0
    with pytest.raises(ValueError, match="seed ids"):
        t_delta.hop_closure(indptr, src, np.array([N]), 1)


@pytest.mark.parametrize("op", ("gcn", "gat"))
def test_feature_update_matches_reference(op):
    """`apply_feature_update`: the features rewritten, the (L-1)-hop
    closure's ages stamped INVALID_AGE bitwise the reference's, the
    version bumped, and the next SLO=0 requests at the tolerance on the
    new features, which move the logits."""
    rspec, _ = _specs(op)
    rplan, rstate, tplan, tstate = _serving(op, 0,
                                            *_stores(rspec, seed=2))
    q = np.arange(10, 40)
    rl0, rstate, _ = r_serve.serve_request(rplan, rstate, q)
    tl0, tstate, _ = t_serve.serve_request(tplan, tstate, q)
    rng = np.random.default_rng(8)
    upd = np.sort(rng.choice(N, 6, replace=False))
    vals = (tplan.graph.x[upd] + rng.normal(0, 2, (6, F))).astype(np.float32)
    v0 = tstate.version
    rstate = r_serve.apply_feature_update(rplan, rstate, upd, vals)
    tstate = t_serve.apply_feature_update(tplan, tstate, upd, vals)
    assert t_serve.INVALID_AGE == r_serve.INVALID_AGE
    assert tstate.version == v0 + 1 == int(rstate.version)
    np.testing.assert_array_equal(tstate.histories.age.numpy(),
                                  np.asarray(rstate.histories.age))
    np.testing.assert_array_equal(tplan.x.numpy(), np.asarray(rplan.x))
    closure = t_delta.hop_closure(tplan.indptr, tplan.src, upd, L - 1)
    assert (tstate.histories.age.numpy()[closure]
            == t_serve.INVALID_AGE).all()
    for _ in range(2):
        rl, rstate, _ = r_serve.serve_request(rplan, rstate, q)
        tl, tstate, td = t_serve.serve_request(tplan, tstate, q)
        np.testing.assert_allclose(tl, np.asarray(rl), **TOL)
        assert td["halo_age_max"] == 0.0
    assert np.abs(tl - tl0).max() > 1e-3
    # the reference's checks, with its messages
    for nodes, values, msg in (
            ([1, 1], np.zeros((2, F)), "feat_nodes must be unique"),
            ([1, 2], np.zeros((1, F)), r"feat_values rows \(1\)"),
            ([1], np.zeros((1, F + 1)), "feature width"),
            ([N], np.zeros((1, F)), "update ids must be in")):
        with pytest.raises(ValueError, match=msg):
            t_serve.apply_feature_update(tplan, tstate, np.array(nodes),
                                         values.astype(np.float32))
        with pytest.raises(ValueError, match=msg):
            r_serve.apply_feature_update(rplan, rstate, np.array(nodes),
                                         values.astype(np.float32))


def test_deprecated_shims_warn_and_match_typed_api():
    """`bind_state` / `serve` warn DeprecationWarning with the reference's
    texts and give what `init_serve_state` / `serve_request` give."""
    op = "gat"
    _, tspec = _specs(op)
    _, tg = _graphs()
    _, tparams = _params(op)
    _, store = _stores(_specs(op)[0], seed=4)

    def mk():
        return t_serve.build_serve_plan(tg, tspec, t_serve.ServeConfig(
            buckets=BUCKETS), device="cpu")

    p_new, p_old = mk(), mk()
    st_new = t_serve.init_serve_state(
        p_new, t_serve.ServeState(tparams, store.clone()))
    with pytest.warns(DeprecationWarning,
                      match=r"serve.bind_state is deprecated; use "
                            r"serve.init_serve_state\(plan, state\)"):
        st_old = t_serve.bind_state(
            p_old, SimpleNamespace(params=tparams, histories=store.clone()))
    assert isinstance(st_old, t_serve.ServeState)
    legacy = SimpleNamespace(params=tparams, histories=st_old.histories)
    for i, q in enumerate(_requests()[:2]):
        ln, st_new, dn = t_serve.serve_request(p_new, st_new, q)
        with pytest.warns(DeprecationWarning,
                          match=r"serve.serve is deprecated; use "
                                r"serve.serve_request\(plan, state, "
                                r"query_nodes\)"):
            lo, st_old, do = t_serve.serve(p_old, legacy if i == 0
                                           else st_old, q)
        np.testing.assert_array_equal(ln, lo)
        assert {k: v for k, v in dn.items() if k != "host_build_ms"} == \
            {k: v for k, v in do.items() if k != "host_build_ms"}
    for a, b in zip(st_new.histories.tables + [st_new.histories.age],
                    st_old.histories.tables + [st_old.histories.age]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("op", ("gin", "gat", "pna", "gcn"))
def test_serve_blocks_bitwise_reference(op):
    """A serve batch carries the op's family, forward only, bitwise the
    reference's `subgraph_batch` family (the reference also tiles the
    transposed one); K grows monotone per bucket and never shrinks."""
    rg, tg = _graphs()
    _, tspec = _specs(op)
    tplan = t_serve.build_serve_plan(tg, tspec, t_serve.ServeConfig(
        buckets=BUCKETS), device="cpu")
    unit = op in t_model.UNIT_BLOCK_OPS
    rng = np.random.default_rng(9)
    ks = []
    for size in (30, 3, 25):
        nodes = np.sort(rng.choice(N, size, replace=False))
        bucket = t_serve._bucket_for(tplan.query_buckets, size)
        k0 = tplan._pad_k.get(bucket, 1)
        hb = t_serve._host_request_batch(tplan, nodes, bucket)
        fam = hb.unit if unit else hb.forward
        assert (hb.forward is None) == unit and (hb.unit is None) != unit
        assert hb.transposed is None and hb.unit_transposed is None
        max_h, max_e = tplan.pads[bucket]
        rb = r_gas.subgraph_batch(tplan.indptr, tplan.src, tplan.w, N,
                                  nodes, max_b=bucket, max_h=max_h,
                                  max_e=max_e, build_blocks=True,
                                  unit_weights=unit, pad_k=k0)
        want = rb.unit if unit else rb.forward
        np.testing.assert_array_equal(fam.vals, np.asarray(want.vals))
        np.testing.assert_array_equal(fam.cols, np.asarray(want.cols))
        for f in ("batch_nodes", "halo_nodes", "edge_dst", "edge_src",
                  "edge_w"):
            np.testing.assert_array_equal(getattr(hb, f),
                                          np.asarray(getattr(rb, f)))
        ks.append((bucket, fam.cols.shape[1]))
        assert fam.cols.shape[1] >= k0
        assert tplan._pad_k[bucket] == fam.cols.shape[1]
    # the 25-node request shares the 30-node one's bucket: its K is the
    # floor that one set, at least
    assert ks[0][0] == ks[2][0] and ks[2][1] >= ks[0][1]
    # the forward-only unit family serves, and a backward through it
    # raises (serving runs none)
    if op in ("gat", "pna"):
        hb = t_serve.build_request_batch(tplan, np.arange(20), 32)
        x = torch.randn(hb.max_b + hb.max_h + 1, 6, requires_grad=True)
        if op == "pna":
            out = t_model.ops.pna_reduce(x, x, None, None, hb.max_b,
                                         hb.ublocks)[0]
        else:
            xs = x.reshape(-1, 2, 3)
            out = t_model.ops.edge_softmax_aggregate(
                xs, xs[..., 0], xs[..., 1], None, None, hb.max_b,
                hb.ublocks)
        with pytest.raises(ValueError, match="transposed unit blocks"):
            out.sum().backward()


@pytest.mark.parametrize("history_dtype", ("f32", "int8"))
def test_host_store_serves_bitwise_device_store(history_dtype):
    """A `history_storage="host"` store (read only through its raw
    prefetch into mini-tables, pushed through its raw rows) serves the
    same requests as the device store bitwise: logits, tables, scales and
    clock."""
    op = "gat"
    _, tspec = _specs(op)
    _, tg = _graphs()
    _, tparams = _params(op)
    cfg = t_serve.ServeConfig(buckets=BUCKETS)
    states = []
    for storage in ("device", "host"):
        plan = t_serve.build_serve_plan(tg, tspec, cfg, device="cpu")
        store = t_hist.HistoryStore.create(N + 1, tspec.hist_dims(),
                                           history_dtype, "cpu",
                                           storage=storage)
        state = t_serve.init_serve_state(plan,
                                         t_serve.ServeState(tparams, store))
        out = []
        for q in _requests():
            lg, state, _ = t_serve.serve_request(plan, state, q)
            out.append(lg)
        states.append((out, state.histories))
    (ld, dev), (lh, host) = states
    assert host.storage == "host"
    for a, b in zip(ld, lh):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(dev.tables + (dev.scales or []) + [dev.age],
                    host.tables + (host.scales or []) + [host.age]):
        assert torch.equal(a[:N], b[:N])


def test_make_serve_step_fn_is_serve_step():
    """The exposed step function gives `serve_step`'s logits and store
    (the version aside), and the step pushes but keeps the clock."""
    op = "pna"
    rspec, tspec = _specs(op)
    _, tg = _graphs()
    _, tparams = _params(op)
    outs = []
    for use_fn in (False, True):
        _, store = _stores(rspec, seed=6)
        plan = t_serve.build_serve_plan(tg, tspec, t_serve.ServeConfig(
            buckets=BUCKETS), device="cpu")
        state = t_serve.init_serve_state(plan,
                                         t_serve.ServeState(tparams, store))
        age0 = state.histories.age.clone()
        batch = t_serve.build_request_batch(plan, np.arange(5, 25), 32)
        ridx, rmask = t_serve._reset_arrays(np.arange(5, 9), 32, "cpu")
        if use_fn:
            step = t_serve.make_serve_step_fn(plan)
            logits, st, _ = step(tparams, state.histories, batch, ridx,
                                 rmask, plan.x)
        else:
            logits, state, _ = t_serve.serve_step(plan, state, batch, ridx,
                                                  rmask)
            assert state.version == 1
            st = state.histories
        want = age0.clone()
        want[5:9] = 0
        assert torch.equal(st.age, want)
        outs.append((logits, st))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1].tables, outs[1][1].tables):
        assert torch.equal(a, b)


@pytest.mark.parametrize("history_dtype", ("f32", "int8", "vq"))
def test_forward_without_pushes_writes_nothing(history_dtype):
    """`gas_batch_forward(apply_pushes=False)`: the logits and pushed rows
    of the in-place forward, bitwise, with no table, scale or clock
    written; the rows encoded by the codec (`HistoryCodec.encode`, or the
    cast to storage) are the bits the in-place push wrote; and
    `push_raw` of them into a copy of the old store gives the pushed
    store's rows."""
    op = "gat"
    _, tspec = _specs(op)
    _, tg = _graphs()
    _, tparams = _params(op)
    plan = t_serve.build_serve_plan(tg, tspec, t_serve.ServeConfig(
        buckets=BUCKETS), device="cpu")
    rng = np.random.default_rng(7)
    store = t_hist.HistoryStore.create(N + 1, tspec.hist_dims(),
                                       history_dtype, "cpu")
    idx = torch.arange(N, dtype=torch.int32)
    for ell in range(store.num_layers):
        store.push(ell, idx, torch.from_numpy(rng.standard_normal(
            (N, D)).astype(np.float32)), torch.ones(N, dtype=torch.bool))
    before = store.clone()
    batch = t_serve.build_request_batch(plan, np.arange(40, 70), 32)
    x = torch.from_numpy(tg.x)
    l0, _, d0, p0 = t_model.gas_batch_forward(
        tparams, tspec, x, batch, before, vq_stats=False,
        return_pushed=True, apply_pushes=False)
    for a, b in zip(before.tables + (before.scales or []) + [before.age],
                    store.tables + (store.scales or []) + [store.age]):
        assert torch.equal(a, b)
    pushed = store.clone()
    l1, _, d1, p1 = t_model.gas_batch_forward(
        tparams, tspec, x, batch, pushed, vq_stats=False,
        return_pushed=True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert float(d0["hist_quant_err"]) == pytest.approx(
        float(d1["hist_quant_err"]), rel=1e-5, abs=1e-12)
    codec = t_hist.get_codec(history_dtype)
    rows, scales = [], []
    for ell, pay in enumerate(p0):
        if codec.encode is None:
            rows.append(pay.to(codec.storage))
        else:
            r, s = codec.encode(pay, before.layer_codebook(ell))
            rows.append(r)
            scales.append(s)
    before.push_raw(batch.batch_nodes, batch.batch_mask, rows,
                    scales or None)
    for a, b in zip(before.tables + (before.scales or []),
                    pushed.tables + (pushed.scales or [])):
        assert torch.equal(a[:N], b[:N])
    with pytest.raises(ValueError, match="push_raw"):
        before.push_raw(batch.batch_nodes, batch.batch_mask, rows[:1],
                        scales or None)


def test_build_serve_plan_rejects_unknown_op():
    _, tg = _graphs()
    spec = t_model.GNNSpec(op="sage", d_in=F, d_hidden=D, num_classes=C,
                           num_layers=L)
    with pytest.raises(ValueError, match="unknown op"):
        t_serve.build_serve_plan(tg, spec, t_serve.ServeConfig(),
                                 device="cpu")
