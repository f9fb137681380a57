"""PyTorch port, the serving slice against the JAX reference.

Both packages get the same graph (bitwise, see test_torch_host.py), the
same weights (the reference's `init_gnn` carried across by
`params_from_numpy`, or a reference checkpoint read by
`load_gas_state_npz`) and the same history tables, and serve the same
requests, threading their states: the reference on the Pallas kernels in
interpret mode, the port on the CPU (its kernels' plain versions).

Floats compare at rtol=1e-5, atol=2e-5 (the tolerance tests/test_serve.py
uses for kernel backends: the block sums are taken in another order);
ages, versions, the refresh/step/chunk counts and the halo-age
diagnostics compare exactly. Over int8 and bf16 stores (the same
requests, SLO=0, None and 2) the logits and `hist_quant_err` compare at
1e-4 and the tables as dequantized values within one quantization step
per row, at least 99.9% of the codes equal: a pushed value a rounding away
from a code's .5 boundary may round to either side."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")

from repro.core import gas as r_gas
from repro.core import history as r_hist
from repro.core import runtime as r_runtime
from repro.core import serve as r_serve
from repro.data.graphs import citation_graph as r_citation
from repro.gnn import model as r_model
from repro.train.checkpoint import save_gas_state

from repro_torch.core import gas as t_gas
from repro_torch.core import history as t_hist
from repro_torch.core import serve as t_serve
from repro_torch.data.graphs import citation_graph as t_citation
from repro_torch.gnn import model as t_model
from repro_torch.train.checkpoint import (load_gas_state_npz,
                                          params_from_numpy)

N, F, D, C, L = 280, 20, 24, 3, 3
TOL = dict(rtol=1e-5, atol=2e-5)
BUCKETS = (8, 32)
ROOT = Path(__file__).resolve().parents[1]


def _graphs(seed=0):
    kw = dict(num_nodes=N, avg_degree=4.5, num_features=F, num_classes=C,
              seed=seed)
    return r_citation(**kw), t_citation(**kw)


def _specs():
    return (r_model.GNNSpec(op="gcn", d_in=F, d_hidden=D, num_classes=C,
                            num_layers=L),
            t_model.GNNSpec(op="gcn", d_in=F, d_hidden=D, num_classes=C,
                            num_layers=L))


def _flat(params):
    return {f"layers/{i}/{k}": np.asarray(v)
            for i, layer in enumerate(params["layers"])
            for k, v in layer.items()}


def _random_store(seed):
    rng = np.random.default_rng(seed)
    tables = [rng.standard_normal((N + 1, D)).astype(np.float32)
              for _ in range(L - 1)]
    age = rng.integers(0, 5, N + 1).astype(np.int32)
    return tables, age


def _stores(tables=None, age=None):
    rs = r_hist.HistoryStore.create(N + 1, [D] * (L - 1),
                                    backend="interpret", history_dtype="f32")
    ts = t_hist.HistoryStore.create(N + 1, [D] * (L - 1), device="cpu")
    if tables is not None:
        rs = dataclasses.replace(rs, tables=tuple(jnp.asarray(t)
                                                  for t in tables),
                                 age=jnp.asarray(age))
        ts.tables = [torch.from_numpy(t.copy()) for t in tables]
        ts.age = torch.from_numpy(age.copy())
    return rs, ts


def _serving(slo, rparams, rstore, tparams, tstore, seed=0):
    rg, tg = _graphs(seed)
    rspec, tspec = _specs()
    rplan = r_serve.build_serve_plan(rg, rspec, r_serve.ServeConfig(
        staleness_slo=slo, buckets=BUCKETS, backend="interpret"))
    tplan = t_serve.build_serve_plan(tg, tspec, t_serve.ServeConfig(
        staleness_slo=slo, buckets=BUCKETS), device="cpu")
    rstate = r_serve.init_serve_state(
        rplan, SimpleNamespace(params=rparams, histories=rstore))
    tstate = t_serve.init_serve_state(tplan,
                                      t_serve.ServeState(tparams, tstore))
    return rplan, rstate, tplan, tstate


def _assert_states_match(rstate, tstate):
    rs, ts = rstate.histories, tstate.histories
    for a, b in zip(rs.tables, ts.tables):
        np.testing.assert_allclose(b.numpy()[:N], np.asarray(a)[:N], **TOL)
    np.testing.assert_array_equal(ts.age.numpy(), np.asarray(rs.age))
    assert tstate.version == int(rstate.version)


def _requests():
    rng = np.random.default_rng(11)
    q1 = rng.choice(N, 20, replace=False)
    q2 = np.concatenate([q1[:3], rng.choice(N, 6, replace=False), q1[:2]])
    q3 = rng.choice(N, 45, replace=False)         # two chunks of <= 32
    return [q1, q2, q3, q1]


def _serve_both(slo, rparams, tparams, tables=None, age=None):
    rstore, tstore = _stores(tables, age)
    rplan, rstate, tplan, tstate = _serving(slo, rparams, rstore, tparams,
                                            tstore)
    _assert_states_match(rstate, tstate)
    chunks = []
    for q in _requests():
        rl, rstate, rd = r_serve.serve_request(rplan, rstate, q)
        tl, tstate, td = t_serve.serve_request(tplan, tstate, q)
        assert tl.shape == (len(q), C)
        np.testing.assert_allclose(tl, rl, **TOL)
        for k in ("refreshed", "num_steps", "num_chunks", "halo_age_mean",
                  "halo_age_max", "hist_quant_err"):
            assert td[k] == rd[k], (k, td[k], rd[k])
        assert td["host_build_ms"] > 0        # every request cuts a batch
        if slo is not None:
            assert td["halo_age_max"] <= slo
        _assert_states_match(rstate, tstate)
        chunks.append(td["num_chunks"])
    assert max(chunks) == 2
    return tplan, tstate


@pytest.fixture(scope="module")
def weights():
    rspec, _ = _specs()
    rparams = r_model.init_gnn(jax.random.PRNGKey(0), rspec)
    return rparams, params_from_numpy(_flat(rparams), device="cpu")


def test_serve_slo0_matches_reference(weights):
    rparams, tparams = weights
    tplan, tstate = _serve_both(0, rparams, tparams)
    # SLO=0 is exact: the full-graph forward, to f32 tolerance
    _, tg = _graphs()
    dst, src, w = t_gas.gcn_edge_weights(tg)
    exact = t_model.full_forward(
        tstate.params, tplan.spec, tplan.x,
        (torch.from_numpy(dst), torch.from_numpy(src)), torch.from_numpy(w),
        N).numpy()
    q = _requests()[2]
    logits, _, _ = t_serve.serve_request(tplan, tstate, q)
    np.testing.assert_allclose(logits, exact[q], **TOL)


def test_serve_slo_none_matches_reference(weights):
    rparams, tparams = weights
    _serve_both(None, rparams, tparams, *_random_store(1))


def test_serve_slo2_matches_reference(weights):
    rparams, tparams = weights
    _serve_both(2, rparams, tparams, *_random_store(2))


def test_gas_batch_forward_matches_reference(weights):
    rparams, tparams = weights
    rg, tg = _graphs()
    rspec, tspec = _specs()
    tables, age = _random_store(3)
    rstore, tstore = _stores(tables, age)
    indptr, src, w = t_gas.weighted_in_csr(tg)
    nodes = np.sort(np.random.default_rng(3).choice(N, 50, replace=False))
    hb = t_gas.subgraph_batch(indptr, src, w, N, nodes, build_blocks=True)
    rbatch = r_gas.subgraph_batch(indptr, src, w, N, nodes,
                                  build_blocks=True).device()
    rl, rstore2, _, rd = r_model.gas_batch_forward(
        rparams, rspec, jnp.asarray(rg.x), rbatch, rstore,
        backend="interpret")
    tl, tstore2, td = t_model.gas_batch_forward(
        tparams, tspec, torch.from_numpy(tg.x), hb.to("cpu"), tstore)
    assert tstore2 is tstore
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
    for a, b in zip(rstore2.tables, tstore.tables):
        np.testing.assert_allclose(b.numpy()[:N], np.asarray(a)[:N], **TOL)
    np.testing.assert_array_equal(tstore.age.numpy(), np.asarray(rstore2.age))
    for k in ("halo_age_mean", "halo_age_max", "hist_quant_err"):
        assert float(td[k]) == float(rd[k]), k
    # the unfused (materialized) branch, from the same store
    rstore, tstore = _stores(tables, age)
    rl, rstore2, _, _ = r_model.gas_batch_forward(
        rparams, rspec, jnp.asarray(rg.x), rbatch, rstore,
        backend="interpret", fuse_halo=False)
    tl, _, _ = t_model.gas_batch_forward(
        tparams, tspec, torch.from_numpy(tg.x), hb.to("cpu"), tstore,
        fuse_halo=False)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
    for a, b in zip(rstore2.tables, tstore.tables):
        np.testing.assert_allclose(b.numpy()[:N], np.asarray(a)[:N], **TOL)


@pytest.mark.parametrize("ell", [0, 1])
def test_materialize_x_all_and_diags_match_reference(ell):
    _, tg = _graphs()
    tables, age = _random_store(4)
    rstore, tstore = _stores(tables, age)
    indptr, src, w = t_gas.weighted_in_csr(tg)
    nodes = np.arange(30, 70)
    hb = t_gas.subgraph_batch(indptr, src, w, N, nodes)
    hb = hb.replace(halo_mask=hb.halo_mask & (np.arange(hb.max_h) % 3 > 0))
    rng = np.random.default_rng(ell)
    x_cur = rng.standard_normal((hb.max_b, D)).astype(np.float32)
    xh = rng.standard_normal((hb.max_h, D)).astype(np.float32)
    want = r_gas.materialize_x_all(
        ell, jnp.asarray(x_cur), jnp.asarray(xh), rstore,
        r_gas.subgraph_batch(indptr, src, w, N, nodes).replace(
            halo_mask=jnp.asarray(hb.halo_mask)).device(), True)
    tb = hb.to("cpu")
    got = t_gas.materialize_x_all(ell, torch.from_numpy(x_cur),
                                  torch.from_numpy(xh), tstore, tb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rd = r_gas.staleness_diags(jnp.asarray(age), jnp.asarray(hb.halo_nodes),
                               jnp.asarray(hb.halo_mask))
    td = t_gas.staleness_diags(tstore.age, tb.halo_nodes, tb.halo_mask)
    for k in rd:
        assert float(td[k]) == float(rd[k]), k


def test_full_forward_matches_reference(weights):
    rparams, tparams = weights
    rg, tg = _graphs()
    rspec, tspec = _specs()
    dst, src, w = t_gas.gcn_edge_weights(tg)
    want = np.asarray(r_model.full_forward(
        rparams, rspec, jnp.asarray(rg.x),
        (jnp.asarray(dst), jnp.asarray(src)), jnp.asarray(w), N))
    got = t_model.full_forward(
        tparams, tspec, torch.from_numpy(tg.x),
        (torch.from_numpy(dst), torch.from_numpy(src)), torch.from_numpy(w),
        N)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_load_reference_checkpoint(tmp_path):
    """A state the reference trained and saved with `save_gas_state`
    loads into the port, and both serve it alike."""
    rg, tg = _graphs()
    rspec, tspec = _specs()
    cfg = r_runtime.GASConfig(num_parts=3, backend="jnp", epochs=1, seed=0,
                              history_dtype="f32")
    plan = r_runtime.build_plan(rg, rspec, cfg)
    state, _ = r_runtime.fit(plan, r_runtime.init_state(plan), epochs=1)
    path = str(tmp_path / "gas.npz")
    save_gas_state(path, state, step=1, meta={"args": {"hidden": D}})

    params, store, step = load_gas_state_npz(path, device="cpu")
    assert step == 1
    for rl, tl in zip(state.params["layers"], params["layers"]):
        for k in ("w", "b"):
            np.testing.assert_array_equal(tl[k].numpy(), np.asarray(rl[k]))
    for a, b in zip(state.histories.tables, store.tables):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(store.age.numpy(),
                                  np.asarray(state.histories.age))

    rstore = dataclasses.replace(state.histories, backend="interpret")
    rplan, rstate, tplan, tstate = _serving(0, state.params, rstore, params,
                                            store)
    q = _requests()[0]
    rl, rstate, _ = r_serve.serve_request(rplan, rstate, q)
    tl, tstate, _ = t_serve.serve_request(tplan, tstate, q)
    np.testing.assert_allclose(tl, rl, **TOL)
    _assert_states_match(rstate, tstate)


def test_launcher_smoke_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_gas", "--smoke",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "smoke OK" in out.stdout


def _quantized_stores(history_dtype, tables=None, age=None):
    """Both packages' stores at `history_dtype`, empty or holding the f32
    `tables` quantized by the reference's codec."""
    dims = [D] * (L - 1)
    rs = r_hist.HistoryStore.create(N + 1, dims, backend="interpret",
                                    history_dtype=history_dtype)
    ts = t_hist.HistoryStore.create(N + 1, dims, history_dtype, "cpu")
    if tables is None:
        return rs, ts
    if history_dtype == "int8":
        enc = [r_hist.quantize_rows(jnp.asarray(t)) for t in tables]
        rs = dataclasses.replace(rs, tables=tuple(q for q, _ in enc),
                                 scales=tuple(s for _, s in enc),
                                 age=jnp.asarray(age))
        ts.scales = [torch.from_numpy(np.array(s)) for _, s in enc]
    else:
        rs = dataclasses.replace(rs, tables=tuple(
            jnp.asarray(t).astype(jnp.bfloat16) for t in tables),
            age=jnp.asarray(age))
    ts.tables = [torch.from_numpy(np.array(t, np.float32)).to(
        t_hist.get_codec(history_dtype).storage) for t in rs.tables]
    ts.age = torch.from_numpy(age.copy())
    return rs, ts


@pytest.mark.parametrize("history_dtype,slo", [("int8", 0), ("int8", None),
                                               ("int8", 2), ("bf16", 0)])
def test_serve_quantized_matches_reference(weights, history_dtype, slo):
    """A quantized store bound as it is: the requests of the f32 tests
    (SLO=0 refreshes push quantized rows), against the reference's
    `serve_request` over the same store; a plan pinning another precision
    refuses it."""
    rparams, tparams = weights
    fill = (None, None) if slo == 0 else _random_store(slo or 1)
    rstore, tstore = _quantized_stores(history_dtype, *fill)
    pinned = t_serve.build_serve_plan(_graphs()[1], _specs()[1],
                                      t_serve.ServeConfig(history_dtype="f32"),
                                      device="cpu")
    with pytest.raises(ValueError, match="pins history_dtype"):
        t_serve.init_serve_state(pinned, t_serve.ServeState(tparams, tstore))
    rplan, rstate, tplan, tstate = _serving(slo, rparams, rstore, tparams,
                                            tstore)
    for q in _requests():
        rl, rstate, rd = r_serve.serve_request(rplan, rstate, q)
        tl, tstate, td = t_serve.serve_request(tplan, tstate, q)
        np.testing.assert_allclose(tl, rl, rtol=1e-4, atol=1e-4)
        for k in ("refreshed", "num_steps", "num_chunks", "halo_age_mean",
                  "halo_age_max"):
            assert td[k] == rd[k], (k, td[k], rd[k])
        np.testing.assert_allclose(td["hist_quant_err"],
                                   rd["hist_quant_err"], rtol=1e-4)
        assert td["hist_quant_err"] > 0       # every step pushes
        np.testing.assert_array_equal(tstate.histories.age.numpy(),
                                      np.asarray(rstate.histories.age))
    rs, ts = rstate.histories, tstate.histories
    every = np.arange(N, dtype=np.int32)
    for ell in range(L - 1):
        want = np.asarray(rs.pull(ell, jnp.asarray(every)).astype(
            jnp.float32))
        got = ts.pull(ell, torch.from_numpy(every)).float().numpy()
        step = (np.asarray(rs.scales[ell])[:N, None]
                if history_dtype == "int8"
                else np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7 + 1e-4)
        assert np.all(np.abs(got - want) <= step * (1 + 1e-5))
        same = np.mean(np.asarray(rs.tables[ell], np.float32)[:N]
                       == ts.tables[ell].float().numpy()[:N])
        assert same >= 0.999, same
