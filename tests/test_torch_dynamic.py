"""PyTorch port, evolving graphs on the CPU against the JAX reference.

The reference's small fixtures (tests/test_dynamic.py: 160 nodes, 8
features and hidden units, 3 layers, 2 heads, 4 parts). Host code is
bitwise the reference's: `random_delta`, `apply_delta` and a delta's
seeds, the validation messages, `out_closure`, `assign_new_nodes` and
`incremental_repair`, `patch_batches` (the index rows and both block
families, also against the port's own from-scratch `build_batches`), and
`HistoryStore.grow` for every store type. `advance` runs in both
packages from the same carried state (the reference's initial weights
through `params_from_numpy`, seeded tables, scales and clock), the
reference on its plain `jnp` backend: the partition, the batches and the
`AdvanceInfo` counts equal, tables outside the delta's out-closure
bitwise, inside at rtol=1e-5, atol=2e-5 (block sums in another order),
int8 codes bitwise and scales at 1e-5, ages exact, and the old store left
as it was. `fit_dynamic` over two deltas (one a callable) at the
reference's node counts and cold flags, losses and accuracies at 1e-5.
Also the launcher's and the example's runs, and the reference's legacy
`Histories` helpers and executor guards the port now carries."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")

from repro.core import delta as r_delta
from repro.core import dynamic as r_dyn
from repro.core import gas as r_gas
from repro.core import history as r_hist
from repro.core import partition as r_part
from repro.core import runtime as r_rt
from repro.data.graphs import citation_graph as r_citation
from repro.gnn import model as r_model
from repro.kernels import ops as r_ops
from repro.train import checkpoint as r_ckpt

from repro_torch.core import delta as t_delta
from repro_torch.core import dynamic as t_dyn
from repro_torch.core import gas as t_gas
from repro_torch.core import history as t_hist
from repro_torch.core import partition as t_part
from repro_torch.core import runtime as t_rt
from repro_torch.data.graphs import citation_graph as t_citation
from repro_torch.examples import evolving_graph
from repro_torch.gnn import model as t_model
from repro_torch.kernels import ops as t_ops
from repro_torch.launch import train_dynamic
from repro_torch.train import checkpoint as t_ckpt

N, F, D, C, L, HEADS, PARTS = 160, 8, 8, 3, 3, 2, 4
OPS = ("gcn", "gin", "gat", "pna", "gcnii", "appnp")
TOL = dict(rtol=1e-5, atol=2e-5)
INDEX_FIELDS = ("batch_nodes", "batch_mask", "halo_nodes", "halo_mask",
                "edge_dst", "edge_src", "edge_w")
BLOCK_FIELDS = ("forward", "transposed", "unit", "unit_transposed")
DELTA_KW = dict(edge_churn=0.02, nodes_add=3, new_degree=3, feat_frac=0.02,
                seed=7)


def _graphs(n=N, seed=0):
    kw = dict(num_nodes=n, num_features=F, num_classes=C, seed=seed)
    return r_citation(**kw), t_citation(**kw)


def _specs(op):
    kw = dict(op=op, d_in=F, d_hidden=D, num_classes=C, num_layers=L,
              heads=HEADS)
    return r_model.GNNSpec(**kw), t_model.GNNSpec(**kw)


def _dcfgs(history_dtype="f32", parts=PARTS, **kw):
    r = r_dyn.DynamicGASConfig(base=r_rt.GASConfig(
        num_parts=parts, backend="jnp", history_dtype=history_dtype), **kw)
    t = t_dyn.DynamicGASConfig(base=t_rt.GASConfig(
        num_parts=parts, history_dtype=history_dtype), **kw)
    return r, t


def _np(t):
    """A tensor's bits as numpy (bf16 as int16)."""
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _r_np(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _flat_params(params):
    return {k: np.asarray(v) for k, v in r_ckpt._flatten(params).items()}


def _assert_graphs_equal(rg, tg):
    for f in ("indptr", "indices", "x", "y", "train_mask", "val_mask",
              "test_mask"):
        a, b = getattr(rg, f), getattr(tg, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert rg.num_classes == tg.num_classes


def _assert_batches_equal(a, b, blocks=True):
    for f in INDEX_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    assert (a.num_batches, a.max_b, a.max_h, a.max_e) == \
        (b.num_batches, b.max_b, b.max_h, b.max_e)
    if not blocks:
        return
    for fam in BLOCK_FIELDS:
        sa, sb = getattr(a, fam), getattr(b, fam)
        assert (sa is None) == (sb is None), fam
        if sa is not None:
            np.testing.assert_array_equal(np.asarray(sa.vals),
                                          np.asarray(sb.vals), err_msg=fam)
            np.testing.assert_array_equal(np.asarray(sa.cols),
                                          np.asarray(sb.cols), err_msg=fam)


# ---------------------------------------------------------------------------
# Deltas, closures and the partition repair: bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", (0, 1, 2))
def test_random_and_applied_delta_bitwise(seed):
    rg, tg = _graphs(140, seed=seed)
    kw = dict(edge_churn=0.08, nodes_add=4, new_degree=3, feat_frac=0.05,
              seed=seed + 10)
    rd, td = r_delta.random_delta(rg, **kw), t_delta.random_delta(tg, **kw)
    for f in ("edges_add", "edges_del", "x_new", "y_new", "feat_nodes",
              "feat_values"):
        np.testing.assert_array_equal(getattr(rd, f), getattr(td, f),
                                      err_msg=f)
    assert td.num_new_nodes == rd.num_new_nodes == 4
    for fn in ("touched_nodes", "invalidation_seeds"):
        np.testing.assert_array_equal(getattr(rd, fn)(rg.num_nodes),
                                      getattr(td, fn)(tg.num_nodes))
    rg2, tg2 = r_delta.apply_delta(rg, rd), t_delta.apply_delta(tg, td)
    _assert_graphs_equal(rg2, tg2)
    seeds = td.invalidation_seeds(tg.num_nodes)
    for hops in (0, 1, 2, 3):
        np.testing.assert_array_equal(t_delta.out_closure(tg2, seeds, hops),
                                      r_delta.out_closure(rg2, seeds, hops))
    # set semantics: a present edge re-added and an absent one deleted
    # leave the structure as it was, in both
    dst, src = tg.coo()
    same = dict(edges_add=[(int(dst[0]), int(src[0]))],
                edges_del=[[0, 0 if seed else 1]])
    _assert_graphs_equal(
        r_delta.apply_delta(rg, r_delta.GraphDelta(**same)),
        t_delta.apply_delta(tg, t_delta.GraphDelta(**same)))
    assert t_delta.GraphDelta.empty().is_empty()
    assert not t_delta.GraphDelta(edges_add=[[0, 1]]).is_empty()


def _raises_alike(r_fn, t_fn):
    with pytest.raises(ValueError) as re_:
        r_fn()
    with pytest.raises(ValueError) as te:
        t_fn()
    assert str(te.value) == str(re_.value)


@pytest.mark.parametrize("case", ["edge_out_of_range", "x_new_width",
                                  "values_without_nodes", "duplicate_nodes",
                                  "rows_mismatch", "feat_node_new",
                                  "seed_out_of_range"])
def test_delta_validation_messages(case):
    rg, tg = _graphs(50)
    z = np.zeros((1, F), np.float32)
    kw = {"edge_out_of_range": dict(edges_add=[[0, 50]]),
          "x_new_width": dict(x_new=np.zeros((1, 5), np.float32)),
          "values_without_nodes": dict(feat_values=z),
          "duplicate_nodes": dict(feat_nodes=[3, 3],
                                  feat_values=np.zeros((2, F), np.float32)),
          "rows_mismatch": dict(feat_nodes=[3, 4], feat_values=z),
          "feat_node_new": dict(feat_nodes=[50], feat_values=z)}.get(case)
    if case == "seed_out_of_range":
        _raises_alike(lambda: r_delta.out_closure(rg, [50], 1),
                      lambda: t_delta.out_closure(tg, [50], 1))
        return
    _raises_alike(
        lambda: r_delta.apply_delta(rg, r_delta.GraphDelta(**kw)),
        lambda: t_delta.apply_delta(tg, t_delta.GraphDelta(**kw)))


@pytest.mark.parametrize("seed", (0, 3))
def test_partition_repair_bitwise(seed):
    rg, tg = _graphs(seed=seed)
    part = t_part.metis_like_partition(tg.indptr, tg.indices, PARTS,
                                       seed=0)
    np.testing.assert_array_equal(
        part, r_part.metis_like_partition(rg.indptr, rg.indices, PARTS,
                                          seed=0))
    td = t_delta.random_delta(tg, edge_churn=0.05, nodes_add=6,
                              feat_frac=0.02, seed=seed + 5)
    g2 = t_delta.apply_delta(tg, td)
    ext = t_part.assign_new_nodes(g2.indptr, g2.indices, part, PARTS)
    np.testing.assert_array_equal(
        ext, r_part.assign_new_nodes(g2.indptr, g2.indices, part, PARTS))
    assert ext.dtype == np.int32 and ext.shape == (g2.num_nodes,)
    region = t_delta.hop_closure(g2.indptr, g2.indices,
                                 td.invalidation_seeds(tg.num_nodes), 1)
    for passes in (1, 4):
        np.testing.assert_array_equal(
            t_part.incremental_repair(g2.indptr, g2.indices, ext, PARTS,
                                      region, passes=passes, seed=seed),
            r_part.incremental_repair(g2.indptr, g2.indices, ext, PARTS,
                                      region, passes=passes, seed=seed))


# ---------------------------------------------------------------------------
# Batch patching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("unit", [False, True], ids=["weighted", "unit"])
def test_patch_batches_bitwise(unit):
    """The reference's and the port's patches of the same stack agree in
    every array, and equal the port's from-scratch build at the old pads
    (the block counts grown as the patch grows them)."""
    rg, tg = _graphs(seed=1)
    part = t_part.metis_like_partition(tg.indptr, tg.indices, PARTS, seed=0)
    kw = dict(pad_to=(64, 96, 600), build_blocks=True, unit_weights=unit)
    old_t = t_gas.build_batches(tg, part, **kw)
    old_r = r_gas.build_batches(rg, part, **kw)
    _assert_batches_equal(old_r, old_t)
    td = t_delta.random_delta(tg, edge_churn=0.03, nodes_add=2, seed=4)
    g2 = t_delta.apply_delta(tg, td)
    part2 = t_part.assign_new_nodes(g2.indptr, g2.indices, part, PARTS)
    touched = td.touched_nodes(tg.num_nodes)
    rebuild = np.unique(part2[touched])
    got = t_gas.patch_batches(g2, part2, old_t, rebuild,
                              num_nodes_old=tg.num_nodes)
    want = r_gas.patch_batches(r_delta.apply_delta(rg, r_delta.random_delta(
        rg, edge_churn=0.03, nodes_add=2, seed=4)), part2, old_r, rebuild,
        num_nodes_old=rg.num_nodes)
    _assert_batches_equal(want, got)
    fam = got.unit if unit else got.forward
    fam_t = got.unit_transposed if unit else got.transposed
    scratch = t_gas.build_batches(g2, part2, pad_to=(64, 96, 600),
                                  build_blocks=True, unit_weights=unit,
                                  pad_k=fam.cols.shape[2],
                                  pad_k_t=fam_t.cols.shape[2])
    _assert_batches_equal(scratch, got)


def test_patch_batches_returns_none_on_pad_overflow():
    """Exact pads and a delta that inflates one batch's edge row: the
    patch refuses, in both packages (the reference's case)."""
    rg, tg = _graphs(120, seed=1)
    part = t_part.metis_like_partition(tg.indptr, tg.indices, 4, seed=0)
    hub = np.asarray([[0, v] for v in range(60, 100)])
    g2 = t_delta.apply_delta(tg, t_delta.GraphDelta(edges_add=hub))
    rebuild = np.unique(part[hub.ravel()])
    old = t_gas.build_batches(tg, part, build_blocks=False)
    assert t_gas.patch_batches(g2, part, old, rebuild) is None
    assert r_gas.patch_batches(
        r_delta.apply_delta(rg, r_delta.GraphDelta(edges_add=hub)), part,
        r_gas.build_batches(rg, part, build_blocks=False), rebuild) is None
    # a changed part count refuses too
    assert t_gas.patch_batches(g2, part % 3, old, [0]) is None


# ---------------------------------------------------------------------------
# HistoryStore.grow
# ---------------------------------------------------------------------------

def _seeded_stores(hd, dims, n_rows, seed=0):
    """The reference's and the port's stores of `hd` holding the same
    seeded tables (codes), scales and clock; vq shares the reference's
    codebooks and seeded statistics."""
    rng = np.random.default_rng(seed)
    rs = r_hist.HistoryStore.create(n_rows, dims, backend="jnp",
                                    history_dtype=hd)
    codec = t_hist.get_codec(hd)
    tables = []
    for t in rs.tables:
        shape = np.asarray(t).shape
        if hd == "int8":
            tables.append(rng.integers(-127, 128, shape).astype(np.int8))
        elif hd == "vq":
            tables.append(rng.integers(0, 256, shape).astype(np.uint8))
        else:
            tables.append(rng.standard_normal(shape).astype(np.float32))
    age = rng.integers(0, 7, n_rows).astype(np.int32)
    rkw = dict(tables=tuple(jnp.asarray(t, np.asarray(rs.tables[0]).dtype)
                            for t in tables), age=jnp.asarray(age))
    tkw = dict(tables=[torch.from_numpy(np.asarray(t)).to(codec.storage)
                       for t in tables], age=torch.from_numpy(age.copy()))
    if codec.scaled:
        scales = [rng.uniform(0.01, 2.0, n_rows).astype(np.float32)
                  for _ in dims]
        rkw["scales"] = tuple(map(jnp.asarray, scales))
        tkw["scales"] = [torch.from_numpy(s.copy()) for s in scales]
    if codec.vq:
        counts = [rng.integers(0, 5, np.asarray(c).shape).astype(np.float32)
                  for c in rs.cb_counts]
        rkw["cb_counts"] = tuple(map(jnp.asarray, counts))
        tkw.update(codebooks=[torch.from_numpy(np.array(c))
                              for c in rs.codebooks],
                   cb_counts=[torch.from_numpy(c.copy()) for c in counts],
                   cb_sums=[torch.from_numpy(np.array(s))
                            for s in rs.cb_sums])
    ts = t_hist.HistoryStore(history_dtype=hd, **tkw)
    return dataclasses.replace(rs, **rkw), ts


def _store_leaves(s):
    out = {"age": s.age}
    for name in ("tables", "scales", "codebooks", "cb_counts", "cb_sums"):
        for i, t in enumerate(getattr(s, name) or ()):
            out[f"{name}/{i}"] = t
    return out


@pytest.mark.parametrize("hd", ["f32", "bf16", "int8", "vq"])
def test_grow_bitwise(hd):
    rs, ts = _seeded_stores(hd, [16, 8], 41)
    before = {k: _np(v).copy() for k, v in _store_leaves(ts).items()}
    rg_, tg_ = rs.grow(5), ts.grow(5)
    rl, tl = _store_leaves(rg_), _store_leaves(tg_)
    assert rl.keys() == tl.keys()
    for k in rl:
        assert tl[k].dtype == ts.tables[0].dtype or not k.startswith(
            "tables"), k
        np.testing.assert_array_equal(_np(tl[k]), _r_np(rl[k]), err_msg=k)
    assert tg_.tables[0].shape[0] == 46 and tg_.history_dtype == hd
    # the old store is left as it was, and shares no tensor with the new
    for k, v in _store_leaves(ts).items():
        np.testing.assert_array_equal(_np(v), before[k], err_msg=k)
        assert v.data_ptr() != tl[k].data_ptr(), k
    assert ts.grow(0) is ts


# ---------------------------------------------------------------------------
# advance against the reference's
# ---------------------------------------------------------------------------

def _carried(op, hd, seed=0, **dkw):
    """Both packages' dynamic plans on the same graph and partition, and
    states with the reference's initial weights and the same seeded
    tables, scales and clock."""
    rg, tg = _graphs(seed=seed)
    rspec, tspec = _specs(op)
    rdc, tdc = _dcfgs(hd, **dkw)
    rplan = r_dyn.build_dynamic_plan(rg, rspec, rdc)
    tplan = t_dyn.build_dynamic_plan(tg, tspec, tdc, device="cpu",
                                     part=np.asarray(rplan.part))
    np.testing.assert_array_equal(
        tplan.part, t_rt.partition(tg, tdc.base))     # the same partition
    _assert_batches_equal(rplan.batches, tplan.batches, blocks=False)
    rstate = r_rt.init_state(rplan)
    tstate = t_rt.init_state(tplan, params=t_ckpt.params_from_numpy(
        _flat_params(rstate.params), device="cpu"))
    if hd in ("f32", "int8"):
        rs, ts = _seeded_stores(hd, tspec.hist_dims(), N + 1, seed=seed + 1)
        rstate = rstate.replace(histories=dataclasses.replace(
            rs, backend="jnp"))
        tstate.histories = ts
    return rplan, rstate, tplan, tstate, rdc, tdc


@pytest.mark.parametrize("hd", ["f32", "int8"])
@pytest.mark.parametrize("op", OPS)
def test_advance_matches_reference(op, hd):
    rplan, rstate, tplan, tstate, rdc, tdc = _carried(
        op, hd, cold_rebuild_frac=1.01)
    rg, tg = rplan.graph, tplan.graph
    rd = r_delta.random_delta(rg, **DELTA_KW)
    td = t_delta.random_delta(tg, **DELTA_KW)
    before = {k: _np(v).copy()
              for k, v in _store_leaves(tstate.histories).items()}
    rplan2, rstate2, rinfo = r_dyn.advance(rplan, rstate, rd, rdc)
    tplan2, tstate2, tinfo = t_dyn.advance(tplan, tstate, td, tdc)
    assert not tinfo.cold, tinfo.reason
    for f in ("cold", "reason", "num_new_nodes", "closure_size",
              "closure_frac", "rebuilt_parts", "reassigned"):
        assert getattr(tinfo, f) == getattr(rinfo, f), f
    np.testing.assert_array_equal(tplan2.part, np.asarray(rplan2.part))
    _assert_batches_equal(rplan2.batches, tplan2.batches, blocks=False)
    assert tplan2._pad_to == tuple(rplan2._pad_to)
    # the patched blocks are the from-scratch build's at the same pads
    _assert_batches_equal(t_gas.build_batches(
        tplan2.graph, tplan2.part, pad_to=tplan2._pad_to, build_blocks=True,
        unit_weights=tplan.unit_blocks, pad_k=tplan2._pad_k,
        pad_k_t=tplan2._pad_k_t), tplan2.batches)
    for name, a in (("x", tplan2.x), ("y", tplan2.y),
                    ("train_mask", tplan2.train_mask),
                    ("eval_w", tplan2.eval_w)):
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(getattr(rplan2, name)),
                                      err_msg=name)

    N2 = tg.num_nodes + td.num_new_nodes
    closure = t_delta.out_closure(tplan2.graph,
                                  td.invalidation_seeds(tg.num_nodes), L - 1)
    # the sentinel row N2 is the pushes' sacrificial row in the port
    outside = np.setdiff1d(np.arange(N2), closure)
    rh, th = rstate2.histories, tstate2.histories
    np.testing.assert_array_equal(th.age.numpy()[:N2],
                                  np.asarray(rh.age)[:N2])
    assert (th.age.numpy()[closure] == 0).all()
    for ell in range(len(th.tables)):
        got, want = th.tables[ell].numpy(), np.asarray(rh.tables[ell])
        np.testing.assert_array_equal(got[outside], want[outside],
                                      err_msg=f"outside, layer {ell}")
        if hd == "int8":
            np.testing.assert_array_equal(got[closure], want[closure],
                                          err_msg=f"codes, layer {ell}")
            s_got = th.scales[ell].numpy()
            s_want = np.asarray(rh.scales[ell])
            np.testing.assert_array_equal(s_got[outside], s_want[outside])
            # a scale is max|v| / 127: held as the values it is the
            # largest of are, at TOL over 127
            np.testing.assert_allclose(s_got[closure], s_want[closure],
                                       rtol=TOL["rtol"],
                                       atol=TOL["atol"] / 127)
        else:
            np.testing.assert_allclose(got[closure], want[closure], **TOL,
                                       err_msg=f"inside, layer {ell}")
    # the old plan and store are left as they were; params and optimizer
    # state ride through
    for k, v in _store_leaves(tstate.histories).items():
        np.testing.assert_array_equal(_np(v), before[k], err_msg=k)
    assert tplan.graph.num_nodes == tg.num_nodes
    assert tplan.batches.batch_nodes.max() == tg.num_nodes
    assert tstate2.params is tstate.params
    assert tstate2.opt_state is tstate.opt_state
    # training goes on over the advanced plan
    tstate3, m = t_rt.fit(tplan2, tstate2, epochs=1)
    assert np.isfinite(m[0]["loss"])
    assert t_rt.predict(tplan2, tstate3).shape == (N2, C)


def test_advance_cold_fallback():
    rplan, rstate, tplan, tstate, rdc, tdc = _carried(
        "gcn", "f32", seed=2, cold_rebuild_frac=0.0)
    kw = dict(edge_churn=0.01, nodes_add=2, seed=3)
    _, rstate2, rinfo = r_dyn.advance(
        rplan, rstate, r_delta.random_delta(rplan.graph, **kw), rdc)
    tplan2, tstate2, tinfo = t_dyn.advance(
        tplan, tstate, t_delta.random_delta(tplan.graph, **kw), tdc)
    assert tinfo.cold and "closure" in tinfo.reason
    assert tinfo.reason == rinfo.reason
    assert tinfo.rebuilt_parts == rinfo.rebuilt_parts == PARTS
    assert tplan2.graph.num_nodes == N + 2
    # a cold rebuild re-pushes everything: the whole clock resets
    np.testing.assert_array_equal(tstate2.histories.age.numpy(),
                                  np.asarray(rstate2.histories.age))
    assert (tstate2.histories.age.numpy()[:N + 2] == 0).all()
    for a, b in zip(tstate2.histories.tables, rstate2.histories.tables):
        np.testing.assert_allclose(a.numpy()[:N + 2],
                                   np.asarray(b)[:N + 2], **TOL)
    # a pad overflow falls back cold too
    hub = t_delta.GraphDelta(edges_add=[[0, v] for v in range(20, 150)])
    _, _, info = t_dyn.advance(tplan, tstate, hub, dataclasses.replace(
        tdc, cold_rebuild_frac=1.01, pad_slack=0.0))
    assert info.cold and info.reason == "pad overflow (or changed part count)"


def test_build_dynamic_plan_rejects_regrouped_epochs():
    _, tg = _graphs(80)
    _, tspec = _specs("gcn")
    rbase = r_rt.GASConfig(num_parts=4, backend="jnp", clusters_per_batch=2)
    tbase = t_rt.GASConfig(num_parts=4, clusters_per_batch=2)
    _raises_alike(
        lambda: r_dyn.build_dynamic_plan(
            _graphs(80)[0], _specs("gcn")[0],
            r_dyn.DynamicGASConfig(base=rbase)),
        lambda: t_dyn.build_dynamic_plan(
            tg, tspec, t_dyn.DynamicGASConfig(base=tbase), device="cpu"))


def test_fit_dynamic_matches_reference(monkeypatch):
    rg, tg = _graphs(110, seed=4)
    rspec, tspec = _specs("gcn")
    rdc, tdc = _dcfgs(parts=3, cold_rebuild_frac=1.01)
    rdc = dataclasses.replace(rdc, base=dataclasses.replace(rdc.base,
                                                            epochs=1))
    tdc = dataclasses.replace(tdc, base=dataclasses.replace(tdc.base,
                                                            epochs=1))
    losses = {"r": [], "t": []}
    for key, mod in (("r", r_dyn), ("t", t_dyn)):
        def spy(plan, state, epochs=None, _fit=mod.fit, _key=key, **kw):
            state, m = _fit(plan, state, epochs=epochs, **kw)
            losses[_key] += [e["loss"] for e in m]
            return state, m
        monkeypatch.setattr(mod, "fit", spy)

    def deltas(pkg):
        return [pkg.random_delta(tg if pkg is t_delta else rg,
                                 edge_churn=0.02, nodes_add=2, seed=11),
                lambda cur: pkg.random_delta(cur, edge_churn=0.02,
                                             nodes_add=1, feat_frac=0.03,
                                             seed=12)]
    rplan, rstate, rhist = r_dyn.fit_dynamic(rg, rspec, rdc,
                                             deltas(r_delta))
    params = t_ckpt.params_from_numpy(_flat_params(r_model.init_gnn(
        jax.random.key(0), rspec)), device="cpu")
    tplan, tstate, thist = t_dyn.fit_dynamic(tg, tspec, tdc,
                                             deltas(t_delta), device="cpu",
                                             params=params)
    assert [h["num_nodes"] for h in thist] == [110.0, 112.0, 113.0]
    assert len(thist) == len(rhist) == 3
    for th, rh in zip(thist, rhist):
        assert th.keys() == rh.keys()
        for k in ("snapshot", "num_nodes", "cold", "rebuilt_parts"):
            if k in rh:
                assert th[k] == rh[k], k
        for k in ("train_acc", "val_acc", "test_acc", "closure_frac"):
            if k in rh:
                np.testing.assert_allclose(th[k], rh[k], rtol=1e-5,
                                           err_msg=k)
    assert len(losses["t"]) == len(losses["r"]) == 3
    np.testing.assert_allclose(losses["t"], losses["r"], rtol=1e-5)
    np.testing.assert_array_equal(tplan.part, np.asarray(rplan.part))


def test_launcher_and_example_on_cpu(capsys):
    train_dynamic.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "smoke OK" in out and "incremental" in out
    hist = evolving_graph.main(nodes=300, snapshots=2, device="cpu")
    assert len(hist) == 3 and hist[-1]["num_nodes"] == 308.0
    assert "advances ran incrementally" in capsys.readouterr().out


def test_dynamic_entry_points_default_to_cuda():
    """device=None means "cuda": without a card the slice's entry points
    raise instead of running on the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    _, tg = _graphs(40)
    _, tspec = _specs("gcn")
    _, tdc = _dcfgs(parts=2)
    for call in (lambda: t_dyn.build_dynamic_plan(tg, tspec, tdc),
                 lambda: t_dyn.fit_dynamic(tg, tspec, tdc, []),
                 lambda: train_dynamic.main(["--smoke"]),
                 lambda: evolving_graph.main(nodes=60, snapshots=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_host_store_advance_bitwise_device_store():
    """A host store (on the CPU: the card's code path through the raw
    prefetch) advances bitwise as the device store does."""
    out = []
    for storage in ("device", "host"):
        _, tg = _graphs()
        _, tspec = _specs("gat")
        tdc = t_dyn.DynamicGASConfig(base=t_rt.GASConfig(
            num_parts=PARTS, history_dtype="int8", history_storage=storage,
            prefetch_depth=1), cold_rebuild_frac=1.01)
        plan = t_dyn.build_dynamic_plan(tg, tspec, tdc, device="cpu")
        state, _ = t_rt.fit(plan, t_rt.init_state(plan), epochs=1)
        _, state2, _ = t_dyn.advance(plan, state, t_delta.random_delta(
            tg, **DELTA_KW), tdc)
        assert state2.histories.storage == storage
        out.append({k: _np(v) for k, v in
                    _store_leaves(state2.histories).items()})
    for k in out[0]:
        np.testing.assert_array_equal(out[1][k], out[0][k], err_msg=k)


# ---------------------------------------------------------------------------
# The legacy history helpers and the executors' guards (ROADMAP A13)
# ---------------------------------------------------------------------------

def test_legacy_push_pull_roundtrip():
    """tests/test_gas_core.py's property on the port's free functions, and
    the push against the kernel op (tests/test_backend_dispatch.py)."""
    table = torch.zeros((10, 4))
    idx = torch.tensor([2, 5, 7, 10], dtype=torch.int32)   # last: padding
    mask = torch.tensor([True, True, True, False])
    vals = torch.arange(16.0).reshape(4, 4)
    t2 = t_hist.push(table, idx, vals, mask)
    np.testing.assert_array_equal(t_hist.pull(t2, idx[:3]).numpy(),
                                  vals[:3].numpy())
    assert float(t2[9].abs().sum()) == 0.0           # padding dropped
    assert float(table.abs().sum()) == 0.0           # a new table
    rng = np.random.default_rng(2)
    tab = torch.from_numpy(rng.standard_normal((50, 96)).astype(np.float32))
    idx = torch.from_numpy(rng.permutation(50)[:12].astype(np.int32))
    vals = torch.from_numpy(rng.standard_normal((12, 96)).astype(np.float32))
    mask = torch.from_numpy(rng.random(12) < 0.8)
    got = t_hist.push(tab, idx, vals, mask)
    np.testing.assert_array_equal(
        got.numpy(), t_ops.push_rows(tab.clone(), idx, vals, mask).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(r_hist.push(
            jnp.asarray(tab.numpy()), jnp.asarray(idx.numpy()),
            jnp.asarray(vals.numpy()), jnp.asarray(mask.numpy()))))


def test_legacy_histories_through_the_executor():
    """`init_histories`, `tick`, `history_bytes`, the store round trip and
    `gas_batch_forward` over a `Histories`, which comes back as one and
    equals the run over a `HistoryStore`."""
    _, tg = _graphs()
    _, tspec = _specs("gcn")
    plan = t_rt.build_plan(tg, tspec, t_rt.GASConfig(num_parts=PARTS),
                           device="cpu")
    params = t_model.init_gnn(tspec, seed=0, device="cpu")
    rh = r_hist.init_histories(N + 1, tspec.hist_dims())
    hist = t_hist.init_histories(N + 1, tspec.hist_dims(), device="cpu")
    assert t_hist.history_bytes(hist) == r_hist.history_bytes(rh)
    store = t_hist.HistoryStore.create(N + 1, tspec.hist_dims(), "f32",
                                       "cpu")
    batch = plan.batch(0)
    _, out, _ = t_model.gas_batch_forward(params, tspec, plan.x, batch, hist)
    _, ref, _ = t_model.gas_batch_forward(params, tspec, plan.x, batch,
                                          store)
    assert isinstance(out, t_hist.Histories)
    for a, b in zip(out.tables, ref.tables):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(out.age.numpy(), ref.age.numpy())
    _, out2, _ = t_gas.gas_forward(
        lambda ell, x_all, b: x_all[:b.batch_mask.shape[0]], 2, plan.x,
        batch, out)
    assert isinstance(out2, t_hist.Histories)
    age = t_hist.tick(out2, batch.batch_nodes, batch.batch_mask)
    np.testing.assert_array_equal(
        age.numpy(), np.asarray(r_hist.tick(
            r_hist.Histories(tables=[], age=jnp.asarray(out2.age.numpy())),
            jnp.asarray(batch.batch_nodes.numpy()),
            jnp.asarray(batch.batch_mask.numpy()))))
    back = t_hist.HistoryStore.from_histories(out2).to_histories()
    assert back.tables[0] is out2.tables[0] and back.age is out2.age
    _raises_alike(
        lambda: r_hist.HistoryStore.create(4, [8], backend="jnp",
                                           history_dtype="int8"
                                           ).to_histories(),
        lambda: t_hist.HistoryStore.create(4, [8], "int8",
                                           "cpu").to_histories())
    with pytest.raises(TypeError, match="GASBatch"):
        t_model.gas_batch_forward(params, tspec, plan.x, {}, store)
    assert t_gas.resolve_store(store) == (store, False)


@pytest.mark.parametrize("hd", ["f32", "bf16", "int8", "vq"])
def test_store_bytes_and_dtype_helpers(hd):
    dims = [16, 8]
    rs = r_hist.HistoryStore.create(33, dims, backend="jnp",
                                    history_dtype=hd)
    ts = t_hist.HistoryStore.create(33, dims, hd, "cpu")
    assert ts.bytes_per_table() == rs.bytes_per_table()
    assert ts.bytes() == rs.bytes()
    assert str(t_hist.storage_dtype(hd)) == \
        f"torch.{np.dtype(r_hist.storage_dtype(hd)).name}"
    assert t_hist.host_storage_supported()
    rg, tg = _graphs()
    part = t_part.random_partition(N, PARTS, seed=0)
    tb = t_gas.build_batches(tg, part, build_blocks=True)
    rb = r_gas.build_batches(rg, part, build_blocks=True)
    for b in range(PARTS):
        assert t_ops.bcsr_density(tb.forward.cols[b], tb.forward.vals[b]) \
            == r_ops.bcsr_density(np.asarray(rb.forward.cols[b]),
                                  np.asarray(rb.forward.vals[b]))
