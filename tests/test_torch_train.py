"""PyTorch port, the training slice against the JAX reference.

Host code compares bitwise: partitions, the stacked batches of every block
family, cluster grouping and padding bounds. The global-norm clip
compares at 1e-6 (the two frameworks sum a leaf in different orders);
the AdamW update, fed the reference's clipped gradients, bitwise.

The runtime runs GCN, GAT and PNA (300 nodes, 4 parts, d_hidden=16, 2
heads; PNA with log_deg_mean=1.8) from the reference's `init_gnn`
params carried across. One step's loss,
gradients and history tables compare at 1e-4 against the reference on
backend="interpret" (block sums in another order). The update then runs
in both frameworks on the reference's gradients and compares at 1e-6: fed
their own, an element whose gradient sits at rounding level would move by
about lr in a direction the rounding picks (in AdamW's first step
m / sqrt(v) is sign(g)). Two epochs' per-epoch mean losses compare at
1e-3 against backend="jnp" (segment sums, and the trajectories drift
apart by such flips), and the exact accuracies at 2 test nodes.

`python tests/test_torch_train.py --reference-acc [PARTITIONS.npz]
[--history-dtype f32|bf16|int8|vq] [--op CONFIG] [--perturb N ...]
[--rng-key N ...]` prints the reference's GAS test accuracy for
chip_smoke.py's training configurations (`CONFIGS`), from the port's
initial params (moved by one ulp for each `--perturb N > 0`, and with
the state's rng key replaced for each `--rng-key N`), on this host's
partitions or on the ones in the file (see `reference_accuracy`), over a
store of the given precision (a vq store from the port's initial
codebooks);
`--port-acc` runs the same on the port, on the CPU, and `--trajectory
EPOCHS` prints both packages' per-epoch mean losses side by side."""
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")
import _torch_threads  # noqa: E402  one torch thread a test process

from repro.core import gas as r_gas
from repro.core import partition as r_part
from repro.core import runtime as r_rt
from repro.data.graphs import citation_graph as r_citation
from repro.data.graphs import sbm_cluster_graph as r_sbm
from repro.gnn import model as r_model
from repro.train import checkpoint as r_ckpt
from repro.train import optimizer as r_opt

from repro_torch.core import gas as t_gas
from repro_torch.core import partition as t_part
from repro_torch.core import runtime as t_rt
from repro_torch.data.graphs import citation_graph as t_citation
from repro_torch.data.graphs import sbm_cluster_graph as t_sbm
from repro_torch.gnn import model as t_model
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import optimizer as t_opt

N, F, D, C = 300, 12, 16, 3
STEP = dict(rtol=1e-4, atol=1e-4)
T = torch.from_numpy


def _graphs(seed=0, n=N, f=F, c=C, **kw):
    kw = dict(num_nodes=n, num_features=f, num_classes=c, seed=seed, **kw)
    return r_citation(**kw), t_citation(**kw)


def _flat(params, prefix=""):
    """A params tree as flat "layers/0/w"-style keys of numpy arrays."""
    if isinstance(params, dict):
        return {k2: v2 for k, v in params.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(params, list):
        return {k2: v2 for i, v in enumerate(params)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(params)}


# ---------------------------------------------------------------------------
# Host code, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n,parts", [(0, 300, 4), (5, 700, 7)])
def test_partitions_bitwise(seed, n, parts):
    rg, _ = _graphs(seed=seed, n=n)
    want = r_part.metis_like_partition(rg.indptr, rg.indices, parts,
                                       seed=seed)
    got = t_part.metis_like_partition(rg.indptr, rg.indices, parts,
                                      seed=seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_part.random_partition(n, parts, seed),
                                  r_part.random_partition(n, parts, seed))
    assert t_part.edge_cut(rg.indptr, rg.indices, got) == \
        r_part.edge_cut(rg.indptr, rg.indices, want)


_FIELDS = ("batch_nodes", "batch_mask", "halo_nodes", "halo_mask",
           "edge_dst", "edge_src", "edge_w")
_FAMILIES = ("forward", "transposed", "unit", "unit_transposed")


def _assert_stack_equal(rb, tb):
    for f in _FIELDS:
        a, b = getattr(rb, f), getattr(tb, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("num_batches", "max_b", "max_h", "max_e", "bn"):
        assert getattr(rb, f) == getattr(tb, f), f
    for fam in _FAMILIES:
        ra, ta = getattr(rb, fam), getattr(tb, fam)
        assert (ra is None) == (ta is None), fam
        if ra is not None:
            np.testing.assert_array_equal(ra.vals, ta.vals, err_msg=fam)
            np.testing.assert_array_equal(ra.cols, ta.cols, err_msg=fam)


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("pads", [None, ((200, 260, 900), 5, 4)])
def test_build_batches_bitwise(unit, pads):
    rg, tg = _graphs()
    part = r_part.metis_like_partition(rg.indptr, rg.indices, 4)
    kw = {} if pads is None else dict(pad_to=pads[0], pad_k=pads[1],
                                      pad_k_t=pads[2])
    rb = r_gas.build_batches(rg, part, build_blocks=True, unit_weights=unit,
                             **kw)
    tb = t_gas.build_batches(tg, part, build_blocks=True, unit_weights=unit,
                             **kw)
    _assert_stack_equal(rb, tb)
    assert (tb.ublocks is None) != unit and (tb.blocks is None) == unit
    # no blocks unless asked: the index arrays alone
    _assert_stack_equal(r_gas.build_batches(rg, part, build_blocks=False),
                        t_gas.build_batches(tg, part))
    # one batch off the stack, and the device copy of the stack
    one = tb.to("cpu")[2]
    assert one.num_batches == 1
    np.testing.assert_array_equal(one.edge_src.numpy(), rb.edge_src[2])
    fam = one.unit if unit else one.forward
    np.testing.assert_array_equal(
        fam.vals.numpy(), (rb.unit if unit else rb.forward).vals[2])


def test_group_partition_and_padding_bounds_bitwise():
    rg, tg = _graphs(n=500)
    part = r_part.metis_like_partition(rg.indptr, rg.indices, 8)
    for k in (2, 3):
        np.testing.assert_array_equal(
            t_gas.group_partition(part, k, np.random.default_rng(k)),
            r_gas.group_partition(part, k, np.random.default_rng(k)))
        assert t_gas.padding_bounds(tg, part, k) == \
            r_gas.padding_bounds(rg, part, k)
    np.testing.assert_array_equal(t_gas.group_partition(part, 2),
                                  r_gas.group_partition(part, 2))


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def _opt_case():
    rng = np.random.default_rng(0)
    shapes = {"layers/0/w": (7, 5), "layers/0/b": (5,), "layers/1/w": (5, 3),
              "layers/1/b": (3,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10 ** (step - 1)).astype(np.float32)
              for k, s in shapes.items()} for step in range(3)]

    def tree(flat, conv):
        return {"layers": [{k: conv(flat[f"layers/{i}/{k}"]) for k in "bw"}
                           for i in range(2)]}

    return p0, grads, tree


def test_adamw_and_clip_match_reference():
    """The clip against the reference, at the gradients' three scales. The
    global norm may differ by an ulp: `jnp.sum` and `torch.sum` reduce a
    leaf in different orders (7.433969974517822 against 7.433969497680664
    at step 1 on one host), so the norm and the clipped leaves hold at
    rtol 1e-6, not bitwise."""
    _, grads, tree = _opt_case()
    for g in grads:
        rg_, r_gn = r_opt.clip_by_global_norm(tree(g, jnp.asarray), 2.0)
        tl, t_gn = t_opt.clip_by_global_norm(
            t_opt.tree_leaves(tree(g, T)), 2.0)
        np.testing.assert_allclose(float(t_gn), float(r_gn), rtol=1e-6)
        for a, b in zip(tl, jax.tree_util.tree_leaves(rg_)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


def test_adamw_update_bitwise_from_reference_clip():
    """The update against the reference: three AdamW steps, each fed the
    reference's clipped gradients (through numpy), give params and both
    moments bitwise equal to the reference's. Fed the port's own clip
    instead, an ulp of the global norm would compound through the moments
    under cancellation, which is the clip's tolerance, not the update's."""
    p0, grads, tree = _opt_case()
    rp = tree(p0, jnp.asarray)
    tp = tree(p0, lambda a: T(a.copy()))
    r_state, t_state = r_opt.adamw_init(rp), t_opt.adamw_init(tp)
    for step, g in enumerate(grads):
        rg_, _ = r_opt.clip_by_global_norm(tree(g, jnp.asarray), 2.0)
        tl = [T(np.array(a)) for a in jax.tree_util.tree_leaves(rg_)]
        rp, r_state = r_opt.adamw_update(rg_, r_state, rp, lr=0.01, b1=0.9,
                                         b2=0.999, weight_decay=5e-4)
        tp, t_state = t_opt.adamw_update(tl, t_state, tp, lr=0.01, b1=0.9,
                                         b2=0.999, weight_decay=5e-4)
        assert int(t_state.step) == int(r_state.step) == step + 1
        for tt, rt in ((tp, rp), (t_state.m, r_state.m),
                       (t_state.v, r_state.v)):
            for a, b in zip(t_opt.tree_leaves(tt),
                            jax.tree_util.tree_leaves(rt)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# Runtime, GCN, GAT and PNA
# ---------------------------------------------------------------------------

def _specs(op):
    kw = dict(op=op, d_in=F, d_hidden=D, num_classes=C, num_layers=2,
              heads=2, log_deg_mean=1.8 if op == "pna" else 1.0)
    return r_model.GNNSpec(**kw), t_model.GNNSpec(**kw)


def _plans(op, backend="interpret", history_dtype="f32", **cfg):
    rg, tg = _graphs()
    rspec, tspec = _specs(op)
    rplan = r_rt.build_plan(rg, rspec, r_rt.GASConfig(
        num_parts=4, backend=backend, history_dtype=history_dtype, **cfg))
    tplan = t_rt.build_plan(tg, tspec, t_rt.GASConfig(
        num_parts=4, history_dtype=history_dtype, **cfg), device="cpu")
    rstate = r_rt.init_state(rplan)
    tstate = t_rt.init_state(tplan, params=t_ckpt.params_from_numpy(
        _flat(rstate.params), device="cpu"))
    return rplan, rstate, tplan, tstate


@pytest.mark.parametrize("partitioner", ["metis", "random"])
def test_plan_from_a_given_partition(partitioner):
    """`partition(graph, config)` is the reference `build_plan`'s partition,
    and `build_plan(part=)` builds the reference's batches from it; a
    partition of another length raises."""
    rg, tg = _graphs()
    rspec, tspec = _specs("gcn")
    rplan = r_rt.build_plan(rg, rspec, r_rt.GASConfig(
        num_parts=4, partitioner=partitioner, backend="interpret"))
    cfg = t_rt.GASConfig(num_parts=4, partitioner=partitioner)
    part = t_rt.partition(tg, cfg)
    np.testing.assert_array_equal(part, rplan.part)
    tplan = t_rt.build_plan(tg, tspec, cfg, device="cpu", part=part)
    _assert_stack_equal(rplan.batches, tplan.batches)
    with pytest.raises(ValueError, match="part must have shape"):
        t_rt.build_plan(tg, tspec, cfg, device="cpu", part=part[:-1])


def _ref_grads(rplan, rstate, batch):
    """The reference step's loss, gradients and pushed store (its
    `_make_step_fn_ex` loss, without the update)."""
    spec = rplan.spec

    def loss_fn(p):
        logits, store, _, _ = r_model.gas_batch_forward(
            p, spec, rplan.x, batch, rstate.histories, backend=rplan.backend)
        labels = jnp.take(rplan.y, batch.batch_nodes, mode="clip")
        m = jnp.take(rplan.train_mask, batch.batch_nodes, mode="clip")
        m = m & batch.batch_mask
        logz = jax.scipy.special.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, labels[:, None], axis=-1)[:, 0]
        return jnp.sum((logz - gold) * m) / jnp.maximum(jnp.sum(m), 1), store

    (loss, store), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        rstate.params)
    return loss, grads, store


@pytest.mark.parametrize("op", ["gcn", "gat", "pna"])
def test_one_step_matches_reference(op):
    """Loss, every gradient and the pushed history tables of one step
    (batch 2, after a first step on batch 0 fills the tables), then the
    params after the update."""
    rplan, rstate, tplan, tstate = _plans(op)
    for b in (0, 2):
        r_loss, r_g, r_store = _ref_grads(rplan, rstate, rplan.batch(b))
        t_g, t_m = t_rt.grads_and_metrics(tplan, tstate, tplan.batch(b))
        np.testing.assert_allclose(float(t_m["loss"]), float(r_loss), **STEP)
        r_leaves = jax.tree_util.tree_leaves(r_g)
        assert len(t_g) == len(r_leaves)
        for a, g in zip(t_g, r_leaves):
            np.testing.assert_allclose(a.numpy(), np.asarray(g), **STEP)
        for a, t in zip(r_store.tables, tstate.histories.tables):
            np.testing.assert_allclose(t.numpy()[:N], np.asarray(a)[:N],
                                       **STEP)
        np.testing.assert_array_equal(tstate.histories.age.numpy(),
                                      np.asarray(r_store.age))
        # the update: the port's `apply_update` and the reference step's
        # (clip, then AdamW with the runtime's b2 and weight decay), both on
        # the reference's gradients, so that a gradient at rounding level,
        # whose sign the two frameworks may round apart, cannot move an
        # element by lr one way and not the other; what is left is the
        # rounding of the update itself
        cfg = rplan.config
        r_clip, _ = r_opt.clip_by_global_norm(r_g, cfg.grad_clip)
        r_p, r_os = r_opt.adamw_update(
            r_clip, rstate.opt_state, rstate.params, lr=cfg.lr, b1=0.9,
            b2=0.999, weight_decay=cfg.weight_decay)
        t_rt.apply_update(tplan, tstate, [T(np.array(g)) for g in r_leaves])
        assert int(tstate.opt_state.step) == int(r_os.step)
        for tt, rt, atol in ((tstate.params, r_p, 1e-6),
                             (tstate.opt_state.m, r_os.m, 1e-9),
                             (tstate.opt_state.v, r_os.v, 1e-9)):
            for a, p in zip(t_opt.tree_leaves(tt),
                            jax.tree_util.tree_leaves(rt)):
                np.testing.assert_allclose(a.numpy(), np.asarray(p),
                                           rtol=1e-6, atol=atol)
        # the full reference step from the same state, then re-sync: carry
        # its params, moments and tables over
        rstate, _ = r_rt.train_step(rplan, rstate, rplan.batch(b))
        tstate = _carry(rstate)


def _carry(rstate):
    flat = {k: np.asarray(v) for k, v in r_ckpt._flatten(rstate).items()}
    params = t_ckpt.params_from_numpy(
        {k: v for k, v in flat.items() if k.startswith("params/")}, "cpu")
    opt = t_opt.AdamWState(
        step=T(flat["opt_state/step"].astype(np.int32)),
        m=t_ckpt.params_from_numpy(
            {k: v for k, v in flat.items() if k.startswith("opt_state/m/")},
            "cpu"),
        v=t_ckpt.params_from_numpy(
            {k: v for k, v in flat.items() if k.startswith("opt_state/v/")},
            "cpu"))
    store = t_ckpt.HistoryStore(
        tables=[T(np.array(t)) for t in rstate.histories.tables],
        age=T(np.array(rstate.histories.age)), history_dtype="f32")
    return t_rt.GASState(params=params, opt_state=opt, histories=store,
                         rng=np.asarray(flat["rng"], np.uint32))


@pytest.mark.parametrize("op", ["gcn", "gat", "pna"])
def test_two_epochs_and_accuracy_match_reference(op):
    """Two shuffled epochs' mean losses against the reference's segment
    ("jnp") route, the exact accuracies after them, and `predict`, which
    must leave the state's tables and clock as they were."""
    rplan, rstate, tplan, tstate = _plans(op, backend="jnp")
    for e in range(2):
        rstate, rm = r_rt.train_epoch(rplan, rstate, e)
        tstate, tm = t_rt.train_epoch(tplan, tstate, e)
        np.testing.assert_allclose(tm["loss"], rm["loss"], rtol=1e-3)
        assert tm["halo_age_max"] == rm["halo_age_max"]
    r_acc = r_rt.evaluate_exact(rplan, rstate)
    t_acc = t_rt.evaluate_exact(tplan, tstate)
    n_test = int(tplan.graph.test_mask.sum())
    for k in ("train_acc", "val_acc", "test_acc"):
        assert abs(t_acc[k] - r_acc[k]) <= 2.0 / n_test, (k, t_acc, r_acc)
    tables = [t.clone() for t in tstate.histories.tables]
    age = tstate.histories.age.clone()
    logits = t_rt.predict(tplan, tstate)
    assert logits.shape == (N, C) and torch.isfinite(logits).all()
    for a, b in zip(tables, tstate.histories.tables):
        assert torch.equal(a, b)
    assert torch.equal(age, tstate.histories.age)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(r_rt.predict(rplan, rstate)),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("op", ["gcn", "gat", "pna"])
def test_two_int8_epochs_match_reference(op):
    """Two shuffled epochs over an int8 store against the reference's
    "jnp" route: per-epoch mean losses and `hist_quant_err` at 1e-3 (the
    f32 test's tolerance: the trajectories drift by the same flips, and a
    pushed value at a code's .5 boundary may round to either side), the
    exact accuracies at 2 test nodes."""
    rplan, rstate, tplan, tstate = _plans(op, backend="jnp",
                                          history_dtype="int8")
    for e in range(2):
        rstate, rm = r_rt.train_epoch(rplan, rstate, e)
        tstate, tm = t_rt.train_epoch(tplan, tstate, e)
        np.testing.assert_allclose(tm["loss"], rm["loss"], rtol=1e-3)
        assert tm["hist_quant_err"] > 0
        np.testing.assert_allclose(tm["hist_quant_err"],
                                   rm["hist_quant_err"], rtol=1e-3)
        assert tm["halo_age_max"] == rm["halo_age_max"]
    assert tstate.histories.tables[0].dtype == torch.int8
    r_acc = r_rt.evaluate_exact(rplan, rstate)
    t_acc = t_rt.evaluate_exact(tplan, tstate)
    n_test = int(tplan.graph.test_mask.sum())
    for k in ("train_acc", "val_acc", "test_acc"):
        assert abs(t_acc[k] - r_acc[k]) <= 2.0 / n_test, (k, t_acc, r_acc)


def test_clusters_per_batch_regroup_matches_reference():
    """Two clusters per batch, regrouped each epoch: the same padded
    batches as the reference's, epoch after epoch."""
    rplan, rstate, tplan, tstate = _plans("gcn", backend="interpret",
                                          clusters_per_batch=2)
    for e in range(2):
        if e > 0:
            r_rt._regroup(rplan)
            t_rt._regroup(tplan)
        _assert_stack_equal(rplan.batches, tplan.batches)
    tstate, m = t_rt.train_epoch(tplan, tstate, 2)
    assert np.isfinite(m["loss"])


def test_gas_state_checkpoint_roundtrips_through_reference(tmp_path):
    """The port's `save_gas_state` is read by the reference's
    `load_gas_state`, and the port reads the reference's back (optimizer
    state included)."""
    rplan, rstate, tplan, tstate = _plans("gat")
    tstate, _ = t_rt.train_step(tplan, tstate, tplan.batch(1))
    path = str(tmp_path / "port.npz")
    t_ckpt.save_gas_state(path, tstate, step=1, meta={"op": "gat"})
    restored, step = r_ckpt.load_gas_state(path, r_rt.init_state(rplan))
    assert step == 1
    want = {k: np.asarray(v) for k, v in r_ckpt._flatten(restored).items()}
    with np.load(path) as data:
        for k in data.files:
            if k.startswith("state/"):
                np.testing.assert_array_equal(data[k], want[k[6:]], err_msg=k)
    assert int(restored.opt_state.step) == 1
    back, step = t_ckpt.load_gas_state(path, device="cpu")
    assert step == 1
    for a, b in zip(t_opt.tree_leaves(back.opt_state.v),
                    t_opt.tree_leaves(tstate.opt_state.v)):
        assert torch.equal(a, b)
    assert torch.equal(back.histories.tables[0], tstate.histories.tables[0])


def test_unported_training_options_raise():
    # the async pipeline's knobs build (tests/test_torch_async.py trains
    # them); a placement outside ("device", "host") raises
    for cfg in (t_rt.GASConfig(num_parts=2, prefetch_depth=1),
                t_rt.GASConfig(num_parts=2, history_storage="host")):
        rg, tg = _graphs()
        plan = t_rt.build_plan(tg, _specs("gcn")[1], cfg, device="cpu")
        assert t_rt.init_state(plan).histories.storage == \
            (cfg.history_storage or "device")
    with pytest.raises(ValueError, match="history_storage must be"):
        t_rt.GASConfig(num_parts=2, history_storage="pcie")
    # the staleness decay, the regularizer, alpha, lam and dropout take
    # any value the reference takes
    t_rt.GASConfig(num_parts=2, halo_age_decay=0.5)
    t_model.GNNSpec(op="gat", d_in=4, d_hidden=8, num_classes=2,
                    num_layers=2, reg_weight=0.1, reg_delta=0.1, alpha=0.2,
                    lam=1.0, dropout=0.5)
    # fused_epoch builds, with the reference's name and default, and
    # trains (tests/test_torch_fused_epoch.py)
    assert not t_rt.GASConfig(num_parts=2).fused_epoch
    assert t_rt.GASConfig(num_parts=2, fused_epoch=True).fused_epoch
    rg, tg = _graphs()
    plan = t_rt.build_plan(tg, _specs("gcn")[1], t_rt.GASConfig(
        num_parts=2, fused_epoch=True, epochs=1), device="cpu")
    _, (m,) = t_rt.fit(plan, t_rt.init_state(plan))
    assert np.isfinite(m["loss"]) and plan._fused is not None
    # every operator serves (Queue A item 6 is ported): GAT's serve plan
    # reads the unit-weight blocks
    from repro_torch.core import serve as t_serve
    _, tg = _graphs()
    plan = t_serve.build_serve_plan(tg, _specs("gat")[1],
                                    t_serve.ServeConfig(), device="cpu")
    assert plan.unit_weights


# ---------------------------------------------------------------------------
# The reference accuracy chip_smoke.py holds the port to
# ---------------------------------------------------------------------------

# table 5's GAS GCN rows (benchmarks/table5_baselines.py:39-53), with and
# without histories
TABLE5_GCN = ("gas-gcn", "cluster-gcn")


def _reference_config(op: str):
    """chip_smoke.py's training configuration `op`: (the graph, the spec
    keywords, the `GASConfig` keywords) for both packages (GCN: the
    quickstart; GAT: the Cora shape; PNA: table 5's `gas-pna` graph and
    spec, `benchmarks/table5_baselines.py`; GCNII: its `gas-gcnii16` on
    the same graph; GIN: table 2's `gin-4L-cluster`,
    `benchmarks/table2_ablation.py`; GIN+reg: the deep-GNN example's GIN,
    `examples/deep_gnn_large_graph.py`; APPNP: table 1's `appnp-5L`,
    `benchmarks/table1_full_vs_gas.py`; table 5's `gas-gcn` and
    `cluster-gcn`, the latter without histories, on PNA's graph). The
    graph is a pair: the reference's and the port's."""
    cfg = dict(num_parts=16, epochs=60, lr=0.01)
    spec = dict(op=op, d_hidden=64, num_layers=2, heads=8)
    if op in ("gin", "gin+reg"):
        kw = (dict(num_nodes=900, num_communities=6, seed=22) if op == "gin"
              else dict(num_nodes=6000, num_communities=10, seed=2))
        graphs = (r_sbm(**kw), t_sbm(**kw))
        spec.update(op="gin", num_layers=4,
                    d_hidden=48 if op == "gin" else 64)
        if op == "gin":
            cfg.update(num_parts=24, clusters_per_batch=8, epochs=80)
        else:
            spec.update(reg_delta=0.05, reg_weight=0.05)
            cfg.update(num_parts=40, clusters_per_batch=10, epochs=40)
    else:
        if op == "gcn":
            kw = dict(num_nodes=2500, num_features=128, num_classes=7,
                      homophily=0.75, feature_noise=2.0, seed=0)
        elif op == "gat":
            kw = dict(num_nodes=2708, num_features=1433, num_classes=7,
                      seed=0)
        elif op == "appnp":
            kw = dict(num_nodes=1200, num_features=64, num_classes=6,
                      homophily=0.72, feature_noise=2.2, seed=10)
            spec.update(num_layers=5, alpha=0.1)
            cfg.update(num_parts=8)
        else:
            kw = dict(num_nodes=4000, num_features=64, num_classes=6,
                      homophily=0.7, feature_noise=2.5, seed=80)
            spec.update(d_hidden=48)
            if op == "pna":
                spec.update(log_deg_mean=1.8)
            elif op in TABLE5_GCN:
                spec.update(op="gcn")
                cfg.update(use_history=op == "gas-gcn")
            else:
                spec.update(num_layers=16, alpha=0.1)
        graphs = (r_citation(**kw), t_citation(**kw))
    spec.update(d_in=graphs[0].x.shape[1],
                num_classes=graphs[0].num_classes)
    return graphs, spec, cfg


def reference_accuracy(op: str, epochs=None, part=None,
                       history_dtype: str = "f32", perturb: int = 0,
                       rng_key=None):
    """The reference's exact accuracies after its epochs (60 unless the
    configuration says otherwise, or `epochs`) on the "jnp" backend for
    chip_smoke.py's configuration `op` (`_reference_config`), starting
    from the port's `init_gnn(spec, seed=0)` params carried across, so
    that both runs share graph, partition, initial weights and
    hyperparameters. `part` replaces the partition this host computes
    (e.g. one computed on another host, which may order equal degrees
    otherwise); `history_dtype` is the store's precision (a vq store
    starts from the port's initial codebooks). `perturb` > 0 moves every
    initial weight by one ulp, up or down as `default_rng(perturb)` draws:
    a run that differs from the unperturbed one by rounding alone, whose
    accuracy shows how far such differences carry after the epochs.
    `rng_key` replaces the state's key (`jax.random.key(rng_key)`; the
    default is `init_state`'s seed + 1), which draws the Eq. 3
    regularizer's noise. Returns (the partition's digest as chip_smoke.py
    prints it, accuracies)."""
    (g, _), spec_kw, cfg = _reference_config(op)
    cfg.update(history_dtype=history_dtype, epochs=epochs or cfg["epochs"])
    real = r_rt.metis_like_partition
    if part is not None:
        r_rt.metis_like_partition = lambda *a, **k: np.asarray(part, np.int32)
    try:
        plan = r_rt.build_plan(g, r_model.GNNSpec(**spec_kw), r_rt.GASConfig(
            partitioner="metis", backend="jnp", **cfg))
    finally:
        r_rt.metis_like_partition = real
    tparams = t_model.init_gnn(t_model.GNNSpec(**spec_kw), seed=0,
                               device="cpu")
    params = jax.tree_util.tree_map(jnp.asarray, _nudged(tparams, perturb))
    state = r_rt.init_state(plan).replace(params=params,
                                          opt_state=r_opt.adamw_init(params))
    if rng_key is not None:
        state = state.replace(rng=jax.random.key(rng_key))
    state = _with_port_codebooks(state)
    for e in range(cfg["epochs"]):
        state, _ = r_rt.train_epoch(plan, state, e)
    digest = hashlib.sha256(np.ascontiguousarray(
        plan.part, np.int32).tobytes()).hexdigest()[:12]
    return digest, r_rt.evaluate_exact(plan, state)


def _with_port_codebooks(rstate):
    """A reference state whose vq store starts from the port's initial
    codebooks (`vq_init_codebook(d)`, drawn from a `torch.Generator`), so
    that both packages start from the same quantizer; other stores are
    returned as they are."""
    h = rstate.histories
    if h.codebooks is None:
        return rstate
    from repro_torch.core.history import vq_init_codebook
    cbs = tuple(jnp.asarray(vq_init_codebook(
        cb.shape[0] * cb.shape[2], device="cpu").numpy()) for cb in h.codebooks)
    return rstate.replace(histories=dataclasses.replace(h, codebooks=cbs))


def _nudged(params, perturb: int):
    """The params tree with every weight moved by one ulp, up or down as
    `default_rng(perturb)` draws (unchanged for perturb 0), as numpy."""
    rng = np.random.default_rng(perturb)

    def nudge(a):
        a = a.numpy().copy()
        if perturb:
            a = np.nextafter(a, np.where(rng.random(a.shape) < 0.5, -np.inf,
                                         np.inf).astype(np.float32))
        return a

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [tree(v) for v in t]
        return nudge(t)

    return tree(params)


def port_accuracy(op: str, epochs=None, part=None,
                  history_dtype: str = "f32", perturb: int = 0,
                  rng_key=None):
    """`reference_accuracy`'s run on the port, on the CPU: the same graph,
    partition, initial weights (one-ulp perturbations included) and
    hyperparameters (`rng_key` seeds the port's own noise generator).
    Returns (the partition's digest, accuracies)."""
    (_, g), spec_kw, cfg = _reference_config(op)
    cfg.update(history_dtype=history_dtype, epochs=epochs or cfg["epochs"])
    real = t_rt.metis_like_partition
    if part is not None:
        t_rt.metis_like_partition = lambda *a, **k: np.asarray(part, np.int32)
    try:
        plan = t_rt.build_plan(g, t_model.GNNSpec(**spec_kw),
                               t_rt.GASConfig(partitioner="metis", **cfg),
                               device="cpu")
    finally:
        t_rt.metis_like_partition = real
    params = t_model.init_gnn(t_model.GNNSpec(**spec_kw), seed=0,
                              device="cpu")
    flat = _flat(_nudged(params, perturb))
    state = t_rt.init_state(plan, params=t_ckpt.params_from_numpy(flat,
                                                                  "cpu"))
    if rng_key is not None:
        state.gen = t_rt.noise_generator(np.array([0, rng_key], np.uint32),
                                         "cpu")
    for e in range(cfg["epochs"]):
        state, _ = t_rt.train_epoch(plan, state, e)
    digest = hashlib.sha256(np.ascontiguousarray(
        plan.part, np.int32).tobytes()).hexdigest()[:12]
    return digest, t_rt.evaluate_exact(plan, state)


def loss_trajectories(op: str, epochs: int, part=None,
                      history_dtype: str = "f32"):
    """Per-epoch mean losses of the port (on the CPU) and of the reference
    ("jnp") side by side, for chip_smoke.py's configuration of `op`, both
    from the port's `init_gnn(spec, seed=0)` params on one partition
    (`part`, else this host's): where two trajectories that agree step by
    step part ways, and how fast. Returns [(port, reference), ...]."""
    (rg, tg), spec_kw, cfg = _reference_config(op)
    cfg.update(partitioner="metis", history_dtype=history_dtype,
               epochs=epochs)
    r_real, t_real = r_rt.metis_like_partition, t_rt.metis_like_partition
    if part is not None:
        fixed = lambda *a, **k: np.asarray(part, np.int32)  # noqa: E731
        r_rt.metis_like_partition = t_rt.metis_like_partition = fixed
    try:
        rplan = r_rt.build_plan(rg, r_model.GNNSpec(**spec_kw),
                                r_rt.GASConfig(backend="jnp", **cfg))
        tplan = t_rt.build_plan(tg, t_model.GNNSpec(**spec_kw),
                                t_rt.GASConfig(**cfg), device="cpu")
    finally:
        r_rt.metis_like_partition, t_rt.metis_like_partition = r_real, t_real
    tstate = t_rt.init_state(tplan)
    # copies: the port's update writes its params in place, and
    # `jnp.asarray` may alias a numpy buffer on the CPU
    rparams = jax.tree_util.tree_map(lambda t: jnp.array(t.numpy()),
                                     tstate.params)
    rstate = _with_port_codebooks(r_rt.init_state(rplan).replace(
        params=rparams, opt_state=r_opt.adamw_init(rparams)))
    out = []
    for e in range(epochs):
        tstate, tm = t_rt.train_epoch(tplan, tstate, e)
        rstate, rm = r_rt.train_epoch(rplan, rstate, e)
        out.append((tm["loss"], float(rm["loss"])))
    return out


# chip_smoke.py's training configurations (table 5's two GCN rows run
# through `GASTrainer` in its table-5 phase)
CONFIGS = ("gcn", "gat", "pna", "gcnii", "gin", "gin+reg", "appnp") + \
    TABLE5_GCN

if __name__ == "__main__":
    # python tests/test_torch_train.py --reference-acc|--port-acc
    #     [PARTITIONS.npz] [--history-dtype f32|bf16|int8|vq]
    #     [--op CONFIG] [--perturb N ...] [--rng-key N ...]
    # python tests/test_torch_train.py --trajectory EPOCHS [PARTITIONS.npz]
    #     [--history-dtype ...] [--op ...]
    import argparse
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--reference-acc", action="store_true")
    mode.add_argument("--port-acc", action="store_true",
                      help="the same runs on the port, on the CPU")
    mode.add_argument("--trajectory", type=int, metavar="EPOCHS",
                      help="print the port's and the reference's per-epoch "
                           "mean losses side by side instead")
    ap.add_argument("partitions", nargs="?")
    ap.add_argument("--history-dtype", default="f32")
    ap.add_argument("--op", choices=CONFIGS, action="append",
                    help="a configuration (GCNII and table 5's GCN rows "
                         "take PNA's partition)")
    ap.add_argument("--perturb", type=int, action="append",
                    help="one-ulp perturbations of the initial weights (the "
                         "seed of each; 0 = none)")
    ap.add_argument("--rng-key", type=int, action="append",
                    help="the state's rng key (the Eq. 3 noise), one run "
                         "each")
    args = ap.parse_args()
    parts = np.load(args.partitions) if args.partitions else None

    def part_of(op):
        if parts is None:
            return None
        return parts["pna" if op in ("gcnii",) + TABLE5_GCN else op]

    for op in args.op or ("gcn", "gat", "pna"):
        if args.trajectory:
            for e, (t, r) in enumerate(loss_trajectories(
                    op, args.trajectory, part_of(op), args.history_dtype)):
                print(op, args.history_dtype, f"epoch {e}: port {t!r}, "
                      f"reference {r!r}", flush=True)
            continue
        run = port_accuracy if args.port_acc else reference_accuracy
        for key in args.rng_key or (None,):
            for pt in args.perturb or (0,):
                print(op, args.history_dtype, f"perturb {pt}",
                      f"rng key {key}", *run(
                          op, part=part_of(op),
                          history_dtype=args.history_dtype, perturb=pt,
                          rng_key=key), flush=True)


@pytest.mark.parametrize("op", ["gcn", "gat", "pna"])
def test_layer_routes(op, monkeypatch):
    """Layers >= 1 take the fused route (GCN, even on a forward-only serve
    batch, which has no transposed blocks) or the halo-split route (GAT);
    `fuse_halo=False` takes the materialized route for every layer."""
    _, _, tplan, tstate = _plans(op)
    calls = []
    for name in ("_fused_prop", "_halo_prop", "_prop"):
        real = getattr(t_model, name)
        monkeypatch.setattr(t_model, name, lambda *a, _n=name, _f=real, **k:
                            calls.append(_n) or _f(*a, **k))
    batch = tplan.batch(0)
    if op == "gcn":
        batch = batch.replace(transposed=None)
    with torch.no_grad():
        t_model.gas_batch_forward(tstate.params, tplan.spec, tplan.x, batch,
                                  tstate.histories)
        assert calls == ["_prop", "_fused_prop" if op == "gcn"
                         else "_halo_prop"]
        calls.clear()
        t_model.gas_batch_forward(tstate.params, tplan.spec, tplan.x, batch,
                                  tstate.histories, fuse_halo=False)
        assert calls == ["_prop", "_prop"]
