"""PyTorch port, the fused epoch (`GASConfig.fused_epoch`) on the CPU.

The reference runs a fused epoch as one jitted `lax.scan` over the
stacked batches, and `tests/test_system.py:93` holds it to the stepwise
epoch. The port's fused epoch selects each position's batch off the
stack by a device index and runs the steps unrolled (`runtime.
fused_body`); on the card that body is captured as one CUDA graph, on
the CPU it runs eagerly and is the fused epoch's plain version. Here:

  * the port's fused epochs equal its stepwise epochs bitwise (params,
    AdamW moments and step count, tables, scales, codebooks, k-means
    statistics, the clock and every epoch metric) for all six operators,
    f32 / bf16 / int8 / vq stores (vq refit every epoch), device and host
    stores at prefetch depths 0 and 1, two clusters a batch and the Eq. 3
    regularizer;
  * the port's fused epochs against the reference's `GASTrainer(
    fused_epoch=True, backend="jnp")` from the reference's initial params
    carried across: epoch losses, `gas_predict` and the params at TRAJ,
    the exact accuracies equal (GCN and GAT over f32, GCN over int8, two
    clusters a batch, and the port's host store at depth 1 against the
    reference's depth-1 pipeline);
  * `make_step_fn` bitwise `train_step`, `make_prefetch_step_fn`
    bitwise `prefetch_step`, and `repro_torch.core`'s runtime surface.
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")
import _torch_threads  # noqa: E402, F401  one torch thread a test process

from repro.data.graphs import citation_graph as r_citation
from repro.gnn.model import GNNSpec as RSpec
from repro.train import checkpoint as r_ckpt
from repro.train import gas_trainer as r_trainer

import repro_torch.core as t_core
from repro_torch.core import runtime as t_rt
from repro_torch.data.graphs import citation_graph as t_citation
from repro_torch.gnn.model import GNNSpec as TSpec
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import gas_trainer as t_trainer
from repro_torch.train.optimizer import adamw_init, tree_leaves

TRAJ = dict(rtol=1e-5, atol=1e-5)
N, F, D, C = 150, 16, 16, 4


def _spec(op):
    layers = {"gcnii": 4, "appnp": 3}.get(op, 2)
    return TSpec(op=op, d_in=F, d_hidden=D, num_classes=C,
                 num_layers=layers, heads=2,
                 log_deg_mean=1.8 if op == "pna" else 1.0,
                 reg_weight=0.5 if op == "gin+reg" else 0.0)


def _leaves(state):
    h = state.histories
    out = tree_leaves(state.params) + [state.opt_state.step] + \
        tree_leaves(state.opt_state.m) + tree_leaves(state.opt_state.v) + \
        h.tables + [h.age]
    for name in ("scales", "codebooks", "cb_counts", "cb_sums"):
        out += getattr(h, name) or []
    return out


def _run(op, fused, epochs=3, **cfg):
    g = t_citation(num_nodes=N, num_features=F, num_classes=C, seed=7)
    spec = _spec(op)
    if op == "gin+reg":
        spec = dataclasses.replace(spec, op="gin")
    plan = t_rt.build_plan(g, spec, t_rt.GASConfig(
        num_parts=3, seed=3, fused_epoch=fused, **cfg), device="cpu")
    state = t_rt.init_state(plan)
    metrics = [t_rt.train_epoch(plan, state, e)[1] for e in range(epochs)]
    return plan, state, metrics


@pytest.mark.parametrize("op,cfg", [
    ("gcn", {}), ("gat", {}), ("gin", {}), ("gcnii", {}), ("appnp", {}),
    ("pna", {}), ("gin+reg", {}),
    ("gcn", dict(history_dtype="bf16")),
    ("pna", dict(history_dtype="int8")),
    ("gat", dict(history_dtype="vq", vq_refit_every=1)),
    ("gcn", dict(history_dtype="int8", history_storage="host")),
    ("gcnii", dict(history_storage="host", prefetch_depth=1)),
    ("gat", dict(history_dtype="vq", vq_refit_every=1,
                 history_storage="host", prefetch_depth=1)),
    ("gcn", dict(history_dtype="int8", prefetch_depth=1)),
    ("gcn", dict(clusters_per_batch=2)),
    ("gat", dict(clusters_per_batch=2, history_dtype="vq",
                 vq_refit_every=1, prefetch_depth=1)),
], ids=lambda v: v if isinstance(v, str) else
    "-".join(f"{k}={w}" for k, w in v.items()) or "f32")
def test_fused_epoch_matches_stepwise(op, cfg):
    """tests/test_system.py:93's property on the port: three fused epochs
    equal three stepwise epochs bitwise, every state leaf and every epoch
    metric."""
    _, a, ma = _run(op, False, **cfg)
    plan, b, mb = _run(op, True, **cfg)
    assert plan._fused is not None and plan._fused.replays == 0
    assert ma == mb
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), i


# the reference's GASTrainer beside the port's on the same graph
GRAPH = dict(num_nodes=200, num_features=12, num_classes=3, seed=2)


def _to_port(params):
    """A reference params tree carried across (`params_from_numpy`)."""
    flat = {k: np.asarray(v) for k, v in r_ckpt._flatten(params).items()}
    return t_ckpt.params_from_numpy(flat, device="cpu")


@pytest.mark.parametrize("op,kw,depth", [
    ("gcn", {}, 0), ("gat", {}, 0), ("gcn", dict(history_dtype="int8"), 0),
    ("gcn", dict(clusters_per_batch=2), 0), ("gcn", {}, 1)],
    ids=["gcn", "gat", "gcn-int8", "gcn-cpb2", "gcn-host-depth1"])
def test_fused_epoch_matches_reference_fused_epoch(op, kw, depth):
    """Two fused epochs of the port's `GASTrainer(fused_epoch=True)`
    against the reference's (`backend="jnp"`, one `lax.scan` an epoch)
    from the reference's initial params carried across: the epoch
    losses, `gas_predict` and the params at TRAJ, the exact accuracies
    equal. At depth 1 the port's store is a host store and both epochs
    are pipelined (the reference's own host store is red, ROADMAP Queue
    C, so its device store runs the pipeline)."""
    spec = dict(op=op, d_in=GRAPH["num_features"], d_hidden=16,
                num_classes=GRAPH["num_classes"], num_layers=2, heads=2)
    tcfg = dict(epochs=2, seed=0)
    r = r_trainer.GASTrainer(r_citation(**GRAPH), RSpec(**spec), num_parts=3,
                             fused_epoch=True, backend="jnp",
                             tcfg=r_trainer.TrainConfig(**tcfg), **kw)
    t = t_trainer.GASTrainer(t_citation(**GRAPH), TSpec(**spec), num_parts=3,
                             fused_epoch=True, device="cpu",
                             tcfg=t_trainer.TrainConfig(**tcfg), **kw)
    assert t.config.fused_epoch and r.config.fused_epoch
    np.testing.assert_array_equal(r.part, t.part)
    if depth:
        r.plan = dataclasses.replace(r.plan, config=dataclasses.replace(
            r.plan.config, prefetch_depth=depth))
        t.plan = t_rt.build_plan(t.graph, t.spec, dataclasses.replace(
            t.config, prefetch_depth=depth, history_storage="host"),
            device="cpu", part=t.part)
        t.state = t_rt.init_state(t.plan)
        assert t.hist.storage == "host" and t_rt._resolved_depth(t.plan) == 1
    t.params = _to_port(r.params)
    t.opt_state = adamw_init(t.params)
    np.testing.assert_allclose([m["loss"] for m in t.fit()],
                               [m["loss"] for m in r.fit()], **TRAJ)
    assert t.plan._fused is not None
    np.testing.assert_allclose(t.gas_predict().numpy(),
                               np.asarray(r.gas_predict()), **TRAJ)
    for a, b in zip(tree_leaves(t.params), tree_leaves(_to_port(r.params))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TRAJ)
    assert t.evaluate() == r.evaluate()


@pytest.mark.parametrize("op,cfg", [
    ("gcn", {}), ("gat", dict(history_dtype="vq")),
    ("pna", dict(history_dtype="int8", history_storage="host"))])
def test_step_functions_equal_the_steps(op, cfg):
    """`make_step_fn(plan)` is `train_step` and `make_prefetch_step_fn(
    plan, 1)` is `prefetch_step`, bitwise: two states from one seed, each
    driven by one of the two over the same batches."""
    runs = []
    for how in ("module", "fn"):
        plan = t_rt.build_plan(
            t_citation(num_nodes=N, num_features=F, num_classes=C, seed=7),
            _spec(op), t_rt.GASConfig(num_parts=3, seed=3, **cfg),
            device="cpu")
        state, out = t_rt.init_state(plan), []
        args = (plan.x, plan.y, plan.train_mask)
        step = t_rt.make_step_fn(plan)
        for b in (2, 0, 1):
            if how == "module":
                state, m = t_rt.train_step(plan, state, plan.batch(b))
            else:
                state, m = step(state, plan.batch(b), *args)
            out.append(m)
        pf = t_rt.make_prefetch_step_fn(plan, 1)
        queue = (t_rt._prefetch_entry(plan, state.histories, plan.batch(1)),)
        for b, fb in ((1, 2), (2, 0), (0, None)):
            future = None if fb is None else plan.batch(fb)
            if how == "module":
                state, m, queue = t_rt.prefetch_step(plan, state,
                                                     plan.batch(b), future,
                                                     queue)
            else:
                state, m, queue = pf(state, plan.batch(b), future, queue,
                                     *args)
            assert tuple(m) == t_rt.STEP_METRICS
            out.append(m)
        assert queue == ()
        runs.append((state, out))
    (a, ma), (b, mb) = runs
    for x, y in zip(ma, mb):
        assert all(torch.equal(x[k], y[k]) for k in t_rt.STEP_METRICS)
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)


def test_core_exports_the_runtime_surface():
    """`repro_torch.core` lifts the reference's runtime names, and
    `core.serve` stays the submodule."""
    import repro.core as r_core
    from repro_torch.core import serve
    names = ("GASConfig", "GASPlan", "GASState", "build_plan", "init_state",
             "train_step", "train_epoch", "fit", "predict",
             "evaluate_exact", "make_step_fn", "GASBatch", "BlockStructure",
             "HistoryStore", "HistoryExecConfig")
    for name in names:
        assert hasattr(r_core, name), name
        assert getattr(t_core, name) is not None, name
    assert t_core.make_step_fn is t_rt.make_step_fn
    assert t_core.make_prefetch_step_fn is t_rt.make_prefetch_step_fn
    assert serve.__name__ == "repro_torch.core.serve"
    assert {f.name for f in dataclasses.fields(t_core.GASConfig)} >= {
        "fused_epoch", "prefetch_depth", "history_storage"}


@pytest.mark.parametrize("hd", ["f32", "int8", "vq"])
def test_prefetch_into_ring_slots(hd):
    """`HistoryStore.prefetch(idx, out=prefetch_buffers(M))` writes the
    rows bitwise what a prefetch into new tensors returns, into the given
    buffers; buffers of another shape or type raise."""
    from repro_torch.core.history import HistoryStore
    store = HistoryStore.create(41, [16, 16], hd, "cpu")
    g = torch.Generator().manual_seed(1)
    idx = torch.randperm(40, generator=g)[:20].to(torch.int32)
    for ell in range(2):
        store.push(ell, idx, torch.randn(20, 16, generator=g),
                   torch.ones(20, dtype=torch.bool))
    pull = torch.tensor([3, 0, 40, -2, 7, 7], dtype=torch.int32)
    slot = store.prefetch_buffers(pull.shape[0])
    got, want = store.prefetch(pull, out=slot), store.prefetch(pull)
    for (r, s), (sr, ss), (wr, ws) in zip(got, slot, want):
        assert r is sr and torch.equal(r, wr)
        assert s is ss and (s is None or torch.equal(s, ws))
    bad = store.prefetch_buffers(pull.shape[0] + 1)
    with pytest.raises(ValueError, match="out must hold"):
        store.prefetch(pull, out=bad)
