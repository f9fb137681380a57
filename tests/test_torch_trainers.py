"""PyTorch port, the paper's trainer shell and its Table 5 baselines
against the JAX reference.

`core.partition.inter_intra_ratio` bitwise on Table 6's four graph
families (0.4 of their size) under random and METIS-like partitions;
`train.optimizer.cosine_schedule` at warm-up, mid and end steps (int and
0-d tensor steps) and `sgd_update` (f32 and bf16 params) bitwise;
`train.checkpoint.save_checkpoint` / `load_checkpoint` files read by the
other package bitwise, `step` kept; `train.gas_trainer.GASTrainer`
against the port's runtime (losses, `gas_predict` and `evaluate`
exactly equal), its kwargs landing in `GASConfig`, `tcfg` not shared,
`fused_epoch=True` bitwise the stepwise trainer, and two epochs against the reference's
`GASTrainer` from its initial state carried across at 1e-5;
`train.baselines.GraphSAGETrainer`'s sampled batches bitwise, then its
step losses and final params at 1e-5 from the reference's weights, and
`SGCTrainer`'s propagated features at 1e-6 and its losses from the
reference's weights at 1e-5.

    python tests/test_torch_trainers.py --table5-baselines [--port]

prints the reference's (or, with --port, the port's on the CPU) test
accuracy of table 5's GraphSAGE and SGC rows at the table's full sizes
under seeds 0-5, the numbers chip_smoke.py holds the card's runs to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")
import _torch_threads  # noqa: E402  one torch thread a test process

from repro.core import partition as r_part
from repro.core import runtime as r_rt
from repro.data.graphs import citation_graph as r_citation
from repro.data.graphs import sbm_cluster_graph as r_sbm
from repro.gnn.model import GNNSpec as RSpec
from repro.train import baselines as r_base
from repro.train import checkpoint as r_ckpt
from repro.train import gas_trainer as r_trainer
from repro.train import optimizer as r_opt

from repro_torch.core import partition as t_part
from repro_torch.core import runtime as t_rt
from repro_torch.data.graphs import citation_graph as t_citation
from repro_torch.data.graphs import sbm_cluster_graph as t_sbm
from repro_torch.gnn.model import GNNSpec as TSpec
from repro_torch.gnn.model import init_gnn
from repro_torch.train import baselines as t_base
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import gas_trainer as t_trainer
from repro_torch.train import optimizer as t_opt

TRAJ = dict(rtol=1e-5, atol=1e-5)


def _to_port(params):
    """A reference params tree carried across (`params_from_numpy`)."""
    flat = {k: np.asarray(v) for k, v in r_ckpt._flatten(params).items()}
    return t_ckpt.params_from_numpy(flat, device="cpu")


def _leaves_np(tree):
    return [t.numpy() for t in t_opt.tree_leaves(tree)]


# ---------------------------------------------------------------------------
# Table 6's statistic, the schedule, SGD, the flat checkpoint
# ---------------------------------------------------------------------------

# benchmarks/table6_interconnectivity.py:16-27 at its quick scale (0.4)
TABLE6 = {
    "cora-like": ("citation", dict(num_nodes=1080, avg_degree=4, seed=60),
                  20),
    "pubmed-like": ("citation", dict(num_nodes=3200, avg_degree=5,
                                     homophily=0.8, seed=61), 32),
    "cluster-sbm": ("sbm", dict(num_nodes=1200, num_communities=12,
                                seed=62), 24),
    "dense-sbm": ("sbm", dict(num_nodes=800, num_communities=8, p_intra=0.1,
                              p_inter=0.01, seed=63), 16),
}


@pytest.mark.parametrize("name", sorted(TABLE6))
def test_inter_intra_ratio_bitwise(name):
    """Both packages' ratio on both packages' graphs, under a random and
    the port's METIS-like partition (itself bitwise the reference's,
    tests/test_torch_train.py): the same float, bit for bit."""
    kind, kw, parts = TABLE6[name]
    rg, tg = ((r_citation(**kw), t_citation(**kw)) if kind == "citation"
              else (r_sbm(**kw), t_sbm(**kw)))
    np.testing.assert_array_equal(rg.indptr, tg.indptr)
    np.testing.assert_array_equal(rg.indices, tg.indices)
    for part in (t_part.random_partition(tg.num_nodes, parts, 0),
                 t_part.metis_like_partition(tg.indptr, tg.indices, parts,
                                             seed=0)):
        got = t_part.inter_intra_ratio(tg.indptr, tg.indices, part)
        want = r_part.inter_intra_ratio(rg.indptr, rg.indices, part)
        assert type(got) is float and got == want and got > 0, (got, want)


@pytest.mark.parametrize("step", [0, 3, 10, 11, 40, 99, 100, 150])
def test_cosine_schedule_matches_reference(step):
    """Warm-up, its end, the cosine's middle, its end and past it: the
    same float32 from an int step and a 0-d int32 tensor step."""
    ref = float(r_opt.cosine_schedule(1e-3, warmup=10, total=100)(
        jnp.asarray(step, jnp.int32)))
    lr = t_opt.cosine_schedule(1e-3, warmup=10, total=100)
    for s in (step, torch.tensor(step, dtype=torch.int32)):
        got = lr(s)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), ref, rtol=0, atol=1e-7)


def test_sgd_update_matches_reference():
    """p - lr * g in f32, cast back to each param's dtype (f32 and bf16
    leaves), bitwise."""
    rng = np.random.default_rng(0)
    p = {"layers": [{"w": rng.normal(size=(5, 3)).astype(np.float32),
                     "b": rng.normal(size=(3,)).astype(np.float32)}],
         "h": rng.normal(size=(4,)).astype(np.float32)}
    g = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), p)
    rp = jax.tree_util.tree_map(jnp.asarray, p)
    rp["h"] = rp["h"].astype(jnp.bfloat16)
    want = r_opt.sgd_update(jax.tree_util.tree_map(jnp.asarray, g), rp, 0.1)
    tp = t_opt.tree_map(torch.from_numpy, p)
    tp["h"] = tp["h"].to(torch.bfloat16)
    got = t_opt.sgd_update(t_opt.tree_map(torch.from_numpy, g), tp, 0.1)
    assert got["h"].dtype == torch.bfloat16
    for a, b in zip(jax.tree_util.tree_leaves(want), t_opt.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.to(torch.float32).numpy())


def _checkpoint_trees(kind):
    """(reference params, port params) of one content: a GNN's (GIN: a
    0-d eps and a head beside the layers) or a generic tree holding a bf16
    leaf, each with an AdamW state one step in."""
    if kind == "gin":
        spec = dict(op="gin", d_in=6, d_hidden=8, num_classes=3,
                    num_layers=2)
        tparams = init_gnn(TSpec(**spec), seed=3, device="cpu")
        rparams = jax.tree_util.tree_map(lambda t: jnp.array(t.numpy()),
                                         tparams)
    else:
        rng = np.random.default_rng(1)
        rparams = {"w": jnp.asarray(rng.normal(size=(2, 3)), jnp.float32),
                   "b": {"bias": jnp.asarray(rng.normal(size=(3,)),
                                             jnp.bfloat16)}}
        tparams = {"w": torch.from_numpy(np.array(rparams["w"])),
                   "b": {"bias": torch.from_numpy(np.asarray(
                       rparams["b"]["bias"], np.float32)).to(torch.bfloat16)}}
    rgrads = jax.tree_util.tree_map(lambda a: jnp.ones_like(a) * 0.5,
                                    rparams)
    rparams, ropt = r_opt.adamw_update(rgrads, r_opt.adamw_init(rparams),
                                       rparams, lr=0.01)
    tgrads = t_opt.tree_map(lambda a: torch.full_like(a, 0.5), tparams)
    tparams, topt = t_opt.adamw_update(tgrads, t_opt.adamw_init(tparams),
                                       tparams, lr=0.01)
    return (rparams, ropt), (tparams, topt)


@pytest.mark.parametrize("kind", ["gin", "generic"])
def test_checkpoint_cross_reads_bitwise(kind, tmp_path):
    """A file the port writes loads bitwise in the reference's
    `load_checkpoint` and vice versa, the optimizer state and `step`
    included (bf16 leaves widened to f32 on disk and narrowed back)."""
    (rparams, ropt), (tparams, topt) = _checkpoint_trees(kind)
    port_file, ref_file = str(tmp_path / "port.npz"), str(tmp_path / "r.npz")
    t_ckpt.save_checkpoint(port_file, tparams, topt, step=42)
    r_ckpt.save_checkpoint(ref_file, rparams, ropt, step=7)
    with np.load(port_file) as a, np.load(ref_file) as b:
        assert sorted(a.files) == sorted(b.files)
    p, o, step = r_ckpt.load_checkpoint(port_file, rparams, ropt)
    assert step == 42
    for a, b in zip(jax.tree_util.tree_leaves((p, o)),
                    t_opt.tree_leaves(tparams) + [topt.step] +
                    t_opt.tree_leaves(topt.m) + t_opt.tree_leaves(topt.v)):
        assert a.dtype.name == str(b.dtype).split(".")[-1], (a.dtype, b.dtype)
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.to(torch.float32).numpy())
    p, o, step = t_ckpt.load_checkpoint(ref_file, tparams, topt)
    assert step == 7 and isinstance(o, t_opt.AdamWState)
    assert _restored_equal(p, o, rparams, ropt, tparams)
    # no optimizer template: params only
    p, o, _ = t_ckpt.load_checkpoint(ref_file, tparams)
    assert o is None


def _restored_equal(p, o, rparams, ropt, tparams):
    """The port's restored (params, opt) equal the reference's leaves
    bitwise, in the template's dtypes."""
    for a, b in zip(t_opt.tree_leaves(tparams), t_opt.tree_leaves(p)):
        assert a.dtype == b.dtype
    want = jax.tree_util.tree_leaves((rparams, ropt))
    got = t_opt.tree_leaves(p) + [o.step] + t_opt.tree_leaves(o.m) + \
        t_opt.tree_leaves(o.v)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.to(torch.float32).numpy())
    return len(want) == len(got)


# ---------------------------------------------------------------------------
# GASTrainer
# ---------------------------------------------------------------------------

# tests/test_runtime_api.py:208-212's small problem
GRAPH = dict(num_nodes=150, num_features=16, num_classes=4, seed=11)
SPEC = dict(op="gcn", d_in=16, d_hidden=16, num_classes=4, num_layers=3)


def test_trainer_matches_runtime_exactly():
    """GASTrainer is a thin shell: the runtime driven directly reproduces
    its losses, `gas_predict` and `evaluate` exactly."""
    g = t_citation(**GRAPH)
    tr = t_trainer.GASTrainer(g, TSpec(**SPEC), num_parts=3, device="cpu",
                              tcfg=t_trainer.TrainConfig(epochs=2, seed=0))
    shell = [m["loss"] for m in tr.fit(2)]
    assert tr.device == torch.device("cpu")
    plan = t_rt.build_plan(g, TSpec(**SPEC), t_rt.GASConfig(
        num_parts=3, epochs=2, seed=0), device="cpu")
    np.testing.assert_array_equal(plan.part, tr.part)
    state = t_rt.init_state(plan)
    losses = []
    for e in range(2):
        state, m = t_rt.train_epoch(plan, state, e)
        losses.append(m["loss"])
    assert losses == shell
    assert torch.equal(t_rt.predict(plan, state), tr.gas_predict())
    assert t_rt.evaluate_exact(plan, state) == tr.evaluate()
    # one more step through the shell and through the runtime
    m_shell = tr.train_step(tr.plan.batch(0))
    state, m = t_rt.train_step(plan, state, plan.batch(0))
    assert torch.equal(m["loss"], m_shell["loss"])


def test_trainer_kwargs_land_in_gasconfig():
    g = t_citation(**GRAPH)
    part = t_part.random_partition(g.num_nodes, 3, 0)
    tr = t_trainer.GASTrainer(g, TSpec(**SPEC), num_parts=3,
                              partitioner="random", fuse_halo=False,
                              use_history=False, history_dtype="int8",
                              clusters_per_batch=1, device="cpu", part=part,
                              tcfg=t_trainer.TrainConfig(lr=0.05, seed=4))
    assert isinstance(tr.config, t_rt.GASConfig)
    c = tr.config
    assert (c.fuse_halo, c.use_history, c.history_dtype, c.partitioner,
            c.lr, c.seed) == (False, False, "int8", "random", 0.05, 4)
    assert tr.part is part and tr.hist.history_dtype == "int8"
    assert tr.batches.num_batches == 3 and tr.x.shape == (150, 16)
    assert tr.y.shape == (151,) and tr.train_mask.shape == (151,)
    new = t_opt.tree_map(torch.zeros_like, tr.params)
    tr.params = new
    assert tr.state.params is new


def test_trainer_tcfg_not_shared_between_instances():
    import inspect
    for cls in (t_trainer.GASTrainer, t_trainer.FullBatchTrainer,
                t_base.GraphSAGETrainer, t_base.SGCTrainer):
        default = inspect.signature(cls.__init__).parameters["tcfg"].default
        assert default is None, cls
    g = t_citation(num_nodes=120, num_features=8, num_classes=3, seed=1)
    spec = TSpec(op="gcn", d_in=8, d_hidden=8, num_classes=3, num_layers=2)
    a = t_trainer.GASTrainer(g, spec, num_parts=2, device="cpu")
    b = t_trainer.GASTrainer(g, spec, num_parts=2, device="cpu")
    assert a.tcfg is not b.tcfg
    a.tcfg.lr = 123.0
    assert b.tcfg.lr != 123.0


def test_trainer_fused_epoch_raises():
    """`fused_epoch=True`, refused until the fused epoch was ported, now
    reaches the trainer's config and trains: two fused epochs give the
    stepwise trainer's losses, params and `gas_predict` bitwise."""
    g = t_citation(num_nodes=120, num_features=8, num_classes=3, seed=1)
    spec = TSpec(op="gcn", d_in=8, d_hidden=8, num_classes=3, num_layers=2)
    tcfg = t_trainer.TrainConfig(epochs=2)
    a = t_trainer.GASTrainer(g, spec, num_parts=2, device="cpu", tcfg=tcfg)
    b = t_trainer.GASTrainer(g, spec, num_parts=2, fused_epoch=True,
                             device="cpu", tcfg=tcfg)
    assert b.config.fused_epoch and not a.config.fused_epoch
    assert a.fit() == b.fit()
    assert b.plan._fused is not None
    for x, y in zip(t_opt.tree_leaves(a.params), t_opt.tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert torch.equal(a.gas_predict(), b.gas_predict())


def test_trainer_matches_reference_trainer():
    """Two epochs of the port's GASTrainer against the reference's ("jnp"
    backend) from the reference's initial params carried across: the
    epoch losses, `gas_predict` and the params at 1e-5, the exact
    accuracies equal."""
    r = r_trainer.GASTrainer(r_citation(**GRAPH), RSpec(**SPEC),
                             num_parts=3, backend="jnp",
                             tcfg=r_trainer.TrainConfig(epochs=2, seed=0))
    t = t_trainer.GASTrainer(t_citation(**GRAPH), TSpec(**SPEC),
                             num_parts=3, device="cpu",
                             tcfg=t_trainer.TrainConfig(epochs=2, seed=0))
    np.testing.assert_array_equal(r.part, t.part)
    t.params = _to_port(r.params)
    t.opt_state = t_opt.adamw_init(t.params)
    np.testing.assert_allclose([m["loss"] for m in t.fit()],
                               [m["loss"] for m in r.fit()], **TRAJ)
    np.testing.assert_allclose(t.gas_predict().numpy(),
                               np.asarray(r.gas_predict()), **TRAJ)
    for a, b in zip(_leaves_np(t.params), _leaves_np(_to_port(r.params))):
        np.testing.assert_allclose(a, b, **TRAJ)
    assert t.evaluate() == r.evaluate()


# ---------------------------------------------------------------------------
# Table 5's baselines
# ---------------------------------------------------------------------------

# tests/test_system.py:16-20 and :113-121's small GraphSAGE / SGC
HARD = dict(num_nodes=1200, num_features=64, num_classes=6, homophily=0.7,
            feature_noise=2.5, seed=5)


def test_graphsage_batches_and_steps_match_reference():
    """The same rng draws give bitwise the reference's sampled layers and
    frontiers; from the reference's weights carried across, two epochs'
    step losses and the final params at 1e-5 and the exact accuracies
    equal."""
    kw = dict(d_hidden=16, num_layers=2, fanout=5, batch_size=64)
    r = r_base.GraphSAGETrainer(r_citation(**HARD), **kw,
                                tcfg=r_trainer.TrainConfig(epochs=2, seed=0))
    t = t_base.GraphSAGETrainer(t_citation(**HARD), **kw, device="cpu",
                                tcfg=t_trainer.TrainConfig(epochs=2, seed=0))
    assert t.caps == r.caps == [64, 384, 2304]
    # sampling: two shuffles and a batch each, from the trainers' rngs
    r_rng, t_rng = r.rng.bit_generator.state, t.rng.bit_generator.state
    for _ in range(2):
        r.rng.shuffle(r.train_nodes)
        t.rng.shuffle(t.train_nodes)
        np.testing.assert_array_equal(r.train_nodes, t.train_nodes)
        (rl, rb), (tl, tb) = (x._sample_batch(x.train_nodes[:64])
                              for x in (r, t))
        np.testing.assert_array_equal(rb, tb)
        for a, b in zip(rl, tl):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    r.rng.bit_generator.state, t.rng.bit_generator.state = r_rng, t_rng
    t.params = _to_port(r.params)
    t.opt_state = t_opt.adamw_init(t.params)
    rm, tm = r.fit(), t.fit()
    assert len(tm) == len(rm) == 4
    np.testing.assert_allclose([m["loss"] for m in tm],
                               [m["loss"] for m in rm], **TRAJ)
    for a, b in zip(_leaves_np(t.params), _leaves_np(_to_port(r.params))):
        np.testing.assert_allclose(a, b, **TRAJ)
    assert t.evaluate() == r.evaluate()


def test_sgc_features_and_steps_match_reference():
    """Â^2 X at 1e-6; from the reference's weights carried across, ten
    steps' losses and the final params at 1e-5 (AdamW at the reference's
    b2 = 0.95, no clip), the exact accuracies equal."""
    tcfg = dict(epochs=10, lr=0.05, seed=0)
    r = r_base.SGCTrainer(r_citation(**HARD), k=2,
                          tcfg=r_trainer.TrainConfig(**tcfg))
    t = t_base.SGCTrainer(t_citation(**HARD), k=2, device="cpu",
                          tcfg=t_trainer.TrainConfig(**tcfg))
    np.testing.assert_allclose(t.features.numpy(), np.asarray(r.features),
                               rtol=1e-6, atol=1e-6)
    t.params = {k: torch.from_numpy(np.array(v))
                for k, v in r.params.items()}
    t.opt_state = t_opt.adamw_init(t.params)
    r_losses = []
    for _ in range(tcfg["epochs"]):
        r.params, r.opt_state, loss = r._step(r.params, r.opt_state,
                                              r.features, r._y, r._m)
        r_losses.append(float(loss))
    np.testing.assert_allclose([m["loss"] for m in t.fit()], r_losses,
                               **TRAJ)
    for k in ("w", "b"):
        np.testing.assert_allclose(t.params[k].numpy(),
                                   np.asarray(r.params[k]), **TRAJ)
    assert t.evaluate() == r.evaluate()


# ---------------------------------------------------------------------------
# The reference accuracy chip_smoke.py holds table 5's baselines to
# ---------------------------------------------------------------------------

# benchmarks/table5_baselines.py:15-37 at full size
TABLE5_GRAPH = dict(num_nodes=4000, num_features=64, num_classes=6,
                    homophily=0.7, feature_noise=2.5, seed=80)


def table5_baseline_accuracy(name: str, seed: int, port: bool = False):
    """Test accuracy of table 5's `graphsage` (d_hidden 48, 2 layers,
    fanout 10, batch 256, 15 epochs, lr 0.01) or `sgc` (k = 2, 240 epochs,
    lr 0.05) row under `TrainConfig(seed=seed)`: the reference's, or with
    `port` the port's on the CPU."""
    base, trainer, graph = ((t_base, t_trainer, t_citation) if port
                            else (r_base, r_trainer, r_citation))
    g = graph(**TABLE5_GRAPH)
    dev = dict(device="cpu") if port else {}
    if name == "graphsage":
        tr = base.GraphSAGETrainer(
            g, d_hidden=48, num_layers=2, fanout=10, batch_size=256,
            tcfg=trainer.TrainConfig(epochs=15, lr=0.01, seed=seed), **dev)
    else:
        tr = base.SGCTrainer(g, k=2, tcfg=trainer.TrainConfig(
            epochs=240, lr=0.05, seed=seed), **dev)
    tr.fit()
    return tr.evaluate()["test_acc"]


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--table5-baselines", action="store_true", required=True)
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    for name in ("graphsage", "sgc"):
        for seed in range(6):
            print(name, "port" if args.port else "reference", f"seed {seed}",
                  repr(table5_baseline_accuracy(name, seed, args.port)),
                  flush=True)
