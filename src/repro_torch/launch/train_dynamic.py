"""Evolving-graph GAS launcher: train across a snapshot sequence.

The port of `repro.launch.train_dynamic`. It builds a slack-padded
dynamic plan (`core.dynamic.build_dynamic_plan`), fits the initial
snapshot, then for each snapshot draws a seeded `random_delta` (edge
churn, node arrivals, feature drift), carries the plan and state across
it with the incremental `advance` (partition repair, batch patching,
selective history re-push) and trains on. For each snapshot it prints
the accuracies and where the advance's time went.

    python -m repro_torch.launch.train_dynamic --nodes 800 --parts 8 \
        --snapshots 4 --epochs 3 --churn 0.01 --nodes-add 5
        [--op gcn|gin|gat|gcnii|appnp|pna]
        [--history-dtype f32|bf16|int8|vq] [--history-storage device|host]
        [--prefetch-depth K] [--device cuda|cpu] [--smoke]

    # cold rebuilds at every snapshot, for comparison:
    ... train_dynamic --cold-frac 0.0

`--device` defaults to cuda and raises without a card; `--device cpu`
runs every kernel's plain version. `--smoke` runs two snapshots on a
small graph and checks the dynamic contract: the advance stayed
incremental, the repaired partition is valid and balanced, the history
rows outside the delta's out-closure kept their bits (and ages), the rows
inside have age 0, and the metrics after the advance are finite; it ends
with "smoke OK".
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import delta as D
from repro_torch.core import dynamic as DY
from repro_torch.core import runtime as R
from repro_torch.core.config import resolve_device
from repro_torch.core.history import HISTORY_STORAGES
from repro_torch.data.graphs import citation_graph
from repro_torch.gnn.model import OPS, GNNSpec


def _host(ts):
    """CPU copies of `ts`' bits (bf16 tables as int16; a pinned table is
    read once the card is done writing it)."""
    return [(t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
            .detach().cpu().clone().numpy() for t in ts]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--op", choices=OPS, default="gcn")
    ap.add_argument("--nodes", type=int, default=800)
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=3,
                    help="training epochs per snapshot")
    ap.add_argument("--snapshots", type=int, default=4,
                    help="number of deltas applied after the initial fit")
    ap.add_argument("--churn", type=float, default=0.01,
                    help="fraction of undirected edges deleted AND "
                         "inserted per snapshot")
    ap.add_argument("--nodes-add", type=int, default=5,
                    help="new nodes per snapshot")
    ap.add_argument("--feat-frac", type=float, default=0.01,
                    help="fraction of nodes whose features drift")
    ap.add_argument("--cold-frac", type=float, default=0.25,
                    help="closure fraction above which advance "
                         "cold-rebuilds (0 forces cold every snapshot)")
    ap.add_argument("--pad-slack", type=float, default=0.25)
    ap.add_argument("--history-dtype", default=None,
                    choices=("f32", "bf16", "int8", "vq"),
                    help="history-table storage precision (default: "
                         "$REPRO_HISTORY_DTYPE, else f32)")
    ap.add_argument("--history-storage", default=None,
                    choices=HISTORY_STORAGES,
                    help="history-table placement (default: "
                         "$REPRO_HISTORY_STORAGE, else device); host keeps "
                         "the tables in pinned host memory")
    ap.add_argument("--prefetch-depth", type=int, default=0,
                    help="software-pipeline depth: prefetch batch i+depth's "
                         "halo rows during batch i (0 = synchronous)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="small run that checks the dynamic contract")
    args = ap.parse_args(argv)

    if args.smoke:
        args.nodes = min(args.nodes, 180)
        args.snapshots = 2
        args.epochs = min(args.epochs, 2)
        args.parts = min(args.parts, 4)
        args.cold_frac = 1.01          # the contract under test
    device = resolve_device(args.device)

    g = citation_graph(num_nodes=args.nodes, num_features=args.features,
                       num_classes=args.classes, seed=args.seed)
    spec = GNNSpec(op=args.op, d_in=args.features, d_hidden=args.hidden,
                   num_classes=args.classes, num_layers=args.layers,
                   heads=args.heads)
    dcfg = DY.DynamicGASConfig(
        base=R.GASConfig(num_parts=args.parts,
                         history_dtype=args.history_dtype,
                         history_storage=args.history_storage,
                         prefetch_depth=args.prefetch_depth,
                         epochs=args.epochs, seed=args.seed),
        cold_rebuild_frac=args.cold_frac, pad_slack=args.pad_slack)

    plan = DY.build_dynamic_plan(g, spec, dcfg, device=device)
    state = R.init_state(plan)
    t0 = time.perf_counter()
    state, _ = R.fit(plan, state, epochs=args.epochs)
    ev = R.evaluate_exact(plan, state)
    print(f"snapshot 0: {g.num_nodes} nodes, trained {args.epochs} "
          f"epochs in {time.perf_counter() - t0:.1f}s, val "
          f"{ev['val_acc']:.3f} test {ev['test_acc']:.3f} "
          f"(device={device}, history={state.histories.history_dtype}, "
          f"{state.histories.storage} storage)")

    smoke_rec = None
    for snap in range(1, args.snapshots + 1):
        d = D.random_delta(plan.graph, edge_churn=args.churn,
                           nodes_add=args.nodes_add,
                           feat_frac=args.feat_frac,
                           seed=args.seed + 100 + snap)
        n_old = plan.graph.num_nodes
        grown = (state.histories.grow(d.num_new_nodes) if args.smoke
                 else None)
        plan, state, info = DY.advance(plan, state, d, dcfg)
        if args.smoke:
            # host copies of the contract's data now: the next fit pushes
            # into these tables in place
            h = state.histories.sync()
            smoke_rec = dict(
                d=d, info=info, n_old=n_old, grown=_host(grown.tables),
                grown_age=_host([grown.age])[0], tables=_host(h.tables),
                age=_host([h.age])[0])
        state, metrics = R.fit(plan, state, epochs=args.epochs)
        ev = R.evaluate_exact(plan, state)
        mode = "cold" if info.cold else "incremental"
        print(f"snapshot {snap}: {plan.graph.num_nodes} nodes "
              f"(+{info.num_new_nodes}), advance {info.total_s * 1e3:.1f}ms "
              f"[{mode}: partition {info.partition_s * 1e3:.1f} "
              f"batches {info.batches_s * 1e3:.1f} "
              f"repush {info.repush_s * 1e3:.1f}], "
              f"closure {info.closure_frac:.1%}, "
              f"rebuilt {info.rebuilt_parts} parts, "
              f"moved {info.reassigned} nodes, "
              f"val {ev['val_acc']:.3f} test {ev['test_acc']:.3f}")

    if args.smoke:
        assert np.isfinite([m["loss"] for m in metrics]).all(), metrics
        _smoke_asserts(args, plan, state, smoke_rec)
        print("smoke OK")


def _smoke_asserts(args, plan, state, rec):
    info = rec["info"]
    assert not info.cold, info.reason
    part = np.asarray(plan.part)
    N = plan.graph.num_nodes
    assert part.shape == (N,) and part.min() >= 0 \
        and part.max() < args.parts
    sizes = np.bincount(part, minlength=args.parts)
    assert sizes.max() <= int(np.ceil(1.15 * N / args.parts)) + 1, sizes
    # rows outside the delta's out-closure kept their bits (ages too),
    # rows inside reset their clock: checked on the host copies taken
    # right after the advance
    closure = D.out_closure(plan.graph,
                            rec["d"].invalidation_seeds(rec["n_old"]),
                            plan.spec.num_layers - 1)
    outside = np.setdiff1d(np.arange(N), closure)
    for t_new, t_old in zip(rec["tables"], rec["grown"]):
        np.testing.assert_array_equal(t_new[outside], t_old[outside])
    np.testing.assert_array_equal(rec["age"][closure], 0)
    np.testing.assert_array_equal(rec["age"][outside],
                                  rec["grown_age"][outside])
    ev = R.evaluate_exact(plan, state)
    assert np.isfinite(ev["val_acc"]) and np.isfinite(ev["test_acc"])
    assert torch.isfinite(R.predict(plan, state)).all()


if __name__ == "__main__":
    main()
