"""Evolving graph: GAS training across a churning snapshot sequence.

The counterpart of `examples/evolving_graph.py`. It trains a GCN on an
initial snapshot, then streams a sequence of `GraphDelta`s (edge churn,
node arrivals, feature drift) through `core.dynamic.fit_dynamic`. Each
snapshot's `advance` repairs the substrate instead of rebuilding it:

  * the partition is repaired from the old assignment, over the delta's
    1-hop boundary region only;
  * only the parts the delta touches re-emit their padded rows and BCSR
    blocks, bitwise what a from-scratch build emits;
  * only the history rows inside the delta's (L-1)-hop out-closure are
    re-pushed; every other row and its staleness clock keep their bits;

with parameters and optimizer state riding through, so that training
continues rather than restarts. A closure that swallows more than
`cold_rebuild_frac` of the graph falls back to a cold rebuild.

    python -m repro_torch.examples.evolving_graph \
        [--nodes 1200] [--snapshots 5] [--churn 0.005] [--epochs 3]
        [--device cuda|cpu]

`--device` defaults to cuda and raises without a card.
"""
import argparse

from repro_torch.core import delta as D
from repro_torch.core import dynamic as DY
from repro_torch.core import runtime as R
from repro_torch.data.graphs import citation_graph
from repro_torch.gnn.model import GNNSpec


def main(nodes=1200, snapshots=5, churn=0.005, epochs=3, device=None):
    g = citation_graph(num_nodes=nodes, num_features=16, num_classes=4,
                       homophily=0.8, seed=0)
    spec = GNNSpec(op="gcn", d_in=16, d_hidden=32, num_classes=4,
                   num_layers=3)
    # the synthetic citation graphs are small worlds: even a small delta's
    # 2-hop out-closure covers a large share of the nodes, so the example
    # takes a generous cold threshold to show the incremental path (on
    # large sparse graphs closures stay local, and 0.25 is the knob)
    dcfg = DY.DynamicGASConfig(
        base=R.GASConfig(num_parts=8, epochs=epochs, seed=0),
        cold_rebuild_frac=0.9,    # patch while local, rebuild when not
        pad_slack=0.25)           # pad headroom the patches grow into

    # one seeded delta generator per snapshot: mild edge churn, a few
    # node arrivals, mild feature drift; each a callable, so that it names
    # the current graph's edges
    def make_delta(snap):
        return lambda cur: D.random_delta(
            cur, edge_churn=churn, nodes_add=4, new_degree=3,
            feat_frac=0.01, seed=100 + snap)

    plan, state, history = DY.fit_dynamic(
        g, spec, dcfg, [make_delta(s) for s in range(snapshots)],
        log=True, device=device)

    final = history[-1]
    print(f"\nfinal snapshot: {int(final['num_nodes'])} nodes, "
          f"val {final['val_acc']:.3f}, test {final['test_acc']:.3f}")
    incr = [h for h in history[1:] if h["cold"] == 0.0]
    k = max(len(incr), 1)
    closure = sum(h["closure_frac"] for h in incr) / k
    adv_ms = sum(h["advance_s"] for h in incr) / k * 1e3
    print(f"{len(incr)}/{len(history) - 1} advances ran incrementally "
          f"(mean closure {closure:.1%}, mean advance {adv_ms:.1f} ms)")
    return history


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=1200)
    ap.add_argument("--snapshots", type=int, default=5)
    ap.add_argument("--churn", type=float, default=0.005)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    main(nodes=args.nodes, snapshots=args.snapshots, churn=args.churn,
         epochs=args.epochs, device=args.device)
