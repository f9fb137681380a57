"""Scale a DEEP GCNII and an EXPRESSIVE GIN to a larger graph with GAS
(the paper's section 6.3 scenario): models that are hard to scale because
their receptive field spans the whole graph.

The counterpart of `examples/deep_gnn_large_graph.py`: a 32-layer GCNII
64 wide on a citation graph of `--nodes` nodes in METIS-like clusters, two
clusters a batch; then a 4-layer GIN with the Eq. 3 regularizer on a
CLUSTER-style SBM graph of up to 6,000 nodes, ten clusters a batch; both
through `GASTrainer`.

    python -m repro_torch.examples.deep_gnn_large_graph [--nodes 20000]
        [--epochs 30] [--device cuda|cpu]

`--device` defaults to cuda and raises without a card.
"""
import argparse
import time

from repro_torch.core.partition import inter_intra_ratio
from repro_torch.data.graphs import citation_graph, sbm_cluster_graph
from repro_torch.gnn.model import GNNSpec
from repro_torch.train.gas_trainer import GASTrainer, TrainConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=20000)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    graph = citation_graph(num_nodes=args.nodes, avg_degree=8,
                           num_features=128, num_classes=10,
                           homophily=0.7, feature_noise=2.0, seed=1)
    parts = max(args.nodes // 800, 8)
    print(f"graph: {graph.num_nodes} nodes {graph.num_edges} edges; "
          f"{parts} METIS-like clusters")

    # deep GCNII: full-batch would hold num_nodes x hidden x 32 activations
    spec = GNNSpec(op="gcnii", d_in=128, d_hidden=64, num_classes=10,
                   num_layers=32, alpha=0.1)
    t0 = time.time()
    tr = GASTrainer(graph, spec, num_parts=parts, partitioner="metis",
                    clusters_per_batch=2,
                    tcfg=TrainConfig(epochs=args.epochs, lr=0.01),
                    device=args.device)
    print("inter/intra after clustering:",
          round(inter_intra_ratio(graph.indptr, graph.indices, tr.part), 3))
    tr.fit(log_every=10)
    gcnii = tr.evaluate()
    print(f"GCNII-32L: {gcnii} in {time.time() - t0:.0f}s")
    b = tr.batches
    ws = (b.max_b + b.max_h) * 64 * 4 * 32 / 1e6
    print(f"device working set {ws:.1f}MB for a {graph.num_nodes}-node "
          f"graph (constant in graph size: the paper's central claim)")

    # expressive GIN on a CLUSTER-style task
    sbm = sbm_cluster_graph(num_nodes=min(args.nodes, 6000),
                            num_communities=10, seed=2)
    spec2 = GNNSpec(op="gin", d_in=sbm.x.shape[1], d_hidden=64,
                    num_classes=10, num_layers=4, reg_delta=0.05,
                    reg_weight=0.05)
    tr2 = GASTrainer(sbm, spec2, num_parts=40, partitioner="metis",
                     clusters_per_batch=10,
                     tcfg=TrainConfig(epochs=max(args.epochs, 40), lr=0.01),
                     device=args.device)
    tr2.fit(log_every=10)
    gin = tr2.evaluate()
    print(f"GIN-4L on CLUSTER-SBM: {gin}")
    return gcnii, gin


if __name__ == "__main__":
    main()
