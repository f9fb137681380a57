"""Train a GNN with GAS and its full-batch baseline: the port's quickstart.

The counterpart of `examples/quickstart.py`: the synthetic citation graph
(homophily 0.75, feature noise 2.0, seed 0), a model with
`d_hidden=64` (GAT: 8 heads of 8, one output head; PNA: table 5's
`gas-pna` spec, `d_hidden=48` and `log_deg_mean=1.8`, as
`benchmarks/table5_baselines.py` runs it) at table 1's depths
(`benchmarks/table1_full_vs_gas.py`: 2, APPNP 5, GCNII 8, and GIN's 4
of table 2; alpha 0.1), histories stored at
`--history-dtype` (f32, bf16, int8 or vq) and placed by
`--history-storage` (device, or host: pinned host memory), a METIS-like
partition, `--epochs` epochs of full-batch training and of GAS
training (the epoch pipelined `--prefetch-depth` batches deep), then
both test accuracies from the exact full-graph forward and the GAS one
from `predict` beside them, with the history store's bytes (on the
device and on the host), its compression against f32 and the last
epoch's `hist_quant_err`.

    python -m repro_torch.launch.train_gas
        [--op gcn|gin|gat|gcnii|appnp|pna] [--nodes N]
        [--features F] [--classes C] [--parts P] [--epochs E]
        [--history-dtype f32|bf16|int8|vq] [--history-storage device|host]
        [--prefetch-depth K] [--device cuda|cpu] [--smoke]

`--device` defaults to cuda and raises without a card; `--device cpu`
runs every kernel's plain version. `--smoke` shrinks the run (400
nodes, 32 features, 4 parts, 3 epochs) and checks that the losses and
logits are finite, ending with "smoke OK".
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import runtime as R
from repro_torch.core.config import resolve_device
from repro_torch.core.history import HISTORY_STORAGES
from repro_torch.data.graphs import citation_graph
from repro_torch.gnn.model import OPS, GNNSpec
from repro_torch.train.gas_trainer import FullBatchTrainer, TrainConfig


# each op's default depth: table 1's (table 2's for GIN)
DEPTH = {"gcn": 2, "gat": 2, "pna": 2, "gin": 4, "appnp": 5, "gcnii": 8}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--op", choices=OPS, default="gcn")
    ap.add_argument("--nodes", type=int, default=2500)
    ap.add_argument("--features", type=int, default=128)
    ap.add_argument("--classes", type=int, default=7)
    ap.add_argument("--parts", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--history-dtype", default=None,
                    choices=("f32", "bf16", "int8", "vq"),
                    help="history-table storage precision (default: "
                         "$REPRO_HISTORY_DTYPE, else f32)")
    ap.add_argument("--history-storage", default=None,
                    choices=HISTORY_STORAGES,
                    help="history-table placement (default: "
                         "$REPRO_HISTORY_STORAGE, else device); host keeps "
                         "the tables in pinned host memory and moves only "
                         "the pulled rows to the device")
    ap.add_argument("--prefetch-depth", type=int, default=0,
                    help="software-pipeline depth: prefetch batch i+depth's "
                         "halo rows during batch i (0 = synchronous)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    if args.smoke:
        args.nodes, args.features, args.parts, args.epochs = 400, 32, 4, 3
    device = resolve_device(args.device)

    graph = citation_graph(num_nodes=args.nodes, num_features=args.features,
                           num_classes=args.classes, homophily=0.75,
                           feature_noise=2.0, seed=0)
    print(f"graph: {graph.num_nodes} nodes, {graph.num_edges} edges, "
          f"{graph.num_classes} classes; device {device}")
    spec = GNNSpec(op=args.op, d_in=args.features,
                   d_hidden=48 if args.op == "pna" else 64,
                   num_classes=args.classes,
                   num_layers=DEPTH[args.op], heads=8,
                   alpha=0.1, log_deg_mean=1.8 if args.op == "pna" else 1.0)

    t0 = time.perf_counter()
    full = FullBatchTrainer(graph, spec, TrainConfig(epochs=args.epochs),
                            device=device)
    hist = full.fit()
    acc_full = full.evaluate()
    _sync(device)
    print(f"full-batch {args.op.upper()}: test acc "
          f"{acc_full['test_acc']:.4f} ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    config = R.GASConfig(num_parts=args.parts, partitioner="metis",
                         epochs=args.epochs, lr=0.01,
                         history_dtype=args.history_dtype,
                         history_storage=args.history_storage,
                         prefetch_depth=args.prefetch_depth)
    plan = R.build_plan(graph, spec, config, device=device)
    t_plan = time.perf_counter() - t0
    state = R.init_state(plan)
    state, metrics = R.fit(plan, state)
    acc_gas = R.evaluate_exact(plan, state)
    logits = R.predict(plan, state)
    pred_acc = float(R._accuracy(
        logits, plan.y[:graph.num_nodes],
        torch.from_numpy(graph.test_mask).to(device)))
    _sync(device)
    print(f"GAS {args.op.upper()}       : test acc "
          f"{acc_gas['test_acc']:.4f} ({time.perf_counter() - t0:.1f}s, of "
          f"which plan {t_plan:.1f}s; {plan.batches.num_batches} batches, "
          f"max_b {plan.batches.max_b}, max_h {plan.batches.max_h})")
    print(f"delta          : "
          f"{(acc_gas['test_acc'] - acc_full['test_acc']) * 100:+.2f}pp "
          f"(paper Table 1: GAS matches full-batch)")
    print(f"gas_predict    : logits {tuple(logits.shape)}, test acc "
          f"{pred_acc:.4f} from the histories")
    store = state.histories
    f32_bytes = store.f32_bytes()
    where = store.placement_bytes()
    print(f"history store  : {store.bytes():,} bytes "
          f"({store.history_dtype}, {f32_bytes / max(store.bytes(), 1):.2f}x"
          f" vs f32), hist_quant_err {metrics[-1]['hist_quant_err']:.3g}; "
          f"{store.storage} storage, {where['device']:,} bytes on the "
          f"device and {where['host']:,} on the host (the clock "
          f"included), prefetch depth {R._resolved_depth(plan)}")
    if args.smoke:
        losses = [m["loss"] for m in metrics] + [h["loss"] for h in hist]
        assert np.isfinite(losses).all(), losses
        assert torch.isfinite(logits).all()
        print("smoke OK")
    return {"full": acc_full, "gas": acc_gas, "predict_test_acc": pred_acc,
            "epochs": metrics}


if __name__ == "__main__":
    main()
