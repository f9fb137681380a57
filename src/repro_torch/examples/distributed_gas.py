"""Distributed GAS: ranks train one cluster each per superstep.

The counterpart of `examples/distributed_gas.py` (the paper's §7 future
work): 4 ranks train a 3-layer GCN, 48 wide, on one METIS-like cluster
each; the histories are split by rows, halo rows move by the fixed
exchange of `core.dist_gas.halo_exchange` (raw rows, one all_to_all a
layer), and the gradient shares are summed over the ranks once a
superstep. The ranks are spawned processes in one gloo group; on the card
they share it (all on cuda:0 with one card), each on its own CUDA
context, and the exchanges are staged through pinned host buffers.

    python -m repro_torch.examples.distributed_gas \
        [--ranks 4] [--supersteps 80] [--nodes 2000] [--device cuda|cpu]

`--device` defaults to cuda and raises without a card. The store's
precision is $REPRO_HISTORY_DTYPE's (f32, bf16 or int8), else f32, as in
the reference.
"""
import argparse
import statistics
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import dist_gas as DG
from repro_torch.core.config import resolve_device
from repro_torch.core.gas import gcn_edge_weights
from repro_torch.core.partition import metis_like_partition
from repro_torch.data.graphs import citation_graph
from repro_torch.gnn.model import GNNSpec, full_forward, init_gnn
from repro_torch.kernels import _build
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt

# the reference example's graph, model and optimizer
GRAPH = dict(num_nodes=2000, num_features=64, num_classes=6, homophily=0.72,
             feature_noise=2.2, seed=7)
SPEC = dict(op="gcn", d_in=64, d_hidden=48, num_classes=6, num_layers=3)
ADAMW = dict(lr=0.01, b1=0.9, b2=0.999, weight_decay=5e-4)
CLIP = 2.0


def setup(ranks: int = 4, nodes: int = GRAPH["num_nodes"]):
    """(graph, partition, structs, spec) of the example: the reference's
    graph (`nodes` nodes), its METIS-like partition into `ranks` parts
    (seed 0) and the distributed plan."""
    g = citation_graph(**{**GRAPH, "num_nodes": nodes})
    part = metis_like_partition(g.indptr, g.indices, ranks, seed=0)
    return g, part, DG.build_dist_structs(g, part), GNNSpec(**SPEC)


def train_rank(rank: int, world_size: int, group, device, structs, spec,
               params_np: Dict[str, np.ndarray], x_pad, y_pad, m_pad,
               supersteps: int, log: bool = True,
               profile: int = 0) -> Dict[str, Any]:
    """Rank body (`core.dist_gas.run_ranks`): `supersteps` supersteps from
    the given params, each clipped at CLIP then an AdamW step. Returns
    the final params (flat numpy), per superstep the loss, the train
    accuracy and the host seconds (to a device sync), the task's
    `core.dist_gas.stats` (the collectives' seconds and parts, the wire
    bytes), its launch counts and the rank's device. On the card,
    `profile` > 0 runs the last `profile` supersteps under
    torch.profiler and adds "profile": this rank's device time (every
    kernel and copy) and the window's wall time, in us, and the steps."""
    rows = structs.rows
    params = ckpt.params_from_numpy(params_np, device=device)
    state = opt.adamw_init(params)
    store = structs.init_store(spec.hist_dims(), rank=rank, device=device)
    x, y, m = (torch.from_numpy(np.ascontiguousarray(
        a[rank * rows:(rank + 1) * rows])).to(device)
        for a in (x_pad, y_pad, m_pad))
    batch = structs.device_batch(rank, device)
    exchange = structs.exchange_arrays(rank, device)
    loss_fn = DG.make_dist_loss_fn(spec, structs, group)
    losses, accs, seconds = [], [], []
    prof, window = None, None
    for step in range(supersteps):
        if profile and device.type == "cuda" and \
                step == supersteps - profile:
            torch.cuda.synchronize(device)
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            window = time.perf_counter()
        t0 = time.perf_counter()
        loss, store, acc, _, grads = DG.superstep(
            loss_fn, params, store, x, y, m, batch, exchange, group)
        grads, _ = opt.clip_by_global_norm(opt.tree_leaves(grads), CLIP)
        params, state = opt.adamw_update(grads, state, params, **ADAMW)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
        accs.append(float(acc))
        if log and rank == 0 and (step + 1) % 20 == 0:
            print(f"superstep {step + 1}: loss {losses[-1]:.4f} train acc "
                  f"{accs[-1]:.4f}", flush=True)
    out = {"params": ckpt._flatten("", params), "loss": losses,
           "acc": accs, "seconds": seconds, "stats": dict(DG.stats),
           "launches": dict(_build.launch_counts), "device": str(device)}
    if prof is not None:
        wall_us = (time.perf_counter() - window) * 1e6
        prof.__exit__(None, None, None)
        dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        out["profile"] = {"device_us": dev_us, "wall_us": wall_us,
                          "steps": profile}
    return out


def exact_accuracy(g, spec, params_np, device) -> float:
    """The exact full-graph forward's test accuracy of flat params."""
    params = ckpt.params_from_numpy(params_np, device=device)
    dst, src, w = gcn_edge_weights(g)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    with torch.no_grad():
        logits = full_forward(params, spec, t(g.x), (t(dst), t(src)), t(w),
                              g.num_nodes)
    pred = torch.argmax(logits, -1).cpu().numpy()
    return float((pred[g.test_mask] == g.y[g.test_mask]).mean())


def main(ranks: int = 4, supersteps: int = 80,
         nodes: int = GRAPH["num_nodes"], device=None,
         log: bool = True) -> Dict[str, Any]:
    dev = resolve_device(device)
    g, part, structs, spec = setup(ranks, nodes)
    if log:
        print(f"{g.num_nodes} nodes on {ranks} ranks, {structs.rows} "
              f"rows/rank, max halo {structs.max_halo}")
    params_np = ckpt._flatten("", init_gnn(spec, seed=0, device="cpu"))
    x_pad = DG.permute_node_array(structs, g.x)
    y_pad = DG.permute_node_array(structs, g.y.astype(np.int32))
    m_pad = DG.permute_node_array(structs, g.train_mask)
    t0 = time.perf_counter()
    out = DG.run_ranks(train_rank, ranks, structs, spec, params_np, x_pad,
                       y_pad, m_pad, supersteps, log, device=device)
    if log:
        st = {k: v * 1e3 / supersteps for k, v in out[0]["stats"].items()}
        print(f"trained in {time.perf_counter() - t0:.1f}s (ranks spawned "
              f"included; superstep p50 "
              f"{statistics.median(out[0]['seconds']) * 1e3:.2f} ms; rank "
              f"0's collectives "
              f"{st['exchange_s'] + st['allreduce_s']:.2f} ms a superstep, "
              f"their gloo calls {st['gloo_s']:.2f} ms)")
    for r in out[1:]:
        for k, v in r["params"].items():
            if not np.array_equal(v, out[0]["params"][k]):
                raise AssertionError(f"params {k} differ across ranks")
    acc = exact_accuracy(g, spec, out[0]["params"], dev)
    if log:
        print("test acc:", acc)
    return {"graph": g, "part": part, "structs": structs, "spec": spec,
            "ranks": out, "test_acc": acc}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--supersteps", type=int, default=80)
    ap.add_argument("--nodes", type=int, default=GRAPH["num_nodes"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    main(ranks=args.ranks, supersteps=args.supersteps, nodes=args.nodes,
         device=args.device)
