"""GAS serving launcher (PyTorch port): history tables as a warm cache.

Binds a GCN's params and history tables — loaded from a checkpoint
written by either package's `save_gas_state`, or freshly initialized at
`--history-dtype` (f32, bf16, int8 or vq; a fresh state is what the
reference serves with `--epochs 0`) — and answers a stream of batched query-node requests under
a staleness SLO, printing p50/p99 latency, accuracy and cache
diagnostics:

    PYTHONPATH=src python -m repro_torch.launch.serve_gas \
        --nodes 600 --slo 0 --requests 16 --batch 32
    PYTHONPATH=src python -m repro_torch.launch.serve_gas --checkpoint gas.npz
    PYTHONPATH=src python -m repro_torch.launch.serve_gas --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_gas --smoke \
        --device cpu --history-dtype int8

`--device` defaults to cuda. `--smoke` serves two requests on a tiny graph
and asserts the SLO contract: `halo_age_max <= slo`, a repeated request
is served bit-identically, and SLO=0 logits match the full-graph forward
(to f32 tolerance: the batch aggregates block by block, the full forward
edge by edge; over a bf16 or int8 store the halo rows carry the store's
rounding, so the smoke holds them to the store's precision instead:
2e-2 for bf16 and 5e-2 for int8, a few quantization steps of logits of
order 1; a vq store's rows carry its codebook's distortion, a relative
error near 0.8 per row at the initial codebook, so it is not held to the
full forward, as the reference's smoke holds no compressed store to it).
The cache line prints the store's bytes and its compression
against f32. Only the in-process role of the reference (`--role both`)
is ported; the store service and its frontends come later (ROADMAP
Queue A).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import gas as G
from repro_torch.core import serve as S
from repro_torch.core.config import resolve_device
from repro_torch.core.history import HistoryStore
from repro_torch.data.graphs import citation_graph
from repro_torch.gnn.model import GNNSpec, full_forward, init_gnn
from repro_torch.train.checkpoint import load_gas_meta, load_gas_state_npz

# SLO=0 serving against the full forward: the same sums in another order
# for an f32 store; for a quantized one the pushed rows carry its rounding
# (a vq store's distortion is not a rounding: not held, see above)
SMOKE_TOL = {"f32": 1e-4, "bf16": 2e-2, "int8": 5e-2}


def _parse_slo(s: str):
    return None if s.lower() in ("none", "inf") else int(s)


def _build(args):
    g = citation_graph(num_nodes=args.nodes, num_features=args.features,
                       num_classes=args.classes, seed=args.seed)
    spec = GNNSpec(op=args.op, d_in=args.features, d_hidden=args.hidden,
                   num_classes=args.classes, num_layers=args.layers)
    return g, spec


def _state(args, device):
    """(graph, spec, ServeState before binding): from a checkpoint, or
    freshly initialized params and a zero store."""
    if args.checkpoint:
        meta = load_gas_meta(args.checkpoint)
        if meta is not None:
            for k, v in meta.get("args", {}).items():
                if hasattr(args, k):
                    setattr(args, k, v)
        g, spec = _build(args)
        params, store, step = load_gas_state_npz(args.checkpoint, device)
        args.history_dtype = store.history_dtype
        print(f"loaded {args.checkpoint} (step {step})")
    else:
        g, spec = _build(args)
        params = init_gnn(spec, seed=args.seed, device=device)
        store = HistoryStore.create(g.num_nodes + 1, spec.hist_dims(),
                                    history_dtype=args.history_dtype,
                                    device=device)
        print("serving a freshly initialized state (no --checkpoint)")
    return g, spec, S.ServeState(params=params, histories=store)


def _query_stream(args, num_nodes):
    rng = np.random.default_rng(args.seed + 1)
    return [rng.choice(num_nodes, size=args.batch, replace=False)
            for _ in range(args.requests)]


def run(args):
    device = resolve_device(args.device)
    g, spec, state = _state(args, device)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    splan = S.build_serve_plan(
        g, spec, S.ServeConfig(staleness_slo=args.slo, buckets=buckets),
        device=device)
    state = S.init_serve_state(splan, state)
    store = state.histories
    f32_bytes = store.f32_bytes()
    print(f"cache: {store.num_layers} tables x {g.num_nodes} rows, "
          f"{store.bytes():,} bytes ({store.history_dtype}, "
          f"{f32_bytes / max(store.bytes(), 1):.2f}x vs f32), "
          f"device={device}, slo={args.slo}, buckets={splan.query_buckets}")

    queries = _query_stream(args, g.num_nodes)
    # warm-up, as the reference launcher does: the first request builds
    # the kernel library and cuBLAS handles, which latency should not hold
    _, state, _ = S.serve_request(splan, state, queries[0])
    lat, results = [], []
    for q in queries:
        t0 = time.perf_counter()
        logits, state, diags = S.serve_request(splan, state, q)
        lat.append((time.perf_counter() - t0) * 1e3)
        results.append((q, logits, diags))

    y = np.asarray(g.y)
    correct = sum(int((np.argmax(lg, -1) == y[q]).sum())
                  for q, lg, _ in results)
    print(f"served {args.requests} x {args.batch} queries on {device}: "
          f"p50 {np.percentile(lat, 50):.2f} ms, "
          f"p99 {np.percentile(lat, 99):.2f} ms, "
          f"acc {correct / (args.requests * args.batch):.3f}, "
          f"halo_age_max {max(d['halo_age_max'] for *_, d in results):.0f}, "
          f"refreshed {sum(d['refreshed'] for *_, d in results):.0f} rows, "
          f"hist_quant_err "
          f"{np.mean([d['hist_quant_err'] for *_, d in results]):.3g}")

    if args.smoke:
        _smoke_asserts(args, g, spec, splan, state, results)
        print("smoke OK")


def _smoke_asserts(args, g, spec, splan, state, results):
    slo = args.slo
    if slo is not None:
        for _, _, d in results:
            assert d["halo_age_max"] <= slo, (d, slo)
    # a repeated request reads the same cached rows: bit-identical
    q = results[0][0]
    first = S.serve_request(splan, state, q)[0]
    np.testing.assert_array_equal(first, S.serve_request(splan, state, q)[0])
    tol = SMOKE_TOL.get(state.histories.history_dtype)
    if slo == 0 and tol is not None:
        dst, src, w = G.gcn_edge_weights(g)
        dev = splan.device
        with torch.no_grad():
            exact = full_forward(
                state.params, spec, splan.x,
                (torch.from_numpy(dst).to(dev), torch.from_numpy(src).to(dev)),
                torch.from_numpy(w).to(dev), g.num_nodes).cpu().numpy()
        for q, lg, _ in results:
            np.testing.assert_allclose(lg, exact[q], rtol=tol, atol=tol)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", default="both", choices=("both",),
                    help="in-process serving (the store service and its "
                         "frontends are not ported yet)")
    ap.add_argument("--op", default="gcn", choices=("gcn",))
    ap.add_argument("--nodes", type=int, default=600)
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--slo", type=_parse_slo, default=0,
                    help="staleness bound; 0 = exact, 'none' = pure cache")
    ap.add_argument("--buckets", default="8,32,128",
                    help="comma-separated query padding buckets")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--history-dtype", default=None,
                    choices=("f32", "bf16", "int8", "vq"),
                    help="precision of a fresh store (default: "
                         "$REPRO_HISTORY_DTYPE, else f32; a checkpoint's "
                         "store keeps its own)")
    ap.add_argument("--checkpoint", default=None,
                    help="serve a state written by either package's "
                         "save_gas_state")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny run asserting the SLO contract")
    args = ap.parse_args(argv)

    if args.smoke:
        args.nodes = min(args.nodes, 200)
        args.requests = 2
    with torch.no_grad():
        run(args)


if __name__ == "__main__":
    main()
