"""GAS serving launcher (PyTorch port): history tables as a warm cache.

Trains a small GAS model (`GASConfig -> build_plan -> init_state -> fit`,
`--parts` / `--epochs`), or loads a checkpoint written by either package's
`save_gas_state`, binds its params and history tables (f32, bf16, int8 or
vq, served as they are) as the serving cache, and answers a stream of
batched query-node requests under a staleness SLO, printing p50/p99
latency, accuracy and cache diagnostics. Any of the six operators
(`--op gcn|gin|gat|gcnii|appnp|pna`, `--heads` for GAT).

Roles (`--role`, the process split of `core/serve_service.py`, on the
reference's wire protocol):

    # one process, in-process serving (default)
    PYTHONPATH=src python -m repro_torch.launch.serve_gas --role both \
        --nodes 600 --parts 4 --epochs 5 --slo 2 --requests 16 --batch 32

    # process 1: the history-owning backend (the sole writer), on a socket
    PYTHONPATH=src python -m repro_torch.launch.serve_gas --role backend \
        --port 18321 --nodes 600 --epochs 5

    # processes 2..N: stateless frontends; the same graph and serve flags,
    # the params arrive over the wire at hello
    PYTHONPATH=src python -m repro_torch.launch.serve_gas --role frontend \
        --port 18321 --nodes 600 --slo 0 --requests 16 --batch 32

`--port 0` binds an ephemeral port, which `--port-file F` writes once the
backend listens. `--save-checkpoint F` writes the trained state (with the
model flags in its meta, which `--checkpoint F` reads back). `--epochs 0`
serves a freshly initialized state (zero tables). `--device` defaults to
cuda; `--device cpu` runs the kernels' plain versions.

`--smoke` (any role) serves two requests on a graph of at most 200 nodes
after at most 2 epochs and asserts the SLO contract: `halo_age_max <= slo`,
a repeated request is served bit-identically, and SLO=0 logits match the
full-graph forward at SMOKE_TOL (the batch aggregates block by block, the
full forward edge by edge; over a bf16 or int8 store the halo rows carry
the store's rounding, so the smoke holds them to the store's precision: a
few quantization steps of logits of order 1; a vq store's rows carry its
codebook's distortion, so it is not held to the full forward, as the
reference's smoke holds no compressed store to it). The reference's smoke
asks SLO=0 to be bitwise the full recompute, which its own two-process run
misses under jax 0.9.0 (up to 2.4e-7); the port states its tolerance.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import gas as G
from repro_torch.core import runtime as R
from repro_torch.core import serve as S
from repro_torch.core import serve_service as SS
from repro_torch.core.config import resolve_device
from repro_torch.data.graphs import citation_graph
from repro_torch.gnn.model import OPS, GNNSpec, full_forward
from repro_torch.train.checkpoint import (load_gas_meta, load_gas_state_npz,
                                          save_gas_state)

# SLO=0 serving against the full forward: the same sums in another order
# for an f32 store; for a quantized one the pushed rows carry its rounding
# (a vq store's distortion is not a rounding: not held, see above)
SMOKE_TOL = {"f32": 1e-4, "bf16": 2e-2, "int8": 5e-2}
# the model flags a checkpoint's meta carries
_MODEL_ARGS = ("op", "nodes", "features", "classes", "hidden", "layers",
               "heads", "parts", "history_dtype", "seed")


def _parse_slo(s: str):
    return None if s.lower() in ("none", "inf") else int(s)


def _graph_spec(args):
    g = citation_graph(num_nodes=args.nodes, num_features=args.features,
                       num_classes=args.classes, seed=args.seed)
    spec = GNNSpec(op=args.op, d_in=args.features, d_hidden=args.hidden,
                   num_classes=args.classes, num_layers=args.layers,
                   heads=args.heads)
    return g, spec


def _serve_config(args):
    buckets = tuple(int(b) for b in args.buckets.split(","))
    return S.ServeConfig(staleness_slo=args.slo, buckets=buckets)


def _trained_state(args, device):
    """(graph, spec, a state with `params` and `histories`): restored from
    `--checkpoint`, trained for `--epochs`, or (`--epochs 0`) freshly
    initialized with zero tables."""
    if args.checkpoint:
        meta = load_gas_meta(args.checkpoint)
        if meta is not None:
            for k, v in meta.get("args", {}).items():
                if hasattr(args, k):
                    setattr(args, k, v)
        g, spec = _graph_spec(args)
        params, store, step = load_gas_state_npz(args.checkpoint, device)
        state = S.ServeState(params=params, histories=store)
        print(f"loaded {args.checkpoint} (step {step}, "
              f"history_dtype={store.history_dtype})")
    else:
        g, spec = _graph_spec(args)
        cfg = R.GASConfig(num_parts=args.parts, epochs=args.epochs,
                          history_dtype=args.history_dtype, seed=args.seed)
        plan = R.build_plan(g, spec, cfg, device=device)
        state = R.init_state(plan)
        if args.epochs > 0:
            t0 = time.perf_counter()
            state, logs = R.fit(plan, state, epochs=args.epochs)
            print(f"trained {args.epochs} epochs in "
                  f"{time.perf_counter() - t0:.1f}s "
                  f"(loss {logs[-1]['loss']:.4f})")
        else:
            print("serving a freshly initialized state (--epochs 0)")
    args.history_dtype = state.histories.history_dtype
    if args.save_checkpoint:
        if not isinstance(state, R.GASState):
            raise ValueError("--save-checkpoint writes a trained state; "
                             "drop --checkpoint")
        save_gas_state(args.save_checkpoint, state, step=args.epochs,
                       meta={"args": {k: getattr(args, k)
                                      for k in _MODEL_ARGS}})
        print(f"saved {args.save_checkpoint}")
    return g, spec, state


def _query_stream(args, num_nodes):
    rng = np.random.default_rng(args.seed + 1)
    return [rng.choice(num_nodes, size=args.batch, replace=False)
            for _ in range(args.requests)]


def _serve_stream(args, g, serve_one, device, extra=lambda d: ""):
    """The warm-up request, then `--requests` timed ones through
    `serve_one(q) -> (logits, diags)`; prints the report line and returns
    [(query, logits, diags)]."""
    queries = _query_stream(args, g.num_nodes)
    # the first request builds the kernel library and cuBLAS handles,
    # which latency should not hold
    serve_one(queries[0])
    lat, results = [], []
    for q in queries:
        t0 = time.perf_counter()
        logits, diags = serve_one(q)
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
          f"{np.mean([d['hist_quant_err'] for *_, d in results]):.3g}"
          + extra([d for *_, d in results]))
    return results


def _run_both(args, device):
    """In-process serving through the plan/state/request API."""
    g, spec, state = _trained_state(args, device)
    splan = S.build_serve_plan(g, spec, _serve_config(args), device=device)
    with torch.no_grad():
        state = S.init_serve_state(splan, state)
        store = state.histories
        print(f"cache: {store.num_layers} tables x {g.num_nodes} rows, "
              f"{store.bytes():,} bytes ({store.history_dtype}, "
              f"{store.f32_bytes() / max(store.bytes(), 1):.2f}x vs f32), "
              f"op={spec.op}, device={device}, slo={args.slo}, "
              f"buckets={splan.query_buckets}")
        box = [state]

        def serve_one(q):
            logits, box[0], diags = S.serve_request(splan, box[0], q)
            return logits, diags

        results = _serve_stream(args, g, serve_one, device)
        if args.smoke:
            _smoke_asserts(args, g, spec, splan, box[0].params,
                           store.history_dtype, results,
                           lambda q: serve_one(q)[0])
            print("smoke OK")


def _run_backend(args, device):
    """The history-owning store service: the sole writer, a blocking
    accept loop (stop it with a signal)."""
    g, spec, state = _trained_state(args, device)
    splan = S.build_serve_plan(g, spec, _serve_config(args), device=device)
    with torch.no_grad():
        backend = SS.HistoryBackend(splan, S.init_serve_state(splan, state))
    store = backend.state.histories
    print(f"backend: {store.num_layers} tables x {g.num_nodes} rows "
          f"({store.history_dtype}), op={spec.op}, device={device}, "
          f"slo={args.slo}, version 0")

    def ready(port):
        print(f"backend listening on {args.host}:{port}", flush=True)
        if args.port_file:
            with open(args.port_file, "w") as f:
                f.write(str(port))

    with torch.no_grad():
        SS.serve_backend_forever(backend, host=args.host, port=args.port,
                                 ready=ready)


def _run_frontend(args, device):
    """A stateless query frontend: its graph, spec and serve flags must
    match the backend's; the params (and codebooks) arrive at hello."""
    g, spec = _graph_spec(args)
    transport = SS.SocketTransport(args.host, args.port)
    with torch.no_grad():
        fe = SS.ServeFrontend(g, spec, _serve_config(args), transport,
                              device=device)
        print(f"frontend: connected to {args.host}:{args.port}, "
              f"history_dtype={fe.history_dtype}, op={spec.op}, "
              f"slo={args.slo}, device={device}")
        results = _serve_stream(
            args, g, fe.serve_request, device,
            extra=lambda ds: f", retries "
                             f"{sum(d['num_retries'] for d in ds):.0f}")
        if args.smoke:
            _smoke_asserts(args, g, spec, fe.plan, fe.params,
                           fe.history_dtype, results,
                           lambda q: fe.serve_request(q)[0])
            print("smoke OK")
    fe.close()


def _smoke_asserts(args, g, spec, splan, params, history_dtype, results,
                   replay):
    slo = args.slo
    if slo is not None:
        for _, _, d in results:
            assert d["halo_age_max"] <= slo, (d, slo)
    # a repeated request reads the same cached rows: bit-identical
    q = results[0][0]
    np.testing.assert_array_equal(replay(q), replay(q))
    tol = SMOKE_TOL.get(history_dtype)
    if slo == 0 and tol is not None:
        dst, src, w = G.gcn_edge_weights(g)
        dev = splan.device
        exact = full_forward(
            params, spec, splan.x,
            (torch.from_numpy(dst).to(dev), torch.from_numpy(src).to(dev)),
            torch.from_numpy(w).to(dev), g.num_nodes).cpu().numpy()
        for q, lg, _ in results:
            np.testing.assert_allclose(lg, exact[q], rtol=tol, atol=tol)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", default="both",
                    choices=("both", "backend", "frontend"),
                    help="both = in-process serving; backend = the "
                         "history-owning store service; frontend = a "
                         "stateless query resolver over the wire")
    ap.add_argument("--op", default="gcn", choices=OPS)
    ap.add_argument("--nodes", type=int, default=600)
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--heads", type=int, default=4, help="GAT's heads")
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=5,
                    help="training epochs before serving (0: serve a "
                         "fresh state)")
    ap.add_argument("--history-dtype", default=None,
                    choices=("f32", "bf16", "int8", "vq"),
                    help="precision of the trained store (default: "
                         "$REPRO_HISTORY_DTYPE, else f32; a checkpoint's "
                         "store keeps its own)")
    ap.add_argument("--slo", type=_parse_slo, default=0,
                    help="staleness bound; 0 = exact, 'none' = pure cache")
    ap.add_argument("--buckets", default="8,32,128",
                    help="comma-separated query padding buckets")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None,
                    help="serve a state written by either package's "
                         "save_gas_state instead of training")
    ap.add_argument("--save-checkpoint", default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=18321,
                    help="store-service port (0 = ephemeral)")
    ap.add_argument("--port-file", default=None,
                    help="backend: write the bound port here once ready")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny run asserting the SLO contract")
    args = ap.parse_args(argv)

    if args.smoke:
        args.nodes = min(args.nodes, 200)
        args.requests = 2
        args.epochs = min(args.epochs, 2)
    device = resolve_device(args.device)
    {"both": _run_both, "backend": _run_backend,
     "frontend": _run_frontend}[args.role](args, device)


if __name__ == "__main__":
    main()
