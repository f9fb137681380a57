"""GAS serving: history tables as a low-latency node-embedding cache.

The port of `repro.core.serve` for f32 stores and the GCN operator. A
batched inference request for a query set Q is answered by ONE padded
batch over Q whose halo rows come straight out of the history tables.

Staleness SLO (the reference's contract, unchanged). Every table row
carries an `age` (serve steps since it was last re-pushed). A request
under `ServeConfig.staleness_slo = s` is answered only from rows with
age <= s: older rows are re-pushed first by a single refresh batch over
the stale closure of Q (`stale_closure`), then the query batch runs
against the refreshed tables. `s = None` never refreshes (pure cache
reads); `s = 0` serves exactly — `init_serve_state` advances every age
once, the refresh closure covers every stale node reachable from Q
through stale-only in-paths within L-1 hops, and ages are reset only for
rows the bound proves fresh (see the reference module's docstring).

Request-size bucketing: query sets pad up to the next size in
`ServeConfig.buckets`, refresh batches up a doubling ladder of the same
buckets to N, with halo/edge pads per bucket from worst-case degree sums.
Every request batch is tiled into forward BCSR blocks
(`gas.subgraph_batch(build_blocks=True, transposed=False)`: serving runs
no backward, so the transposed family the reference also tiles is not
built), and the step aggregates through the kernels — `bcsr_spmm` at
layer 0, `gather_spmm` above it — pulls features with `gather_rows` and
pushes with `scatter_rows`. Block counts K grow lazily per bucket
(`ServePlan._pad_k`), as in the reference.

Surface:

    ServeConfig -> build_serve_plan -> init_serve_state -> serve_request

The reference threads an immutable `ServeState`; here the bound
`HistoryStore` is updated in place by every step, so a `ServeState`
returned by `serve_request` shares its store with the one passed in
(thread the returned state; the old one sees the same tables).
`version` is bumped by every writing step, as in the reference.
Not ported yet (ROADMAP Queue A): `apply_feature_update`, the deprecated
`bind_state`/`serve` shims, quantized stores and `serve_service`.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.graphs import Graph
from repro_torch.gnn.model import gas_batch_forward
from . import delta
from . import gas as G
from .batch import GASBatch
from .config import HistoryExecConfig, resolve_device
from .history import HistoryStore


@dataclass(frozen=True, kw_only=True)
class ServeConfig(HistoryExecConfig):
    """Serving knobs: `staleness_slo` (default 0 — refresh to exactness;
    None never refreshes), `history_dtype` (None = the bound store's;
    set it to make `init_serve_state` reject any other precision) and
    `buckets` (query-size pads)."""
    staleness_slo: Optional[int] = 0
    buckets: Tuple[int, ...] = (8, 32, 128)


@dataclass(frozen=True)
class ServeState:
    """Model `params`, the bound `HistoryStore` (updated in place by every
    step) and the table `version`, bumped by every writing step."""
    params: Any
    histories: HistoryStore
    version: int = 0

    def replace(self, **kw) -> "ServeState":
        return dataclasses.replace(self, **kw)


@dataclass
class ServePlan:
    """Everything built once per served graph: the weighted in-edge CSR
    (global-COO per-destination order preserved), the features on the
    device, per-bucket padding bounds and the bucket ladders."""
    graph: Graph
    spec: Any                              # gnn.model.GNNSpec
    config: ServeConfig
    device: torch.device
    x: torch.Tensor                        # [N, F] features on `device`
    indptr: np.ndarray                     # [N+1] in-edge CSR (w/ loops)
    src: np.ndarray                        # [E] sources, per-dst order
    w: np.ndarray                          # [E] GCN-normalized weights
    query_buckets: Tuple[int, ...]
    refresh_buckets: Tuple[int, ...]
    pads: Dict[int, Tuple[int, int]]       # bucket -> (max_h, max_e)
    bn: int = 128
    # bucket -> K, the forward family's lazy monotone block-count floor
    _pad_k: Dict[int, int] = field(default_factory=dict)


def build_serve_plan(graph: Graph, spec, config: ServeConfig,
                     device=None) -> ServePlan:
    """CSR + padding bounds + bucket ladders, and the features uploaded to
    `device` (None means "cuda")."""
    dev = resolve_device(device)
    N = graph.num_nodes
    indptr, src_s, w_s = G.weighted_in_csr(graph)

    if not config.buckets:
        raise ValueError("ServeConfig.buckets must be non-empty")
    qb = tuple(sorted({min(int(b), N) for b in config.buckets if b > 0}))
    if not qb:
        raise ValueError(f"no usable bucket in {config.buckets}")
    ladder = list(qb)
    while ladder[-1] < N:
        ladder.append(min(ladder[-1] * 2, N))
    rb = tuple(dict.fromkeys(ladder))

    # worst-case pads per bucket size b: any b nodes pull at most the
    # top-b in-degree sum of edges, and at most one distinct halo node
    # per non-self edge (degrees here include the self-loop)
    degs = (indptr[1:] - indptr[:-1]).astype(np.int64)
    dsort = np.sort(degs)[::-1]
    cum_e = np.cumsum(dsort)
    cum_h = np.cumsum(np.maximum(dsort - 1, 0))
    pads = {}
    for b in set(qb) | set(rb):
        max_e = int(cum_e[min(b, N) - 1])
        max_h = int(max(1, min(cum_h[min(b, N) - 1], N)))
        pads[b] = (max_h, max(max_e, 1))

    x = torch.from_numpy(np.ascontiguousarray(graph.x, np.float32)).to(dev)
    return ServePlan(graph=graph, spec=spec, config=config, device=dev, x=x,
                     indptr=indptr, src=src_s, w=w_s, query_buckets=qb,
                     refresh_buckets=rb, pads=pads)


def init_serve_state(plan: ServePlan, state) -> ServeState:
    """Bind a state (anything with `params`/`histories`) to the serving
    clock: every age is advanced once (in place), because a training run's
    final step pushed its rows before the parameter update. The version
    starts at 0."""
    store = state.histories
    if store.age.shape[0] != plan.graph.num_nodes + 1:
        raise ValueError(
            f"state serves {store.age.shape[0] - 1} nodes, plan has "
            f"{plan.graph.num_nodes}")
    if store.device != plan.device:
        raise ValueError(f"store on {store.device}, plan on {plan.device}")
    want = plan.config.history_dtype
    if want is not None and want != store.history_dtype:
        raise ValueError(
            f"plan pins history_dtype={want!r} but the bound store is "
            f"{store.history_dtype!r}")
    store.age += 1
    return ServeState(params=state.params, histories=store, version=0)


# ---------------------------------------------------------------------------
# Stale closure (host-side BFS over the in-edge CSR)
# ---------------------------------------------------------------------------

def stale_closure(plan: ServePlan, age: np.ndarray, query: np.ndarray,
                  slo: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Nodes to re-push before serving `query` under staleness bound
    `slo`: BFS from Q over in-edges, depth 1..L-1, expanding only through
    stale rows (age > slo). Depth 1 excludes Q; deeper levels may re-enter
    Q. Returns (refresh set, its depth<=1 subset), both sorted unique."""
    empty = np.zeros(0, np.int64)
    L = plan.spec.num_layers
    if slo is None or L <= 1:
        return empty, empty
    N = plan.graph.num_nodes
    stale = np.asarray(age)[:N] > slo
    in_q = np.zeros(N, bool)
    in_q[query] = True
    in_r = np.zeros(N, bool)
    frontier = np.asarray(query, np.int64)
    depth1 = empty
    for depth in range(1, L):
        nbrs = delta.csr_neighbors(plan.indptr, plan.src, frontier)
        if nbrs.size == 0:
            break
        cand = stale[nbrs] & ~in_r[nbrs]
        if depth == 1:
            cand &= ~in_q[nbrs]
        new = nbrs[cand]
        if depth == 1:
            depth1 = new
        if new.size == 0:
            break
        in_r[new] = True
        frontier = new
    return np.flatnonzero(in_r).astype(np.int64), depth1


# ---------------------------------------------------------------------------
# Request batches + the per-bucket step
# ---------------------------------------------------------------------------

def _bucket_for(buckets: Tuple[int, ...], n: int) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"request of {n} rows exceeds largest bucket "
                     f"{buckets[-1]} (serve_request() chunks before this)")


def _host_request_batch(plan: ServePlan, nodes: np.ndarray,
                        bucket: int) -> GASBatch:
    """The host half of `build_request_batch` (numpy)."""
    max_h, max_e = plan.pads[bucket]
    batch = G.subgraph_batch(plan.indptr, plan.src, plan.w,
                             plan.graph.num_nodes, nodes, max_b=bucket,
                             max_h=max_h, max_e=max_e, build_blocks=True,
                             bn=plan.bn, pad_k=plan._pad_k.get(bucket, 1),
                             transposed=False)
    plan._pad_k[bucket] = int(batch.forward.cols.shape[1])
    return batch


def build_request_batch(plan: ServePlan, nodes: np.ndarray,
                        bucket: int) -> GASBatch:
    """One `GASBatch` over an arbitrary node set, padded to the bucket's
    (max_b, max_h, max_e) and tiled into forward BCSR blocks (K padded to
    the bucket's floor, which this call grows), on the plan's device. The
    reference's batch also carries the transposed family, which only a
    backward pass reads; serving does not build it."""
    return _host_request_batch(plan, nodes, bucket).to(plan.device)


def serve_step(plan: ServePlan, state: ServeState, batch: GASBatch,
               reset_idx: torch.Tensor, reset_mask: torch.Tensor
               ) -> Tuple[torch.Tensor, ServeState, Dict[str, torch.Tensor]]:
    """One serving step on a padded request batch: the GAS forward (halo
    rows read out of the history tables), in-place pushes of the freshly
    computed rows, and the age resets in `reset_idx`/`reset_mask`
    ([max_b], padding masked). Serving does not advance the staleness
    clock: the pre-step ages are kept and only the reset rows clear.
    Returns (logits [max_b, C], the next state, diagnostics)."""
    store = state.histories
    age0 = store.age.clone()
    logits, store, diags = gas_batch_forward(state.params, plan.spec, plan.x,
                                             batch, store)
    store.age.copy_(age0)
    store.reset_age(reset_idx, reset_mask)
    return logits, state.replace(version=state.version + 1), diags


def _reset_arrays(rows: np.ndarray, bucket: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = np.zeros(bucket, np.int32)
    mask = np.zeros(bucket, bool)
    idx[:len(rows)] = rows
    mask[:len(rows)] = True
    return torch.from_numpy(idx).to(device), torch.from_numpy(mask).to(device)


# ---------------------------------------------------------------------------
# Request orchestration
# ---------------------------------------------------------------------------

def serve_request(plan: ServePlan, state: ServeState, query_nodes
                  ) -> Tuple[np.ndarray, ServeState, Dict[str, float]]:
    """Answer one batched inference request.

    Dedups the query ids, chunks them to the largest bucket, and per
    chunk: reads the staleness clock, re-pushes the stale closure as one
    layer-synchronous refresh batch (bound permitting), then serves the
    query batch against the refreshed tables. Returns (logits
    [len(query_nodes), num_classes] in input order, the next state, and
    diagnostics; `halo_age_*` are measured at query-batch entry, after
    refresh; `host_build_ms` is the host time spent cutting and tiling
    the request's batches)."""
    cfg = plan.config
    slo = cfg.staleness_slo
    N = plan.graph.num_nodes
    q = np.asarray(query_nodes, np.int64).ravel()
    if q.size == 0:
        raise ValueError("empty query")
    if q.min() < 0 or q.max() >= N:
        raise ValueError(f"query ids must be in [0, {N})")
    uniq, inv = np.unique(q, return_inverse=True)
    max_q = plan.query_buckets[-1]
    n_chunks = -(-len(uniq) // max_q)
    chunks = np.array_split(uniq, n_chunks)
    host_s = 0.0

    def request_batch(nodes, bucket):
        nonlocal host_s
        t0 = time.perf_counter()
        batch = _host_request_batch(plan, nodes, bucket)
        host_s += time.perf_counter() - t0
        return batch.to(plan.device)

    out = np.zeros((len(uniq), plan.spec.num_classes), np.float32)
    halo_means: List[float] = []
    halo_max = 0.0
    qerrs: List[float] = []
    refreshed = 0
    steps = 0
    pos = 0
    for chunk in chunks:
        age = state.histories.age.cpu().numpy()
        refresh, depth1 = stale_closure(plan, age, chunk, slo)
        if refresh.size:
            bucket = _bucket_for(plan.refresh_buckets, len(refresh))
            batch = request_batch(refresh, bucket)
            # slo = 0: only the depth<=1 rows end up exact at every layer;
            # slo > 0: every refreshed row resets
            reset_rows = depth1 if slo == 0 else refresh
            ridx, rmask = _reset_arrays(reset_rows, bucket, plan.device)
            _, state, rdiags = serve_step(plan, state, batch, ridx, rmask)
            qerrs.append(float(rdiags["hist_quant_err"]))
            refreshed += int(refresh.size)
            steps += 1
        bucket = _bucket_for(plan.query_buckets, len(chunk))
        batch = request_batch(chunk, bucket)
        # the query rows were just recomputed: under a numeric bound their
        # clock restarts; slo = None keeps the clock read-only
        reset_rows = chunk if slo is not None else np.zeros(0, np.int64)
        ridx, rmask = _reset_arrays(reset_rows, bucket, plan.device)
        logits, state, qdiags = serve_step(plan, state, batch, ridx, rmask)
        out[pos:pos + len(chunk)] = logits[:len(chunk)].cpu().numpy()
        halo_means.append(float(qdiags["halo_age_mean"]))
        halo_max = max(halo_max, float(qdiags["halo_age_max"]))
        qerrs.append(float(qdiags["hist_quant_err"]))
        steps += 1
        pos += len(chunk)

    diags = {
        "halo_age_mean": float(np.mean(halo_means)),
        "halo_age_max": halo_max,
        "hist_quant_err": float(np.mean(qerrs)),
        "refreshed": float(refreshed),
        "num_steps": float(steps),
        "num_chunks": float(len(chunks)),
        "host_build_ms": host_s * 1e3,
    }
    return out[inv], state, diags
