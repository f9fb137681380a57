"""GAS serving: history tables as a low-latency node-embedding cache.

The port of `repro.core.serve` for all six operators (GCN, GIN, GAT,
GCNII, APPNP, PNA) over f32, bf16, int8 and vq history stores (a
quantized store is bound as it is, and every refresh push quantizes on
the way in; a vq store's codebooks and k-means statistics are left
exactly as they were: serving pushes encode against the bound codebook
and gather no statistics). A batched inference request for a query set Q
is answered by ONE padded batch over Q whose halo rows come straight out
of the history tables.

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
`apply_feature_update` rewrites node features in a live plan and stamps
every row within L-1 hops of them `INVALID_AGE`, so the next request
under any finite SLO re-pushes them.

Request-size bucketing: query sets pad up to the next size in
`ServeConfig.buckets`, refresh batches up a doubling ladder of the same
buckets to N, with halo/edge pads per bucket from worst-case degree sums.
Every request batch is tiled into forward BCSR blocks of the op's family
(`gas.subgraph_batch(build_blocks=True, transposed=False)`: the
GCN-weighted blocks for GCN, GCNII and APPNP, the unit-weight ones for
GIN, GAT and PNA; serving runs no backward, so the transposed family the
reference also tiles is not built), and the step runs the op's forward
kernels: `bcsr_spmm` at layer 0 (GAT's edge softmax and PNA's reduction
at every layer), `gather_spmm` above it for the fused ops, `gather_rows`
for the features and the halo-split ops' history pulls, and the store's
push. Block counts K grow lazily per bucket (`ServePlan._pad_k`, one
family a plan), as in the reference.

Surface:

    ServeConfig -> build_serve_plan -> init_serve_state -> serve_request

The reference threads an immutable `ServeState`; here the bound
`HistoryStore` is updated in place by every step, so a `ServeState`
returned by `serve_request` shares its store with the one passed in
(thread the returned state; the old one sees the same tables).
`version` is bumped by every writing step, as in the reference.
`make_serve_step_fn` exposes the step itself, and the deprecated
`bind_state` / `serve` shims warn and delegate. The split into one
history-owning backend and stateless frontends is `core.serve_service`.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.graphs import Graph
from repro_torch.gnn.model import (UNIT_BLOCK_OPS, _check_op,
                                   gas_batch_forward)
from . import delta
from . import gas as G
from .batch import GASBatch
from .config import HistoryExecConfig, resolve_device
from .history import HistoryStore

# age stamped on rows invalidated by a feature update: large enough that
# every finite staleness SLO treats them as stale until re-pushed
INVALID_AGE = 1 << 20


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
    device, per-bucket padding bounds, the bucket ladders, and which block
    family the op reads (`unit_weights`: the unit-weight blocks of GIN,
    GAT and PNA)."""
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
    unit_weights: bool = False
    bn: int = 128
    # bucket -> K, the lazy monotone block-count floor of the plan's one
    # forward family (the weighted or the unit-weight one)
    _pad_k: Dict[int, int] = field(default_factory=dict)


def build_serve_plan(graph: Graph, spec, config: ServeConfig,
                     device=None) -> ServePlan:
    """CSR + padding bounds + bucket ladders, the op's block family (the
    unit-weight one for GIN, GAT and PNA, the weighted one for GCN, GCNII
    and APPNP, as the reference's `UNIT_BLOCK_OPS`), and the features
    uploaded to `device` (None means "cuda")."""
    _check_op(spec)
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
                     refresh_buckets=rb, pads=pads,
                     unit_weights=spec.op in UNIT_BLOCK_OPS)


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


def _rewrite_features(plan: ServePlan, nodes, values) -> np.ndarray:
    """Checked (the reference's checks and messages), the plan's features
    rewritten in place (`plan.graph.x` and `plan.x`): rows `nodes` take
    `values`. Returns the ids as int64."""
    N = plan.graph.num_nodes
    nodes, values = delta.check_feature_update(nodes, values)
    new_x = np.array(plan.graph.x, np.float32)
    if values.shape[1:] != new_x.shape[1:]:
        raise ValueError(
            f"feature width {values.shape[1:]} != {new_x.shape[1:]}")
    if len(nodes) and (nodes.min() < 0 or nodes.max() >= N):
        raise ValueError(f"update ids must be in [0, {N})")
    new_x[nodes] = values
    plan.graph = dataclasses.replace(plan.graph, x=new_x)
    plan.x = torch.from_numpy(new_x).to(plan.device)
    return nodes


def apply_feature_update(plan: ServePlan, state, nodes: np.ndarray,
                         values: np.ndarray):
    """Rewrite node features in a live serving plan and invalidate every
    history row the change can reach. The plan's features are rewritten
    (`plan.x` and `plan.graph`; the structure is untouched), and every node
    within L-1 hops of an updated node (`delta.hop_closure` over the
    plan's own CSR) gets its age stamped `INVALID_AGE`, in place: the
    deepest table row depends on features L-1 hops away, so everything in
    that closure may now disagree with a fresh recompute, and nothing
    outside it can. At SLO=0 the next request serves the new features
    exactly; `slo=None` plans keep serving the cached rows. The ids must be
    unique and in [0, N), one value row of the features' width each (the
    reference's checks and messages).

    Accepts a `ServeState` (its version bumped: an invalidation is a write
    generation) or anything with `histories` (the deprecated flow), and
    returns the updated state of the same type. The plan is updated in
    place."""
    nodes = _rewrite_features(plan, nodes, values)
    closure = delta.hop_closure(plan.indptr, plan.src, nodes,
                                plan.spec.num_layers - 1)
    age = state.histories.age
    age[torch.from_numpy(closure).to(age.device)] = INVALID_AGE
    if isinstance(state, ServeState):
        state = state.replace(version=state.version + 1)
    return state


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
                             transposed=False,
                             unit_weights=plan.unit_weights)
    fam = batch.unit if plan.unit_weights else batch.forward
    plan._pad_k[bucket] = int(fam.cols.shape[1])
    return batch


def build_request_batch(plan: ServePlan, nodes: np.ndarray,
                        bucket: int) -> GASBatch:
    """One `GASBatch` over an arbitrary node set, padded to the bucket's
    (max_b, max_h, max_e) and tiled into the forward BCSR blocks of the
    plan's family (K padded to the bucket's floor, which this call grows),
    on the plan's device. The reference's batch also carries the
    transposed family, which only a backward pass reads; serving does not
    build it."""
    return _host_request_batch(plan, nodes, bucket).to(plan.device)


def make_serve_step_fn(plan: ServePlan) -> Callable:
    """The serve step `(params, store, batch, reset_idx, reset_mask, x) ->
    (logits, store, diags)` as a function, the reference's un-jitted
    step: the GAS forward (halo rows read out of the history tables),
    in-place pushes of the freshly computed rows, and the age resets in
    `reset_idx`/`reset_mask` ([max_b], padding masked). Serving does not
    advance the staleness clock: the pre-step ages are kept and only the
    reset rows clear. Nor does it touch a vq store's codebooks or
    statistics (the reference restores both after its step)."""
    spec = plan.spec

    def step(params, store, batch, reset_idx, reset_mask, x):
        age0 = store.age.clone()
        logits, store, diags = gas_batch_forward(params, spec, x, batch,
                                                 store, vq_stats=False)
        store.age.copy_(age0)
        store.reset_age(reset_idx, reset_mask)
        return logits, store, diags

    return step


def serve_step(plan: ServePlan, state: ServeState, batch: GASBatch,
               reset_idx: torch.Tensor, reset_mask: torch.Tensor
               ) -> Tuple[torch.Tensor, ServeState, Dict[str, torch.Tensor]]:
    """One serving step on a padded request batch (`make_serve_step_fn`)
    over the state's params and store. A step writes tables, so the
    version is bumped. Returns (logits [max_b, C], the next state,
    diagnostics)."""
    logits, _, diags = make_serve_step_fn(plan)(
        state.params, state.histories, batch, reset_idx, reset_mask, plan.x)
    return logits, state.replace(version=state.version + 1), diags


def reset_rows_np(rows: np.ndarray, bucket: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(idx int32 [bucket], mask bool [bucket]): the age resets of a step
    over `rows`, padded; what the reference's `_reset_arrays` builds and
    the serving wire protocol carries."""
    idx = np.zeros(bucket, np.int32)
    mask = np.zeros(bucket, bool)
    idx[:len(rows)] = rows
    mask[:len(rows)] = True
    return idx, mask


def _reset_arrays(rows: np.ndarray, bucket: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    idx, mask = reset_rows_np(rows, bucket)
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


# ---------------------------------------------------------------------------
# One-release deprecation shims (the reference's PR-6 surface)
# ---------------------------------------------------------------------------

def bind_state(plan: ServePlan, state) -> ServeState:
    """Deprecated: use `init_serve_state(plan, state)`. Warns (the
    reference's text) and delegates."""
    warnings.warn(
        "serve.bind_state is deprecated; use "
        "serve.init_serve_state(plan, state)",
        DeprecationWarning, stacklevel=2)
    return init_serve_state(plan, state)


def serve(plan: ServePlan, state, query_nodes
          ) -> Tuple[np.ndarray, ServeState, Dict[str, float]]:
    """Deprecated: use `serve_request(plan, state, query_nodes)`. Warns
    (the reference's text) and delegates; a state that is not a
    `ServeState` (anything with `params` and `histories`) is wrapped into
    one at version 0, its ages untouched."""
    warnings.warn(
        "serve.serve is deprecated; use "
        "serve.serve_request(plan, state, query_nodes)",
        DeprecationWarning, stacklevel=2)
    if not isinstance(state, ServeState):
        state = ServeState(params=state.params, histories=state.histories)
    return serve_request(plan, state, query_nodes)
