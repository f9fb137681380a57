"""Evolving-graph GAS: training across a snapshot sequence, with the
incremental `advance` (the training side's twin of serving's refresh).

The port of `repro.core.dynamic`. Graphs churn: edges appear and go,
nodes join, features drift. Rebuilding the whole GAS substrate (the
partition, the padded batches and their BCSR blocks, the history tables)
for each snapshot throws away almost everything a small delta leaves
intact. `advance(plan, state, delta, dcfg)` carries a `GASPlan` and its
`GASState` across a `core.delta.GraphDelta` by three incremental repairs:

  1. **Partition repair** (`core.partition.incremental_repair`): new
     nodes join their neighbors' majority part, then the FM refinement
     re-runs from the old assignment over only the delta's 1-hop region.
  2. **Batch patching** (`core.gas.patch_batches`): only the parts that
     hold a touched node, a neighbor of one (its GCN weights renormalize)
     or a moved node re-emit their padded rows and block rows; every
     other batch is copied, bitwise what a from-scratch `build_batches`
     gives (the pads carry `pad_slack` headroom, so churn rarely
     overflows them).
  3. **Selective history invalidation**: only the rows inside the
     delta's L-1-hop out-closure are re-pushed, as one layer-synchronous
     `subgraph_batch` through the ordinary `gas_batch_forward(fuse_halo=
     False)` push path, under `torch.no_grad()`. Every row outside keeps
     its bits and its age; the re-pushed rows' ages are 0.

When the closure covers more than `cold_rebuild_frac` of the graph, or a
rebuilt part overflows its pads, `advance` rebuilds cold (a fresh METIS
partition, fresh batches, every row re-pushed), which is always correct,
only slower; `AdvanceInfo.reason` says which path ran.

The reference's stores are immutable. The port's pushes write in place,
so the re-push runs on a store of its own: `HistoryStore.grow` when nodes
arrive (a host store grows into new pinned buffers), else `clone()`; the
old plan and state are left as they were. Parameters and optimizer state
ride through by identity (`state2.params is state.params`), so training
resumes on the new snapshot where it left off. On the card the
`AdvanceInfo` times are read after a device synchronization, so the
re-push's seconds hold its kernels, not only their launches.

Entry points run on the card unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.data.graphs import Graph
from . import delta as D
from . import gas as G
from .batch import BlockStructure, GASBatch
from .partition import (assign_new_nodes, incremental_repair,
                        metis_like_partition, random_partition)
from .runtime import (GASConfig, GASPlan, GASState, build_plan,
                      evaluate_exact, fit, init_state)


@dataclass(frozen=True)
class DynamicGASConfig:
    """Evolving-graph knobs on top of a base `GASConfig`.

    `cold_rebuild_frac`: the closure fraction above which `advance` stops
    patching and rebuilds cold (the incremental repairs win only while
    the delta is local). `repair_passes`: FM passes of the partition
    repair. `pad_slack`: fractional headroom on every padded dimension
    (max_b, max_h, max_e and the block counts) at build time, so that
    moderate churn patches in place instead of overflowing the pads.
    `closure_hops`: the depth of history invalidation, by default L-1
    (the exact reach of a delta through L layers)."""
    base: GASConfig
    cold_rebuild_frac: float = 0.25
    repair_passes: int = 4
    pad_slack: float = 0.25
    closure_hops: Optional[int] = None


@dataclass
class AdvanceInfo:
    """What one `advance` did, and where its time went (seconds)."""
    cold: bool
    reason: str
    num_new_nodes: int
    closure_size: int
    closure_frac: float
    rebuilt_parts: int
    reassigned: int
    partition_s: float
    batches_s: float
    repush_s: float
    total_s: float


def _clock(device: torch.device) -> float:
    """`perf_counter()` once the card has run everything queued on it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _slacked(n: int, frac: float) -> int:
    return int(np.ceil(max(int(n), 1) * (1.0 + frac)))


def _grow_block_k(batches: GASBatch, pad_k: int, pad_k_t: int) -> GASBatch:
    """The block K axes zero-extended to (pad_k, pad_k_t), as
    `build_batches(pad_k=...)` pads (padding slots are all-zero blocks at
    column 0), applied afterwards so that the slack follows the real K."""
    unit = batches.unit is not None
    names = ("unit", "unit_transposed") if unit else ("forward", "transposed")
    return batches.replace(**{
        name: BlockStructure(*G._grow_k(getattr(batches, name).vals,
                                        getattr(batches, name).cols, k))
        for name, k in zip(names, (pad_k, pad_k_t))})


def _build_slacked(graph: Graph, part: np.ndarray, unit_blocks: bool,
                   pad_slack: float
                   ) -> Tuple[GASBatch, Tuple[int, int, int], int, int]:
    """Stacked host batches (with the op's block family) with `pad_slack`
    headroom on every padded dimension: a block-less probe sizes the
    pads, and the K slack is grafted onto the real build. Returns
    (batches, pad_to, K, K_t)."""
    probe = G.build_batches(graph, part, build_blocks=False)
    pad_to = (_slacked(probe.max_b, pad_slack),
              _slacked(probe.max_h, pad_slack),
              _slacked(probe.max_e, pad_slack))
    batches = G.build_batches(graph, part, pad_to=pad_to, build_blocks=True,
                              unit_weights=unit_blocks)
    bs, bs_t = ((batches.unit, batches.unit_transposed) if unit_blocks
                else (batches.forward, batches.transposed))
    pk = _slacked(bs.cols.shape[2], pad_slack)
    pk_t = _slacked(bs_t.cols.shape[2], pad_slack)
    return _grow_block_k(batches, pk, pk_t), pad_to, pk, pk_t


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def build_dynamic_plan(graph: Graph, spec, dcfg: DynamicGASConfig,
                       device=None, part: Optional[np.ndarray] = None
                       ) -> GASPlan:
    """`build_plan` for a graph that is going to evolve: the same plan,
    but every padded dimension carries `pad_slack` headroom, so that later
    `advance` calls patch the batches in place under moderate churn.
    `device` (None means "cuda") and a precomputed `part` as
    `build_plan` takes them."""
    cfg = dcfg.base
    if cfg.clusters_per_batch != 1:
        raise ValueError(
            "dynamic plans require clusters_per_batch == 1 (regrouped "
            "epochs re-emit all batches every epoch — there is nothing "
            "incremental to preserve)")
    plan = build_plan(graph, spec, cfg, device=device, part=part)
    plan.batches, plan._pad_to, plan._pad_k, plan._pad_k_t = \
        _build_slacked(graph, plan.part, plan.unit_blocks, dcfg.pad_slack)
    plan.batch_stack = plan.batches.to(plan.device)
    return plan


# ---------------------------------------------------------------------------
# Selective history re-push
# ---------------------------------------------------------------------------

@torch.no_grad()
def _repush_closure(plan: GASPlan, state: GASState, store,
                    repush: np.ndarray) -> Any:
    """Re-push the rows `repush` of `store`, in place, as one subgraph
    batch through the ordinary forward (layer-synchronous: layer l reads
    the layer l-1 rows of the halo from the tables, which outside the
    out-closure are valid by its definition), unfused so that every store
    type takes the same materialized route, with no decay and no
    regularizer: a recompute, not a training step. Every other row keeps
    its bits, and the clock keeps every age but the re-pushed rows',
    which become 0. Returns `store`."""
    from repro_torch.gnn.model import gas_batch_forward

    if plan.spec.num_layers <= 1 or len(repush) == 0:
        return store
    old_age = store.age.clone()
    indptr, src, w = G.weighted_in_csr(plan.graph)
    batch = G.subgraph_batch(indptr, src, w, plan.graph.num_nodes, repush,
                             build_blocks=True, transposed=False,
                             unit_weights=plan.unit_blocks).to(plan.device)
    gas_batch_forward(state.params, plan.spec, plan.x, batch, store,
                      use_history=True, fuse_halo=False)
    # the forward ticked the whole clock; the contract is narrower: only
    # the re-pushed rows are fresh, every other row keeps its age
    store.age.copy_(old_age)
    store.age[_tensor(repush, store.device)] = 0
    return store


# ---------------------------------------------------------------------------
# advance
# ---------------------------------------------------------------------------

def advance(plan: GASPlan, state: GASState, delta: D.GraphDelta,
            dcfg: DynamicGASConfig
            ) -> Tuple[GASPlan, GASState, AdvanceInfo]:
    """Carry (plan, state) across one `GraphDelta` by the three
    incremental repairs, or cold (see the module docstring). Returns (new
    plan, new state, AdvanceInfo). The old plan and state are left as
    they were: the new plan is a shallow copy with new graph, partition,
    batches and device arrays (it keeps the history placement, the
    regrouping rng and the pipeline's side stream), and the new state a
    new store with the old params and optimizer state."""
    dev = plan.device
    t0 = _clock(dev)
    cfg = dcfg.base
    g_old = plan.graph
    n_old = g_old.num_nodes
    g_new = D.apply_delta(g_old, delta)
    N = g_new.num_nodes
    n_new_nodes = delta.num_new_nodes
    hops = (dcfg.closure_hops if dcfg.closure_hops is not None
            else plan.spec.num_layers - 1)
    seeds = delta.invalidation_seeds(n_old)
    closure = D.hop_closure(g_new.indptr, g_new.indices, seeds, hops)
    closure_frac = len(closure) / max(N, 1)

    cold = closure_frac > dcfg.cold_rebuild_frac
    reason = (f"closure {closure_frac:.3f} > cold_rebuild_frac "
              f"{dcfg.cold_rebuild_frac}" if cold else "incremental")
    part_new = None
    patched = None
    rebuilt: np.ndarray = np.zeros(0, np.int64)
    reassigned = 0
    if not cold:
        part_ext = assign_new_nodes(g_new.indptr, g_new.indices,
                                    plan.part, cfg.num_parts)
        region = D.hop_closure(g_new.indptr, g_new.indices, seeds, 1)
        part_new = incremental_repair(
            g_new.indptr, g_new.indices, part_ext, cfg.num_parts,
            region, passes=dcfg.repair_passes, seed=cfg.seed)
        moved = np.flatnonzero(part_new[:n_old]
                               != np.asarray(plan.part)[:n_old])
        reassigned = int(len(moved))
        t_part = time.perf_counter()
        # a batch is re-emitted iff its members or any of its edge weights
        # changed: the parts holding a structural endpoint or a new node
        # (adjacency), a neighbor of one (its GCN weights renormalize with
        # the endpoint's degree), or a moved node (old and new part).
        # Feature-only updates touch no batch.
        touched = delta.touched_nodes(n_old)
        nbrs = D.csr_neighbors(g_new.indptr, g_new.indices, touched)
        aff = np.unique(np.concatenate(
            [touched, nbrs, moved,
             np.arange(n_old, N, dtype=np.int64)]))
        rebuilt = np.unique(np.concatenate(
            [part_new[aff],
             np.asarray(plan.part)[moved]])).astype(np.int64)
        patched = G.patch_batches(g_new, part_new, plan.batches, rebuilt,
                                  num_nodes_old=n_old)
        if patched is None:
            cold = True
            reason = "pad overflow (or changed part count)"

    new_plan = dataclasses.replace(plan)   # shallow copy
    if cold:
        if cfg.partitioner == "metis":
            part_new = metis_like_partition(g_new.indptr, g_new.indices,
                                            cfg.num_parts, seed=cfg.seed)
        else:
            part_new = random_partition(N, cfg.num_parts, seed=cfg.seed)
        t_part = time.perf_counter()
        patched, new_plan._pad_to, new_plan._pad_k, new_plan._pad_k_t = \
            _build_slacked(g_new, part_new, plan.unit_blocks,
                           dcfg.pad_slack)
        rebuilt = np.arange(patched.num_batches, dtype=np.int64)
    t_batches = time.perf_counter()

    new_plan.graph = g_new
    new_plan.part = part_new
    new_plan.batches = patched
    new_plan.batch_stack = patched.to(dev)
    new_plan.x = _tensor(g_new.x, dev)
    new_plan.y = _tensor(np.concatenate([g_new.y, np.zeros(1, np.int32)]),
                         dev)
    new_plan.train_mask = _tensor(
        np.concatenate([g_new.train_mask, [False]]), dev)
    dst, src, w = G.gcn_edge_weights(g_new)
    new_plan.eval_edges = (_tensor(dst, dev), _tensor(src, dev))
    new_plan.eval_w = _tensor(w, dev)

    # the re-push writes in place, so it gets a store of its own
    store = state.histories
    store = store.grow(n_new_nodes) if n_new_nodes else store.clone()
    repush = np.arange(N, dtype=np.int64) if cold else closure
    new_state = state.replace(
        histories=_repush_closure(new_plan, state, store, repush))
    t_end = _clock(dev)

    return new_plan, new_state, AdvanceInfo(
        cold=cold, reason=reason, num_new_nodes=n_new_nodes,
        closure_size=int(len(closure)), closure_frac=float(closure_frac),
        rebuilt_parts=int(len(rebuilt)), reassigned=reassigned,
        partition_s=t_part - t0, batches_s=t_batches - t_part,
        repush_s=t_end - t_batches, total_s=t_end - t0)


# ---------------------------------------------------------------------------
# Snapshot-sequence trainer
# ---------------------------------------------------------------------------

DeltaLike = Union[D.GraphDelta, Callable[[Graph], D.GraphDelta]]


def fit_dynamic(graph: Graph, spec, dcfg: DynamicGASConfig,
                deltas: Iterable[DeltaLike],
                epochs_per_snapshot: Optional[int] = None,
                log: bool = False, device=None, params=None
                ) -> Tuple[GASPlan, GASState, List[Dict[str, float]]]:
    """Train across a snapshot sequence: fit on the initial graph, then
    for each delta `advance` (carrying histories, partition, optimizer
    state and parameters) and fit again. A delta may be a `GraphDelta`
    or a callable `graph -> GraphDelta` (a generator such as
    `core.delta.random_delta` must see the current graph to name valid
    edges). `device` (None means "cuda") and `params` (initial weights,
    e.g. the reference's carried across; None draws `init_gnn`'s) as
    `build_plan` and `init_state` take them. Returns (final plan, final
    state, one record per snapshot: exact-evaluation accuracies and the
    advance's diagnostics)."""
    plan = build_dynamic_plan(graph, spec, dcfg, device=device)
    state = init_state(plan, params=params)
    epochs = (dcfg.base.epochs if epochs_per_snapshot is None
              else epochs_per_snapshot)
    history: List[Dict[str, float]] = []

    def _record(snap: int, info: Optional[AdvanceInfo]) -> None:
        ev = evaluate_exact(plan, state)
        rec: Dict[str, float] = {"snapshot": float(snap), **ev,
                                 "num_nodes": float(plan.graph.num_nodes)}
        if info is not None:
            rec.update(cold=float(info.cold),
                       closure_frac=info.closure_frac,
                       rebuilt_parts=float(info.rebuilt_parts),
                       advance_s=info.total_s)
        history.append(rec)
        if log:
            extra = ("" if info is None else
                     f" advance={info.total_s * 1e3:.1f}ms "
                     f"({'cold' if info.cold else 'incremental'}, "
                     f"closure {info.closure_frac:.1%})")
            print(f"snapshot {snap}: val={ev['val_acc']:.4f} "
                  f"test={ev['test_acc']:.4f}{extra}")

    state, _ = fit(plan, state, epochs=epochs)
    _record(0, None)
    for i, d in enumerate(deltas):
        if callable(d):
            d = d(plan.graph)
        plan, state, info = advance(plan, state, d, dcfg)
        state, _ = fit(plan, state, epochs=epochs)
        _record(i + 1, info)
    return plan, state, history
