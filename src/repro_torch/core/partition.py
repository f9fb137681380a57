"""Graph partitioning for mini-batch selection (paper §3: "Minimizing
Inter-Connectivity Between Batches").

The port of `repro.core.partition`'s `metis_like_partition`,
`random_partition`, `edge_cut` and `inter_intra_ratio` (paper Table 6),
and the incremental repair of evolving graphs (`assign_new_nodes`,
`incremental_repair`, which `core.dynamic.advance` runs): the same numpy
and Python, line for line, so a partition is bitwise the reference's and
every batch built from it is too (tests/test_torch_train.py,
tests/test_torch_trainers.py, tests/test_torch_dynamic.py).
`metis_like_partition` is a multilevel partitioner with the METIS
objective (min edge-cut, balanced parts): greedy heavy-edge-matching
coarsening, BFS region-growing at the coarsest level, then boundary
Kernighan-Lin/FM refinement during uncoarsening. The refinement walks
nodes one by one in Python, which takes minutes at PubMed's size
(ROADMAP, open findings). The repair refines only the delta's region,
seeded from the old assignment: O(region), not O(N).
"""
from __future__ import annotations

from collections import deque

import numpy as np


def random_partition(num_nodes: int, num_parts: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    part = np.repeat(np.arange(num_parts), -(-num_nodes // num_parts))[:num_nodes]
    rng.shuffle(part)
    return part.astype(np.int32)


def _coarsen(indptr, indices, weights):
    """Heavy-edge matching: returns (match_map, coarse graph)."""
    n = len(indptr) - 1
    order = np.argsort(-np.diff(indptr))        # high-degree first
    matched = np.full(n, -1, np.int64)
    cid = 0
    for v in order:
        if matched[v] >= 0:
            continue
        best, best_w = -1, -1.0
        for e in range(indptr[v], indptr[v + 1]):
            u = indices[e]
            if matched[u] < 0 and u != v and weights[e] > best_w:
                best, best_w = u, weights[e]
        matched[v] = cid
        if best >= 0:
            matched[best] = cid
        cid += 1
    # build coarse graph
    cu = matched[np.repeat(np.arange(n), np.diff(indptr))]
    cv = matched[indices]
    keep = cu != cv
    cu, cv, w = cu[keep], cv[keep], weights[keep]
    key = cu.astype(np.int64) * cid + cv
    uniq, inv = np.unique(key, return_inverse=True)
    wsum = np.bincount(inv, weights=w)
    cu2 = (uniq // cid).astype(np.int64)
    cv2 = (uniq % cid).astype(np.int64)
    order2 = np.argsort(cu2, kind="stable")
    cu2, cv2, wsum = cu2[order2], cv2[order2], wsum[order2]
    cptr = np.zeros(cid + 1, np.int64)
    np.cumsum(np.bincount(cu2, minlength=cid), out=cptr[1:])
    return matched, (cptr, cv2, wsum, cid)


def _bfs_grow(indptr, indices, node_w, num_parts, rng):
    """Greedy BFS region growing into balanced parts at the coarsest level."""
    n = len(indptr) - 1
    target = node_w.sum() / num_parts
    part = np.full(n, -1, np.int64)
    loads = np.zeros(num_parts)
    seeds = rng.permutation(n)
    p = 0
    for s in seeds:
        if part[s] >= 0:
            continue
        q = deque([s])
        while q and loads[p] < target:
            v = q.popleft()
            if part[v] >= 0:
                continue
            part[v] = p
            loads[p] += node_w[v]
            for e in range(indptr[v], indptr[v + 1]):
                u = indices[e]
                if part[u] < 0:
                    q.append(u)
        if loads[p] >= target and p < num_parts - 1:
            p += 1
    unassigned = np.flatnonzero(part < 0)
    for v in unassigned:
        part[v] = np.argmin(loads)
        loads[part[v]] += node_w[v]
    return part


def _refine(indptr, indices, weights, node_w, part, num_parts, passes=8,
            balance_cap=1.2, seed=0, nodes=None):
    """Greedy boundary FM refinement: move a node to the neighboring part
    with the largest positive (external - internal) edge-weight gain,
    subject to a balance cap. `nodes` restricts the candidate-move set
    (incremental repair sweeps only the delta-touched region); loads and
    gains still account for the whole graph."""
    n = len(indptr) - 1
    target = node_w.sum() / num_parts
    loads = np.bincount(part, weights=node_w, minlength=num_parts)
    rng = np.random.default_rng(seed)
    cand = np.arange(n) if nodes is None else np.asarray(nodes, np.int64)
    for _ in range(passes):
        moved = 0
        for v in rng.permutation(cand):
            pv = part[v]
            gain: dict = {}
            internal = 0.0
            for e in range(indptr[v], indptr[v + 1]):
                u, w = indices[e], weights[e]
                pu = part[u]
                if pu != pv:
                    gain[pu] = gain.get(pu, 0.0) + w
                else:
                    internal += w
            if not gain:
                continue
            best_p, best_g = pv, 0.0
            for pcand, g in gain.items():
                if loads[pcand] + node_w[v] > balance_cap * target:
                    continue
                if g - internal > best_g:
                    best_p, best_g = pcand, g - internal
            if best_p != pv:
                loads[pv] -= node_w[v]
                loads[best_p] += node_w[v]
                part[v] = best_p
                moved += 1
        if moved == 0:
            break
    return part


def _rebalance(indptr, indices, weights, node_w, part, num_parts,
               balance_cap=1.15):
    """Force-move nodes out of overloaded parts (cheapest boundary first)
    until every part is within balance_cap * target."""
    target = node_w.sum() / num_parts
    loads = np.bincount(part, weights=node_w, minlength=num_parts)
    for _ in range(10 * num_parts):
        over = np.flatnonzero(loads > balance_cap * target)
        if len(over) == 0:
            break
        p_over = over[np.argmax(loads[over])]
        members = np.flatnonzero(part == p_over)
        p_under = int(np.argmin(loads))
        # cheapest node to evict: most external edges relative to internal
        best_v, best_score = members[0], -np.inf
        for v in members[: min(len(members), 2000)]:
            ext = int_ = 0.0
            for e in range(indptr[v], indptr[v + 1]):
                if part[indices[e]] == p_over:
                    int_ += weights[e]
                else:
                    ext += weights[e]
            score = ext - int_
            if score > best_score:
                best_v, best_score = v, score
        part[best_v] = p_under
        loads[p_over] -= node_w[best_v]
        loads[p_under] += node_w[best_v]
    return part


def metis_like_partition(indptr: np.ndarray, indices: np.ndarray,
                         num_parts: int, seed: int = 0,
                         coarsen_to: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    coarsen_to = coarsen_to or max(100, 8 * num_parts)
    levels = []
    ptr, idx = indptr.astype(np.int64), indices.astype(np.int64)
    w = np.ones(len(idx))
    node_w = np.ones(len(ptr) - 1)
    while len(ptr) - 1 > max(coarsen_to, 4 * num_parts):
        matched, (cptr, cidx, cw, cid) = _coarsen(ptr, idx, w)
        if cid >= len(ptr) - 1:     # no progress
            break
        levels.append((ptr, idx, w, node_w, matched))
        cnode_w = np.bincount(matched, weights=node_w, minlength=cid)
        ptr, idx, w, node_w = cptr, cidx, cw, cnode_w

    part = _bfs_grow(ptr, idx, node_w, num_parts, rng)
    part = _refine(ptr, idx, w, node_w, part, num_parts, passes=10, seed=seed)
    part = _rebalance(ptr, idx, w, node_w, part, num_parts)
    for fptr, fidx, fw, fnode_w, matched in reversed(levels):
        part = part[matched]
        part = _refine(fptr, fidx, fw, fnode_w, part, num_parts, passes=4,
                       seed=seed)
        part = _rebalance(fptr, fidx, fw, fnode_w, part, num_parts)
    return part.astype(np.int32)


# ---------------------------------------------------------------------------
# Incremental repair (evolving graphs, core/dynamic.py)
# ---------------------------------------------------------------------------

def assign_new_nodes(indptr: np.ndarray, indices: np.ndarray,
                     part: np.ndarray, num_parts: int) -> np.ndarray:
    """Extend an assignment over `part.size` nodes to the whole graph:
    each new node joins its neighbors' majority part (ties and isolated
    arrivals go to the least-loaded part). New ids are taken in order and
    the loads updated as they land, so a burst of arrivals spreads
    instead of piling onto one part. Returns int32 [N]."""
    n = len(indptr) - 1
    n_old = len(part)
    out = np.empty(n, np.int32)
    out[:n_old] = part
    loads = np.bincount(part, minlength=num_parts).astype(np.int64)
    for v in range(n_old, n):
        nbrs = indices[indptr[v]:indptr[v + 1]]
        nbrs = nbrs[nbrs < v]           # only already-assigned neighbors
        if len(nbrs):
            votes = np.bincount(out[nbrs], minlength=num_parts)
            top = votes.max()
            ties = np.flatnonzero(votes == top)
            p = int(ties[np.argmin(loads[ties])])
        else:
            p = int(np.argmin(loads))
        out[v] = p
        loads[p] += 1
    return out


def incremental_repair(indptr: np.ndarray, indices: np.ndarray,
                       part: np.ndarray, num_parts: int,
                       region: np.ndarray, passes: int = 4,
                       seed: int = 0) -> np.ndarray:
    """Repair an assignment after a graph delta: FM-refine only the
    `region` nodes (the delta's boundary), seeded from the old
    assignment, then rebalance. A node outside `region` can move only in
    the rebalance, which acts only when a part overflowed. O(region *
    degree), not O(N). Returns int32 [N]."""
    ptr = np.asarray(indptr, np.int64)
    idx = np.asarray(indices, np.int64)
    w = np.ones(len(idx))
    node_w = np.ones(len(ptr) - 1)
    out = np.asarray(part, np.int64).copy()
    out = _refine(ptr, idx, w, node_w, out, num_parts, passes=passes,
                  seed=seed, nodes=region)
    out = _rebalance(ptr, idx, w, node_w, out, num_parts)
    return out.astype(np.int32)


def edge_cut(indptr, indices, part) -> int:
    dst = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return int(np.sum(part[dst] != part[indices]) // 2)


def inter_intra_ratio(indptr, indices, part) -> float:
    """Edges between parts over edges inside parts (each undirected edge
    counted in both directions), paper Table 6."""
    dst = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    inter = np.sum(part[dst] != part[indices])
    intra = np.sum(part[dst] == part[indices])
    return float(inter) / max(float(intra), 1.0)
