"""Typed graph deltas for evolving-graph GAS (numpy), the port of
`repro.core.delta`.

  * `GraphDelta`: one snapshot-to-snapshot change record (undirected edge
    insertions and deletions, appended nodes with features and labels,
    in-place feature updates of existing nodes).
  * `apply_delta`: the CSR patched row by row. Only the touched rows are
    re-spliced; every other row is copied as it is, so the result is
    bitwise what `data.graphs._to_csr` builds from the edited edge list.
  * `csr_neighbors` / `hop_closure` / `out_closure`: the L-hop closure of a
    seed set over the CSR. Serving's stale-closure walk and
    `serve.apply_feature_update` step through the first two; `out_closure`
    is the rows `core.dynamic.advance` re-pushes.
  * `check_feature_update`: the validation a feature update gets (here in
    `GraphDelta` and in `serve.apply_feature_update`), with the
    reference's messages.
  * `random_delta`: a seeded churn generator (tests, launchers, examples).

The same numpy code as the reference, line for line, so a graph and a
delta are bitwise the reference's from the same seed
(tests/test_torch_dynamic.py). Everything here is host work: deltas are
set-up data, like partitions and batches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.data.graphs import Graph

_EMPTY_EDGES = np.zeros((0, 2), np.int64)
_EMPTY = np.zeros(0, np.int64)


def _as_edges(e) -> np.ndarray:
    if e is None:
        return _EMPTY_EDGES
    e = np.asarray(e, np.int64).reshape(-1, 2)
    return e[e[:, 0] != e[:, 1]]            # self-loops are never stored


def _sym(edges: np.ndarray) -> np.ndarray:
    """Both directions of each undirected pair, deduplicated."""
    if len(edges) == 0:
        return _EMPTY_EDGES
    both = np.concatenate([edges, edges[:, ::-1]], axis=0)
    return np.unique(both, axis=0)


def check_feature_update(feat_nodes, feat_values
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(ids int64 [m], values f32 [m, ...]) of an in-place feature update,
    checked as the reference's `GraphDelta(feat_nodes=..., feat_values=...)`
    checks it: the ids unique and one value row per id, with its
    messages."""
    fn = np.asarray(feat_nodes, np.int64).ravel()
    if len(np.unique(fn)) != len(fn):
        raise ValueError("feat_nodes must be unique")
    fv = np.asarray(feat_values, np.float32)
    if fv.shape[0] != fn.shape[0]:
        raise ValueError(
            f"feat_values rows ({fv.shape[0]}) != feat_nodes "
            f"({fn.shape[0]})")
    return fn, fv


@dataclass(frozen=True)
class GraphDelta:
    """One snapshot-to-snapshot change set.

    `edges_add` / `edges_del` are [*, 2] undirected (u, v) pairs:
    direction and duplicates are normalized away when the delta is
    applied, and self-loops are dropped here. `x_new` / `y_new` describe
    appended nodes (ids `N_old .. N_old + n_new`), whose adjacency comes
    from `edges_add` rows naming the new ids. `feat_nodes` /
    `feat_values` overwrite the features of existing nodes. Deleting an
    absent edge or adding a present one is a no-op (set semantics), so
    deltas compose without bookkeeping."""
    edges_add: np.ndarray = dataclasses.field(
        default_factory=lambda: _EMPTY_EDGES)
    edges_del: np.ndarray = dataclasses.field(
        default_factory=lambda: _EMPTY_EDGES)
    x_new: Optional[np.ndarray] = None       # [n_new, F] float32
    y_new: Optional[np.ndarray] = None       # [n_new] int32
    feat_nodes: Optional[np.ndarray] = None  # [m] existing node ids
    feat_values: Optional[np.ndarray] = None  # [m, F] float32

    def __post_init__(self):
        object.__setattr__(self, "edges_add", _as_edges(self.edges_add))
        object.__setattr__(self, "edges_del", _as_edges(self.edges_del))
        if self.feat_nodes is not None:
            fn, fv = check_feature_update(self.feat_nodes, self.feat_values)
            object.__setattr__(self, "feat_nodes", fn)
            object.__setattr__(self, "feat_values", fv)
        elif self.feat_values is not None:
            raise ValueError("feat_values without feat_nodes")

    @classmethod
    def empty(cls) -> "GraphDelta":
        return cls()

    @property
    def num_new_nodes(self) -> int:
        return 0 if self.x_new is None else int(self.x_new.shape[0])

    def is_empty(self) -> bool:
        return (len(self.edges_add) == 0 and len(self.edges_del) == 0
                and self.num_new_nodes == 0 and self.feat_nodes is None)

    def touched_nodes(self, num_nodes_old: int) -> np.ndarray:
        """Structure-touched node ids (sorted unique): the endpoints of
        every edge change and the appended nodes, whose adjacency rows or
        GCN degree normalization change; the seeds of the partition
        repair and the batch patch. Feature-only updates are not included
        (see `invalidation_seeds`)."""
        new = np.arange(num_nodes_old,
                        num_nodes_old + self.num_new_nodes, dtype=np.int64)
        return np.unique(np.concatenate(
            [self.edges_add.ravel(), self.edges_del.ravel(), new]))

    def invalidation_seeds(self, num_nodes_old: int) -> np.ndarray:
        """The seeds of history invalidation: the structure-touched nodes
        and the feature-updated ones, everything whose layer-0 inputs or
        aggregation weights changed. Their L-1-hop `out_closure` is the
        rows `core.dynamic.advance` re-pushes."""
        feat = (self.feat_nodes if self.feat_nodes is not None else _EMPTY)
        return np.union1d(self.touched_nodes(num_nodes_old), feat)


# ---------------------------------------------------------------------------
# CSR patch application
# ---------------------------------------------------------------------------

def apply_delta(graph: Graph, delta: GraphDelta) -> Graph:
    """A new `Graph` with the delta applied by re-splicing the CSR.

    Only the rows of touched nodes are recomputed (per row
    `union1d(setdiff1d(old, dels), adds)`, which keeps each row sorted);
    every other row is copied in one vectorized splice, so the result is
    bitwise what `data.graphs._to_csr` builds from the whole edited edge
    list. Appended nodes get their rows from `edges_add` and all-False
    masks (unlabeled arrivals)."""
    n_old = graph.num_nodes
    n_new = delta.num_new_nodes
    n = n_old + n_new
    adds = _sym(delta.edges_add)
    dels = _sym(delta.edges_del)
    for name, e in (("edges_add", adds), ("edges_del", dels)):
        if len(e) and (e.min() < 0 or e.max() >= n):
            raise ValueError(f"{name} references node >= {n} (or < 0)")

    touched = np.unique(np.concatenate(
        [adds[:, 0], dels[:, 0],
         np.arange(n_old, n, dtype=np.int64)]))
    indptr_old = graph.indptr.astype(np.int64)
    counts = np.concatenate([np.diff(indptr_old),
                             np.zeros(n_new, np.int64)])

    # each touched row's new sorted neighbor list (work of the delta's size)
    def _per_dst(e):
        order = np.argsort(e[:, 0], kind="stable")
        d = e[order, 0]
        bounds = np.searchsorted(d, touched, side="left"), \
            np.searchsorted(d, touched, side="right")
        return e[order, 1], bounds

    add_src, (a_lo, a_hi) = _per_dst(adds)
    del_src, (d_lo, d_hi) = _per_dst(dels)
    new_rows = {}
    for i, r in enumerate(touched):
        old_nb = (graph.indices[indptr_old[r]:indptr_old[r + 1]]
                  if r < n_old else _EMPTY)
        nb = np.union1d(np.setdiff1d(old_nb, del_src[d_lo[i]:d_hi[i]]),
                        add_src[a_lo[i]:a_hi[i]])
        new_rows[int(r)] = nb.astype(np.int64)
        counts[r] = len(nb)

    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.empty(int(indptr[-1]), np.int64)
    # one vectorized copy of every untouched row: its old offsets within
    # the row are kept, so it lands at indptr_new[dst] + old offset
    is_touched = np.zeros(n_old, bool)
    is_touched[touched[touched < n_old]] = True
    old_dst = np.repeat(np.arange(n_old, dtype=np.int64),
                        np.diff(indptr_old))
    keep = ~is_touched[old_dst]
    offs = np.arange(len(old_dst), dtype=np.int64) - indptr_old[old_dst]
    indices[indptr[old_dst[keep]] + offs[keep]] = graph.indices[keep]
    for r, nb in new_rows.items():
        indices[indptr[r]:indptr[r] + len(nb)] = nb

    x = graph.x
    if n_new:
        x_new = np.asarray(delta.x_new, np.float32)
        if x_new.shape[1] != graph.x.shape[1]:
            raise ValueError(
                f"x_new width {x_new.shape[1]} != graph feature width "
                f"{graph.x.shape[1]}")
        x = np.concatenate([x, x_new], axis=0)
    if delta.feat_nodes is not None:
        if delta.feat_nodes.max(initial=-1) >= n_old:
            raise ValueError("feat_nodes must reference existing nodes")
        x = np.array(x)
        x[delta.feat_nodes] = delta.feat_values
    y = graph.y
    if n_new:
        y_new = (np.asarray(delta.y_new, np.int32) if delta.y_new is not None
                 else np.zeros(n_new, np.int32))
        y = np.concatenate([y, y_new])

    def _extend_mask(m):
        return (np.concatenate([m, np.zeros(n_new, bool)]) if n_new
                else m)

    return Graph(indptr=indptr.astype(np.int32),
                 indices=indices.astype(np.int32),
                 x=np.asarray(x, np.float32), y=y.astype(np.int32),
                 train_mask=_extend_mask(graph.train_mask),
                 val_mask=_extend_mask(graph.val_mask),
                 test_mask=_extend_mask(graph.test_mask),
                 num_classes=graph.num_classes)


# ---------------------------------------------------------------------------
# Closures (host BFS over the CSR)
# ---------------------------------------------------------------------------

def csr_neighbors(indptr: np.ndarray, indices: np.ndarray,
                  nodes: np.ndarray) -> np.ndarray:
    """Sorted-unique union of the CSR rows of `nodes` (one vectorized
    flat gather)."""
    nodes = np.asarray(nodes, np.int64)
    if nodes.size == 0:
        return _EMPTY
    indptr = np.asarray(indptr, np.int64)
    starts = indptr[nodes]
    lens = indptr[nodes + 1] - starts
    total = int(lens.sum())
    if total == 0:
        return _EMPTY
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    flat = np.repeat(starts - offs, lens) + np.arange(total)
    return np.unique(np.asarray(indices)[flat].astype(np.int64))


def hop_closure(indptr: np.ndarray, indices: np.ndarray,
                seeds: np.ndarray, hops: int) -> np.ndarray:
    """All nodes within `hops` CSR steps of `seeds` (seeds included),
    sorted unique. BFS with a visited mask, so each frontier only expands
    fresh nodes."""
    n = len(indptr) - 1
    seeds = np.unique(np.asarray(seeds, np.int64))
    if seeds.size and (seeds[0] < 0 or seeds[-1] >= n):
        raise ValueError(f"seed ids must be in [0, {n})")
    in_c = np.zeros(n, bool)
    in_c[seeds] = True
    frontier = seeds
    for _ in range(max(int(hops), 0)):
        if frontier.size == 0:
            break
        nbrs = csr_neighbors(indptr, indices, frontier)
        new = nbrs[~in_c[nbrs]]
        in_c[new] = True
        frontier = new
    return np.flatnonzero(in_c).astype(np.int64)


def out_closure(graph: Graph, seeds: np.ndarray, hops: int) -> np.ndarray:
    """Every node whose layer-(<= hops) representation can change when
    `seeds` change: the push-direction dual of serving's stale-closure
    pull walk. The graphs are undirected (a symmetric CSR), so both walk
    the same `hop_closure`."""
    return hop_closure(graph.indptr, graph.indices, seeds, hops)


# ---------------------------------------------------------------------------
# Seeded churn generator
# ---------------------------------------------------------------------------

def random_delta(graph: Graph, edge_churn: float = 0.01,
                 nodes_add: int = 0, new_degree: int = 3,
                 feat_frac: float = 0.0, feat_scale: float = 0.5,
                 seed: int = 0) -> GraphDelta:
    """A random `GraphDelta`: `edge_churn` of the undirected edges deleted
    and as many fresh non-edges inserted, `nodes_add` new nodes attached
    to `new_degree` random existing nodes each, and `feat_frac` of the
    nodes' features perturbed by Gaussian noise of scale `feat_scale`."""
    rng = np.random.default_rng(seed)
    n = graph.num_nodes
    dst, src = graph.coo()
    und = np.stack([dst, src], axis=1)[dst < src].astype(np.int64)
    k = int(round(edge_churn * len(und)))

    dels = (und[rng.choice(len(und), size=k, replace=False)]
            if k else _EMPTY_EDGES)
    existing = set(map(tuple, und))
    adds = []
    for _ in range(20 * k):
        if len(adds) >= k:
            break
        u, v = rng.integers(0, n, size=2)
        if u == v:
            continue
        key = (min(u, v), max(u, v))
        if key in existing:
            continue
        existing.add(key)
        adds.append(key)
    adds = np.asarray(adds, np.int64).reshape(-1, 2)

    x_new = y_new = None
    if nodes_add > 0:
        f = graph.x.shape[1]
        y_new = rng.integers(0, graph.num_classes,
                             size=nodes_add).astype(np.int32)
        x_new = rng.normal(0, 1.0, size=(nodes_add, f)).astype(np.float32)
        attach = []
        for i in range(nodes_add):
            nb = rng.choice(n, size=min(new_degree, n), replace=False)
            attach.append(np.stack(
                [np.full(len(nb), n + i, np.int64), nb.astype(np.int64)],
                axis=1))
        adds = np.concatenate([adds] + attach, axis=0)

    feat_nodes = feat_values = None
    m = int(round(feat_frac * n))
    if m > 0:
        feat_nodes = np.sort(rng.choice(n, size=m, replace=False))
        feat_values = (graph.x[feat_nodes] + feat_scale * rng.normal(
            0, 1.0, size=(m, graph.x.shape[1]))).astype(np.float32)

    return GraphDelta(edges_add=adds, edges_del=dels, x_new=x_new,
                      y_new=y_new, feat_nodes=feat_nodes,
                      feat_values=feat_values)
