"""Synthetic graph generators (numpy only; no dataset downloads).

A copy of `repro.data.graphs` for the PyTorch port, which imports nothing
of the JAX package: the same numpy RNG stream, so the arrays are bitwise
equal to the reference's for the same arguments (tests/test_torch_host.py).

Two families matched to the paper's benchmarks:
  - `citation_graph`: Cora/PubMed-like homophilous graph — features are
    class-conditional Gaussians, edges prefer same-class endpoints,
    planetoid-style small train split.
  - `sbm_cluster_graph`: the CLUSTER task (Dwivedi et al., 2020) — stochastic
    block model; node features are uninformative except one randomly *seeded*
    node per community that reveals its label, so solving the task REQUIRES
    multi-hop message passing (this is the expressiveness testbed).

Graphs are undirected, stored as numpy CSR; GNN code consumes COO.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class Graph:
    indptr: np.ndarray           # [N+1] int32 CSR
    indices: np.ndarray          # [E] int32 (destination-major neighbor lists)
    x: np.ndarray                # [N, F] float32 node features
    y: np.ndarray                # [N] int32 labels
    train_mask: np.ndarray       # [N] bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def coo(self) -> Tuple[np.ndarray, np.ndarray]:
        """(dst, src) arrays; CSR row = destination node."""
        dst = np.repeat(np.arange(self.num_nodes, dtype=np.int32),
                        self.degrees().astype(np.int64))
        return dst, self.indices


def _to_csr(n: int, edges: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """edges: [E,2] (u,v) directed pairs -> CSR by destination."""
    dst = edges[:, 0]
    order = np.argsort(dst, kind="stable")
    dst, src = dst[order], edges[order, 1]
    counts = np.bincount(dst, minlength=n)
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(counts, out=indptr[1:])
    return indptr.astype(np.int32), src.astype(np.int32)


def _symmetrize(edges: np.ndarray) -> np.ndarray:
    both = np.concatenate([edges, edges[:, ::-1]], axis=0)
    both = np.unique(both, axis=0)
    both = both[both[:, 0] != both[:, 1]]
    return both


def _splits(rng, n, y, num_classes, train_per_class=20, val_frac=0.15):
    train_mask = np.zeros(n, bool)
    for c in range(num_classes):
        idx = np.flatnonzero(y == c)
        take = min(train_per_class, max(1, len(idx) // 10))
        train_mask[rng.choice(idx, size=take, replace=False)] = True
    rest = np.flatnonzero(~train_mask)
    rng.shuffle(rest)
    n_val = int(val_frac * n)
    val_mask = np.zeros(n, bool)
    val_mask[rest[:n_val]] = True
    test_mask = np.zeros(n, bool)
    test_mask[rest[n_val:]] = True
    return train_mask, val_mask, test_mask


def citation_graph(num_nodes: int = 2708, avg_degree: float = 4.0,
                   num_features: int = 128, num_classes: int = 7,
                   homophily: float = 0.83, feature_noise: float = 1.0,
                   seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    n = num_nodes
    y = rng.integers(0, num_classes, size=n).astype(np.int32)

    # class-conditional features
    means = rng.normal(0, 1.0, size=(num_classes, num_features))
    x = (means[y] + feature_noise * rng.normal(0, 1.0, size=(n, num_features))
         ).astype(np.float32)

    # preferential same-class wiring
    m = int(n * avg_degree / 2)
    by_class = [np.flatnonzero(y == c) for c in range(num_classes)]
    u = rng.integers(0, n, size=m)
    same = rng.random(m) < homophily
    v = np.empty(m, np.int64)
    for i in range(m):
        v[i] = rng.choice(by_class[y[u[i]]]) if same[i] else rng.integers(0, n)
    edges = _symmetrize(np.stack([u, v], axis=1))
    indptr, indices = _to_csr(n, edges)

    tm, vm, sm = _splits(rng, n, y, num_classes)
    return Graph(indptr, indices, x, y, tm, vm, sm, num_classes)


def sbm_cluster_graph(num_nodes: int = 1200, num_communities: int = 6,
                      p_intra: float = 0.05, p_inter: float = 0.0025,
                      num_seeds_per_class: int = 1, seed: int = 0) -> Graph:
    """CLUSTER-style SBM. Features: one-hot of revealed label for seed nodes,
    zeros elsewhere (+1 indicator channel for 'is seed')."""
    rng = np.random.default_rng(seed)
    n, k = num_nodes, num_communities
    y = rng.integers(0, k, size=n).astype(np.int32)

    # block-model edges (vectorized sparse sampling)
    blocks = [np.flatnonzero(y == c) for c in range(k)]
    edge_list = []
    for a in range(k):
        for b in range(a, k):
            p = p_intra if a == b else p_inter
            na, nb = len(blocks[a]), len(blocks[b])
            cnt = rng.binomial(na * nb if a != b else na * (na - 1) // 2, p)
            if cnt == 0:
                continue
            uu = rng.choice(blocks[a], size=cnt)
            vv = rng.choice(blocks[b], size=cnt)
            edge_list.append(np.stack([uu, vv], axis=1))
    edges = _symmetrize(np.concatenate(edge_list, axis=0))
    indptr, indices = _to_csr(n, edges)

    x = np.zeros((n, k + 1), np.float32)
    for c in range(k):
        idx = rng.choice(blocks[c], size=min(num_seeds_per_class, len(blocks[c])),
                         replace=False)
        x[idx, c] = 1.0
        x[idx, k] = 1.0

    # transductive: every non-seed node is labeled; split train/val/test
    tm = np.zeros(n, bool)
    rest = rng.permutation(n)
    tm[rest[: int(0.6 * n)]] = True
    vm = np.zeros(n, bool)
    vm[rest[int(0.6 * n): int(0.8 * n)]] = True
    sm = ~(tm | vm)
    return Graph(indptr, indices, x, y, tm, vm, sm, k)

