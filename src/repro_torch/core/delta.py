"""CSR closures (numpy), the part of `repro.core.delta` that serving uses:
`csr_neighbors` (the stale-closure walk steps through it), `hop_closure`
(the nodes a feature update can reach, which `serve.apply_feature_update`
invalidates) and `check_feature_update`, the validation the reference's
`GraphDelta.__post_init__` gives a feature update, with its messages. The
rest of the reference module (`GraphDelta`, `apply_delta`, `out_closure`,
`random_delta`: evolving graphs) is not ported yet (ROADMAP Queue A item
7)."""
from __future__ import annotations

from typing import Tuple

import numpy as np

_EMPTY = np.zeros(0, np.int64)


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
