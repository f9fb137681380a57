"""CSR neighbor expansion (numpy), the port of `repro.core.delta`'s
`csr_neighbors`: serving's stale-closure walk steps through it. The rest
of the reference module (graph deltas, evolving graphs) is not ported
yet (ROADMAP Queue A)."""
from __future__ import annotations

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
