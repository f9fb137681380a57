"""Typed GAS batch structures: `GASBatch` + `BlockStructure`.

The port of `repro.core.batch`. Plain frozen dataclasses: the host side
(`core.gas.build_batches`, `core.gas.subgraph_batch`) fills them with
numpy arrays, and `.to(device)` returns a copy whose array fields are
torch tensors on that device. Index conventions are the reference's:
`batch_nodes`/`halo_nodes` are global ids padded with N, `edge_dst` is
local in [0, max_b) (pad -> trash row max_b), `edge_src` is local in
[0, max_b+max_h] (pad -> dummy zero row).

A batch is either stacked (from `build_batches`: every array field has a
leading `num_batches` axis) or single (`stacked[b]`, or `subgraph_batch`);
the pads and counts describe the per-batch shapes either way. The
reference registers both classes as JAX pytrees so that `jax.lax.scan`
can walk a stack; the port indexes the stack in a Python loop.

Block families (each a `BlockStructure` of dense `vals` [..., R, K, bn,
bn] at column blocks `cols` [..., R, K]; padding slots are all-zero
blocks at column 0):

  * ``forward``          — GCN-normalized local adjacency
                           [max_b, max_b+max_h+1]
  * ``transposed``       — its transpose, which the backward reads
  * ``unit``             — unit-weight (edge-multiplicity) values for the
                           ops that never read the normalized weights
                           (GIN, GAT, PNA)
  * ``unit_transposed``  — its transpose
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _to(a, device: torch.device):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclass(frozen=True)
class BlockStructure:
    """One BCSR family: dense `vals` [..., R, K, bn, bn] at column blocks
    `cols` [..., R, K]."""
    vals: Any
    cols: Any

    def to(self, device) -> "BlockStructure":
        return BlockStructure(_to(self.vals, device), _to(self.cols, device))

    def __getitem__(self, b) -> "BlockStructure":
        return BlockStructure(self.vals[b], self.cols[b])


_BLOCK_FIELDS = ("forward", "transposed", "unit", "unit_transposed")


@dataclass(frozen=True)
class GASBatch:
    """One padded GAS batch, or the stack of a partition's batches."""
    batch_nodes: Any             # [*, max_b] int32, padded with N
    batch_mask: Any              # [*, max_b] bool
    halo_nodes: Any              # [*, max_h] int32, padded with N
    halo_mask: Any               # [*, max_h] bool
    edge_dst: Any                # [*, max_e] int32
    edge_src: Any                # [*, max_e] int32
    edge_w: Any                  # [*, max_e] float32, 0 for padding
    forward: Optional[BlockStructure] = None
    transposed: Optional[BlockStructure] = None
    unit: Optional[BlockStructure] = None
    unit_transposed: Optional[BlockStructure] = None
    num_batches: int = 1
    max_b: int = 0
    max_h: int = 0
    max_e: int = 0
    bn: int = 128

    @property
    def blocks(self) -> Optional[Tuple]:
        """Weighted-SpMM blocks for `kernels.ops`: (vals, cols[, vals_t,
        cols_t]); the transposed pair is what the backward reads."""
        if self.forward is None:
            return None
        out = (self.forward.vals, self.forward.cols)
        if self.transposed is not None:
            out += (self.transposed.vals, self.transposed.cols)
        return out

    @property
    def ublocks(self) -> Optional[Tuple]:
        """Unit-weight (multiplicity) blocks for the GIN, GAT and PNA
        kernels: (uvals, cols[, uvals_t, cols_t]); the transposed pair is
        what the backward reads, and a forward-only serve batch
        (`core.gas.subgraph_batch(transposed=False)`) carries none."""
        if self.unit is None:
            return None
        out = (self.unit.vals, self.unit.cols)
        if self.unit_transposed is not None:
            out += (self.unit_transposed.vals, self.unit_transposed.cols)
        return out

    def __getitem__(self, b) -> "GASBatch":
        """Slice one batch (or a range) off the leading axis of every array
        field; an integer index also sets `num_batches` to 1. On torch
        fields the slices are views, so no block is copied."""
        kw = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if f.name in _BLOCK_FIELDS or isinstance(
                    v, (np.ndarray, torch.Tensor)):
                kw[f.name] = v[b]
        if isinstance(b, (int, np.integer)):
            kw["num_batches"] = 1
        return replace(self, **kw)

    def to(self, device) -> "GASBatch":
        """A copy whose array fields are torch tensors on `device`."""
        return self.map_arrays(lambda a: _to(a, device))

    def replace(self, **kw) -> "GASBatch":
        return replace(self, **kw)

    def map_arrays(self, fn) -> "GASBatch":
        """A batch whose every array (the block families' `vals` and
        `cols` included) is `fn` of this batch's."""
        kw = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if f.name in _BLOCK_FIELDS:
                kw[f.name] = None if v is None else BlockStructure(
                    fn(v.vals), fn(v.cols))
            elif isinstance(v, (np.ndarray, torch.Tensor)):
                kw[f.name] = fn(v)
        return replace(self, **kw)

    def arrays(self) -> List[Any]:
        """Every array, in the order `map_arrays` visits them."""
        out = []
        self.map_arrays(out.append)
        return out
