"""Typed GAS batch structures: `GASBatch` + `BlockStructure`.

The port of `repro.core.batch`. Plain frozen dataclasses: the host side
(`core.gas.subgraph_batch`) fills them with numpy arrays, and `.to(device)`
returns a copy whose array fields are torch tensors on that device. Index
conventions are the reference's: `batch_nodes`/`halo_nodes` are global ids
padded with N, `edge_dst` is local in [0, max_b) (pad -> trash row max_b),
`edge_src` is local in [0, max_b+max_h] (pad -> dummy zero row).

Block families (each a `BlockStructure` of dense `vals` [R, K, bn, bn] at
column blocks `cols` [R, K]; padding slots are all-zero blocks at column
0): `forward` holds the GCN-normalized local adjacency
[max_b, max_b+max_h+1]; `transposed` holds its transpose, which the
backward of the training slice reads.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Any, Optional, Tuple

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
    """One BCSR family: dense `vals` [R, K, bn, bn] at column blocks
    `cols` [R, K]."""
    vals: Any
    cols: Any

    def to(self, device) -> "BlockStructure":
        return BlockStructure(_to(self.vals, device), _to(self.cols, device))


_BLOCK_FIELDS = ("forward", "transposed")


@dataclass(frozen=True)
class GASBatch:
    """One padded GAS batch (the single-batch form of the reference's
    `GASBatch`; the port has no stacked form yet)."""
    batch_nodes: Any             # [max_b] int32, padded with N
    batch_mask: Any              # [max_b] bool
    halo_nodes: Any              # [max_h] int32, padded with N
    halo_mask: Any               # [max_h] bool
    edge_dst: Any                # [max_e] int32
    edge_src: Any                # [max_e] int32
    edge_w: Any                  # [max_e] float32, 0 for padding
    forward: Optional[BlockStructure] = None
    transposed: Optional[BlockStructure] = None
    max_b: int = 0
    max_h: int = 0
    max_e: int = 0
    bn: int = 128

    @property
    def blocks(self) -> Optional[Tuple]:
        """(vals, cols) of the forward family, or None."""
        if self.forward is None:
            return None
        return (self.forward.vals, self.forward.cols)

    def to(self, device) -> "GASBatch":
        """A copy whose array fields are torch tensors on `device`."""
        kw = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if f.name in _BLOCK_FIELDS:
                kw[f.name] = None if v is None else v.to(device)
            elif isinstance(v, (np.ndarray, torch.Tensor)):
                kw[f.name] = _to(v, device)
        return replace(self, **kw)

    def replace(self, **kw) -> "GASBatch":
        return replace(self, **kw)
