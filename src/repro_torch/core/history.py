"""Historical embedding storage (the paper's central data structure), f32.

The port of `repro.core.history.HistoryStore` for f32 histories: one
[N+1, d] table per hidden layer holding each node's layer output from the
last time it was computed (the +1 row is a masked sentinel that padded
indices point at, and the push's sacrificial row), plus the staleness
clock `age` [N+1] int32.

The reference store is a frozen pytree whose methods return new stores,
and XLA performs its push in place only when the jitted step donates the
tables. Here the store is mutable: `push` scatters into the table tensor
itself and `tick` updates `age` in place, and both return the store for
chaining. bf16/int8/vq stores (ROADMAP Queue A, quantized histories) and
host-memory tables are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from repro_torch.kernels import ops
from .config import check_history_dtype, resolve_device


@dataclass
class HistoryStore:
    tables: List[torch.Tensor]
    age: torch.Tensor
    history_dtype: str = "f32"

    @classmethod
    def create(cls, num_nodes: int, dims: List[int],
               history_dtype: Optional[str] = None,
               device=None) -> "HistoryStore":
        """Zero tables and ages. `num_nodes` must include the sentinel row
        (pass N + 1). `device=None` means "cuda"."""
        hd = history_dtype or "f32"
        check_history_dtype(hd)
        dev = resolve_device(device)
        return cls(tables=[torch.zeros((num_nodes, d), dtype=torch.float32,
                                       device=dev) for d in dims],
                   age=torch.zeros((num_nodes,), dtype=torch.int32,
                                   device=dev),
                   history_dtype=hd)

    @property
    def device(self) -> torch.device:
        return self.age.device

    @property
    def num_layers(self) -> int:
        return len(self.tables)

    def pull(self, ell: int, idx: torch.Tensor) -> torch.Tensor:
        """Gather rows of H̄^(ell) (idx clipped to the table)."""
        return ops.pull_rows(self.tables[ell], idx)

    def push(self, ell: int, idx: torch.Tensor, values: torch.Tensor,
             mask: torch.Tensor) -> "HistoryStore":
        """Scatter fresh rows into H̄^(ell) in place where `mask`; masked
        rows go to the sentinel row."""
        ops.push_rows(self.tables[ell], idx, values, mask,
                      scratch_last_row=True)
        return self

    def tick(self, batch_idx: torch.Tensor,
             mask: torch.Tensor) -> "HistoryStore":
        """Advance the staleness clock in place: age += 1, just-pushed
        rows -> 0."""
        self.age += 1
        return self.reset_age(batch_idx, mask)

    def reset_age(self, idx: torch.Tensor,
                  mask: torch.Tensor) -> "HistoryStore":
        """In place: age[idx[i]] = 0 where mask[i] (masked entries are
        dropped). A mask over the clock, so no host sync."""
        n = self.age.shape[0]
        hit = torch.zeros((n + 1,), dtype=torch.bool, device=self.device)
        hit[torch.where(mask, idx.long(), n)] = True
        self.age.masked_fill_(hit[:n], 0)
        return self

    def bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tables)
