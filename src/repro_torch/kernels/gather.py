"""History pull (row gather): `gather_rows`.

Replaces `src/repro/kernels/gather.py:37 gather_rows`. On CUDA tensors it
launches `csrc/gather.cu` (one warp per row, 16-byte lanes, ragged D
masked in the kernel; bound by bytes: M*D*4 read plus M*D*4 written); on
CPU tensors it runs the plain version `ref.gather_rows_ref`.
"""
from __future__ import annotations

import torch

from . import _build as B
from .ref import gather_rows_ref

__all__ = ["gather_rows", "gather_rows_ref"]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out [M, D] = table[idx]; `idx` int32 [M], pre-clipped to [0, N)."""
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_ref(table, idx)
    name = "gather_rows"
    dev = B.require_cuda(name, table, idx)
    B.require_dtype(name, table, torch.float32, "table")
    B.require_dtype(name, idx, torch.int32, "idx")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"{name}: table [N, D] and idx [M], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    m, d = idx.shape[0], table.shape[1]
    out = torch.empty((m, d), dtype=table.dtype, device=dev)
    B.check(B.lib().repro_gather_rows_f32(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), m, d,
        B.stream_ptr(dev)), name)
    B.launch_counts[name] += 1
    return out
