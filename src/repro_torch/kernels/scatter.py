"""History push (row scatter): `scatter_rows`, in place.

Replaces `src/repro/kernels/scatter.py:39 scatter_rows`. The reference
aliases the table into the Pallas output, and with a donated buffer XLA
performs the push in place; here the push writes into the table tensor
itself. On CUDA tensors it launches `csrc/scatter.cu` (a per-target
winner pass so that duplicate indices resolve to the last writer, then a
row copy; bound by bytes: M*D*4 read plus M*D*4 written); on CPU tensors
it runs the plain version `ref.scatter_rows_ref`.
"""
from __future__ import annotations

import torch

from . import _build as B
from .ref import scatter_rows_ref

__all__ = ["scatter_rows", "scatter_rows_ref"]


def scatter_rows(table: torch.Tensor, idx: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """In place: table[idx[i]] = values[i] for idx[i] in [0, N); other
    rows are dropped; duplicates resolve to the last occurrence. Returns
    `table`."""
    if all(t.device.type == "cpu" for t in (table, idx, values)):
        return scatter_rows_ref(table, idx, values)
    name = "scatter_rows"
    dev = B.require_cuda(name, table, idx, values)
    B.require_dtype(name, table, torch.float32, "table")
    B.require_dtype(name, values, torch.float32, "values")
    B.require_dtype(name, idx, torch.int32, "idx")
    n, d = table.shape
    m = idx.shape[0]
    if values.shape != (m, d):
        raise ValueError(f"{name}: values {tuple(values.shape)} != {(m, d)}")
    if m >= 2 ** 31:
        raise ValueError(f"{name}: {m} rows exceed the int32 winner pass")
    winner = torch.empty((n,), dtype=torch.int32, device=dev)
    B.check(B.lib().repro_scatter_rows_f32(
        table.data_ptr(), idx.data_ptr(), values.data_ptr(),
        winner.data_ptr(), m, n, d, B.stream_ptr(dev)), name)
    B.launch_counts[name] += 1
    return table
