"""History pull (row gather): `gather_rows`, the dequantizing
`gather_rows_dq`, the decoding `gather_rows_vq`, and `gather_rows_raw`,
the raw storage rows a prefetch moves into a device mini-table.

Replaces `src/repro/kernels/gather.py:37 gather_rows` (f32 and bf16
tables), `gather.py:107 gather_rows_dq` (int8 tables with a per-row f32
scale) and `gather.py:189 gather_rows_vq` (vq code tables with a per-row
f32 scale and a codebook). On CUDA tensors each launches its kernel in
`csrc/gather.cu` (one warp per row, 16-byte lanes, ragged D masked in the
kernel; bound by bytes: M*D*E read plus M*D*E written for the row copy,
E = 4 or 2; M*D int8 bytes and 8*M of index and scale read plus M*D*4
written for the dequant; M*S code bytes, 8*M and the codebook read plus
M*S*8*4 written for the decode); on CPU tensors it runs the plain version
in `ref.py`.

`gather_rows_raw` replaces no Pallas kernel: the reference's
`HistoryStore.prefetch` (`src/repro/core/history.py:596-600`) takes its
raw rows and scales with `jnp.take`. Its kernel (`csrc/gather.cu`) reads
a device table or a pinned host one (`history_storage="host"`) through
its unified address, so that only the pulled rows cross the host link;
bound by bytes, M*R read (over the link for a host table) plus M*R
written, R the row's bytes.
"""
from __future__ import annotations

import torch

from . import _build as B
from .ref import (gather_rows_dq_ref, gather_rows_raw_ref, gather_rows_ref,
                  gather_rows_vq_ref)

__all__ = ["gather_rows", "gather_rows_ref", "gather_rows_dq",
           "gather_rows_dq_ref", "gather_rows_vq", "gather_rows_vq_ref",
           "gather_rows_raw", "gather_rows_raw_ref", "check_codebook"]

_ROW_COPY = {torch.float32: ("repro_gather_rows_f32", "gather_rows"),
             torch.bfloat16: ("repro_gather_rows_bf16", "gather_rows_bf16")}


def _check_shapes(name: str, table: torch.Tensor, idx: torch.Tensor) -> None:
    B.require_dtype(name, idx, torch.int32, "idx")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"{name}: table [N, D] and idx [M], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out [M, D] = table[idx], in the table's type (f32 or bf16); `idx`
    int32 [M], pre-clipped to [0, N)."""
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_ref(table, idx)
    if table.dtype not in _ROW_COPY:
        raise TypeError(f"gather_rows: table must be float32 or bfloat16, "
                        f"got {table.dtype}")
    symbol, name = _ROW_COPY[table.dtype]
    dev = B.require_cuda(name, table, idx)
    _check_shapes(name, table, idx)
    m, d = idx.shape[0], table.shape[1]
    out = torch.empty((m, d), dtype=table.dtype, device=dev)
    B.check(getattr(B.lib(), symbol)(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), m, d,
        B.stream_ptr(dev)), name)
    B.launch_counts[name] += 1
    return out


def gather_rows_dq(table: torch.Tensor, scales: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """out [M, D] f32 = float(table[idx]) * scales[idx][:, None]: the pull
    of an int8 table [N, D] with its f32 scale table [N]; `idx` int32
    [M], pre-clipped to [0, N)."""
    if all(t.device.type == "cpu" for t in (table, scales, idx)):
        return gather_rows_dq_ref(table, scales, idx)
    name = "gather_rows_dq"
    dev = B.require_cuda(name, table, scales, idx)
    B.require_dtype(name, table, torch.int8, "table")
    B.require_dtype(name, scales, torch.float32, "scales")
    _check_shapes(name, table, idx)
    if scales.shape != (table.shape[0],):
        raise ValueError(f"{name}: scales {tuple(scales.shape)} != "
                         f"{(table.shape[0],)}")
    m, d = idx.shape[0], table.shape[1]
    out = torch.empty((m, d), dtype=torch.float32, device=dev)
    B.check(B.lib().repro_gather_rows_dq(
        table.data_ptr(), scales.data_ptr(), idx.data_ptr(), out.data_ptr(),
        m, d, B.stream_ptr(dev)), name)
    B.launch_counts[name] += 1
    return out


def check_codebook(name: str, codebook: torch.Tensor, width: int) -> None:
    """A vq codebook as the kernels take it: f32 [S, 256, 8] for a code
    table of width S."""
    B.require_dtype(name, codebook, torch.float32, "codebook")
    if codebook.shape != (width, 256, 8):
        raise ValueError(f"{name}: codebook {tuple(codebook.shape)} != "
                         f"{(width, 256, 8)}")


def gather_rows_vq(table: torch.Tensor, codebook: torch.Tensor,
                   scales: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out [M, S*8] f32 = decode(table[idx], codebook) * scales[idx][:, None]:
    the pull of a vq table (uint8 codes [N, S]) with its codebook [S, 256,
    8] f32 and its f32 scale table [N]; `idx` int32 [M], pre-clipped to
    [0, N). Unpadded: exactly S*8 columns."""
    operands = (table, codebook, scales, idx)
    if all(t.device.type == "cpu" for t in operands):
        return gather_rows_vq_ref(table, codebook, scales, idx)
    name = "gather_rows_vq"
    dev = B.require_cuda(name, *operands)
    B.require_dtype(name, table, torch.uint8, "table")
    B.require_dtype(name, scales, torch.float32, "scales")
    _check_shapes(name, table, idx)
    n, s_n = table.shape
    check_codebook(name, codebook, s_n)
    if scales.shape != (n,):
        raise ValueError(f"{name}: scales {tuple(scales.shape)} != {(n,)}")
    m = idx.shape[0]
    out = torch.empty((m, s_n * 8), dtype=torch.float32, device=dev)
    B.check(B.lib().repro_gather_rows_vq(
        table.data_ptr(), codebook.data_ptr(), scales.data_ptr(),
        idx.data_ptr(), out.data_ptr(), m, s_n, codebook.shape[1],
        B.stream_ptr(dev)), name)
    B.launch_counts[name] += 1
    return out


def gather_rows_raw(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out [M, ...] = table[clip(idx, 0, N-1)] on the card: the raw
    storage bits of the rows (f32, bf16, int8 or uint8 codes; a 1-d [N]
    scale table gives [M]), bitwise, from a device table or from a pinned
    host one; `idx` int32 [M] on the card, clipped in the kernel. All-CPU
    operands run the plain version."""
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_raw_ref(table, idx)
    name = "gather_rows_raw"
    dev = B.require_cuda(name, idx, pinned=(table,))
    B.require_dtype(name, idx, torch.int32, "idx")
    if table.dim() not in (1, 2) or idx.dim() != 1:
        raise ValueError(f"{name}: table [N] or [N, D] and idx [M], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    m, n = idx.shape[0], table.shape[0]
    if n == 0 and m > 0:
        raise ValueError(f"{name}: an empty table has no row to clip to")
    out = torch.empty((m,) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=dev)
    if out.numel() == 0:
        return out
    row_bytes = table[0].numel() * table.element_size()
    B.check(B.lib().repro_gather_rows_raw(
        B.device_ptr(table), idx.data_ptr(), out.data_ptr(), m, n, row_bytes,
        B.stream_ptr(dev)), name)
    B.launch_counts[name] += 1
    return out
