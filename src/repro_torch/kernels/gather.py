"""History pull (row gather): `gather_rows`, the dequantizing
`gather_rows_dq`, the decoding `gather_rows_vq`, and `gather_rows_raw`,
the raw storage rows a prefetch moves into a device mini-table.

Replaces `src/repro/kernels/gather.py:37 gather_rows` (f32 and bf16
tables), `gather.py:107 gather_rows_dq` (int8 tables with a per-row f32
scale) and `gather.py:189 gather_rows_vq` (vq code tables with a per-row
f32 scale and a codebook). On CUDA tensors each launches its kernel in
`csrc/gather.cu` (bound by bytes: M*D*E read plus M*D*E written for the
row copy, E = 4 or 2; M*D int8 bytes and 8*M of index and scale read plus
M*D*4 written for the dequant; M*S code bytes, 8*M and the codebook read
plus M*S*8*4 written for the decode); on CPU tensors it runs the plain
version in `ref.py`. The row copy, the dequant and the decode launch on a
plan that is a pure function of the shape and the buffers' alignment
(`row_plan`, `dq_plan`, `vq_plan`: units as wide as the row and the
buffers allow, float4 for the decode, rows narrower than 32 units sharing
a warp, up to 4 units a lane in flight). Each kernel clips its row's
index to [0, N - 1], as the reference's `pull_rows` clips it, so a pull
is one launch.

`gather_rows_raw` replaces no Pallas kernel: the reference's
`HistoryStore.prefetch` (`src/repro/core/history.py:596-600`) takes its
raw rows and scales with `jnp.take`. Its kernel (`csrc/gather.cu`) reads
a device table or a pinned host one (`history_storage="host"`) through
its unified address, so that only the pulled rows cross the host link;
bound by bytes, M*R read (over the link for a host table) plus M*R
written, R the row's bytes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build as B
from .ref import (gather_rows_dq_ref, gather_rows_raw_ref, gather_rows_ref,
                  gather_rows_vq_ref)

__all__ = ["gather_rows", "gather_rows_ref", "gather_rows_dq",
           "gather_rows_dq_ref", "gather_rows_vq", "gather_rows_vq_ref",
           "gather_rows_raw", "gather_rows_raw_ref", "check_codebook"]

_ROW_COPY = {torch.float32: "gather_rows", torch.bfloat16: "gather_rows_bf16"}
# csrc/gather.cu: CTAs of 8 warps; a lane holds at most MAX_UNROLL units of
# its row at once
WARPS_PER_CTA, MAX_UNROLL = 8, 4
COPY_UNITS = (16, 8, 4, 2, 1)     # bytes


class RowPlan(NamedTuple):
    """One launch of the row copy, the dequant or the decode
    (csrc/gather.cu): a row cut into `unit`-byte units (the dequant:
    `unit` codes; the decode: float4 halves of subvectors), 2**shift lanes
    a row and so 32 >> shift rows a warp, `unroll` units a lane loaded
    before any is stored, and `ctas` CTAs, a warp for each row group."""
    unit: int
    shift: int
    unroll: int
    ctas: int


def _plan(m: int, unit: int, n_units: int) -> RowPlan:
    """The least power of two of lanes that covers a row's `n_units`
    units, at most 32; 1, 2 or 4 units a lane a pass (4 where a lane has
    more, in several passes); a warp for each group of 32 >> shift
    rows."""
    shift = min(5, max(n_units - 1, 0).bit_length())
    per_lane = max(1, -(-n_units // (1 << shift)))
    unroll = min(MAX_UNROLL, 1 << (per_lane - 1).bit_length())
    groups = -(-m // (32 >> shift))
    return RowPlan(unit, shift, unroll, max(1, -(-groups // WARPS_PER_CTA)))


def row_plan(m: int, row_bytes: int, align: int) -> RowPlan:
    """The row copy's plan for `m` rows of `row_bytes` bytes. `align` is
    the OR of the buffers' addresses: the unit is the widest of
    COPY_UNITS that divides it and the row. A D = 500 f32 row (125 units
    of 16 bytes) takes a warp and 4 units a lane, so 4,096 rows are 512
    CTAs; a d = 64 bf16 row (8 units) takes 8 lanes, 4 rows a warp."""
    unit = next(u for u in COPY_UNITS if (align | row_bytes) % u == 0)
    return _plan(m, unit, row_bytes // unit)


def dq_plan(m: int, d: int, q_addr: int, out_addr: int) -> RowPlan:
    """The dequant's plan for `m` rows of `d` codes: 4 codes a unit (one
    char4 load, one float4 store) where D and the code table's address
    are multiples of 4 and the output is 16-byte aligned, else one code.
    A d = 64 row (16 units) takes 16 lanes, 2 rows a warp."""
    unit = 4 if (q_addr | d) % 4 == 0 and out_addr % 16 == 0 else 1
    return _plan(m, unit, d // unit)


def vq_plan(m: int, s_n: int) -> RowPlan:
    """The decode's plan for `m` rows of `s_n` codes: 2 * s_n units of 16
    bytes (one float4 half of a decoded subvector each). GAT's pull (S =
    8, 16 units) takes 16 lanes a row, 2 rows a warp; the refresh batch's
    (S = 32) a warp a row, 2 units a lane."""
    return _plan(m, 16, 2 * s_n)


def _check_shapes(name: str, table: torch.Tensor, idx: torch.Tensor) -> None:
    B.require_dtype(name, idx, torch.int32, "idx")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"{name}: table [N, D] and idx [M], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")


def _row_copy(name: str, table: torch.Tensor, idx: torch.Tensor,
              out: torch.Tensor) -> torch.Tensor:
    """out [M, D] = table[idx] by the row copy's kernel on its plan, the
    operands checked by the caller; `out` may be any contiguous buffer."""
    m, row_bytes = idx.shape[0], table.shape[1] * table.element_size()
    plan = row_plan(m, row_bytes, table.data_ptr() | out.data_ptr())
    B.check(B.lib().repro_gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), m, table.shape[0],
        row_bytes, *plan, B.stream_ptr(out.device)), name)
    B.launch_counts[name] += 1
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out [M, D] = table[clip(idx, 0, N - 1)], in the table's type (f32
    or bf16); `idx` int32 [M], clipped in the kernel."""
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_ref(table, idx)
    if table.dtype not in _ROW_COPY:
        raise TypeError(f"gather_rows: table must be float32 or bfloat16, "
                        f"got {table.dtype}")
    name = _ROW_COPY[table.dtype]
    dev = B.require_cuda(name, table, idx)
    _check_shapes(name, table, idx)
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype,
                      device=dev)
    return _row_copy(name, table, idx, out)


def _dequant(table: torch.Tensor, scales: torch.Tensor, idx: torch.Tensor,
             out: torch.Tensor) -> torch.Tensor:
    """out [M, D] = float(table[idx]) * scales[idx][:, None] by the
    dequant's kernel on its plan, the operands checked by the caller;
    `out` may be any contiguous f32 buffer."""
    (n, d), m = table.shape, idx.shape[0]
    plan = dq_plan(m, d, table.data_ptr(), out.data_ptr())
    B.check(B.lib().repro_gather_rows_dq(
        table.data_ptr(), scales.data_ptr(), idx.data_ptr(), out.data_ptr(),
        m, n, d, *plan, B.stream_ptr(out.device)), "gather_rows_dq")
    B.launch_counts["gather_rows_dq"] += 1
    return out


def gather_rows_dq(table: torch.Tensor, scales: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """out [M, D] f32 = float(table[t]) * scales[t][:, None], t =
    clip(idx, 0, N - 1): the pull of an int8 table [N, D] with its f32
    scale table [N]; `idx` int32 [M], clipped in the kernel."""
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
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=torch.float32,
                      device=dev)
    return _dequant(table, scales, idx, out)


def check_codebook(name: str, codebook: torch.Tensor, width: int) -> None:
    """A vq codebook as the kernels take it: f32 [S, 256, 8] for a code
    table of width S."""
    B.require_dtype(name, codebook, torch.float32, "codebook")
    if codebook.shape != (width, 256, 8):
        raise ValueError(f"{name}: codebook {tuple(codebook.shape)} != "
                         f"{(width, 256, 8)}")


def gather_rows_vq(table: torch.Tensor, codebook: torch.Tensor,
                   scales: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out [M, S*8] f32 = decode(table[t], codebook) * scales[t][:, None],
    t = clip(idx, 0, N - 1): the pull of a vq table (uint8 codes [N, S])
    with its codebook [S, 256, 8] f32 and its f32 scale table [N]; `idx`
    int32 [M], clipped in the kernel. Unpadded: exactly S*8 columns."""
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
    out = torch.empty((idx.shape[0], s_n * 8), dtype=torch.float32,
                      device=dev)
    return _decode(table, codebook, scales, idx, out)


def _decode(table: torch.Tensor, codebook: torch.Tensor,
            scales: torch.Tensor, idx: torch.Tensor,
            out: torch.Tensor) -> torch.Tensor:
    """out [M, S*8] = the decoding pull by its kernel on `vq_plan`, the
    operands checked by the caller; `out` may be any contiguous f32
    buffer (the kernel refuses one that is not 16-byte aligned)."""
    (n, s_n), m = table.shape, idx.shape[0]
    _, shift, unroll, ctas = vq_plan(m, s_n)
    B.check(B.lib().repro_gather_rows_vq(
        table.data_ptr(), codebook.data_ptr(), scales.data_ptr(),
        idx.data_ptr(), out.data_ptr(), m, n, s_n, codebook.shape[1], shift,
        unroll, ctas, B.stream_ptr(out.device)), "gather_rows_vq")
    B.launch_counts["gather_rows_vq"] += 1
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
