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

`gather_rows_raw_many` replaces no Pallas kernel: the reference's
`HistoryStore.prefetch` (`src/repro/core/history.py:595-601`) takes every
layer's raw rows and scales under one index with `jnp.take`, which XLA is
free to fuse. Its kernel (`csrc/gather.cu`) moves the rows of up to
MAX_RAW_TABLES tables in one launch, each a device table or a pinned host
one (`history_storage="host"`) read through its unified address, so that
only the pulled rows cross the host link; the C entry plans each table's
unit width itself. Bound by bytes, M*R read (over the link for a host
table) plus M*R written, R the row's bytes summed over the tables.
`gather_rows_raw` is its one-table case.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence

import torch

from . import _build as B
from .ref import (gather_rows_dq_ref, gather_rows_raw_many_ref,
                  gather_rows_raw_ref, gather_rows_ref, gather_rows_vq_ref)

__all__ = ["gather_rows", "gather_rows_ref", "gather_rows_dq",
           "gather_rows_dq_ref", "gather_rows_vq", "gather_rows_vq_ref",
           "gather_rows_raw", "gather_rows_raw_ref", "gather_rows_raw_many",
           "gather_rows_raw_many_ref", "check_codebook", "MAX_RAW_TABLES"]

_ROW_COPY = {torch.float32: "gather_rows", torch.bfloat16: "gather_rows_bf16"}
# csrc/gather.cu: CTAs of 8 warps; a lane holds at most MAX_UNROLL units of
# its row at once
WARPS_PER_CTA, MAX_UNROLL = 8, 4
COPY_UNITS = (16, 8, 4, 2, 1)     # bytes
# the most tables one launch of the raw pull or push moves (csrc/common.cuh
# kRawMaxTables); a call over more is ceil(T / MAX_RAW_TABLES) launches
MAX_RAW_TABLES = 64


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


def raw_launches(n_tables: int) -> int:
    """The launches of a raw pull or push over `n_tables` tables that have
    bytes to move: one for every MAX_RAW_TABLES."""
    return -(-n_tables // MAX_RAW_TABLES)


def gather_rows_raw_many(tables: Sequence[torch.Tensor],
                         idx: torch.Tensor,
                         out: Optional[Sequence[torch.Tensor]] = None
                         ) -> List[torch.Tensor]:
    """[table[clip(idx, 0, N - 1)] for table in tables] on the card: the
    raw storage bits of the rows (f32, bf16, int8 or uint8 codes; a 1-d
    [N] scale table gives [M]), bitwise, each table on the card or
    pinned on the host, in one launch for up to MAX_RAW_TABLES tables;
    `idx` int32 [M] on the card, clipped in the kernel. Each output is
    contiguous (the outputs of tables of one type and row shape are views
    of one allocation, `raw_outputs`), or is the given `out` entry, a
    contiguous [M, ...] tensor of the table's type on idx's device, which
    the rows are written into. All-CPU operands run the plain version."""
    tables = list(tables)
    if out is not None:
        _check_raw_outputs(tables, idx, out)
    if idx.device.type == "cpu" and all(t.device.type == "cpu"
                                        for t in tables):
        got = gather_rows_raw_many_ref(tables, idx)
        if out is None:
            return got
        for o, r in zip(out, got):
            o.copy_(r)
        return list(out)
    name = "gather_rows_raw"
    dev = B.require_cuda(name, idx, pinned=tuple(tables))
    B.require_dtype(name, idx, torch.int32, "idx")
    if idx.dim() != 1 or any(t.dim() not in (1, 2) for t in tables):
        raise ValueError(f"{name}: tables [N] or [N, D] and idx [M], got "
                         f"{[tuple(t.shape) for t in tables]} and "
                         f"{tuple(idx.shape)}")
    m = idx.shape[0]
    if m and any(t.shape[0] == 0 for t in tables):
        raise ValueError(f"{name}: an empty table has no row to clip to")
    outs = raw_outputs(tables, m, dev) if out is None else list(out)
    live = [(t, o) for t, o in zip(tables, outs) if o.numel()]
    if live:
        B.check(B.lib().repro_gather_rows_raw_many(
            B.pointers([B.device_ptr(t) for t, _ in live]),
            B.pointers([o.data_ptr() for _, o in live]),
            B.int64s([t.shape[0] for t, _ in live]),
            B.int64s([row_bytes(t) for t, _ in live]),
            len(live), idx.data_ptr(), m, B.stream_ptr(dev)), name)
        B.launch_counts[name] += raw_launches(len(live))
    return outs


def _check_raw_outputs(tables: List[torch.Tensor], idx: torch.Tensor,
                       out: Sequence[torch.Tensor]) -> None:
    """The raw pull's given outputs: one a table, each contiguous, of the
    table's type and of its row shape under M = idx's length, on idx's
    device."""
    m = idx.shape[0]
    if len(out) != len(tables) or any(
            o.shape != (m,) + tuple(t.shape[1:]) or o.dtype != t.dtype
            or o.device != idx.device or not o.is_contiguous()
            for t, o in zip(tables, out)):
        raise ValueError(
            "gather_rows_raw: out must hold one contiguous tensor a table, "
            f"[{m}, ...] of its type on {idx.device}; got "
            f"{[(tuple(o.shape), o.dtype, str(o.device)) for o in out]} "
            f"for {[(tuple(t.shape), t.dtype) for t in tables]}")


def row_bytes(t: torch.Tensor) -> int:
    """The bytes of one row of a table [N] or [N, D] (from its shape)."""
    return math.prod(t.shape[1:]) * t.element_size()


def raw_outputs(tables: List[torch.Tensor], m: int,
                dev: torch.device) -> List[torch.Tensor]:
    """The raw pull's outputs, [m, ...] like each table: one allocation for
    the tables of each type and row shape, unbound into contiguous views,
    and a table unlike any other its own. On an H100 one allocation for
    GCNII-32L's 31 alike tables took 64-372 us less host time a prefetch
    than 31, while a 1- or 2-table prefetch took up to 27 us more through
    one block a group (PERF.md section 6, PR 32)."""
    groups = {}
    for i, t in enumerate(tables):
        groups.setdefault((t.dtype, tuple(t.shape[1:])), []).append(i)
    outs = [None] * len(tables)
    for (dtype, shape), members in groups.items():
        if len(members) == 1:
            outs[members[0]] = torch.empty((m,) + shape, dtype=dtype,
                                           device=dev)
            continue
        block = torch.empty((len(members), m) + shape, dtype=dtype,
                            device=dev)
        for i, o in zip(members, block.unbind(0)):
            outs[i] = o
    return outs


def gather_rows_raw(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out [M, ...] = table[clip(idx, 0, N-1)]: `gather_rows_raw_many` of
    one table (on the card or pinned on the host; a 1-d [N] scale table
    gives [M]); `idx` int32 [M] on the card. All-CPU operands run the
    plain version."""
    return gather_rows_raw_many([table], idx)[0]
