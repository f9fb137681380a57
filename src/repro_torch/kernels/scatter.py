"""History push (row scatter), in place: `scatter_rows`, the
quantizing `scatter_rows_q`, the encoding `scatter_rows_vq`, and
`scatter_rows_raw`, the push of rows already in storage precision.

Replaces `src/repro/kernels/scatter.py:39 scatter_rows` (f32 and bf16
tables), `scatter.py:85 scatter_rows_q` (int8 tables with a per-row f32
scale) and `scatter.py:141 scatter_rows_vq` (vq code tables with a
per-row f32 scale and a codebook). The reference aliases the table into the Pallas output, and
with a donated buffer XLA performs the push in place; here the push
writes into the table tensor itself. On CUDA tensors each launches its
kernel in `csrc/scatter.cu` (duplicate indices resolve to the last
writer: for a push of at most SCAN_MAX_ROWS rows, one kernel that scans
the later indices, so only each target's last row writes it; otherwise
per-target winner passes first. Then a row copy; for int8 a row max, divide, round and clip, and each pushed row's
relative error; for vq a row max, divide and a first-minimum scan of the
codebook per (row, subvector), split over 8 lanes where the push is
small (`scatter_rows_vq_plan`). Bound by bytes: M*D*E read plus M*D*E
written for the copy, E = 4 or 2; M*D*4 read plus M*D + 8*M written for
the quantizing push; the encoding push's nearest-entry search, 24 f32
operations per value and codebook entry, bounds it by operations). On
CPU tensors it runs the plain version in `ref.py`. The table and its
scale table may also be pinned host tensors (`history_storage="host"`):
the kernels write their rows through the buffers' unified addresses,
and their only atomics target the device winner scratch and shared
memory, never the table.

`scatter_rows_raw_many` replaces no Pallas kernel: the reference's
serving backend lands a frontend's encoded rows with `.at[].set`
(`src/repro/core/serve_service.py:255-298`). It is the mirror of
`gather_rows_raw_many`: the rows of up to MAX_RAW_TABLES tables under one
index (every layer's table and scale table of a push) copied bit for bit
in one launch into device tables or pinned host ones (through their
unified addresses, on the current stream, so after the refresh kernels
queued before it and with no host sync), last writer winning. The last
writer of each target is decided once, by `scatter_rows`' one-launch scan
(or its claim passes past SCAN_MAX_ROWS), and applied to every table, so
a target's codes and its scale come from the same pushed row; each
table's rows move in the widest unit, 16, 8, 4, 2 or 1 bytes, its row and
both buffers allow (csrc/scatter.cu). Bound by bytes: M*R read plus M*R
written, R the row's bytes summed over the tables, and 4*M of index; over
the host link for a pinned table. `scatter_rows_raw` is its one-table
case.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import _build as B
from .decode_attn import _sm_count
from .gather import check_codebook, raw_launches, row_bytes
from .ref import (scatter_rows_q_ref, scatter_rows_raw_many_ref,
                  scatter_rows_raw_ref, scatter_rows_ref, scatter_rows_vq_ref)

__all__ = ["scatter_rows", "scatter_rows_ref", "scatter_rows_q",
           "scatter_rows_q_ref", "scatter_rows_vq", "scatter_rows_vq_ref",
           "scatter_rows_raw", "scatter_rows_raw_ref",
           "scatter_rows_raw_many", "scatter_rows_raw_many_ref",
           "scatter_rows_vq_plan", "SCAN_MAX_ROWS"]

_ROW_COPY = {torch.float32: ("repro_scatter_rows_f32", "scatter_rows"),
             torch.bfloat16: ("repro_scatter_rows_bf16", "scatter_rows_bf16")}
# the most rows `scatter_rows` resolves inside its one copy kernel (the
# scan compares every later pair of rows, up to M^2 / 2; the serving
# refresh push has 4,096); a larger push runs the claim passes over an
# N-entry winner scratch first, three kernels (csrc/scatter.cu: kScanMax);
# `scatter_rows_q` and `scatter_rows_vq` take the same limit
SCAN_MAX_ROWS = 4096
# the encoding push's launch (csrc/scatter.cu): codebook entries per
# subvector (kCodes), the most warps a CTA takes, one subvector each at a
# time (kVqMaxWarps), the lanes a (row, subvector) pair may be split over,
# and the most lanes per SM a split push may take (VQ_SPLIT_FILL)
VQ_CODES, VQ_MAX_WARPS, VQ_LANES, VQ_SPLIT_FILL = 256, 16, (1, 8), 512


def scatter_rows_vq_plan(m: int, s_n: int, n_sm: int):
    """(lanes, warps, ctas) of the encoding push's one launch on a card of
    `n_sm` SMs. `warps` per CTA, warp w taking subvectors w, w + warps,
    ...; `lanes` per (pushed row, subvector) pair, lane k scanning the
    entries [k * 256 / lanes, (k + 1) * 256 / lanes) in increasing order:
    8 where the split push takes at most VQ_SPLIT_FILL lanes per SM, else
    1 (on an H100, 8 lanes beat 1 up to 1,024 rows of 8 subvectors and
    lose from 2,501; 2 and 4 lanes lost to one of them at every push of
    the main path: PERF.md, `chip_smoke.py --vq-ablation`); `ctas`, each
    32 / lanes consecutive rows (the launcher's grid). The serving refresh
    push (4,096 x 32 on 132 SMs) takes 1 lane and 128 CTAs of 16 warps,
    one per SM; a training push (194 x 8) 8 lanes and 49 CTAs; the GCN
    refit push (2,501 x 8) 1 lane."""
    warps = max(1, min(s_n, VQ_MAX_WARPS))
    split = VQ_LANES[-1]
    lanes = split if m * split * warps <= n_sm * VQ_SPLIT_FILL else 1
    return lanes, warps, -(-m * lanes // 32)


def _winner(m: int, n: int, dev: torch.device) -> Optional[torch.Tensor]:
    """The claim passes' N-entry winner scratch for a push of more than
    SCAN_MAX_ROWS rows; None (the one-launch scan) for a smaller one."""
    if m <= SCAN_MAX_ROWS:
        return None
    return torch.empty((n,), dtype=torch.int32, device=dev)


def _check_push(name: str, table: torch.Tensor, idx: torch.Tensor,
                values: torch.Tensor, d: Optional[int] = None) -> None:
    B.require_dtype(name, idx, torch.int32, "idx")
    m, d = idx.shape[0], table.shape[1] if d is None else d
    if values.shape != (m, d):
        raise ValueError(f"{name}: values {tuple(values.shape)} != {(m, d)}")
    if m >= 2 ** 31:
        raise ValueError(f"{name}: {m} rows exceed the int32 winner pass")


def scatter_rows(table: torch.Tensor, idx: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """In place: table[idx[i]] = values[i] for idx[i] in [0, N); other
    rows are dropped; duplicates resolve to the last occurrence. `values`
    has the table's type (f32 or bf16). Returns `table`."""
    if all(t.device.type == "cpu" for t in (table, idx, values)):
        return scatter_rows_ref(table, idx, values)
    if table.dtype not in _ROW_COPY:
        raise TypeError(f"scatter_rows: table must be float32 or bfloat16, "
                        f"got {table.dtype}")
    symbol, name = _ROW_COPY[table.dtype]
    dev = B.require_cuda(name, idx, values, pinned=(table,))
    B.require_dtype(name, values, table.dtype, "values")
    _check_push(name, table, idx, values)
    n, d = table.shape
    m = idx.shape[0]
    winner = _winner(m, n, dev)
    B.check(getattr(B.lib(), symbol)(
        B.device_ptr(table), idx.data_ptr(), values.data_ptr(),
        None if winner is None else winner.data_ptr(), m, n, d,
        B.stream_ptr(dev)), name)
    B.launch_counts[name] += 1
    return table


def scatter_rows_q(table: torch.Tensor, scales: torch.Tensor,
                   idx: torch.Tensor, values: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """In place: for idx[i] in [0, N), table[idx[i]] (int8 [N, D]) takes
    the codes of f32 row values[i] and scales[idx[i]] (f32 [N]) its scale
    (`ref.quantize_rows`); other rows are dropped; duplicates resolve to
    the last occurrence, codes and scale alike. Returns (table, scales,
    err): err [M] f32 is every pushed row's relative error
    (`ref.relative_row_error`), dropped rows included."""
    if all(t.device.type == "cpu" for t in (table, scales, idx, values)):
        return scatter_rows_q_ref(table, scales, idx, values)
    name = "scatter_rows_q"
    dev = B.require_cuda(name, idx, values, pinned=(table, scales))
    B.require_dtype(name, table, torch.int8, "table")
    B.require_dtype(name, scales, torch.float32, "scales")
    B.require_dtype(name, values, torch.float32, "values")
    _check_push(name, table, idx, values)
    n, d = table.shape
    if scales.shape != (n,):
        raise ValueError(f"{name}: scales {tuple(scales.shape)} != {(n,)}")
    m = idx.shape[0]
    winner = _winner(m, n, dev)
    err = torch.empty((m,), dtype=torch.float32, device=dev)
    B.check(B.lib().repro_scatter_rows_q(
        B.device_ptr(table), B.device_ptr(scales), err.data_ptr(),
        idx.data_ptr(),
        values.data_ptr(), None if winner is None else winner.data_ptr(), m,
        n, d, B.stream_ptr(dev)), name)
    B.launch_counts[name] += 1
    return table, scales, err


def scatter_rows_vq(table: torch.Tensor, scales: torch.Tensor,
                    idx: torch.Tensor, values: torch.Tensor,
                    codebook: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """In place: for idx[i] in [0, N), table[idx[i]] (uint8 codes [N, S])
    takes the codes of f32 row values[i] [S*8] against `codebook` [S, 256,
    8] and scales[idx[i]] (f32 [N]) its scale (`ref.vq_encode_rows`);
    other rows are dropped; duplicates resolve to the last occurrence,
    codes and scale alike. Returns (table, scales, codes, err): codes [M, S]
    uint8 and err [M] f32 are every pushed row's codes and relative error,
    dropped rows included."""
    operands = (table, scales, idx, values, codebook)
    if all(t.device.type == "cpu" for t in operands):
        return scatter_rows_vq_ref(table, scales, idx, values, codebook)
    name = "scatter_rows_vq"
    dev = B.require_cuda(name, idx, values, codebook,
                         pinned=(table, scales))
    B.require_dtype(name, table, torch.uint8, "table")
    B.require_dtype(name, scales, torch.float32, "scales")
    B.require_dtype(name, values, torch.float32, "values")
    n, s_n = table.shape
    _check_push(name, table, idx, values, d=s_n * 8)
    check_codebook(name, codebook, s_n)
    if scales.shape != (n,):
        raise ValueError(f"{name}: scales {tuple(scales.shape)} != {(n,)}")
    m = idx.shape[0]
    if values.data_ptr() % 16:   # the kernel reads 16 bytes at a time
        values = values.clone()
    winner = _winner(m, n, dev)
    codes = torch.empty((m, s_n), dtype=torch.uint8, device=dev)
    err = torch.empty((m,), dtype=torch.float32, device=dev)
    lanes, warps, _ = scatter_rows_vq_plan(m, s_n, _sm_count(dev))
    B.check(B.lib().repro_scatter_rows_vq(
        B.device_ptr(table), B.device_ptr(scales), codes.data_ptr(),
        err.data_ptr(), idx.data_ptr(), values.data_ptr(),
        codebook.data_ptr(), None if winner is None else winner.data_ptr(),
        m, n, s_n, codebook.shape[1], lanes, warps, B.stream_ptr(dev)),
        name)
    B.launch_counts[name] += 1
    return table, scales, codes, err


def _check_raw_push(tables: List[torch.Tensor], idx: torch.Tensor,
                    rows: List[torch.Tensor]) -> None:
    """What a raw push checks on any device: one row set a table, each of
    the table's type and of shape [M, ...] like the table."""
    name = "scatter_rows_raw"
    if len(tables) != len(rows):
        raise ValueError(f"{name}: {len(tables)} tables and {len(rows)} "
                         "row sets")
    for table, r in zip(tables, rows):
        if r.dtype != table.dtype:
            raise TypeError(f"{name}: rows are {r.dtype}, the table "
                            f"{table.dtype}")
        if table.dim() not in (1, 2) or idx.dim() != 1 or \
                r.shape != idx.shape + table.shape[1:]:
            raise ValueError(f"{name}: table [N] or [N, D], idx [M] and rows"
                             f" [M, ...] like the table, got "
                             f"{tuple(table.shape)}, {tuple(idx.shape)} and "
                             f"{tuple(r.shape)}")


def scatter_rows_raw_many(tables: Sequence[torch.Tensor], idx: torch.Tensor,
                          rows: Sequence[torch.Tensor]
                          ) -> List[torch.Tensor]:
    """In place, for each table and its rows: table[idx[i]] = rows[i] for
    idx[i] in [0, N), bit for bit (f32, bf16, int8 or uint8 rows [N, D],
    or a 1-d [N] table of single elements such as a scale table); other
    rows are dropped; duplicates resolve to the last occurrence, the same
    pushed row in every table. Each rows tensor has its table's type and
    shape past the first axis; a table is on the card or a pinned host
    tensor, `idx` int32 [M] and the rows on the card; one launch for up to
    MAX_RAW_TABLES tables. All-CPU operands run the plain version.
    Returns the tables."""
    tables, rows = list(tables), list(rows)
    _check_raw_push(tables, idx, rows)
    if all(t.device.type == "cpu" for t in tables + rows + [idx]):
        return scatter_rows_raw_many_ref(tables, idx, rows)
    name = "scatter_rows_raw"
    dev = B.require_cuda(name, idx, *rows, pinned=tuple(tables))
    B.require_dtype(name, idx, torch.int32, "idx")
    m = idx.shape[0]
    if m >= 2 ** 31:
        raise ValueError(f"{name}: {m} rows exceed the int32 winner pass")
    # a table of no rows drops every pushed row
    live = [(t, r) for t, r in zip(tables, rows)
            if r.numel() and t.shape[0]]
    if not live:
        return tables
    winner = _winner(m, max(t.shape[0] for t, _ in live), dev)
    B.check(B.lib().repro_scatter_rows_raw_many(
        B.pointers([B.device_ptr(t) for t, _ in live]),
        B.pointers([r.data_ptr() for _, r in live]),
        B.int64s([t.shape[0] for t, _ in live]),
        B.int64s([row_bytes(r) for _, r in live]),
        len(live), idx.data_ptr(),
        None if winner is None else winner.data_ptr(), m,
        B.stream_ptr(dev)), name)
    B.launch_counts[name] += raw_launches(len(live))
    return tables


def scatter_rows_raw(table: torch.Tensor, idx: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """In place: table[idx[i]] = rows[i] for idx[i] in [0, N), bit for bit:
    `scatter_rows_raw_many` of one table (on the card or pinned on the
    host; a 1-d [N] table of single elements such as a scale table); other
    rows are dropped; duplicates resolve to the last occurrence. All-CPU
    operands run the plain version. Returns `table`."""
    return scatter_rows_raw_many([table], idx, [rows])[0]
