"""PNA's multi-aggregator reduction over unit-weight BCSR blocks:
`pna_reduce_fwd`, `pna_reduce_bwd_row`, `pna_reduce_bwd_col`.

Replaces `src/repro/kernels/pna_reduce.py:98 pna_reduce_fwd`, `:194
pna_reduce_bwd_row` and `:254 pna_reduce_bwd_col`. On CUDA tensors each
launches its kernel in `csrc/pna_reduce.cu` (one warp per row of the
block structure, lanes over features, the loop over K and the edges in
the warp, the running stats in registers; the design and the bound are
in the source's head); on CPU tensors each runs its plain version in
`ref.py`. The operands keep the
op's node-major layouts (`xd` [n_dst, F] destination rows, `xs` [n_src,
F]) with no padding of rows or features: the kernels mask the ragged
edges.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build as B
from .bcsr_spmm import BN, check_blocks
from .ref import (pna_reduce_bwd_col_ref, pna_reduce_bwd_row_ref,
                  pna_reduce_fwd_ref)

__all__ = ["pna_reduce_fwd", "pna_reduce_bwd_row", "pna_reduce_bwd_col",
           "pna_reduce_fwd_ref", "pna_reduce_bwd_row_ref",
           "pna_reduce_bwd_col_ref"]


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(name: str, xd, xs, ublk_vals, blk_cols, *dst_side,
           rows_of: str) -> torch.device:
    """Device, dtype, shape and coverage checks shared by the three
    wrappers. `rows_of` names the side the blocks' rows run over ("dst"
    for the forward family, "src" for the transposed one); the blocks must
    cover all of its rows, since each kernel writes only the rows its
    block rows own."""
    dev = B.require_cuda(name, xd, xs, ublk_vals, blk_cols, *dst_side)
    for t, what in ((xd, "xd"), (xs, "xs")) + tuple(
            (t, f"dst-side operand {i}") for i, t in enumerate(dst_side)):
        B.require_dtype(name, t, torch.float32, what)
    check_blocks(name, ublk_vals, blk_cols)
    if xd.dim() != 2 or xs.dim() != 2 or xd.shape[1] != xs.shape[1]:
        raise ValueError(f"{name}: xd {tuple(xd.shape)} and xs "
                         f"{tuple(xs.shape)} must be [n_dst, F], [n_src, F]")
    for t in dst_side:
        if t.shape != xd.shape:
            raise ValueError(f"{name}: destination-side operand "
                             f"{tuple(t.shape)} != {tuple(xd.shape)}")
    rows = xd.shape[0] if rows_of == "dst" else xs.shape[0]
    if blk_cols.shape[0] * BN < rows:
        raise ValueError(f"{name}: {blk_cols.shape[0]} block rows do not "
                         f"cover {rows} {rows_of} rows")
    return dev


def pna_reduce_fwd(xd: torch.Tensor, xs: torch.Tensor,
                   ublk_vals: torch.Tensor, blk_cols: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """(s, mn, mx, cnt, cmin, cmax): the multiplicity-weighted sum, min,
    max and count of relu(xd[dst] + xs[src]) over the forward blocks,
    with the tie counts at the min and max; [n_dst, F] f32 each, cnt
    [n_dst] f32; mn and mx are 0 on rows without edges."""
    if _on_cpu(xd, xs, ublk_vals, blk_cols):
        return pna_reduce_fwd_ref(xd, xs, ublk_vals, blk_cols)
    name = "pna_reduce_fwd"
    dev = _check(name, xd, xs, ublk_vals, blk_cols, rows_of="dst")
    n_dst, F = xd.shape
    R, K = blk_cols.shape
    s, mn, mx, cmin, cmax = (torch.empty((n_dst, F), dtype=torch.float32,
                                         device=dev) for _ in range(5))
    cnt = torch.empty((n_dst,), dtype=torch.float32, device=dev)
    B.check(B.lib().repro_pna_reduce_fwd_f32(
        xd.data_ptr(), xs.data_ptr(), n_dst, xs.shape[0], F,
        ublk_vals.data_ptr(), blk_cols.data_ptr(), R, K, s.data_ptr(),
        mn.data_ptr(), mx.data_ptr(), cnt.data_ptr(), cmin.data_ptr(),
        cmax.data_ptr(), B.stream_ptr(dev)), name)
    B.launch_counts[name] += 1
    return s, mn, mx, cnt, cmin, cmax


def _bwd(name, xd, xs, stats, ublk_vals, blk_cols, rows_of):
    dev = _check(name, xd, xs, ublk_vals, blk_cols, *stats, rows_of=rows_of)
    n_dst, F = xd.shape
    R, K = blk_cols.shape
    out = torch.empty((xd if rows_of == "dst" else xs).shape,
                      dtype=torch.float32, device=dev)
    fn = getattr(B.lib(), f"repro_{name}_f32")
    B.check(fn(xd.data_ptr(), xs.data_ptr(), *(t.data_ptr() for t in stats),
               n_dst, xs.shape[0], F, ublk_vals.data_ptr(),
               blk_cols.data_ptr(), R, K, out.data_ptr(), B.stream_ptr(dev)),
            name)
    B.launch_counts[name] += 1
    return out


def pna_reduce_bwd_row(xd, xs, gs, gmn, gmx, mn, mx, cmin, cmax,
                       ublk_vals: torch.Tensor,
                       blk_cols: torch.Tensor) -> torch.Tensor:
    """dxd [n_dst, F] over the forward blocks. gs/gmn/gmx are the (s, mn,
    mx) cotangents, mn/mx/cmin/cmax the forward's saved stats, all
    [n_dst, F]; min/max cotangents are split evenly across ties."""
    stats = (gs, gmn, gmx, mn, mx, cmin, cmax)
    if _on_cpu(xd, xs, *stats, ublk_vals, blk_cols):
        return pna_reduce_bwd_row_ref(xd, xs, *stats, ublk_vals, blk_cols)
    return _bwd("pna_reduce_bwd_row", xd, xs, stats, ublk_vals, blk_cols,
                "dst")


def pna_reduce_bwd_col(xd, xs, gs, gmn, gmx, mn, mx, cmin, cmax,
                       ublk_vals_t: torch.Tensor,
                       blk_cols_t: torch.Tensor) -> torch.Tensor:
    """dxs [n_src, F] over the transposed blocks, whose rows are sources:
    each source row has one owner; the destination-side operands are as
    in `pna_reduce_bwd_row`."""
    stats = (gs, gmn, gmx, mn, mx, cmin, cmax)
    if _on_cpu(xd, xs, *stats, ublk_vals_t, blk_cols_t):
        return pna_reduce_bwd_col_ref(xd, xs, *stats, ublk_vals_t,
                                      blk_cols_t)
    return _bwd("pna_reduce_bwd_col", xd, xs, stats, ublk_vals_t,
                blk_cols_t, "src")
