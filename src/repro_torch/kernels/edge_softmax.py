"""GAT's edge softmax over unit-weight BCSR blocks: `edge_softmax_fwd`,
`edge_softmax_bwd_row`, `edge_softmax_bwd_col`.

Replaces `src/repro/kernels/edge_softmax.py:92 edge_softmax_fwd`, `:189
edge_softmax_bwd_row` and `:276 edge_softmax_bwd_col`. On CUDA tensors
each launches its kernel in `csrc/edge_softmax.cu`: a warp per row of
the blocks (a destination row of the forward blocks for the forward and
the row pass, a source row of the transposed blocks for the column pass)
streams its block rows once, queues their nonzeros and loads the far
rows of their edges a few at a time; every output has one owner, with no
atomics. Bound by the blocks' bytes, ~0.2 us at GAT's Cora-shaped
batches, below one launch (the design and the bound are in the source's
head). On CPU tensors each runs its plain version in `ref.py`. The
operands keep the op's node-major layouts (`ad` [n_dst, H], `as_`
[n_src, H], `wx` [n_src, H, F]) with no padding of rows or features: the
kernels mask the ragged edges.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build as B
from .bcsr_spmm import BN, check_blocks
from .ref import (edge_softmax_bwd_col_ref, edge_softmax_bwd_row_ref,
                  edge_softmax_fwd_ref)

__all__ = ["edge_softmax_fwd", "edge_softmax_bwd_row",
           "edge_softmax_bwd_col", "edge_softmax_fwd_ref",
           "edge_softmax_bwd_row_ref", "edge_softmax_bwd_col_ref"]


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(name: str, ad, as_, wx, ublk_vals, blk_cols, *dst_side,
           rows_of: str) -> torch.device:
    """Device, dtype, shape and coverage checks shared by the three
    wrappers. `rows_of` names the side the blocks' rows run over ("dst"
    for the forward family, "src" for the transposed one); the blocks must
    cover all of its rows, since each kernel writes only the rows its
    block rows own."""
    dev = B.require_cuda(name, ad, as_, wx, ublk_vals, blk_cols, *dst_side)
    for t, what in ((ad, "ad"), (as_, "as_"), (wx, "wx")) + tuple(
            (t, f"dst-side operand {i}") for i, t in enumerate(dst_side)):
        B.require_dtype(name, t, torch.float32, what)
    check_blocks(name, ublk_vals, blk_cols)
    n_dst, H = ad.shape
    n_src, H2, F = wx.shape
    if as_.shape != (n_src, H) or H2 != H:
        raise ValueError(f"{name}: ad {tuple(ad.shape)}, as_ "
                         f"{tuple(as_.shape)} and wx {tuple(wx.shape)} "
                         "must be [n_dst, H], [n_src, H], [n_src, H, F]")
    for t in dst_side:
        if t.shape[:2] != (n_dst, H):
            raise ValueError(f"{name}: destination-side operand "
                             f"{tuple(t.shape)} must lead with {(n_dst, H)}")
    rows = n_dst if rows_of == "dst" else n_src
    if blk_cols.shape[0] * BN < rows:
        raise ValueError(f"{name}: {blk_cols.shape[0]} block rows do not "
                         f"cover {rows} {rows_of} rows")
    return dev


def edge_softmax_fwd(ad: torch.Tensor, as_: torch.Tensor, wx: torch.Tensor,
                     ublk_vals: torch.Tensor, blk_cols: torch.Tensor,
                     neg_slope: float = 0.2
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out [n_dst, H, F], M [n_dst, H], L [n_dst, H]): the online-softmax
    aggregation over the forward multiplicity blocks and the per-row
    softmax statistics the backward passes reuse."""
    if _on_cpu(ad, as_, wx, ublk_vals, blk_cols):
        return edge_softmax_fwd_ref(ad, as_, wx, ublk_vals, blk_cols,
                                    neg_slope)
    name = "edge_softmax_fwd"
    dev = _check(name, ad, as_, wx, ublk_vals, blk_cols, rows_of="dst")
    n_dst, H = ad.shape
    n_src, _, F = wx.shape
    R, K = blk_cols.shape
    out = torch.empty((n_dst, H, F), dtype=torch.float32, device=dev)
    mmax = torch.empty((n_dst, H), dtype=torch.float32, device=dev)
    lsum = torch.empty((n_dst, H), dtype=torch.float32, device=dev)
    B.check(B.lib().repro_edge_softmax_fwd_f32(
        ad.data_ptr(), as_.data_ptr(), wx.data_ptr(), n_dst, n_src, H, F,
        ublk_vals.data_ptr(), blk_cols.data_ptr(), R, K, neg_slope,
        out.data_ptr(), mmax.data_ptr(), lsum.data_ptr(),
        B.stream_ptr(dev)), name)
    B.launch_counts[name] += 1
    return out, mmax, lsum


def edge_softmax_bwd_row(ad, as_, wx, g, mmax, lsum, delta,
                         ublk_vals: torch.Tensor, blk_cols: torch.Tensor,
                         neg_slope: float = 0.2) -> torch.Tensor:
    """dad [n_dst, H] over the forward blocks; `g` [n_dst, H, F] is the
    output cotangent and `delta` [n_dst, H] = sum_f g * out."""
    if _on_cpu(ad, as_, wx, g, mmax, lsum, delta, ublk_vals, blk_cols):
        return edge_softmax_bwd_row_ref(ad, as_, wx, g, mmax, lsum, delta,
                                        ublk_vals, blk_cols, neg_slope)
    name = "edge_softmax_bwd_row"
    dev = _check(name, ad, as_, wx, ublk_vals, blk_cols, g, mmax, lsum,
                 delta, rows_of="dst")
    n_dst, H = ad.shape
    n_src, _, F = wx.shape
    if g.shape != (n_dst, H, F):
        raise ValueError(f"{name}: g {tuple(g.shape)} != {(n_dst, H, F)}")
    R, K = blk_cols.shape
    dad = torch.empty((n_dst, H), dtype=torch.float32, device=dev)
    B.check(B.lib().repro_edge_softmax_bwd_row_f32(
        ad.data_ptr(), as_.data_ptr(), wx.data_ptr(), g.data_ptr(),
        mmax.data_ptr(), lsum.data_ptr(), delta.data_ptr(), n_dst, n_src, H,
        F, ublk_vals.data_ptr(), blk_cols.data_ptr(), R, K, neg_slope,
        dad.data_ptr(), B.stream_ptr(dev)), name)
    B.launch_counts[name] += 1
    return dad


def edge_softmax_bwd_col(ad, as_, wx, g, mmax, lsum, delta,
                         ublk_vals_t: torch.Tensor, blk_cols_t: torch.Tensor,
                         neg_slope: float = 0.2
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dwx [n_src, H, F], das [n_src, H]) over the transposed blocks,
    whose rows are sources: each source row has one owner."""
    if _on_cpu(ad, as_, wx, g, mmax, lsum, delta, ublk_vals_t, blk_cols_t):
        return edge_softmax_bwd_col_ref(ad, as_, wx, g, mmax, lsum, delta,
                                        ublk_vals_t, blk_cols_t, neg_slope)
    name = "edge_softmax_bwd_col"
    dev = _check(name, ad, as_, wx, ublk_vals_t, blk_cols_t, g, mmax, lsum,
                 delta, rows_of="src")
    n_dst, H = ad.shape
    n_src, _, F = wx.shape
    if g.shape != (n_dst, H, F):
        raise ValueError(f"{name}: g {tuple(g.shape)} != {(n_dst, H, F)}")
    R_t, K_t = blk_cols_t.shape
    dwx = torch.empty((n_src, H, F), dtype=torch.float32, device=dev)
    das = torch.empty((n_src, H), dtype=torch.float32, device=dev)
    B.check(B.lib().repro_edge_softmax_bwd_col_f32(
        ad.data_ptr(), as_.data_ptr(), wx.data_ptr(), g.data_ptr(),
        mmax.data_ptr(), lsum.data_ptr(), delta.data_ptr(), n_dst, n_src, H,
        F, ublk_vals_t.data_ptr(), blk_cols_t.data_ptr(), R_t, K_t,
        neg_slope, dwx.data_ptr(), das.data_ptr(), B.stream_ptr(dev)), name)
    B.launch_counts[name] += 1
    return dwx, das
