"""The GAS hot-path ops over the port's kernels, plus the host-side BCSR
builders.

The port of `repro.kernels.ops`. The reference dispatches each op on a
backend string ("pallas" | "interpret" | "jnp"); the port has one
implementation per op and lets the tensors' device choose: CUDA tensors
launch the hand-written kernels, CPU tensors run their plain PyTorch
versions (`ref.py`). The reference pads features to 128-lane tiles and
node counts to whole blocks before every kernel call and slices the
result back; the CUDA kernels mask ragged edges themselves, so nothing
here pads or copies an operand.

The reference's custom VJPs are `torch.autograd.Function`s here, whose
backwards are kernels too: `spmm` / `gcn_aggregate` and `gas_aggregate`
run `bcsr_spmm` on the transposed blocks (`gas_aggregate`'s float table
takes its gradient from the same product), `edge_softmax_aggregate` runs
GAT's row and column backward kernels, and `pna_reduce` PNA's. The
adjacency blocks are constants (zero cotangent), as in the reference.
None of them saves a history table for the backward: the forward pushes
into the tables in place, and autograd refuses a saved tensor that was
modified since.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .bcsr_spmm import bcsr_spmm
from .edge_softmax import (edge_softmax_bwd_col, edge_softmax_bwd_row,
                           edge_softmax_fwd)
from .fused import gather_plan, gather_spmm
from .gather import gather_rows, gather_rows_dq, gather_rows_vq
from .pna_reduce import (pna_reduce_bwd_col, pna_reduce_bwd_row,
                         pna_reduce_fwd)
from .ref import edge_softmax_coo, pna_reduce_coo
from .scatter import scatter_rows, scatter_rows_q, scatter_rows_vq


# ---------------------------------------------------------------------------
# Host-side BCSR builders (numpy; copies of the reference's)
# ---------------------------------------------------------------------------

def build_bcsr_rect(dst: np.ndarray, src: np.ndarray, w: np.ndarray,
                    n_rows: int, n_cols: int, bn: int = 128
                    ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """COO (dst, src, w) -> rectangular block-CSR.

    dst in [0, n_rows), src in [0, n_cols). R = ceil(n_rows/bn) row blocks;
    K = max non-empty column blocks over any row block (padding blocks:
    col 0 with all-zero values). Returns (vals [R,K,bn,bn], cols [R,K],
    rows_pad, cols_pad) with rows_pad = R*bn, cols_pad = ceil(n_cols/bn)*bn.
    """
    R = max(-(-n_rows // bn), 1)
    C = max(-(-n_cols // bn), 1)
    if len(dst) == 0:
        return (np.zeros((R, 1, bn, bn), np.float32),
                np.zeros((R, 1), np.int32), R * bn, C * bn)
    bi = (dst // bn).astype(np.int64)
    bj = (src // bn).astype(np.int64)
    key = bi * C + bj
    order = np.argsort(key, kind="stable")
    dst_s, src_s, w_s = dst[order], src[order], w[order]
    uniq, inv = np.unique(key[order], return_inverse=True)

    ub_row = (uniq // C).astype(np.int64)
    # slot of each unique block within its row block = cumcount (uniq is
    # sorted, so blocks of one row are contiguous and in ascending j order)
    slot = np.arange(len(uniq)) - np.searchsorted(ub_row, ub_row,
                                                  side="left")
    K = max(int(slot.max()) + 1, 1)
    vals = np.zeros((R * K, bn, bn), np.float32)
    np.add.at(vals, ((ub_row * K + slot)[inv],
                     (dst_s % bn).astype(np.int64),
                     (src_s % bn).astype(np.int64)), w_s)
    cols = np.zeros((R, K), np.int32)
    cols[ub_row, slot] = (uniq % C).astype(np.int32)
    return vals.reshape(R, K, bn, bn), cols, R * bn, C * bn


def build_bcsr(dst: np.ndarray, src: np.ndarray, w: np.ndarray,
               num_nodes: int, bn: int = 128
               ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Square block-CSR over one node space. Returns (vals [R,K,bn,bn],
    cols [R,K], Np) with Np = R*bn."""
    vals, cols, rows_pad, _ = build_bcsr_rect(dst, src, w, num_nodes,
                                              num_nodes, bn=bn)
    return vals, cols, rows_pad


def bcsr_density(blk_cols: np.ndarray, blk_vals: np.ndarray) -> float:
    """Fraction of stored blocks that are structurally non-empty."""
    nonzero = (np.abs(blk_vals).sum(axis=(2, 3)) > 0).sum()
    return float(nonzero) / blk_cols.size


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------

class _SpMM(torch.autograd.Function):
    """out = A @ x on the forward blocks; dx = A^T @ g on the transposed
    blocks (`ops.py:157-175` of the reference). The blocks get no
    gradient."""

    @staticmethod
    def forward(ctx, x, blk_vals, blk_cols, blk_vals_t, blk_cols_t):
        ctx.n_src = x.shape[0]
        ctx.blocks_t = (blk_vals_t, blk_cols_t)
        return bcsr_spmm(x, blk_vals, blk_cols)

    @staticmethod
    def backward(ctx, g):
        vals_t, cols_t = ctx.blocks_t
        if vals_t is None:
            raise ValueError(
                "spmm backward needs the transposed blocks: build the "
                "batch with them (core.gas.build_batches(build_blocks="
                "True)); the forward-only serving batches carry none")
        dx = bcsr_spmm(g.contiguous(), vals_t, cols_t)[:ctx.n_src]
        return dx, None, None, None, None


def spmm(x: torch.Tensor, blk_vals: torch.Tensor, blk_cols: torch.Tensor,
         blk_vals_t: Optional[torch.Tensor] = None,
         blk_cols_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block-CSR SpMM: out [R*bn, D] = A @ x. Differentiable w.r.t. x
    when the transposed pair is given: the backward is `bcsr_spmm` on it."""
    return _SpMM.apply(x, blk_vals, blk_cols, blk_vals_t, blk_cols_t)


def gcn_aggregate(x_all: torch.Tensor, edges, edge_w: torch.Tensor,
                  n_out: int, blocks=None) -> torch.Tensor:
    """GAS neighbor aggregation: out[d] = sum_e w_e * x_all[src_e].

    With `blocks = (blk_vals, blk_cols[, blk_vals_t, blk_cols_t])` it runs
    the block SpMM (`bcsr_spmm`, forward and, on the transposed pair,
    backward); with blocks=None it sums over the padded COO in plain
    tensor code (`index_add_`), which only the full-graph forward uses."""
    if blocks is None:
        dst, src = edges
        msg = x_all[src.long()] * edge_w[:, None]
        out = torch.zeros((n_out + 1, x_all.shape[1]), dtype=msg.dtype,
                          device=msg.device)
        return out.index_add_(0, dst.long(), msg)[:n_out]
    t = tuple(blocks[2:4]) if len(blocks) >= 4 else (None, None)
    return spmm(x_all, blocks[0], blocks[1], *t)[:n_out]


class _GasAggregate(torch.autograd.Function):
    """out = A @ [x_in ; dequant(table)[halo] * mask ; 0] without the
    bracket; its cotangent is one `bcsr_spmm` on the transposed blocks,
    split by row range (`ops.py:246-300` of the reference): rows < n_in
    are dx_in, the next max_h rows, times the halo mask, are index-added
    into a zero table at the halo ids (masked slots dropped), which is a
    float table's gradient. A quantized table, its scales and a vq
    codebook get none (the reference's hard zeros). Only the halo ids,
    the mask and the shapes are kept for the backward, never the table,
    which later pushes overwrite in place."""

    @staticmethod
    def forward(ctx, x_in, table, scales, codebook, halo_nodes, halo_mask,
                blk_vals, blk_cols, blk_vals_t, blk_cols_t):
        bn = blk_vals.shape[-1]
        sel, xrow, trow = gather_plan(blk_cols, halo_nodes, halo_mask,
                                      x_in.shape[0], table.shape[0], bn)
        ctx.n_in = x_in.shape[0]
        ctx.table_shape = tuple(table.shape)
        ctx.table_dtype = table.dtype
        ctx.blocks_t = (blk_vals_t, blk_cols_t)
        if ctx.needs_input_grad[1]:
            ctx.save_for_backward(halo_nodes, halo_mask)
        return gather_spmm(x_in, table, blk_vals, blk_cols, sel, xrow, trow,
                           scales, codebook)

    @staticmethod
    def backward(ctx, g):
        vals_t, cols_t = ctx.blocks_t
        if vals_t is None:
            raise ValueError(
                "gas_aggregate backward needs the transposed blocks: build "
                "the batch with them (core.gas.build_batches(build_blocks="
                "True))")
        dx_all = bcsr_spmm(g.contiguous(), vals_t, cols_t)
        dtable = None
        if ctx.needs_input_grad[1]:
            halo_nodes, halo_mask = ctx.saved_tensors
            n_in, max_h = ctx.n_in, halo_nodes.shape[0]
            dh = dx_all[n_in:n_in + max_h] * halo_mask[:, None]
            dtable = torch.zeros(ctx.table_shape, dtype=ctx.table_dtype,
                                 device=dx_all.device)
            # a masked slot adds its zero row to row 0 (no host sync to
            # drop it)
            idx = torch.where(halo_mask, halo_nodes.long().clamp(
                0, ctx.table_shape[0] - 1), 0)
            dtable.index_add_(0, idx, dh.to(ctx.table_dtype))
        return (dx_all[:ctx.n_in], dtable) + (None,) * 8


def gas_aggregate(x_in: torch.Tensor, table: torch.Tensor,
                  halo_nodes: torch.Tensor, halo_mask: torch.Tensor,
                  n_out: int, blocks, *,
                  scales: Optional[torch.Tensor] = None,
                  codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused GAS aggregation: out = A @ [x_in ; dequant(table)[halo]*mask
    ; 0] without building the bracket: the gather plan is computed on the
    blocks' device, then `gather_spmm` reads in-batch rows from x_in,
    halo rows straight out of the history table (f32, bf16, int8 with
    `scales` [N] f32, or vq codes with `scales` and `codebook` [S, 256, 8],
    dequantized or decoded as they are staged) and zeros elsewhere.
    `blocks` is (blk_vals, blk_cols[, blk_vals_t, blk_cols_t]).
    Differentiable w.r.t. x_in and a float (f32 or bf16) table, both by
    `bcsr_spmm` on the transposed pair; a quantized table and its
    codebook get no gradient (the reference's hard zeros; integer tensors
    cannot require one)."""
    t = tuple(blocks[2:4]) if len(blocks) >= 4 else (None, None)
    return _GasAggregate.apply(x_in, table, scales, codebook, halo_nodes,
                               halo_mask, blocks[0], blocks[1], *t)[:n_out]


def _unit_blocks(name: str, ublocks) -> tuple:
    """(uvals, cols, uvals_t, cols_t) from a unit-weight family given with
    its transposed pair or, for a forward-only serve batch, without it
    (then the last two are None and a backward raises)."""
    if len(ublocks) not in (2, 4):
        raise ValueError(f"{name} needs the unit-weight blocks (ublk_vals, "
                         "blk_cols[, ublk_vals_t, blk_cols_t]): "
                         "build_batches(unit_weights=True)")
    return tuple(ublocks) + (None, None) * (len(ublocks) == 2)


def _need_transposed(name: str, vals_t) -> None:
    if vals_t is None:
        raise ValueError(
            f"{name} backward needs the transposed unit blocks: build the "
            "batch with them (core.gas.build_batches(build_blocks=True, "
            "unit_weights=True)); the forward-only serving batches carry "
            "none")


class _EdgeSoftmax(torch.autograd.Function):
    """GAT's aggregation over the unit-weight blocks (`ops.py:385-422` of
    the reference): the forward kernel, then for the backward delta =
    sum_f g * out in plain tensor code, the row kernel for dad and the
    column kernel for dwx and das."""

    @staticmethod
    def forward(ctx, wx, ad, as_, uv, uc, uvt, uct, neg_slope):
        out, mmax, lsum = edge_softmax_fwd(ad, as_, wx, uv, uc, neg_slope)
        ctx.save_for_backward(ad, as_, wx, out, mmax, lsum)
        ctx.blocks = (uv, uc, uvt, uct)
        ctx.neg_slope = neg_slope
        return out

    @staticmethod
    def backward(ctx, g):
        ad, as_, wx, out, mmax, lsum = ctx.saved_tensors
        uv, uc, uvt, uct = ctx.blocks
        _need_transposed("edge_softmax_aggregate", uvt)
        g = g.contiguous()
        delta = (g * out).sum(-1)
        dad = edge_softmax_bwd_row(ad, as_, wx, g, mmax, lsum, delta, uv, uc,
                                   ctx.neg_slope)
        dwx, das = edge_softmax_bwd_col(ad, as_, wx, g, mmax, lsum, delta,
                                        uvt, uct, ctx.neg_slope)
        return dwx, dad, das, None, None, None, None, None


def edge_softmax_aggregate(wx: torch.Tensor, ad: torch.Tensor,
                           as_: torch.Tensor, edges, edge_w: torch.Tensor,
                           n_out: int, ublocks=None, *,
                           neg_slope: float = 0.2) -> torch.Tensor:
    """GAT aggregation: out[i, h] = sum_j softmax_j(e_ijh) * wx[j, h] with
    e_ijh = leaky_relu(ad[i, h] + as_[j, h]) over the valid edges.

    wx [M, H, F] per-head values, ad/as_ [M, H] per-node logit halves
    (destinations are rows 0..n_out-1). With `ublocks = (ublk_vals,
    blk_cols[, ublk_vals_t, blk_cols_t])` it runs the edge-softmax
    kernels, forward and, on the transposed pair, backward (an
    autograd.Function); with ublocks=None the
    per-edge segment softmax over the COO in plain tensor code
    (`ref.edge_softmax_coo`). Returns [n_out, H, F]; no operand is padded
    to whole blocks or 128 lanes."""
    if ublocks is None:
        return edge_softmax_coo(wx, ad, as_, edges, edge_w, n_out, neg_slope)
    uv, uc, uvt, uct = _unit_blocks("edge_softmax_aggregate", ublocks)
    return _EdgeSoftmax.apply(wx.contiguous(), ad[:n_out].contiguous(),
                              as_.contiguous(), uv, uc, uvt, uct, neg_slope)


class _PNAReduce(torch.autograd.Function):
    """PNA's reduction over the unit-weight blocks (`ops.py:481-511` of
    the reference): the forward kernel, saving the stats (mn, mx) and the
    tie counts (cmin, cmax); the backward runs the row kernel for dxd over
    the forward blocks and the column kernel for dxs over the transposed
    ones. cnt depends on the blocks alone: its cotangent is dropped."""

    @staticmethod
    def forward(ctx, xd, xs, uv, uc, uvt, uct):
        s, mn, mx, cnt, cmin, cmax = pna_reduce_fwd(xd, xs, uv, uc)
        ctx.save_for_backward(xd, xs, mn, mx, cmin, cmax)
        ctx.blocks = (uv, uc, uvt, uct)
        ctx.mark_non_differentiable(cnt)
        return s, mn, mx, cnt

    @staticmethod
    def backward(ctx, gs, gmn, gmx, _gcnt):
        xd, xs, mn, mx, cmin, cmax = ctx.saved_tensors
        uv, uc, uvt, uct = ctx.blocks
        _need_transposed("pna_reduce", uvt)
        gs, gmn, gmx = (torch.zeros_like(mn) if g is None else g.contiguous()
                        for g in (gs, gmn, gmx))
        stats = (gs, gmn, gmx, mn, mx, cmin, cmax)
        dxd = pna_reduce_bwd_row(xd, xs, *stats, uv, uc)
        dxs = pna_reduce_bwd_col(xd, xs, *stats, uvt, uct)
        return dxd, dxs, None, None, None, None


def pna_reduce(xd: torch.Tensor, xs: torch.Tensor, edges,
               edge_w: torch.Tensor, n_out: int, ublocks=None
               ) -> Tuple[torch.Tensor, ...]:
    """PNA's reduction of msg_e = relu(xd[dst_e] + xs[src_e]) per
    destination: (s, mn, mx, cnt) = (sum, min, max, edge count), mn and mx
    0 on destinations without edges; [n_out, F] each, cnt [n_out].

    xd/xs [M, F] are the destination and source halves of PNA's edge MLP
    (destinations are rows 0..n_out-1). With `ublocks = (ublk_vals,
    blk_cols[, ublk_vals_t, blk_cols_t])` it runs the three `pna_reduce`
    kernels, forward and, on the transposed pair, backward (an
    autograd.Function: the min/max
    cotangents split evenly across multiplicity-weighted ties, as
    `jax.ops.segment_min/max` split them); with ublocks=None the segment
    reduction over the COO in plain tensor code (`ref.pna_reduce_coo`).
    No operand is padded to whole blocks or 128 lanes."""
    if ublocks is None:
        return pna_reduce_coo(xd, xs, edges, edge_w, n_out)
    uv, uc, uvt, uct = _unit_blocks("pna_reduce", ublocks)
    return _PNAReduce.apply(xd[:n_out].contiguous(), xs.contiguous(), uv, uc,
                            uvt, uct)


def pull_rows(table: torch.Tensor, idx: torch.Tensor, *,
              scales: Optional[torch.Tensor] = None,
              codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
    """History pull: out[i] = table[idx[i]] (idx clipped to [0, N)), in
    the table's type for f32 and bf16 tables. With `scales` [N] f32 the
    table holds int8 rows and the pull dequantizes: out[i] =
    float(table[idx[i]]) * scales[idx[i]] in f32 (`gather_rows_dq`, the
    multiply fused into the row gather, so only int8 table bytes are
    read). With `codebook` [S, 256, 8] as well, the table holds uint8 vq
    code rows [N, S] and the pull decodes them into [M, S*8] f32
    (`gather_rows_vq`: only S code bytes per row are read)."""
    idx = torch.clamp(idx, 0, table.shape[0] - 1).to(torch.int32)
    if codebook is not None:
        return gather_rows_vq(table, codebook, scales, idx)
    if scales is not None:
        return gather_rows_dq(table, scales, idx)
    return gather_rows(table, idx)


def _push_index(idx: torch.Tensor, mask: torch.Tensor, n: int,
                scratch_last_row: bool) -> torch.Tensor:
    """The scatter index of a masked push: masked rows go to the
    sacrificial last row, or out of range (dropped)."""
    if scratch_last_row:
        safe = torch.where(mask, torch.clamp(idx, 0, n - 2),
                           torch.full_like(idx, n - 1))
    else:
        safe = torch.where(mask, torch.clamp(idx, 0, n - 1),
                           torch.full_like(idx, n))
    return safe.to(torch.int32)


def push_rows(table: torch.Tensor, idx: torch.Tensor, values: torch.Tensor,
              mask: torch.Tensor, *,
              scratch_last_row: bool = False) -> torch.Tensor:
    """History push, in place: table[idx[i]] = values[i] where mask[i];
    returns `table`. Duplicate valid indices resolve to the last writer.
    A bf16 table takes the values rounded to bf16 first (nearest, ties to
    even, as the reference's `astype`), so the scatter moves 2-byte rows.

    `scratch_last_row=True` declares the last table row sacrificial (GAS
    history tables are [N+1, d] with a sentinel row that is only ever read
    through a mask): masked rows are redirected into it, and its contents
    become unspecified; valid indices must stay below N-1. Otherwise
    masked rows are dropped."""
    safe = _push_index(idx, mask, table.shape[0], scratch_last_row)
    return scatter_rows(table, safe, values.to(table.dtype).contiguous())


def push_rows_q(table: torch.Tensor, scales: torch.Tensor,
                idx: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
                *, scratch_last_row: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantizing history push, in place, the dual of the dequantizing
    pull: `table` [N, D] int8 and `scales` [N] f32. Each pushed row is
    quantized as `ref.quantize_rows` does (s = max|v| / 127, q =
    round(v / s)) and its codes and scale land at the same row
    (`scatter_rows_q`: the row max, divide, round and clip run inside the
    scatter, so no quantized copy of the payload is made). Masking and
    `scratch_last_row` as in `push_rows` (the sentinel row's scale becomes
    unspecified too). Returns (table, scales, err), err [M] each pushed
    row's relative quantization error (masked rows' too)."""
    safe = _push_index(idx, mask, table.shape[0], scratch_last_row)
    return scatter_rows_q(table, scales, safe,
                          values.to(torch.float32).contiguous())


def push_rows_vq(table: torch.Tensor, scales: torch.Tensor,
                 idx: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
                 codebook: torch.Tensor, *, scratch_last_row: bool = False
                 ) -> Tuple[torch.Tensor, ...]:
    """Encoding history push, in place (`ops.py:711-761` of the
    reference): `table` [N, S] uint8 codes, `scales` [N] f32, `codebook`
    [S, 256, 8] f32. Each pushed row is normalized by its `max|v|` and
    each 8-wide subvector takes the index of its nearest codebook entry
    (`ref.vq_encode_rows`); codes and scale land at the same row
    (`scatter_rows_vq`: the scale, the division and the nearest-entry
    search run inside the scatter). Masking and `scratch_last_row` as in
    `push_rows`. Returns (table, scales, codes, err): codes [M, S] and err
    [M], each pushed row's codes and relative error (masked rows' too)."""
    safe = _push_index(idx, mask, table.shape[0], scratch_last_row)
    return scatter_rows_vq(table, scales, safe,
                           values.to(torch.float32).contiguous(), codebook)


__all__ = ["build_bcsr", "build_bcsr_rect", "spmm", "gcn_aggregate",
           "gas_aggregate", "edge_softmax_aggregate", "pull_rows",
           "push_rows", "push_rows_q", "push_rows_vq", "bcsr_spmm",
           "gather_plan", "gather_spmm", "gather_rows", "gather_rows_dq",
           "gather_rows_vq", "scatter_rows", "scatter_rows_q",
           "scatter_rows_vq", "edge_softmax_fwd", "edge_softmax_bwd_row",
           "edge_softmax_bwd_col", "pna_reduce", "pna_reduce_fwd",
           "pna_reduce_bwd_row", "pna_reduce_bwd_col"]
