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

Forward only: the custom VJPs of `spmm`/`gas_aggregate` come with the
training slice (ROADMAP Queue A).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .bcsr_spmm import bcsr_spmm
from .fused import gather_plan, gather_spmm
from .gather import gather_rows
from .scatter import scatter_rows


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


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------

def spmm(x: torch.Tensor, blk_vals: torch.Tensor,
         blk_cols: torch.Tensor) -> torch.Tensor:
    """Block-CSR SpMM: out [R*bn, D] = A @ x (forward)."""
    return bcsr_spmm(x, blk_vals, blk_cols)


def gcn_aggregate(x_all: torch.Tensor, edges, edge_w: torch.Tensor,
                  n_out: int, blocks=None) -> torch.Tensor:
    """GAS neighbor aggregation: out[d] = sum_e w_e * x_all[src_e].

    With `blocks = (blk_vals, blk_cols, ...)` it runs the block SpMM
    (`bcsr_spmm`, the serving path); with blocks=None it sums over the
    padded COO in plain tensor code (`index_add_`), which only the
    full-graph reference forward uses."""
    if blocks is None:
        dst, src = edges
        msg = x_all[src.long()] * edge_w[:, None]
        out = torch.zeros((n_out + 1, x_all.shape[1]), dtype=msg.dtype,
                          device=msg.device)
        return out.index_add_(0, dst.long(), msg)[:n_out]
    return spmm(x_all, blocks[0], blocks[1])[:n_out]


def gas_aggregate(x_in: torch.Tensor, table: torch.Tensor,
                  halo_nodes: torch.Tensor, halo_mask: torch.Tensor,
                  n_out: int, blocks, *,
                  scales: Optional[torch.Tensor] = None,
                  codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused GAS aggregation: out = A @ [x_in ; table[halo]*mask ; 0]
    without building the bracket: the gather plan is computed on the
    blocks' device, then `gather_spmm` reads in-batch rows from x_in,
    halo rows straight out of the history table and zeros elsewhere.
    `blocks` is (blk_vals, blk_cols[, ...]); only the forward pair is
    read."""
    blk_vals, blk_cols = blocks[0], blocks[1]
    bn = blk_vals.shape[-1]
    sel, xrow, trow = gather_plan(blk_cols, halo_nodes, halo_mask,
                                  x_in.shape[0], table.shape[0], bn)
    out = gather_spmm(x_in, table, blk_vals, blk_cols, sel, xrow, trow,
                      scales, codebook)
    return out[:n_out]


def pull_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """History pull: out[i] = table[idx[i]] (idx clipped to [0, N)).
    Dequantizing pulls (int8/vq stores) are not ported yet."""
    idx = torch.clamp(idx, 0, table.shape[0] - 1).to(torch.int32)
    return gather_rows(table, idx)


def push_rows(table: torch.Tensor, idx: torch.Tensor, values: torch.Tensor,
              mask: torch.Tensor, *,
              scratch_last_row: bool = False) -> torch.Tensor:
    """History push, in place: table[idx[i]] = values[i] where mask[i];
    returns `table`. Duplicate valid indices resolve to the last writer.

    `scratch_last_row=True` declares the last table row sacrificial (GAS
    history tables are [N+1, d] with a sentinel row that is only ever read
    through a mask): masked rows are redirected into it, and its contents
    become unspecified; valid indices must stay below N-1. Otherwise
    masked rows are dropped."""
    N = table.shape[0]
    if scratch_last_row:
        safe = torch.where(mask, torch.clamp(idx, 0, N - 2),
                           torch.full_like(idx, N - 1))
    else:
        safe = torch.where(mask, torch.clamp(idx, 0, N - 1),
                           torch.full_like(idx, N))
    return scatter_rows(table, safe.to(torch.int32),
                        values.to(table.dtype).contiguous())


__all__ = ["build_bcsr", "build_bcsr_rect", "spmm", "gcn_aggregate",
           "gas_aggregate", "pull_rows", "push_rows", "bcsr_spmm",
           "gather_plan", "gather_spmm", "gather_rows", "scatter_rows"]
