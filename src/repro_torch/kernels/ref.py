"""Plain PyTorch versions of the port's four CUDA kernels.

Each function computes what its kernel computes, on the same arguments, in
plain tensor code: the kernel wrappers (`gather.py`, `scatter.py`,
`bcsr_spmm.py`, `fused.py`) run them when handed CPU tensors, the tests
hold them against the JAX package's Pallas kernels, and `chip_smoke.py`
holds each kernel against them on the card. They repeat the kernels'
arithmetic and are no yardstick of speed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = table[idx[i]]; idx pre-clipped to [0, N)."""
    return table[idx.long()]


def scatter_rows_ref(table: torch.Tensor, idx: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """In place: table[idx[i]] = values[i]; returns `table`.

    Rows whose index lies outside [0, N) are dropped. Duplicate indices
    resolve to the LAST occurrence in row order (the reference's
    sequential-grid semantics): a first pass takes, per target row, the
    largest position that names it, and only that position writes."""
    N = table.shape[0]
    idx = idx.long()
    pos = torch.arange(idx.shape[0], device=idx.device)
    ok = (idx >= 0) & (idx < N)
    tgt = torch.where(ok, idx, torch.full_like(idx, N))
    last = torch.full((N + 1,), -1, dtype=torch.long, device=idx.device)
    last.scatter_reduce_(0, tgt, pos, reduce="amax")
    win = ok & (last[tgt] == pos)
    table[idx[win]] = values[win].to(table.dtype)
    return table


def _gather_blocks(rows: torch.Tensor, blk_cols: torch.Tensor,
                   bn: int) -> torch.Tensor:
    """[n, D] rows -> [R, K, bn, D]: the bn-row block at each column block
    id, rows past n reading as zeros."""
    n, D = rows.shape
    pad = -(-n // bn) * bn - n
    xb = F.pad(rows, (0, 0, 0, pad)).view(-1, bn, D)
    return xb[blk_cols.long()]


def bcsr_spmm_ref(x: torch.Tensor, blk_vals: torch.Tensor,
                  blk_cols: torch.Tensor) -> torch.Tensor:
    """out[r*bn:(r+1)*bn] = sum_k blk_vals[r, k] @ x[blk_cols[r, k]*bn : +bn]
    in f32. x [n_x, D]: rows past n_x read as zeros. Returns [R*bn, D]."""
    R, K, bn, _ = blk_vals.shape
    g = _gather_blocks(x.to(torch.float32), blk_cols, bn)
    out = torch.einsum("rkab,rkbd->rad", blk_vals, g)
    return out.reshape(R * bn, x.shape[1])


def gather_spmm_ref(x_in: torch.Tensor, table: torch.Tensor,
                    blk_vals: torch.Tensor, blk_cols: torch.Tensor,
                    sel: torch.Tensor, xrow: torch.Tensor,
                    trow: torch.Tensor) -> torch.Tensor:
    """f32 fused history-gather aggregation, routed by the gather plan
    (`fused.gather_plan`): row b of block (r, k) is x_in[xrow] where
    sel == 0, table[trow] where sel == 1 and zeros where sel == 2; the
    staged [R, K, bn, D] operand is contracted with the blocks. Returns
    [R*bn, D] f32 (the reference's `ref.gather_spmm_ref` builds the same
    operand as x_all = [x_in ; table[halo] * mask ; 0] instead)."""
    R, K, bn, _ = blk_vals.shape
    D = x_in.shape[1]
    xs = x_in[xrow.long()]                          # [R, K, bn, D]
    ts = table[trow.long()]
    s = sel[..., None]
    g = torch.where(s == 0, xs, torch.where(s == 1, ts, torch.zeros_like(ts)))
    out = torch.einsum("rkab,rkbd->rad", blk_vals, g)
    return out.reshape(R * bn, D)
