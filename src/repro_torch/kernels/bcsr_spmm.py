"""Block-CSR SpMM: `bcsr_spmm`, the layer-0 GAS aggregation.

Replaces `src/repro/kernels/bcsr_spmm.py:42 bcsr_spmm`. On CUDA tensors it
launches `csrc/bcsr_spmm.cu` (a warp per output row streams that row of
its K blocks once through a shared-memory ring, queues the nonzero
entries, and multiplies only those, each against its staged row, into
f32 sums in registers, in the plain version's order; one column tile up
to D = 512; bound by bytes, the blocks as stored, against 2*D f32
operations per nonzero entry: `csrc/block_spmm.cuh`); on CPU tensors it
runs the plain version `ref.bcsr_spmm_ref`.

The one place where the kernel departs from the plain version and the
reference: they compute 0 * inf = NaN, while the kernel skips zero
entries, so a non-finite row of x that only zero entries reach does not
spread into the output (no GAS path feeds non-finite rows).
"""
from __future__ import annotations

import torch

from . import _build as B
from .ref import bcsr_spmm_ref

__all__ = ["bcsr_spmm", "bcsr_spmm_ref", "check_blocks"]

BN = 128


def check_blocks(name: str, blk_vals: torch.Tensor,
                 blk_cols: torch.Tensor) -> None:
    B.require_dtype(name, blk_vals, torch.float32, "blk_vals")
    B.require_dtype(name, blk_cols, torch.int32, "blk_cols")
    if blk_vals.dim() != 4 or blk_vals.shape[2:] != (BN, BN):
        raise ValueError(f"{name}: blk_vals must be [R, K, {BN}, {BN}], "
                         f"got {tuple(blk_vals.shape)}")
    if blk_cols.shape != blk_vals.shape[:2]:
        raise ValueError(f"{name}: blk_cols {tuple(blk_cols.shape)} != "
                         f"{tuple(blk_vals.shape[:2])}")
    if blk_vals.data_ptr() % 16:
        raise ValueError(f"{name}: blk_vals must be 16-byte aligned")


def bcsr_spmm(x: torch.Tensor, blk_vals: torch.Tensor,
              blk_cols: torch.Tensor) -> torch.Tensor:
    """out [R*128, D] f32 = A @ x with A given as BCSR blocks
    (blk_vals [R, K, 128, 128], blk_cols [R, K]). x [n_x, D] f32 needs no
    padding: rows past n_x and columns past D are masked in the kernel.
    The kernel multiplies the nonzero entries only: a non-finite x row
    that only zero entries reach stays out of the output (the plain
    version gives NaN there)."""
    if all(t.device.type == "cpu" for t in (x, blk_vals, blk_cols)):
        return bcsr_spmm_ref(x, blk_vals, blk_cols)
    name = "bcsr_spmm"
    dev = B.require_cuda(name, x, blk_vals, blk_cols)
    B.require_dtype(name, x, torch.float32, "x")
    check_blocks(name, blk_vals, blk_cols)
    R, K = blk_cols.shape
    n_x, d = x.shape
    out = torch.empty((R * BN, d), dtype=torch.float32, device=dev)
    B.check(B.lib().repro_bcsr_spmm_f32(
        x.data_ptr(), n_x, d, blk_vals.data_ptr(), blk_cols.data_ptr(), R,
        K, out.data_ptr(), B.stream_ptr(dev)), name)
    B.launch_counts[name] += 1
    return out
