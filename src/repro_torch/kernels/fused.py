"""Fused history-gather + block-CSR SpMM: `gather_plan`, `gather_spmm`.

Replaces the f32 body of `src/repro/kernels/fused.py:203 gather_spmm`.
The layer input of a GAS layer >= 1 is the virtual operand

    x_all = [x_in ; table[halo_nodes] * halo_mask ; 0]

which the fused kernel never builds: the gather plan (`gather_plan`, one
entry per adjacency-block row) says where virtual column
`blk_cols[r, k] * 128 + b` lives —

    sel == 0 : in-batch  -> x_in[xrow]
    sel == 1 : halo      -> table[trow]  (read straight out of the history)
    sel == 2 : masked halo / dummy / padding -> zeros

On CUDA tensors `gather_spmm` launches `csrc/fused.cu` (the block
contraction of `csrc/block_spmm.cuh` with plan-routed rows; bound by
operations, 2*R*K*128*128*D f32 on the CUDA cores); on CPU tensors it
runs the plain version `ref.gather_spmm_ref`. The reference's int8 and vq
bodies (quantized histories) are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build as B
from .bcsr_spmm import BN, check_blocks
from .ref import gather_spmm_ref

__all__ = ["gather_plan", "gather_spmm", "gather_spmm_ref"]


def gather_plan(blk_cols: torch.Tensor, halo_nodes: torch.Tensor,
                halo_mask: torch.Tensor, n_in: int, n_table: int,
                bn: int = BN
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sel, xrow, trow), each int32 [R, K, bn], from the block column ids
    and the batch's halo index vector — bitwise the reference's plan.
    Plain tensor code on the blocks' device (R*K*bn elements)."""
    dev = blk_cols.device
    row = torch.arange(bn, dtype=torch.int32, device=dev)
    v = blk_cols[:, :, None].to(torch.int32) * bn + row   # virtual column
    max_h = halo_nodes.shape[0]
    is_in = v < n_in
    hidx = torch.clamp(v - n_in, 0, max_h - 1).long()
    halo_ok = (v >= n_in) & (v < n_in + max_h) & halo_mask[hidx]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    xrow = torch.where(is_in, v, zero)
    trow = torch.where(
        halo_ok, torch.clamp(halo_nodes.to(torch.int32)[hidx], 0,
                             n_table - 1), zero)
    sel = torch.where(is_in, zero, torch.where(halo_ok, zero + 1, zero + 2))
    return sel, xrow, trow


def gather_spmm(x_in: torch.Tensor, table: torch.Tensor,
                blk_vals: torch.Tensor, blk_cols: torch.Tensor,
                sel: torch.Tensor, xrow: torch.Tensor, trow: torch.Tensor,
                scales: torch.Tensor = None,
                codebook: torch.Tensor = None) -> torch.Tensor:
    """out [R*128, D] f32 = A @ [x_in ; table[halo] ; 0] per the gather
    plan. x_in [n_in, D] and table [N, D] are f32 of one width D (ragged D
    is masked in the kernel); xrow/trow must be pre-clipped to their
    source's rows (as `gather_plan` makes them)."""
    if scales is not None or codebook is not None:
        raise NotImplementedError(
            "gather_spmm over int8 (scales) or vq (codebook) history tables "
            "is not ported yet (ROADMAP Queue B, quantized histories)")
    if all(t.device.type == "cpu"
           for t in (x_in, table, blk_vals, blk_cols, sel, xrow, trow)):
        return gather_spmm_ref(x_in, table, blk_vals, blk_cols, sel, xrow,
                               trow)
    name = "gather_spmm"
    dev = B.require_cuda(name, x_in, table, blk_vals, blk_cols, sel, xrow,
                         trow)
    B.require_dtype(name, x_in, torch.float32, "x_in")
    B.require_dtype(name, table, torch.float32, "table")
    check_blocks(name, blk_vals, blk_cols)
    R, K = blk_cols.shape
    for t, what in ((sel, "sel"), (xrow, "xrow"), (trow, "trow")):
        B.require_dtype(name, t, torch.int32, what)
        if t.shape != (R, K, BN):
            raise ValueError(f"{name}: {what} {tuple(t.shape)} != "
                             f"{(R, K, BN)}")
    n_in, d = x_in.shape
    if table.dim() != 2 or table.shape[1] != d:
        raise ValueError(f"{name}: table {tuple(table.shape)} must be "
                         f"[N, {d}]")
    out = torch.empty((R * BN, d), dtype=torch.float32, device=dev)
    B.check(B.lib().repro_gather_spmm_f32(
        x_in.data_ptr(), n_in, table.data_ptr(), table.shape[0], d,
        blk_vals.data_ptr(), sel.data_ptr(), xrow.data_ptr(),
        trow.data_ptr(), R, K, out.data_ptr(), B.stream_ptr(dev)), name)
    B.launch_counts[name] += 1
    return out
