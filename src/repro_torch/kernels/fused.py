"""Fused history-gather + block-CSR SpMM: `gather_plan`, `gather_spmm`.

Replaces `src/repro/kernels/fused.py:203 gather_spmm`, its f32 body
(`_make_kernel` :172, which the reference also runs over bf16 tables), its
int8 body (`_make_kernel_dq` :181) and its vq body (`_make_kernel_vq`
:191). The layer input of a GAS layer
>= 1 is the virtual operand

    x_all = [x_in ; dequant(table)[halo_nodes] * halo_mask ; 0]

which the fused kernel never builds: the gather plan (`gather_plan`, one
entry per adjacency-block row) says where virtual column
`blk_cols[r, k] * 128 + b` lives —

    sel == 0 : in-batch  -> x_in[xrow]
    sel == 1 : halo      -> table[trow]  (read straight out of the history,
                            bf16 upcast, int8 times scales[trow], vq codes
                            decoded against the codebook, times
                            scales[trow])
    sel == 2 : masked halo / dummy / padding -> zeros

On CUDA tensors `gather_spmm` launches `csrc/fused.cu` (the block
contraction of `csrc/block_spmm.cuh`: a warp per output row streams its
block rows once, queues the nonzero entries and multiplies only those,
each against its plan-routed row, dequantized as it is read; sel == 2
rows are never read; bound by bytes, the blocks as stored, as
`bcsr_spmm`); on CPU tensors it runs the plain version
`ref.gather_spmm_ref`. As `bcsr_spmm`, the kernel
skips zero entries, so a non-finite x_in or table row that only zero
entries reach does not spread into the output, where the plain version
computes 0 * inf = NaN: the one place where it departs from it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build as B
from .bcsr_spmm import BN, check_blocks
from .gather import check_codebook
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


_BODIES = {torch.float32: ("repro_gather_spmm_f32", "gather_spmm"),
           torch.bfloat16: ("repro_gather_spmm_bf16", "gather_spmm_bf16"),
           torch.int8: ("repro_gather_spmm_dq", "gather_spmm_dq"),
           torch.uint8: ("repro_gather_spmm_vq", "gather_spmm_vq")}


def gather_spmm(x_in: torch.Tensor, table: torch.Tensor,
                blk_vals: torch.Tensor, blk_cols: torch.Tensor,
                sel: torch.Tensor, xrow: torch.Tensor, trow: torch.Tensor,
                scales: torch.Tensor = None,
                codebook: torch.Tensor = None) -> torch.Tensor:
    """out [R*128, D] f32 = A @ [x_in ; dequant(table)[halo] ; 0] per the
    gather plan. x_in [n_in, D] is f32; table [N, D] is f32, bf16, or int8
    with `scales` [N] f32, or uint8 vq codes [N, D/8] with `scales` [N] f32
    and `codebook` [D/8, 256, 8] f32 (ragged D is masked in the kernel);
    xrow/trow must be pre-clipped to their source's rows (as `gather_plan`
    makes them). An int8 table launches the int8 body (`gather_spmm_dq`),
    a vq table the vq body (`gather_spmm_vq`), the others the f32 one
    (`gather_spmm`). The kernel multiplies the nonzero entries only: a
    non-finite row that only zero entries reach stays out of the output
    (the plain version gives NaN there)."""
    scaled = table.dtype in (torch.int8, torch.uint8)
    if scaled != (scales is not None) or \
            (table.dtype == torch.uint8) != (codebook is not None):
        raise TypeError("gather_spmm: an int8 table needs its scales, a vq "
                        "(uint8) table its scales and codebook, and no "
                        "other table takes either")
    operands = (x_in, table, blk_vals, blk_cols, sel, xrow, trow) + \
        tuple(t for t in (scales, codebook) if t is not None)
    if all(t.device.type == "cpu" for t in operands):
        return gather_spmm_ref(x_in, table, blk_vals, blk_cols, sel, xrow,
                               trow, scales, codebook)
    if table.dtype not in _BODIES:
        raise TypeError(f"gather_spmm: table must be float32, bfloat16, "
                        f"int8 or uint8, got {table.dtype}")
    symbol, name = _BODIES[table.dtype]
    dev = B.require_cuda(name, *operands)
    B.require_dtype(name, x_in, torch.float32, "x_in")
    check_blocks(name, blk_vals, blk_cols)
    R, K = blk_cols.shape
    for t, what in ((sel, "sel"), (xrow, "xrow"), (trow, "trow")):
        B.require_dtype(name, t, torch.int32, what)
        if t.shape != (R, K, BN):
            raise ValueError(f"{name}: {what} {tuple(t.shape)} != "
                             f"{(R, K, BN)}")
    n_in, d = x_in.shape
    width = d // 8 if codebook is not None else d
    if table.dim() != 2 or table.shape[1] != width or \
            (codebook is not None and d % 8):
        raise ValueError(f"{name}: table {tuple(table.shape)} must be "
                         f"[N, {width}] for x_in of width {d}")
    tab = (table.data_ptr(),)
    if scales is not None:
        B.require_dtype(name, scales, torch.float32, "scales")
        if scales.shape != (table.shape[0],):
            raise ValueError(f"{name}: scales {tuple(scales.shape)} != "
                             f"{(table.shape[0],)}")
        tab += (scales.data_ptr(),)
    if codebook is not None:
        check_codebook(name, codebook, width)
        tab += (codebook.data_ptr(),)
    out = torch.empty((R * BN, d), dtype=torch.float32, device=dev)
    B.check(getattr(B.lib(), symbol)(
        x_in.data_ptr(), n_in, *tab, table.shape[0], d,
        blk_vals.data_ptr(), sel.data_ptr(), xrow.data_ptr(),
        trow.data_ptr(), R, K, out.data_ptr(), B.stream_ptr(dev)), name)
    B.launch_counts[name] += 1
    return out
