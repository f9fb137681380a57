"""GQA decode attention for one token over a KV cache: `flash_decode`.

Replaces `src/repro/kernels/decode_attn.py:67 flash_decode`. On CUDA
tensors it launches its kernel in `csrc/decode_attn.cu` (split over the
valid slots, one CTA per (b, h, group tile, chunk), then a fold of the
chunks; in bf16 a few long chunks sized from the SM count, streamed
through a ring of k / v tiles in shared memory and scored on the tensor
cores; the design and the bound are in the source's head); on CPU
tensors it runs its plain version `ref.flash_decode_ref`.
The layouts are the reference's: q [B, Kh, G, Dh] (roped, one token), k
and v [B, S, Kh, Dh]. `pos` is the decode position as a host integer, so
the masked tail is known before the launch and never read. Unlike the
Pallas kernel, any S is taken (no `S % block_s == 0`).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build as B
from .ref import flash_decode_ref, flash_decode_valid

__all__ = ["flash_decode", "flash_decode_ref", "flash_decode_plan"]

_SYMBOL = {torch.float32: "repro_flash_decode_f32",
           torch.bfloat16: "repro_flash_decode_bf16"}
_HEAD_DIMS = (32, 64, 128, 256)
# bf16: slots per ring stage (the chunks are whole tiles), the CTAs one SM
# holds (a 128 KB ring each at Dh = 128) and the most group members one
# CTA takes (the M of the tensor cores' m16n8k16)
TILE, CTAS_PER_SM, MAX_GROUP_TILE = 64, 1, 16
# f32 (tests and the CPU comparison): slots a chunk takes, 32 for each of
# its CTA's 8 warps
F32_CHUNK = 256


def flash_decode_plan(B_: int, Kh: int, G: int, n_valid: int, n_sm: int,
                      dtype: torch.dtype = torch.bfloat16):
    """(gt, n_splits, chunk): the group tile and the cut of the valid
    slots into n_splits chunks of `chunk` (the last one shorter, none
    empty). bf16: the whole group in one tile (tiles of MAX_GROUP_TILE
    past it), and as many splits as fill the card's `n_sm` SMs with
    CTAS_PER_SM CTAs each in one wave (at least one, at most one per
    TILE valid slots), each chunk a whole number of tiles. f32: the
    smallest power of two >= min(G, 8) members, chunks of F32_CHUNK."""
    if dtype == torch.float32:
        gt = 1
        while gt < min(G, 8):
            gt *= 2
        chunk = min(F32_CHUNK, n_valid)
        return gt, -(-n_valid // chunk), chunk
    gt = min(G, MAX_GROUP_TILE)
    pairs = B_ * Kh * -(-G // gt)
    splits = max(1, min(CTAS_PER_SM * n_sm // pairs, -(-n_valid // TILE)))
    per_split = -(-n_valid // splits)
    chunk = -(-per_split // TILE) * TILE
    return gt, -(-n_valid // chunk), chunk


_SM_COUNT = {}


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _SM_COUNT:
        _SM_COUNT[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SM_COUNT[dev.index]


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: int, scale: Optional[float] = None) -> torch.Tensor:
    """out [B, Kh, G, Dh] in q's type = softmax(q k^T * scale) v over the
    cache slots up to `pos` (all of them once pos >= S); `scale` defaults
    to Dh^-0.5, as the Pallas kernel's."""
    pos = int(pos)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_decode_ref(q, k, v, pos, scale)
    name = "flash_decode"
    dev = B.require_cuda(name, q, k, v)
    if q.dtype not in _SYMBOL:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    B.require_dtype(name, k, q.dtype, "k")
    B.require_dtype(name, v, q.dtype, "v")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q [B, Kh, G, Dh] and k, v [B, S, Kh, "
                         f"Dh], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b_, kh, g, dh = q.shape
    s = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b_, kh, dh) or s == 0:
        raise ValueError(f"{name}: k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {dh} not in {_HEAD_DIMS}")
    scale = dh ** -0.5 if scale is None else float(scale)
    n_valid = flash_decode_valid(pos, s)
    gt, n_splits, chunk = flash_decode_plan(b_, kh, g, n_valid,
                                            _sm_count(dev), q.dtype)
    pairs = b_ * kh * (-(-g // gt))
    part = torch.empty((pairs, n_splits, gt, dh + 2), dtype=torch.float32,
                       device=dev)
    out = torch.empty_like(q)
    B.check(getattr(B.lib(), _SYMBOL[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), part.data_ptr(),
        out.data_ptr(), b_, s, kh, g, dh, gt, n_valid, n_splits, chunk,
        scale, B.stream_ptr(dev)), name)
    B.launch_counts[name] += 1
    return out
