"""GQA attention (prefill and decode) with RoPE, qk-norm, bias and
sliding windows.

The port of `repro.models.attention`. The prefill path is plain tensor
code, as the reference's is (plain jnp outside any Pallas kernel): a
blockwise softmax over query blocks, so a long prefill never holds the
whole [T, T] score matrix. The decode path writes the new token's roped
k / v into the cache in place and runs its attention in the
`flash_decode` kernel (`kernels/decode_attn.py`). Cross-attention and the
seq-GAS `attention_with_history` are not ported (ROADMAP Queue A item A9).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..kernels.decode_attn import flash_decode
from .common import Params, apply_rope, dense_init, init_rmsnorm, rmsnorm

NEG_INF = -1e30


def init_attention(gen: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, *,
                   qkv_bias: bool = False, qk_norm: bool = False,
                   dtype=torch.float32) -> Params:
    dev = gen.device
    p: Params = {
        "wq": dense_init(gen, d_model, num_heads * head_dim, dtype),
        "wk": dense_init(gen, d_model, num_kv_heads * head_dim, dtype),
        "wv": dense_init(gen, d_model, num_kv_heads * head_dim, dtype),
        "wo": dense_init(gen, num_heads * head_dim, d_model, dtype),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((num_heads * head_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((num_kv_heads * head_dim,), dtype=dtype,
                              device=dev)
        p["bv"] = torch.zeros((num_kv_heads * head_dim,), dtype=dtype,
                              device=dev)
    if qk_norm:
        p["q_norm"] = init_rmsnorm(head_dim, dtype, dev)
        p["k_norm"] = init_rmsnorm(head_dim, dtype, dev)
    return p


def _project_qkv(p: Params, x: torch.Tensor, num_heads: int,
                 num_kv_heads: int, head_dim: int):
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(*x.shape[:-1], num_heads, head_dim)
    k = k.reshape(*x.shape[:-1], num_kv_heads, head_dim)
    v = v.reshape(*x.shape[:-1], num_kv_heads, head_dim)
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B,T,Kh,G,Dh], k: [B,S,Kh,Dh] -> scores [B,Kh,G,T,S]."""
    return torch.einsum("btkgd,bskd->bkgts", q, k)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: [B,Kh,G,T,S], v: [B,S,Kh,Dh] -> [B,T,Kh,G,Dh]."""
    return torch.einsum("bkgts,bskd->btkgd", probs, v)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: int) -> torch.Tensor:
    """Additive f32 bias [Tq, Sk] from absolute positions."""
    diff = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if window > 0:
        ok &= diff < window
    zero = torch.zeros((), dtype=torch.float32, device=diff.device)
    return torch.where(ok, zero, NEG_INF)


def attention_forward(p: Params, x: torch.Tensor, *, num_heads: int,
                      num_kv_heads: int, head_dim: int,
                      positions: torch.Tensor, causal: bool = True,
                      window: int = 0, rope_theta: float = 10000.0,
                      use_rope: bool = True, q_block: int = 1024
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence self-attention (serving prefill). x: [B, T, D];
    positions: [T] int32. Returns (out [B, T, D], cache {k, v} of the
    *roped* keys and values [B, T, Kh, Dh]), which the prefill hands to
    the decode step."""
    B, T, _ = x.shape
    G = num_heads // num_kv_heads
    q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim)
    if use_rope:
        q = apply_rope(q, positions[None, :], rope_theta)
        k = apply_rope(k, positions[None, :], rope_theta)
    q = q.reshape(B, T, num_kv_heads, G, head_dim) * (head_dim ** -0.5)

    # T <= q_block: one block, the reference's first branch; else its
    # loop over query blocks (it pads the last block, whose padded rows it
    # drops; here the last block is shorter)
    outs = []
    for i in range(0, T, q_block):
        bias = _mask_bias(positions[i:i + q_block], positions, causal=causal,
                          window=window)
        s = _gqa_scores(q[:, i:i + q_block], k).to(torch.float32) + bias
        probs = torch.softmax(s, dim=-1).to(v.dtype)
        del s
        outs.append(_gqa_out(probs, v))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    out = out.reshape(B, T, num_heads * head_dim) @ p["wo"]
    return out, {"k": k, "v": v}


def attention_decode(p: Params, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], pos: int, *,
                     num_heads: int, num_kv_heads: int, head_dim: int,
                     rope_theta: float = 10000.0, use_rope: bool = True,
                     cross: bool = False
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode. x: [B, 1, D]; cache {k, v}: [B, Sc, Kh, Dh];
    pos: host int, the absolute position of the new token. For windowed
    attention the cache is a rolling buffer of size Sc == window.

    The new k / v go into slot pos % Sc of the cache IN PLACE (the
    reference returns an updated copy; a copy of a multi-GB cache per
    token would dominate decode), and the returned cache is the same
    tensors. q is scaled by Dh^-0.5 in its own type before the scores, as
    the reference does, and the kernel runs with scale 1."""
    if cross:
        raise NotImplementedError(
            "cross-attention decode is not ported yet (ROADMAP Queue A "
            "item A9)")
    B = x.shape[0]
    Sc = cache["k"].shape[1]
    G = num_heads // num_kv_heads
    q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim)
    if use_rope:
        # a fill on the device: no host-to-device copy per layer
        pos_t = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos_t, rope_theta)
        k = apply_rope(k, pos_t, rope_theta)
    slot = pos % Sc
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    q = q.reshape(B, num_kv_heads, G, head_dim) * (head_dim ** -0.5)
    out = flash_decode(q, cache["k"], cache["v"], pos, scale=1.0)
    return out.reshape(B, 1, num_heads * head_dim) @ p["wo"], cache
