"""GQA attention (train, prefill and decode) with RoPE, qk-norm, bias,
sliding windows and cross-attention.

The port of `repro.models.attention`. The full-sequence path is plain
tensor code, as the reference's is (plain jnp outside any Pallas kernel):
a blockwise softmax over query blocks, so a long prefill never holds the
whole [T, T] score matrix. `attention_with_history` is seq-GAS's chunk
attention over pulled K/V. The decode path writes the new token's roped
k / v into the cache in place and runs its attention in the
`flash_decode` kernel (`kernels/decode_attn.py`); cross-attention decode
runs the same kernel over the image K/V, every slot valid. The
reference's `unroll_q` (it unrolls the query-block loop so that XLA's cost
model counts every block) has no meaning here: the loop is a Python loop.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def _project_q(p: Params, x: torch.Tensor, num_heads: int,
               head_dim: int) -> torch.Tensor:
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(*x.shape[:-1], num_heads, head_dim)
    return rmsnorm(p["q_norm"], q) if "q_norm" in p else q


def _project_kv(p: Params, kv_x: torch.Tensor, num_kv_heads: int,
                head_dim: int):
    k = kv_x @ p["wk"]
    v = kv_x @ p["wv"]
    if "bq" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(*kv_x.shape[:-1], num_kv_heads, head_dim)
    v = v.reshape(*kv_x.shape[:-1], num_kv_heads, head_dim)
    if "k_norm" in p:
        k = rmsnorm(p["k_norm"], k)
    return k, v


def _project_qkv(p: Params, x: torch.Tensor, kv_x: torch.Tensor,
                 num_heads: int, num_kv_heads: int, head_dim: int):
    return (_project_q(p, x, num_heads, head_dim),
            *_project_kv(p, kv_x, num_kv_heads, head_dim))


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
                      use_rope: bool = True,
                      kv_x: Optional[torch.Tensor] = None,
                      kv_positions: Optional[torch.Tensor] = None,
                      q_block: int = 1024
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention (training forward, serving prefill). x:
    [B, T, D]; positions: [T] int32. `kv_x` [B, S, D] given: cross
    attention over it, with no RoPE and no causal mask. Returns (out [B,
    T, D], cache {k, v} of the *roped* keys and values [B, S, Kh, Dh]),
    which the prefill hands to the decode step."""
    B, T, _ = x.shape
    cross = kv_x is not None
    kv_x = x if kv_x is None else kv_x
    kv_positions = positions if kv_positions is None else kv_positions
    G = num_heads // num_kv_heads
    q, k, v = _project_qkv(p, x, kv_x, num_heads, num_kv_heads, head_dim)
    if use_rope and not cross:
        q = apply_rope(q, positions[None, :], rope_theta)
        k = apply_rope(k, kv_positions[None, :], rope_theta)
    q = q.reshape(B, T, num_kv_heads, G, head_dim) * (head_dim ** -0.5)

    # T <= q_block: one block, the reference's first branch; else its
    # loop over query blocks (it pads the last block, whose padded rows it
    # drops; here the last block is shorter)
    outs = []
    for i in range(0, T, q_block):
        bias = _mask_bias(positions[i:i + q_block], kv_positions,
                          causal=causal and not cross, window=window)
        s = _gqa_scores(q[:, i:i + q_block], k).to(torch.float32) + bias
        probs = torch.softmax(s, dim=-1).to(v.dtype)
        del s
        outs.append(_gqa_out(probs, v))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    out = out.reshape(B, T, num_heads * head_dim) @ p["wo"]
    return out, {"k": k, "v": v}


def attention_with_history(p: Params, x: torch.Tensor, *, num_heads: int,
                           num_kv_heads: int, head_dim: int,
                           positions: torch.Tensor,
                           hist_k: Optional[torch.Tensor],
                           hist_v: Optional[torch.Tensor],
                           hist_positions: Optional[torch.Tensor],
                           window: int = 0, rope_theta: float = 10000.0,
                           use_rope: bool = True, causal: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """GAS-for-sequences attention: the current chunk attends to itself
    plus historical K/V pulled from the sequence history (already
    projected and roped, the paper's H-bar layout), causally unless
    `causal` is False.

    x: [B, C, D] the chunk; hist_k / hist_v: [B, Th, Kh, Dh] or None, at
    `hist_positions` [Th]. Returns (out, k_chunk, v_chunk): the chunk's
    K/V, which the caller pushes (the paper's push after compute)."""
    B, C, _ = x.shape
    G = num_heads // num_kv_heads
    q, k, v = _project_qkv(p, x, x, num_heads, num_kv_heads, head_dim)
    if use_rope:
        q = apply_rope(q, positions[None, :], rope_theta)
        k = apply_rope(k, positions[None, :], rope_theta)

    if hist_k is not None and hist_k.shape[1] > 0:
        k_all = torch.cat([hist_k, k], dim=1)
        v_all = torch.cat([hist_v, v], dim=1)
        kv_pos = torch.cat([hist_positions, positions])
    else:
        k_all, v_all, kv_pos = k, v, positions

    qh = q.reshape(B, C, num_kv_heads, G, head_dim) * (head_dim ** -0.5)
    bias = _mask_bias(positions, kv_pos, causal=causal, window=window)
    scores = _gqa_scores(qh, k_all).to(torch.float32) + bias
    probs = torch.softmax(scores, dim=-1).to(v_all.dtype)
    out = _gqa_out(probs, v_all).reshape(B, C, num_heads * head_dim) \
        @ p["wo"]
    return out, k, v


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
    the reference does, and the kernel runs with scale 1.

    `cross`: the cache holds the image K/V; every slot is valid (the
    kernel runs at pos = Sc) and nothing is written to it (the reference
    projects the token's k / v there and drops them; here they are not
    computed)."""
    B = x.shape[0]
    Sc = cache["k"].shape[1]
    G = num_heads // num_kv_heads
    if cross:
        q = _project_q(p, x, num_heads, head_dim)
        if use_rope:
            pos_t = torch.full((1, 1), pos, dtype=torch.int32,
                               device=x.device)
            q = apply_rope(q, pos_t, rope_theta)
        q = q.reshape(B, num_kv_heads, G, head_dim) * (head_dim ** -0.5)
        out = flash_decode(q, cache["k"], cache["v"], Sc, scale=1.0)
        return out.reshape(B, 1, num_heads * head_dim) @ p["wo"], cache
    q, k, v = _project_qkv(p, x, x, num_heads, num_kv_heads, head_dim)
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
