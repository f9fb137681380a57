"""Mixture-of-Experts layer: top-k router and GShard-style capacity
dispatch.

The port of `repro.models.moe`, plain tensor code as the reference's is:
tokens in groups [G, Sg, D]; top-k routing with a capacity of C =
max(ceil(Sg * k / E * capacity_factor), 4) tokens per expert and group,
choices taken in priority order (every token's first choice, then every
second choice, ...), overflow dropped (its residual passes through
upstream); dense one-hot dispatch and combine [G, Sg, E, C]; the GShard
load-balance loss and the router z-loss.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .common import ACTIVATIONS, Params, dense_init, randn


def init_moe(gen: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, dtype=torch.float32) -> Params:
    scale = 1.0 / math.sqrt(d_model)
    return {
        "router": dense_init(gen, d_model, num_experts, torch.float32),
        "w_gate": (randn(gen, (num_experts, d_model, d_ff)) * scale
                   ).to(dtype),
        "w_up": (randn(gen, (num_experts, d_model, d_ff)) * scale).to(dtype),
        "w_down": (randn(gen, (num_experts, d_ff, d_model))
                   * (1.0 / math.sqrt(d_ff))).to(dtype),
    }


def moe_capacity(group_size: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    c = int(math.ceil(group_size * top_k / num_experts * capacity_factor))
    return max(c, 4)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot over the last axis, all zeros where idx >= n (as
    `jax.nn.one_hot`; `F.one_hot` raises there)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def moe_forward(p: Params, x: torch.Tensor, *, num_experts: int, top_k: int,
                capacity_factor: float = 1.25, act: str = "silu",
                group_size: int = 2048
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, T, D] -> (out [B, T, D], aux {load_balance_loss, z_loss})."""
    B, T, D = x.shape
    E, K = num_experts, top_k
    N = B * T
    Sg = min(group_size, N)
    G = N // Sg
    assert G * Sg == N, f"tokens {N} not divisible by group {Sg}"
    xg = x.reshape(G, Sg, D)
    C = moe_capacity(Sg, E, K, capacity_factor)

    logits = xg.to(torch.float32) @ p["router"]                   # [G,Sg,E]
    probs = torch.softmax(logits, dim=-1)
    # torch.topk does not promise lax.top_k's order among equal values;
    # router probabilities from continuous inputs do not tie
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)             # [G,Sg,K]
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    # capacity: the (s, k) choices flattened in priority order (k, s)
    sel = _one_hot(gate_idx, E)                                    # [G,Sg,K,E]
    sel_flat = sel.transpose(1, 2).reshape(G, K * Sg, E)
    pos_flat = torch.cumsum(sel_flat, dim=1) - sel_flat            # place in expert
    pos = pos_flat.reshape(G, K, Sg, E).transpose(1, 2)            # [G,Sg,K,E]
    in_cap = (pos < C).to(torch.float32)
    pos_idx = torch.sum(pos * sel, dim=-1).to(torch.int64)         # [G,Sg,K]
    keep = torch.sum(sel * in_cap, dim=-1)                         # [G,Sg,K]

    cap_onehot = _one_hot(pos_idx, C)                              # [G,Sg,K,C]
    combine = torch.einsum("gske,gsk,gskc->gsec", sel, gate_vals * keep,
                           cap_onehot)                             # [G,Sg,E,C]
    dispatch = (combine > 0.0).to(x.dtype)

    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)              # [G,E,C,D]
    h = ACTIVATIONS[act](torch.einsum("gecd,edf->gecf", xe, p["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", xe, p["w_up"])
    ye = torch.einsum("gecf,efd->gecd", h, p["w_down"])            # [G,E,C,D]
    out = torch.einsum("gsec,gecd->gsd", combine.to(ye.dtype), ye)

    # load balance (GShard): E * sum_e f_e P_e; router z-loss
    me = torch.mean(probs, dim=1)                                  # [G,E]
    ce = torch.mean(_one_hot(gate_idx[..., 0], E), dim=1)
    lb_loss = torch.mean(torch.sum(me * ce, dim=-1)) * E
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return out.reshape(B, T, D), {"load_balance_loss": lb_loss,
                                  "z_loss": z_loss}
