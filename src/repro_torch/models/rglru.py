"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)                (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The port of `repro.models.rglru`. Sequence mode scans the affine pairs
(a, b) in log2(T) steps (Hillis-Steele: step s combines each element
with the one s before it), plain tensor code as the reference's
`lax.associative_scan` is plain jnp; decode mode is the single-step
recurrence. The block is Griffin's: a GeLU gate times [conv1d -> RG-LRU],
then the out-projection. The state `h` is f32; the conv buffer is in the
activation dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .common import ACTIVATIONS, Params, dense_init, randn

_C = 8.0


def init_rglru_block(gen: torch.Generator, d_model: int, width: int,
                     conv_width: int = 4, dtype=torch.float32) -> Params:
    dev = gen.device
    return {
        "in_x": dense_init(gen, d_model, width, dtype),
        "in_gate": dense_init(gen, d_model, width, dtype),
        "conv_w": (randn(gen, (conv_width, width)) * 0.1).to(dtype),
        "conv_b": torch.zeros((width,), dtype=dtype, device=dev),
        "w_r": dense_init(gen, width, width, dtype),
        "w_i": dense_init(gen, width, width, dtype),
        # softplus(lam) * c ~ decay rates
        "lam": torch.full((width,), 0.7, dtype=torch.float32, device=dev),
        "out": dense_init(gen, width, d_model, dtype),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, log(1 + e^x) as logaddexp(x, 0) everywhere
    (F.softplus turns linear above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _gates(p: Params, x: torch.Tensor):
    r = torch.sigmoid((x @ p["w_r"]).to(torch.float32))
    i = torch.sigmoid((x @ p["w_i"]).to(torch.float32))
    log_a = -_C * _softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * i * x.to(torch.float32)
    return a, b


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1. a, b: [B, T, W] f32; h0 [B, W]
    or None (zero). ceil(log2 T) steps of whole-tensor products."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    s, T = 1, a.shape[1]
    while s < T:
        # (a1, b1) then (a2, b2) composes to (a2 a1, a2 b1 + b2)
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def rglru_block_forward(p: Params, x: torch.Tensor,
                        state: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, T, D] -> (y [B, T, D], state {h: [B, W] f32, conv: [B, Wc-1,
    W]})."""
    Wc = p["conv_w"].shape[0]
    gate = ACTIVATIONS["gelu"](x @ p["in_gate"])      # tanh approximation
    u = x @ p["in_x"]                                  # [B, T, W]
    T = u.shape[1]
    u_hist = state["conv"] if state is not None else torch.zeros(
        (x.shape[0], Wc - 1, u.shape[-1]), dtype=u.dtype, device=u.device)
    up = torch.cat([u_hist, u], dim=1)
    conv = sum(up[:, i:i + T] * p["conv_w"][i] for i in range(Wc))
    conv = conv + p["conv_b"]

    a, b = _gates(p, conv)
    h = rglru_scan(a, b, state["h"] if state is not None else None)
    y = (h.to(x.dtype) * gate) @ p["out"]
    return y, {"h": h[:, -1], "conv": up[:, -(Wc - 1):].to(u.dtype)}


def rglru_block_decode(p: Params, x: torch.Tensor,
                       state: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, 1, D]; state as above. Returns (y [B, 1, D], the new state
    as new tensors; the caller writes them into its cache)."""
    gate = ACTIVATIONS["gelu"](x @ p["in_gate"])      # [B, 1, W]
    u = x @ p["in_x"]
    buf = torch.cat([state["conv"], u], dim=1)         # [B, Wc, W]
    conv = torch.einsum("bwc,wc->bc", buf, p["conv_w"]) + p["conv_b"]

    a, b = _gates(p, conv[:, None, :])
    h = a[:, 0] * state["h"] + b[:, 0]                 # [B, W] f32
    y = (h[:, None, :].to(x.dtype) * gate) @ p["out"]
    return y, {"h": h, "conv": buf[:, 1:]}
