"""Common building blocks of the transformer substrate.

The port of `repro.models.common`: params are nested dicts of tensors,
`init_*` functions build them from an explicit `torch.Generator` (to the
reference's distributions; the numbers differ, so the tests carry the
reference's params across instead), and the apply functions are plain
tensor code that runs wherever its tensors are.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype = torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """[in_dim, out_dim] ~ N(0, 1) * scale (default 1/sqrt(in_dim)), drawn
    in f32 on the generator's device, then cast to `dtype`."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms (computed in f32, returned in the input's type)
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].to(torch.float32)).to(dtype)


def init_layernorm(dim: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    out = (x * params["scale"].to(torch.float32)
           + params["bias"].to(torch.float32))
    return out.to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """[head_dim/2] f32 `1 / theta ** (2i / head_dim)`, bitwise the
    reference's: the exponents in f32 as it forms them, the power taken
    in f64 and rounded once to f32 (an f32 power in PyTorch lands one ulp
    off on some entries, e.g. 1 of 64 at head_dim 128, theta 1e6), the
    reciprocal in f32; computed on the CPU, then moved."""
    expo = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    base = torch.tensor(theta, dtype=torch.float32).to(torch.float64)
    freqs = 1.0 / (base ** expo.to(torch.float64)).to(torch.float32)
    return freqs.to(device) if device is not None else freqs


@functools.lru_cache(maxsize=None)
def _freqs_on(head_dim: int, theta: float, device: torch.device
              ) -> torch.Tensor:
    """`rope_freqs` kept on `device`: one copy per (width, theta, device),
    not one per call (a decode step applies RoPE twice a layer)."""
    return rope_freqs(head_dim, theta, device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., T, H, Dh]; positions: [..., T] (broadcastable)."""
    head_dim = x.shape[-1]
    freqs = _freqs_on(head_dim, float(theta), x.device)      # [Dh/2]
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]                  # [..., T, 1, Dh/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations and MLP blocks
# ---------------------------------------------------------------------------

def squared_relu(x):
    r = F.relu(x)
    return r * r


ACTIVATIONS = {
    "silu": F.silu,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "squared_relu": squared_relu,
}


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             gated: bool = True, dtype=torch.float32) -> Params:
    p: Params = {"up": dense_init(gen, d_model, d_ff, dtype),
                 "down": dense_init(gen, d_ff, d_model, dtype)}
    if gated:
        p["gate"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def mlp(params: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    act_fn = ACTIVATIONS[act]
    up = x @ params["up"]
    if "gate" in params:
        up = act_fn(x @ params["gate"]) * up
    else:
        up = act_fn(up)
    return up @ params["down"]
