"""Model assembly for every architecture family: training forward and
loss, prefill and KV-cache decode.

The port of `repro.models.transformer`. Params keep the reference's tree:
`embed` [V, D] (not in the `audio` family, whose inputs are frames),
`pos_embed` [P, D] where `learned_pos`, `segs` (one dict per repeating
segment of the layer pattern, `{"0": layer params stacked on a leading
[reps] axis, ...}`), `final_norm` and `lm_head` [D, V]. The reference
scans each segment with `jax.lax.scan`; here a Python loop walks the
stacked layers. Layer types: `dense` and `local` (attention and MLP),
`moe` (attention and a routed MoE), `cross` (tanh-gated cross-attention
over `image_embeds` and MLP) and `rec` (Griffin's RG-LRU block and MLP).

    get_config -> init_params -> forward / loss_fn
                              -> prefill -> decode_step (-> decode_step ...)
    init_cache, abstract_params, cache_specs

Under autograd with `cfg.remat` each layer runs under
`torch.utils.checkpoint` (non-reentrant): the backward recomputes it.
`remat_policy="dots"` (the reference saves the matmul outputs) has no
PyTorch counterpart and remats the whole layer as "full" does; "none"
turns remat off.

The cache is `{"pos": int, "segs": [{"0": {...}}, ...]}`: per layer
`{"k", "v": [reps, B, Sc, Kh, Dh]}` for attention layers (the image K/V
for `cross`), `{"h": f32 [reps, B, W], "conv": [reps, B, Wc-1, W]}` for
`rec`, with `pos` a host integer (the reference holds an int32 scalar),
so a decode step needs no device-to-host sync to pick the rolling
buffer's branch. `decode_step` writes the new token's k / v and the new
recurrent states into the cache it is given, in place, and returns the
same tensors: the cache passed in is consumed. `abstract_params`,
`cache_specs` and `configs.base.input_specs` give meta tensors, which
allocate nothing.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.config import resolve_device
from . import rglru as rg
from .attention import attention_decode, attention_forward, init_attention
from .common import (META, Params, chunked_cross_entropy, cross_entropy_loss,
                     dense_init, embed_init, init_layernorm, init_mlp,
                     init_rmsnorm, layernorm, mlp, rmsnorm)
from .moe import init_moe, moe_forward

_ATTN_TYPES = ("dense", "local", "moe")


# ---------------------------------------------------------------------------
# Norm dispatch and per-layer init
# ---------------------------------------------------------------------------

def _init_norm(cfg: ArchConfig, dtype, device):
    return init_layernorm(cfg.d_model, dtype, device) \
        if cfg.norm == "layernorm" else init_rmsnorm(cfg.d_model, dtype,
                                                     device)


def _norm(cfg: ArchConfig, p, x):
    return layernorm(p, x) if cfg.norm == "layernorm" else rmsnorm(p, x)


def init_layer(gen: torch.Generator, cfg: ArchConfig, ltype: str) -> Params:
    dt, dev, D = cfg.activation_dtype, gen.device, cfg.d_model

    def attn_p():
        return init_attention(gen, D, cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim_, qkv_bias=cfg.qkv_bias,
                              qk_norm=cfg.qk_norm, dtype=dt)

    if ltype in ("dense", "local", "cross"):
        p = {"n1": _init_norm(cfg, dt, dev), "attn": attn_p(),
             "n2": _init_norm(cfg, dt, dev),
             "mlp": init_mlp(gen, D, cfg.d_ff, cfg.gated_mlp, dt)}
        if ltype == "cross":
            p["g_attn"] = torch.zeros((), dtype=torch.float32, device=dev)
            p["g_mlp"] = torch.zeros((), dtype=torch.float32, device=dev)
        return p
    if ltype == "moe":
        return {"n1": _init_norm(cfg, dt, dev), "attn": attn_p(),
                "n2": _init_norm(cfg, dt, dev),
                "moe": init_moe(gen, D, cfg.d_ff, cfg.num_experts, dt)}
    if ltype == "rec":
        return {"n1": _init_norm(cfg, dt, dev),
                "rg": rg.init_rglru_block(gen, D, cfg.lru_width or D,
                                          cfg.conv_width, dt),
                "n2": _init_norm(cfg, dt, dev),
                "mlp": init_mlp(gen, D, cfg.d_ff, cfg.gated_mlp, dt)}
    raise ValueError(f"unknown layer type {ltype}")


def _window(cfg: ArchConfig, ltype: str) -> int:
    return cfg.window if (ltype == "local" or
                          (ltype == "dense" and cfg.window > 0)) else 0


def _to_decode_cache(c: Dict[str, torch.Tensor], T: int, Sc: int):
    """Re-layout a length-T prefill KV cache into a rolling buffer of Sc
    slots: the last Sc positions, position t in slot t % Sc, or the T
    positions followed by zeros."""
    if Sc == T:
        return c
    if Sc < T:
        return {k: torch.roll(a[:, T - Sc:], (T - Sc) % Sc, dims=1)
                for k, a in c.items()}
    return {k: torch.nn.functional.pad(
        a, (0, 0) * (a.dim() - 2) + (0, Sc - T)) for k, a in c.items()}


def _moe(cfg: ArchConfig, p, x):
    return moe_forward(p, x, num_experts=cfg.num_experts, top_k=cfg.top_k,
                       act=cfg.act, capacity_factor=cfg.moe_capacity_factor,
                       group_size=cfg.moe_group)


def _gated(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(g).to(x.dtype)


# ---------------------------------------------------------------------------
# Per-layer forward (train / prefill) and decode
# ---------------------------------------------------------------------------

def apply_layer(p: Params, x: torch.Tensor, ctx: Dict[str, Any],
                cfg: ArchConfig, ltype: str,
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]:
    """Returns (x, decode cache or None, aux: the MoE losses or {})."""
    aux: Dict[str, torch.Tensor] = {}
    T = x.shape[1]
    attn_kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                   head_dim=cfg.head_dim_, positions=ctx["positions"],
                   rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)
    cache = None
    if ltype in _ATTN_TYPES:
        h, c = attention_forward(p["attn"], _norm(cfg, p["n1"], x),
                                 causal=cfg.causal,
                                 window=_window(cfg, ltype), **attn_kw)
        x = x + h
        if cache_len is not None:
            cache = _to_decode_cache(c, T,
                                     cfg.decode_cache_len(cache_len, ltype))
        h2in = _norm(cfg, p["n2"], x)
        if ltype == "moe":
            h2, aux = _moe(cfg, p["moe"], h2in)
        else:
            h2 = mlp(p["mlp"], h2in, cfg.act)
        x = x + h2
    elif ltype == "cross":
        img = ctx["image_embeds"]
        kv_pos = torch.arange(img.shape[1], dtype=torch.int32,
                              device=img.device)
        h, c = attention_forward(p["attn"], _norm(cfg, p["n1"], x),
                                 kv_x=img, kv_positions=kv_pos,
                                 causal=False, **attn_kw)
        x = x + _gated(p["g_attn"], x) * h
        h2 = mlp(p["mlp"], _norm(cfg, p["n2"], x), cfg.act)
        x = x + _gated(p["g_mlp"], x) * h2
        if cache_len is not None:
            cache = c
    elif ltype == "rec":
        h, st = rg.rglru_block_forward(p["rg"], _norm(cfg, p["n1"], x))
        x = x + h
        x = x + mlp(p["mlp"], _norm(cfg, p["n2"], x), cfg.act)
        if cache_len is not None:
            cache = st
    else:
        raise ValueError(ltype)
    return x, cache, aux


def decode_layer(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 ctx: Dict[str, Any], cfg: ArchConfig, ltype: str
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token through one layer; the layer's cache is updated in
    place (a `cross` layer's is read only)."""
    attn_kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                   head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta)
    if ltype in _ATTN_TYPES:
        h, c = attention_decode(p["attn"], _norm(cfg, p["n1"], x), cache,
                                ctx["pos"], use_rope=cfg.use_rope, **attn_kw)
        x = x + h
        h2in = _norm(cfg, p["n2"], x)
        h2 = _moe(cfg, p["moe"], h2in)[0] if ltype == "moe" else \
            mlp(p["mlp"], h2in, cfg.act)
        return x + h2, c
    if ltype == "cross":
        h, c = attention_decode(p["attn"], _norm(cfg, p["n1"], x), cache,
                                ctx["pos"], use_rope=False, cross=True,
                                **attn_kw)
        x = x + _gated(p["g_attn"], x) * h
        h2 = mlp(p["mlp"], _norm(cfg, p["n2"], x), cfg.act)
        return x + _gated(p["g_mlp"], x) * h2, c
    if ltype == "rec":
        h, st = rg.rglru_block_decode(p["rg"], _norm(cfg, p["n1"], x), cache)
        cache["h"].copy_(st["h"])
        cache["conv"].copy_(st["conv"])
        x = x + h
        return x + mlp(p["mlp"], _norm(cfg, p["n2"], x), cfg.act), cache
    raise ValueError(ltype)


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------

def _stack(trees: List[Params]) -> Params:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _init_params(cfg: ArchConfig, gen) -> Params:
    dt, dev = cfg.activation_dtype, gen.device
    params: Params = {}
    if cfg.family != "audio":
        params["embed"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dt)
    if cfg.learned_pos:
        params["pos_embed"] = embed_init(gen, cfg.learned_pos, cfg.d_model,
                                         dt)
    params["segs"] = [
        _stack([{str(i): init_layer(gen, cfg, lt)
                 for i, lt in enumerate(pattern)} for _ in range(reps)])
        for pattern, reps in cfg.segments()]
    params["final_norm"] = _init_norm(cfg, dt, dev)
    params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                   scale=0.02)
    return params


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Params:
    """Random params in the reference's tree and distributions (normal
    weights scaled by 1/sqrt(fan-in), embeddings and lm_head by 0.02, the
    RG-LRU's conv by 0.1 and its lam at 0.7, norms at one, biases and
    cross gates at zero), in `cfg.activation_dtype` (router, gates and
    lam in f32, as the reference's), drawn from a `torch.Generator` seeded
    with `seed` on `device` (None: "cuda")."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return _init_params(cfg, gen)


def abstract_params(cfg: ArchConfig, seed: int = 0) -> Params:
    """The params tree as meta tensors: shapes and dtypes, no allocation
    (for dry runs). `seed` is the reference's signature's; shapes do not
    depend on it."""
    del seed
    return _init_params(cfg, META)


# ---------------------------------------------------------------------------
# Segment execution
# ---------------------------------------------------------------------------

def _unbind(tree: Params, reps: int) -> List[Params]:
    """A tree of stacked [reps, ...] leaves as `reps` trees of views, one
    `unbind` a leaf: writes into a view land in the stacked tensor."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, reps) for k, v in tree.items()}
        return [{k: p[r] for k, p in parts.items()} for r in range(reps)]
    return list(tree.unbind(0))


def _layers(cfg: ArchConfig, tree: List[Params]) -> List[Tuple[str, Params]]:
    """(layer type, that layer's views of `tree`) for every layer in order:
    `tree` is params["segs"] or a cache's "segs"."""
    out = []
    for (pattern, reps), seg in zip(cfg.segments(), tree):
        per = [_unbind(seg[str(i)], reps) for i in range(len(pattern))]
        out += [(lt, per[i][r]) for r in range(reps)
                for i, lt in enumerate(pattern)]
    return out


def _run_segments(params: Params, x: torch.Tensor, ctx: Dict[str, Any],
                  cfg: ArchConfig, cache_len: Optional[int]):
    """Run every layer. Returns (x, aux: the MoE losses summed over the
    layers and divided by their count, the decode cache's segs or None)."""
    dev = x.device
    aux_lb = torch.zeros((), dtype=torch.float32, device=dev)
    aux_z = torch.zeros((), dtype=torch.float32, device=dev)
    caches = None
    if cache_len is not None:
        caches = _build_cache(cfg, x.shape[0], cache_len, dev,
                              torch.zeros)["segs"]
        views = [lc for _, lc in _layers(cfg, caches)]
    remat = (cfg.remat and cfg.remat_policy != "none" and cache_len is None
             and torch.is_grad_enabled())
    for n, (lt, lp) in enumerate(_layers(cfg, params["segs"])):
        if remat:
            x, c, aux = checkpoint(apply_layer, lp, x, ctx, cfg, lt,
                                   use_reentrant=False)
        else:
            x, c, aux = apply_layer(lp, x, ctx, cfg, lt, cache_len)
        if aux:
            aux_lb = aux_lb + aux["load_balance_loss"]
            aux_z = aux_z + aux["z_loss"]
        if caches is not None:
            for name, a in c.items():
                views[n][name].copy_(a)
    # a tensor divisor: on CUDA a Python one becomes a reciprocal multiply
    n_layers = torch.tensor(max(len(cfg.layer_types()), 1),
                            dtype=torch.float32, device=dev)
    aux = {"load_balance_loss": aux_lb / n_layers, "z_loss": aux_z / n_layers}
    return x, aux, caches


def _device(params: Params) -> torch.device:
    return params["lm_head"].device


def _embed_inputs(params: Params, cfg: ArchConfig, batch: Dict[str, Any]):
    dev = _device(params)
    if cfg.family == "audio":
        x = torch.as_tensor(batch["frames"], device=dev).to(
            cfg.activation_dtype)
    else:
        x = params["embed"][torch.as_tensor(batch["tokens"],
                                            device=dev).long()]
    T = x.shape[1]
    if cfg.learned_pos:
        x = x + params["pos_embed"][:T]
    img = batch.get("image_embeds")
    if img is not None:
        img = torch.as_tensor(img, device=dev).to(cfg.activation_dtype)
    return x, {"positions": torch.arange(T, dtype=torch.int32, device=dev),
               "image_embeds": img}


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def forward(params: Params, cfg: ArchConfig, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Logits [B, T, V] for `batch["tokens"]` [B, T] (`"frames"` [B, T, D]
    in the audio family; `"image_embeds"` [B, n, D] for cross layers),
    and the aux losses (zero without MoE layers)."""
    x, ctx = _embed_inputs(params, cfg, batch)
    x, aux, _ = _run_segments(params, x, ctx, cfg, cache_len=None)
    return _norm(cfg, params["final_norm"], x) @ params["lm_head"], aux


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics): CE against `batch["labels"]` (masked by
    `"mask"` where given; vocab-chunked where `cfg.chunked_ce`, never
    holding [tokens, V] f32 logits) + 0.01 load balance + 1e-3 z-loss."""
    mask = batch.get("mask")
    dev = _device(params)
    labels = torch.as_tensor(batch["labels"], device=dev)
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev)
    if cfg.chunked_ce > 0:
        x, ctx = _embed_inputs(params, cfg, batch)
        x, aux, _ = _run_segments(params, x, ctx, cfg, cache_len=None)
        x = _norm(cfg, params["final_norm"], x)
        ce = chunked_cross_entropy(x, params["lm_head"], labels, mask,
                                   cfg.chunked_ce)
    else:
        logits, aux = forward(params, cfg, batch)
        ce = cross_entropy_loss(logits, labels, mask)
    loss = ce + 0.01 * aux["load_balance_loss"] + 1e-3 * aux["z_loss"]
    return loss, {"loss": loss, "ce": ce, **aux}


def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, Any],
            cache_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(last-position logits [B, V], decode cache) for the batch's inputs
    (as `forward`'s); each attention layer's cache holds
    `cfg.decode_cache_len(cache_len)` slots (cache_len defaults to T)."""
    x, ctx = _embed_inputs(params, cfg, batch)
    T = x.shape[1]
    cache_len = cache_len or T
    x, _, caches = _run_segments(params, x, ctx, cfg, cache_len=cache_len)
    x = _norm(cfg, params["final_norm"], x[:, -1:])
    return x[:, -1, :] @ params["lm_head"], {"pos": T, "segs": caches}


def decode_step(params: Params, cfg: ArchConfig, cache: Dict[str, Any],
                token: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """token: [B, 1] int. Returns (logits [B, V], cache at pos + 1). The
    cache passed in is consumed: its tensors take the new token's k / v
    and the new recurrent states in place and are the returned cache's."""
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name}: an encoder-only architecture has no "
                         "decode step")
    pos = int(cache["pos"])
    embed = params["embed"]
    x = embed[torch.as_tensor(token, device=embed.device).long()]
    if cfg.learned_pos:
        x = x + params["pos_embed"][pos:pos + 1]
    ctx = {"pos": pos}
    for (lt, lp), (_, lc) in zip(_layers(cfg, params["segs"]),
                                 _layers(cfg, cache["segs"])):
        x, _ = decode_layer(lp, x, lc, ctx, cfg, lt)
    x = _norm(cfg, params["final_norm"], x)
    return x[:, -1, :] @ params["lm_head"], {"pos": pos + 1,
                                             "segs": cache["segs"]}


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def _layer_cache_struct(cfg: ArchConfig, ltype: str, B: int, seq_len: int):
    dt = cfg.activation_dtype
    Kh, Dh = cfg.num_kv_heads, cfg.head_dim_
    if ltype in _ATTN_TYPES:
        shape = (B, cfg.decode_cache_len(seq_len, ltype), Kh, Dh)
        return {"k": (shape, dt), "v": (shape, dt)}
    if ltype == "cross":
        shape = (B, cfg.num_image_tokens, Kh, Dh)
        return {"k": (shape, dt), "v": (shape, dt)}
    if ltype == "rec":
        W = cfg.lru_width or cfg.d_model
        return {"h": ((B, W), torch.float32),
                "conv": ((B, cfg.conv_width - 1, W), dt)}
    raise ValueError(ltype)


def _build_cache(cfg: ArchConfig, B: int, seq_len: int, device, make):
    segs = []
    for pattern, reps in cfg.segments():
        seg = {}
        for i, lt in enumerate(pattern):
            shapes = _layer_cache_struct(cfg, lt, B, seq_len)
            seg[str(i)] = {k: make((reps,) + s, dtype=d, device=device)
                           for k, (s, d) in shapes.items()}
        segs.append(seg)
    return {"pos": 0, "segs": segs}


def cache_specs(cfg: ArchConfig, B: int, seq_len: int) -> Dict[str, Any]:
    """The decode cache as meta tensors (`pos` a 0-d int32 one, as the
    reference's spec): shapes and dtypes, no allocation."""
    cache = _build_cache(cfg, B, seq_len, "meta", torch.empty)
    cache["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    return cache


def init_cache(cfg: ArchConfig, B: int, seq_len: int, device=None
               ) -> Dict[str, Any]:
    """A zero cache for `seq_len` positions, at pos = seq_len (the
    reference's convention: the context counts as seen)."""
    cache = _build_cache(cfg, B, seq_len, resolve_device(device),
                         torch.zeros)
    cache["pos"] = seq_len
    return cache
