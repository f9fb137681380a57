"""Transformer serving for dense configs: prefill and KV-cache decode.

The port of `repro.models.transformer`'s inference path. Params keep the
reference's tree: `embed` [V, D], `segs` (one dict per repeating segment
of the layer pattern, `{"0": layer params stacked on a leading [reps]
axis}`), `final_norm` and `lm_head` [D, V]. The reference scans each
segment with `jax.lax.scan`; here a Python loop walks the stacked layers
(inference only: no remat, no scan).

    get_config -> init_params -> prefill -> decode_step (-> decode_step ...)
    init_cache, forward

The cache is `{"pos": int, "segs": [{"0": {"k", "v": [reps, B, Sc, Kh,
Dh]}}, ...]}`, with `pos` a host integer (the reference holds an int32
scalar), so a decode step needs no device-to-host sync to pick the
rolling buffer's branch. `decode_step` writes the new token's k / v into
the cache it is given, in place, and returns the same tensors: the cache
passed in is consumed. Layer types `moe`, `cross` and `rec`, and the
`audio` family, are not ported (ROADMAP Queue A item A9).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..core.config import resolve_device
from .attention import attention_decode, attention_forward, init_attention
from .common import (Params, dense_init, embed_init, init_layernorm,
                     init_mlp, init_rmsnorm, layernorm, mlp, rmsnorm)

_PORTED_LAYERS = ("dense", "local")


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue A "
                               "item A9)")


def _check_layer(ltype: str) -> None:
    if ltype not in _PORTED_LAYERS:
        raise _unported(f"layer type {ltype!r}")


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.family == "audio":
        raise _unported("the audio family (frame inputs, learned positions)")
    for lt in cfg.layer_types():
        _check_layer(lt)


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
    _check_layer(ltype)
    dt, dev = cfg.activation_dtype, gen.device
    return {"n1": _init_norm(cfg, dt, dev),
            "attn": init_attention(gen, cfg.d_model, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.head_dim_,
                                   qkv_bias=cfg.qkv_bias,
                                   qk_norm=cfg.qk_norm, dtype=dt),
            "n2": _init_norm(cfg, dt, dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dt)}


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


# ---------------------------------------------------------------------------
# Per-layer forward (prefill) and decode
# ---------------------------------------------------------------------------

def apply_layer(p: Params, x: torch.Tensor, ctx: Dict[str, Any],
                cfg: ArchConfig, ltype: str,
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (x, decode cache or None)."""
    _check_layer(ltype)
    T = x.shape[1]
    h, c = attention_forward(
        p["attn"], _norm(cfg, p["n1"], x), num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
        positions=ctx["positions"], causal=cfg.causal,
        window=_window(cfg, ltype), rope_theta=cfg.rope_theta,
        use_rope=cfg.use_rope)
    x = x + h
    cache = None
    if cache_len is not None:
        cache = _to_decode_cache(c, T, cfg.decode_cache_len(cache_len, ltype))
    x = x + mlp(p["mlp"], _norm(cfg, p["n2"], x), cfg.act)
    return x, cache


def decode_layer(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 ctx: Dict[str, Any], cfg: ArchConfig, ltype: str
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    _check_layer(ltype)
    h, c = attention_decode(
        p["attn"], _norm(cfg, p["n1"], x), cache, ctx["pos"],
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta,
        use_rope=cfg.use_rope)
    x = x + h
    return x + mlp(p["mlp"], _norm(cfg, p["n2"], x), cfg.act), c


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------

def _stack(trees: List[Params]) -> Params:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Params:
    """Random params in the reference's tree and distributions (normal
    weights scaled by 1/sqrt(fan-in), embeddings and lm_head by 0.02,
    norms at one, biases at zero), in `cfg.activation_dtype`, drawn from
    a `torch.Generator` seeded with `seed` on `device` (None: "cuda")."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = cfg.activation_dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: Params = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                          dt)}
    params["segs"] = [
        _stack([{str(i): init_layer(gen, cfg, lt)
                 for i, lt in enumerate(pattern)} for _ in range(reps)])
        for pattern, reps in cfg.segments()]
    params["final_norm"] = _init_norm(cfg, dt, dev)
    params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                   scale=0.02)
    return params


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
    """Run every layer. Returns (x, the decode cache's segs or None)."""
    caches = None
    if cache_len is not None:
        caches = _build_cache(cfg, x.shape[0], cache_len, x.device,
                              torch.zeros)["segs"]
        views = [lc for _, lc in _layers(cfg, caches)]
    for n, (lt, lp) in enumerate(_layers(cfg, params["segs"])):
        x, c = apply_layer(lp, x, ctx, cfg, lt, cache_len)
        if caches is not None:
            for name, a in c.items():
                views[n][name].copy_(a)
    return x, caches


def _embed_inputs(params: Params, cfg: ArchConfig, batch: Dict[str, Any]):
    embed = params["embed"]
    tokens = torch.as_tensor(batch["tokens"], device=embed.device)
    x = embed[tokens.long()]
    T = x.shape[1]
    return x, {"positions": torch.arange(T, dtype=torch.int32,
                                         device=embed.device)}


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def forward(params: Params, cfg: ArchConfig, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Logits [B, T, V] for `batch["tokens"]` [B, T], and the reference's
    aux losses (zero for dense stacks)."""
    _check_supported(cfg)
    x, ctx = _embed_inputs(params, cfg, batch)
    x, _ = _run_segments(params, x, ctx, cfg, cache_len=None)
    logits = _norm(cfg, params["final_norm"], x) @ params["lm_head"]
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, {"load_balance_loss": zero, "z_loss": zero.clone()}


def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, Any],
            cache_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(last-position logits [B, V], decode cache) for `batch["tokens"]`
    [B, T]; each layer's cache holds `cfg.decode_cache_len(cache_len)`
    slots (cache_len defaults to T)."""
    _check_supported(cfg)
    x, ctx = _embed_inputs(params, cfg, batch)
    T = x.shape[1]
    cache_len = cache_len or T
    x, caches = _run_segments(params, x, ctx, cfg, cache_len=cache_len)
    x = _norm(cfg, params["final_norm"], x[:, -1:])
    return x[:, -1, :] @ params["lm_head"], {"pos": T, "segs": caches}


def decode_step(params: Params, cfg: ArchConfig, cache: Dict[str, Any],
                token: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """token: [B, 1] int. Returns (logits [B, V], cache at pos + 1). The
    cache passed in is consumed: its tensors take the new token's k / v in
    place and are the returned cache's."""
    _check_supported(cfg)
    pos = int(cache["pos"])
    embed = params["embed"]
    x = embed[torch.as_tensor(token, device=embed.device).long()]
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
    _check_layer(ltype)
    dt = cfg.activation_dtype
    Sc = cfg.decode_cache_len(seq_len, ltype)
    shape = (B, Sc, cfg.num_kv_heads, cfg.head_dim_)
    return {"k": (shape, dt), "v": (shape, dt)}


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


def init_cache(cfg: ArchConfig, B: int, seq_len: int, device=None
               ) -> Dict[str, Any]:
    """A zero cache for `seq_len` positions, at pos = seq_len (the
    reference's convention: the context counts as seen)."""
    _check_supported(cfg)
    cache = _build_cache(cfg, B, seq_len, resolve_device(device),
                         torch.zeros)
    cache["pos"] = seq_len
    return cache
