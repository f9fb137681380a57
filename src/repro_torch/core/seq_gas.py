"""GAS-for-sequences: the paper's historical-embedding scheme applied to
the transformer architectures along the SEQUENCE axis.

The port of `repro.core.seq_gas`. A transformer layer is message passing
on a (banded-)complete token graph; contiguous chunks of the sequence are
that graph's clusters. Training processes one chunk at a time:

  - the chunk computes exact activations for its own tokens,
  - attention *pulls* historical K/V for out-of-chunk context from the
    per-layer history (the paper's pull),
  - the chunk's fresh K/V are *pushed* back (the paper's push),
  - no gradient flows into pulled history (`.detach()`, the reference's
    `stop_gradient`).

For causal models processed left to right, chunk k needs only chunks < k,
computed earlier in the same pass: staleness 0, and the chunked forward
is exact. For encoders (hubert, `bidirectional=True`) future chunks come
from the previous pass's history (staleness 1), and the error against the
full forward falls to zero within num_layers + 1 passes with frozen
params (Theorem 2 on sequences). Under autograd with `cfg.remat` each
chunk runs under `torch.utils.checkpoint` (non-reentrant). The device
holds activations for one chunk; the history holds only K/V.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..models.attention import attention_with_history
from ..models.common import cross_entropy_loss, mlp
from ..models.transformer import _device, _norm, _unbind


def _chunk_layer(p, x, cfg: ArchConfig, positions, hist_k, hist_v, hist_pos,
                 ltype: str):
    window = cfg.window if (ltype == "local" or cfg.window > 0) else 0
    h, k_new, v_new = attention_with_history(
        p["attn"], _norm(cfg, p["n1"], x), num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
        positions=positions, hist_k=hist_k, hist_v=hist_v,
        hist_positions=hist_pos, window=window, rope_theta=cfg.rope_theta,
        use_rope=cfg.use_rope, causal=cfg.causal)
    x = x + h
    x = x + mlp(p["mlp"], _norm(cfg, p["n2"], x), cfg.act)
    return x, k_new, v_new


def forward_chunked(params, cfg: ArchConfig, batch: Dict[str, Any],
                    chunk_len: int,
                    history: Optional[List[Dict[str, torch.Tensor]]] = None,
                    bidirectional: bool = False):
    """Chunked forward for dense/local-pattern archs.

    history: per-layer {"k", "v"} [B, T, Kh, Dh] from the PREVIOUS pass,
    read only when `bidirectional` (future context). Returns (logits [B,
    T, V], new_history): this pass's pushed K/V, detached (the H-bar of
    the next pass)."""
    assert all(t in ("dense", "local") for t in cfg.layer_types()), \
        "seq-GAS chunking applies to attention stacks"
    dev = _device(params)
    if cfg.family == "audio":
        x_all = torch.as_tensor(batch["frames"], device=dev).to(
            cfg.activation_dtype)
        if cfg.learned_pos:
            x_all = x_all + params["pos_embed"][:x_all.shape[1]]
    else:
        x_all = params["embed"][torch.as_tensor(batch["tokens"],
                                                device=dev).long()]
    B, T = x_all.shape[:2]
    assert T % chunk_len == 0
    L = cfg.num_layers
    assert len(params["segs"]) == 1, "dense archs have a single segment"
    layers = _unbind(params["segs"][0]["0"], L)   # pattern of one type
    layer_types = cfg.layer_types()

    def arange(lo, hi):
        return torch.arange(lo, hi, dtype=torch.int32, device=dev)

    # running (this pass's) history per layer: exact for chunks < c
    past_k: List[Optional[torch.Tensor]] = [None] * L
    past_v: List[Optional[torch.Tensor]] = [None] * L
    logits_chunks = []
    for lo in range(0, T, chunk_len):
        hi = lo + chunk_len
        pos = arange(lo, hi)

        def run_chunk(xc, past_k, past_v, lo=lo, hi=hi, pos=pos):
            new_k, new_v = [], []
            for ell in range(L):
                hk, hv, hp = past_k[ell], past_v[ell], None
                if hk is not None:
                    hp = arange(0, lo)
                if bidirectional and history is not None:
                    fut_k = history[ell]["k"][:, hi:]
                    fut_v = history[ell]["v"][:, hi:]
                    fut_p = arange(hi, T)
                    hk = fut_k if hk is None else torch.cat([hk, fut_k], 1)
                    hv = fut_v if hv is None else torch.cat([hv, fut_v], 1)
                    hp = fut_p if hp is None else torch.cat([hp, fut_p])
                # pulled history is constant for this chunk's gradient
                hk = None if hk is None else hk.detach()
                hv = None if hv is None else hv.detach()
                xc, kc, vc = _chunk_layer(layers[ell], xc, cfg, pos, hk, hv,
                                          hp, layer_types[ell])
                new_k.append(kc)
                new_v.append(vc)
            return xc, new_k, new_v

        # the lists as they stand now: the backward's recompute must see
        # this chunk's history, not the longer one the loop builds after
        args = (x_all[:, lo:hi], tuple(past_k), tuple(past_v))
        if cfg.remat and torch.is_grad_enabled():
            xc, new_k, new_v = checkpoint(run_chunk, *args,
                                          use_reentrant=False)
        else:
            xc, new_k, new_v = run_chunk(*args)
        for ell in range(L):
            kc, vc = new_k[ell].detach(), new_v[ell].detach()
            past_k[ell] = kc if past_k[ell] is None else torch.cat(
                [past_k[ell], kc], dim=1)
            past_v[ell] = vc if past_v[ell] is None else torch.cat(
                [past_v[ell], vc], dim=1)
        xc = _norm(cfg, params["final_norm"], xc)
        logits_chunks.append(xc @ params["lm_head"])

    logits = torch.cat(logits_chunks, dim=1)
    return logits, [{"k": past_k[ell], "v": past_v[ell]} for ell in range(L)]


def chunked_loss(params, cfg: ArchConfig, batch: Dict[str, Any],
                 chunk_len: int, history=None, bidirectional=False):
    """(mean CE of the chunked forward's logits against
    `batch["labels"]`, masked by `"mask"` where given; the new history)."""
    logits, new_history = forward_chunked(params, cfg, batch, chunk_len,
                                          history, bidirectional)
    dev = logits.device
    mask = batch.get("mask")
    ce = cross_entropy_loss(
        logits, torch.as_tensor(batch["labels"], device=dev),
        None if mask is None else torch.as_tensor(mask, device=dev))
    return ce, new_history
