"""Architecture config schema, registry and input shapes.

The port of `repro.configs.base`: every architecture has a module
`repro_torch/configs/<id>.py` exporting ``FULL`` (the published config,
cited in `source`) and ``SMOKE`` (a reduced variant of the same family),
and some a ``LONG`` sliding-window variant; the values are the
reference's. `activation_dtype` is a torch dtype. The reference's
`input_specs` (shape stand-ins for its dry-run) has no counterpart here.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

INPUT_SHAPES: Dict[str, Dict[str, int]] = {
    "train_4k":    {"seq_len": 4096,    "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768,   "global_batch": 32,  "kind": "prefill"},
    "decode_32k":  {"seq_len": 32768,   "global_batch": 128, "kind": "decode"},
    "long_500k":   {"seq_len": 524288,  "global_batch": 1,   "kind": "decode"},
}

ARCH_IDS = [
    "stablelm-1.6b", "hubert-xlarge", "qwen2-72b", "qwen3-0.6b",
    "recurrentgemma-9b",
]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    act: str = "silu"
    gated_mlp: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    causal: bool = True
    use_rope: bool = True
    rope_theta: float = 10000.0
    learned_pos: int = 0             # >0: learned absolute positions (audio)
    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_group: int = 512
    conv_width: int = 4              # short conv in recurrent blocks
    # hybrid / attention windows
    pattern: Tuple[str, ...] = ("dense",)
    window: int = 0                  # sliding window for "local" layers
    lru_width: int = 0
    # vlm
    num_image_tokens: int = 0
    # numerics / execution (the reference's knobs, kept so configs carry
    # the same values; the port runs eagerly, layer by layer)
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"
    scan_layers: bool = True
    fsdp: bool = False
    replicate_params_decode: bool = False
    decode_cache_shard: str = "headdim"
    grad_accum: int = 1
    chunked_ce: int = 0
    source: str = ""

    # -- derived -----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def segments(self) -> List[Tuple[Tuple[str, ...], int]]:
        """Layer stack as [(repeating pattern, repeats), ...]."""
        pat = self.pattern
        reps, rem = divmod(self.num_layers, len(pat))
        segs: List[Tuple[Tuple[str, ...], int]] = []
        if reps:
            segs.append((pat, reps))
        if rem:
            segs.append((pat[:rem], 1))
        return segs

    def layer_types(self) -> List[str]:
        out: List[str] = []
        for pat, reps in self.segments():
            out.extend(list(pat) * reps)
        return out

    def decode_cache_len(self, seq_len: int, ltype: str) -> int:
        if ltype == "local" or (ltype == "dense" and self.window > 0):
            return min(seq_len, self.window)
        return seq_len

    def param_counts(self) -> Dict[str, int]:
        D, F, V, Dh = self.d_model, self.d_ff, self.vocab_size, self.head_dim_
        H, Kh = self.num_heads, self.num_kv_heads
        attn = D * H * Dh + 2 * D * Kh * Dh + H * Dh * D
        mlp = D * F * (3 if self.gated_mlp else 2)
        total = 0
        active = 0
        for ltype in self.layer_types():
            if ltype in ("dense", "local", "cross"):
                total += attn + mlp
                active += attn + mlp
            elif ltype == "moe":
                e = self.num_experts * 3 * D * F
                total += attn + e + D * self.num_experts
                active += attn + self.top_k * 3 * D * F
            elif ltype == "rec":
                W = self.lru_width or D
                p = 2 * D * W + 2 * W * W + W * D + mlp
                total += p
                active += p
        emb = V * D + D * V
        if self.learned_pos:
            emb += self.learned_pos * D
        return {"total": total + emb, "active": active + emb,
                "total_nonembed": total, "active_nonembed": active}


def normalize(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, variant: str = "full") -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{normalize(arch_id)}")
    return getattr(mod, variant.upper())
