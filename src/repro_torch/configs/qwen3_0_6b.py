"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936; qk-norm, SwiGLU.
"""
import dataclasses
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="qwen3-0.6b", family="dense", num_layers=28, d_model=1024,
    num_heads=16, num_kv_heads=8, head_dim=128, d_ff=3072, vocab_size=151936,
    act="silu", gated_mlp=True, qk_norm=True, norm="rmsnorm",
    rope_theta=1000000.0, pattern=("dense",),
    source="hf:Qwen/Qwen3-8B",
)

LONG = dataclasses.replace(FULL, window=4096)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
    d_ff=384, vocab_size=512)
