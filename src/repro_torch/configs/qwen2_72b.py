"""Qwen2-72B [arXiv:2407.10671].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064; QKV bias, SwiGLU.
"""
import dataclasses
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="qwen2-72b", family="dense", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=29568, vocab_size=152064,
    act="silu", gated_mlp=True, qkv_bias=True, norm="rmsnorm",
    rope_theta=1000000.0, pattern=("dense",),
    source="arXiv:2407.10671",
)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=448,
    vocab_size=512)
