"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b].

24L d_model=2048 32H (GQA kv=32, i.e. full MHA) d_ff=5632 vocab=100352.
StableLM-2 uses rotary (partial) attention with qkv bias and SwiGLU-like MLP.
"""
import dataclasses
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="stablelm-1.6b", family="dense", num_layers=24, d_model=2048,
    num_heads=32, num_kv_heads=32, d_ff=5632, vocab_size=100352,
    act="silu", gated_mlp=True, qkv_bias=True, norm="layernorm",
    rope_theta=10000.0, pattern=("dense",),
    source="hf:stabilityai/stablelm-2-1_6b",
)

# Sliding-window variant used only for the long_500k sub-quadratic study.
LONG = dataclasses.replace(FULL, window=4096)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=352, vocab_size=512)
