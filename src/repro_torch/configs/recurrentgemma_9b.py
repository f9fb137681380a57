"""RecurrentGemma-9B [arXiv:2402.19427] — Griffin: RG-LRU + local attention.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; pattern
rec,rec,local (1 attention : 2 recurrent), window 2048, GeGLU MLP.
"""
import dataclasses
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="recurrentgemma-9b", family="hybrid", num_layers=38, d_model=4096,
    num_heads=16, num_kv_heads=1, head_dim=256, d_ff=12288, vocab_size=256000,
    act="gelu", gated_mlp=True, norm="rmsnorm", rope_theta=10000.0,
    pattern=("rec", "rec", "local"), window=2048, lru_width=4096,
    conv_width=4, source="arXiv:2402.19427",
)

SMOKE = dataclasses.replace(
    FULL, num_layers=3, d_model=128, num_heads=4, num_kv_heads=1, head_dim=32,
    d_ff=384, vocab_size=512, window=64, lru_width=128)
