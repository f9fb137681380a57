"""HuBERT-XLarge [arXiv:2106.07447] — encoder-only (w2v2 backbone).

48L d_model=1280 16H d_ff=5120, 504 cluster classes. Conv feature extractor
is a stub per spec; `input_specs` provides frame embeddings. Encoder-only:
no decode shapes (see DESIGN.md).
"""
import dataclasses
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="hubert-xlarge", family="audio", num_layers=48, d_model=1280,
    num_heads=16, num_kv_heads=16, d_ff=5120, vocab_size=504,
    act="gelu", gated_mlp=False, norm="layernorm", causal=False,
    use_rope=False, learned_pos=32768, pattern=("dense",),
    source="arXiv:2106.07447",
)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=512,
    vocab_size=64, learned_pos=1024)
