"""RecurrentGemma-9B (Griffin): RG-LRU + local attention, 2 rec : 1 attn.
[arXiv:2402.19427] Port of ``repro/configs/recurrentgemma_9b.py``.

38L... pattern period 3 -> 36 full periods + we follow the published 38-layer
stack truncated to the nearest whole period for scan (see note below).
d_model=4096 16H (MQA kv=1) head_dim=256 d_ff=12288 vocab=256000,
RG-LRU width 4096, local attention window 2048.

NOTE: the published depth is 38 with pattern (rec, rec, attn) repeated; 38 is
not divisible by 3, the final partial period is (rec, rec). We model this as
12 scanned super-blocks (36 layers) + 1 trailing super-block with its attn
sub-layer disabled at the config level by rounding depth to 39 — matching
the Griffin family practice of whole residual blocks — and record the
deviation here. Supports long_500k (O(1) recurrent state + bounded window).
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=39,  # 13 x (rec, rec, local_attn); see module docstring
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12_288,
        vocab_size=256_000,
        pattern=("rglru", "rglru", "local_attn"),
        window=2048,
        rglru_block_width=4096,
        act="gelu",
        tie_embeddings=True,
        supports_long_context=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-reduced",
        family="hybrid",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        pattern=("rglru", "rglru", "local_attn"),
        window=16,
        rglru_block_width=64,
        act="gelu",
        tie_embeddings=True,
        supports_long_context=True,
    )
