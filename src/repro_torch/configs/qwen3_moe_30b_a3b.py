"""Qwen3-30B-A3B MoE [hf:Qwen/Qwen3-30B-A3B]. Port of
``repro/configs/qwen3_moe_30b_a3b.py``.

48L d_model=2048 32H (GQA kv=4) head_dim=128 d_ff=768/expert vocab=151936,
MoE 128 experts top-8.
"""
from repro_torch.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151_936,
        pattern=("attn",),
        moe=MoEConfig(num_experts=128, top_k=8),
        rope_theta=1_000_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-reduced",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab_size=256,
        pattern=("attn",),
        moe=MoEConfig(num_experts=8, top_k=2),
    )
