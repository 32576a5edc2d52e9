"""DBRX-132B MoE [hf:databricks/dbrx-base]. Port of
``repro/configs/dbrx_132b.py``.

40L d_model=6144 48H (GQA kv=8) head_dim=128 d_ff=10752/expert vocab=100352,
MoE 16 experts top-4 (fine-grained).
"""
from repro_torch.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=10_752,
        vocab_size=100_352,
        pattern=("attn",),
        moe=MoEConfig(num_experts=16, top_k=4),
        rope_theta=500_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="dbrx-reduced",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        pattern=("attn",),
        moe=MoEConfig(num_experts=4, top_k=2),
    )
