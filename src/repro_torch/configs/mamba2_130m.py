"""Mamba2-130M: SSD (state-space duality), attention-free. [arXiv:2405.21060]
Port of ``repro/configs/mamba2_130m.py``.

24L d_model=768 d_ff=0 vocab=50280, ssm_state=128, expand 2 (d_inner 1536),
head_dim 64 (24 SSD heads), conv width 4. Supports long_500k (O(1) state).
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50_280,
        pattern=("ssd",),
        ssm_state=128,
        ssm_expand=2,
        ssm_conv=4,
        ssm_head_dim=64,
        tie_embeddings=True,
        norm="rmsnorm",
        supports_long_context=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-reduced",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=256,
        pattern=("ssd",),
        ssm_state=16,
        ssm_expand=2,
        ssm_conv=4,
        ssm_head_dim=32,
        tie_embeddings=True,
        supports_long_context=True,
    )
