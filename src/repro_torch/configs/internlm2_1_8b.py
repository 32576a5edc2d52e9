"""InternLM2-1.8B dense GQA [arXiv:2403.17297]. Port of
``repro/configs/internlm2_1_8b.py``.

24L d_model=2048 16H (GQA kv=8) head_dim=128 d_ff=8192 vocab=92544.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92_544,
        pattern=("attn",),
        rope_theta=1_000_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internlm2-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        pattern=("attn",),
    )
