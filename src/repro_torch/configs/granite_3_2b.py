"""Granite-3.0-2B dense GQA. [hf:ibm-granite/granite-3.0-2b-base]
Port of ``repro/configs/granite_3_2b.py``.

40L d_model=2048 32H (GQA kv=8) head_dim=64 d_ff=8192 vocab=49155.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b",
        family="dense",
        num_layers=40,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=49_155,
        pattern=("attn",),
        tie_embeddings=True,
        rope_theta=10_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        pattern=("attn",),
        tie_embeddings=True,
    )
