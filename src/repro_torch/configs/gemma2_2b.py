"""Gemma2-2B: local+global alternating attention, logit softcap. [arXiv:2408.00118]
Port of ``repro/configs/gemma2_2b.py``.

26L d_model=2304 8H (GQA kv=4) head_dim=256 d_ff=9216 vocab=256000,
sliding window 4096 on local layers, attn softcap 50, final logit softcap 30.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        num_layers=26,
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256_000,
        pattern=("local_attn", "attn"),  # alternating local / global
        window=4096,
        logit_softcap=30.0,
        attn_softcap=50.0,
        act="gelu",
        tie_embeddings=True,
        rope_theta=10_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma2-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        pattern=("local_attn", "attn"),
        window=32,
        logit_softcap=30.0,
        attn_softcap=50.0,
        act="gelu",
        tie_embeddings=True,
    )
