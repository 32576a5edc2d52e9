"""InternVL2-1B (InternViT frontend stub + Qwen2-0.5B-class LM backbone).
[arXiv:2404.16821] Port of ``repro/configs/internvl2_1b.py``.

24L d_model=896 14H (GQA kv=2) head_dim=64 d_ff=4864 vocab=151655.
The vision frontend is a STUB: inputs arrive as precomputed patch
embeddings (B, S, d_model) in place of pixels (``data.synthetic.lm_batch``'s
``embeds``). Trained, never served: the engines refuse a frontend config.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab_size=151_655,
        pattern=("attn",),
        frontend="vit_stub",
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        pad_heads_to=16,     # 14 -> 16: shardable heads (+14% attn FLOPs)
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internvl2-reduced",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        pattern=("attn",),
        frontend="vit_stub",
        tie_embeddings=True,
    )
