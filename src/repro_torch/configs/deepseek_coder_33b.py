"""DeepSeek-Coder-33B dense (llama-arch). [arXiv:2401.14196]
Port of ``repro/configs/deepseek_coder_33b.py``.

62L d_model=7168 56H (GQA kv=8) head_dim=128 d_ff=19200 vocab=32256.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        num_layers=62,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=19_200,
        vocab_size=32_256,
        pattern=("attn",),
        rope_theta=100_000.0,
        # the reference pads 56 query heads to 64 (8 zero heads) so that
        # they shard over a 16-way axis; the port keeps its shapes
        pad_heads_to=64,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=160,
        vocab_size=256,
        pattern=("attn",),
    )
