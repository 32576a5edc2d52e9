"""MusicGen-medium: decoder-only transformer over EnCodec tokens.
[arXiv:2306.05284] Port of ``repro/configs/musicgen_medium.py``.

48L d_model=1536 24H (MHA kv=24) head_dim=64 d_ff=6144 vocab=2048.
The EnCodec frontend is a STUB: inputs arrive as precomputed frame
embeddings (``data.synthetic.lm_batch``'s ``embeds``); the backbone predicts
codec tokens (vocab 2048). Trained, never served.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        pattern=("attn",),
        frontend="encodec_stub",
        act="gelu",
        norm="layernorm",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="musicgen-reduced",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        pattern=("attn",),
        frontend="encodec_stub",
        act="gelu",
        norm="layernorm",
    )
