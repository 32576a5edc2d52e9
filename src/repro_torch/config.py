"""Model, training and SEAL configuration. Port of ``repro/config.py``
(``MoEConfig``, ``ModelConfig``, ``ConvSpec``, ``CNNConfig``, ``SealConfig``,
``TrainConfig``, ``PAPER_GPU``).

A copy, not an import: the port imports nothing from ``repro``. The TPU
hardware table is left out. ``PAPER_GPU`` is the paper's modelled GTX480
(the analytic ``core.perfmodel``'s inputs), not a measurement of any card
the port runs on.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    aux_loss_weight: float = 0.01
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | hybrid | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int                   # query heads
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[str, ...] = ("attn",)   # cycled over num_layers
    moe: Optional[MoEConfig] = None
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    window: int = 0                  # sliding window width for local_attn
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    rglru_block_width: int = 0
    pad_heads_to: int = 0
    frontend: Optional[str] = None
    norm: str = "rmsnorm"
    act: str = "silu"
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    dtype: str = "bfloat16"
    supports_long_context: bool = False

    @property
    def heads_eff(self) -> int:
        return max(self.num_heads, self.pad_heads_to)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        if not self.ssm_head_dim:
            return 0
        return self.ssm_d_inner // self.ssm_head_dim

    def n_superblocks(self) -> int:
        if self.num_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible by "
                f"pattern period {len(self.pattern)}")
        return self.num_layers // len(self.pattern)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# The paper's own CNNs (VGG-16 / ResNet-18 / ResNet-34)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ConvSpec:
    kind: str            # "conv" | "pool" | "fc"
    out_ch: int = 0
    kernel: int = 3
    stride: int = 1
    residual: bool = False   # start of a residual block (resnets)


@dataclass(frozen=True)
class CNNConfig:
    name: str
    stages: Tuple[ConvSpec, ...]
    num_classes: int = 10
    img_size: int = 32      # CIFAR-10 for security eval; 224 for traffic model
    in_ch: int = 3

    def with_(self, **kw) -> "CNNConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SealConfig:
    """The paper's technique.

    mode: none | direct | counter | coloe (direct: AES-128-ECB lines, the
      paper's baseline, decrypted whole every dispatch; counter/coloe:
      ChaCha20 counter mode, fused into the matmuls).
    smart_ratio: fraction of weight rows encrypted (paper's SE default 0.5).
    fuse_decrypt: decrypt inside the consumer matmul kernel.
    verify: co-located Carter–Wegman MACs on every leaf (one a weight
      tile, one a 128-byte line), checked by ``sealed_store.verify_params``.
    """
    mode: str = "coloe"
    smart_ratio: float = 0.5
    cipher: str = "chacha20"
    fuse_decrypt: bool = True
    verify: bool = False
    protect_boundary_layers: bool = True


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1            # gradient accumulation factor
    remat: str = "save_carries"      # none | save_carries | full
    grad_compress_pod: bool = False  # int8 EF compression on the pod axis
    seed: int = 0
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True


# The paper's modelled GPU (GTX480-class) for the analytic perfmodel
PAPER_GPU = {
    "gddr_bw": 177.4e9,          # 384-bit * 3696 MT/s
    "aes_bw_per_engine": 8e9,    # state-of-the-art pipelined AES engine
    "n_mem_controllers": 6,
    "line_bytes": 128,
    "counter_bytes": 8,
    "ctr_cache_hit": {1536: 0.98, 384: 0.78, 96: 0.67, 24: 0.55},  # KB -> hit
}
