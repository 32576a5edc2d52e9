"""Model, shape, mesh, training and SEAL configuration. Port of
``repro/config.py`` (``BLOCK_KINDS``, ``MoEConfig``, ``ModelConfig``,
``ConvSpec``, ``CNNConfig``, ``ShapeConfig``, ``SHAPES``,
``cell_supported``, ``SealConfig``, ``MeshConfig``, ``TrainConfig``,
``RunConfig``, ``HW``, ``PAPER_GPU``).

A copy, not an import: the port imports nothing from ``repro``. ``HW``
holds the constants of the card the port runs on (an NVIDIA H100), in place
of the reference's TPU table. ``PAPER_GPU`` is the paper's modelled GTX480
(the analytic ``core.perfmodel``'s inputs), not a measurement of any card
the port runs on.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


BLOCK_KINDS = ("attn", "local_attn", "rglru", "ssd")


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

    def layer_kinds(self) -> Tuple[str, ...]:
        """The concrete kind of each of the num_layers layers."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def n_superblocks(self) -> int:
        if self.num_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible by "
                f"pattern period {len(self.pattern)}")
        return self.num_layers // len(self.pattern)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self, active_only: bool = False) -> int:
        """Rough parameter count, the reference's formula (the roofline's
        MODEL_FLOPS and memory budgets); ``active_only``: an MoE layer's
        top-k experts in place of all of them."""
        d = self.d_model
        total = self.vocab_size * d                  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d             # lm head
        for k in self.layer_kinds():
            if k in ("attn", "local_attn"):
                total += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            elif k == "rglru":
                w = self.rglru_block_width or self.d_model
                # in/out proj + gates + recurrence params
                total += 2 * d * w + 3 * w * w // 1 + 2 * w
            elif k == "ssd":
                di = self.ssm_d_inner
                # in_proj (x,z,B,C,dt) + out_proj + conv + A,D
                nbc = 2 * self.ssm_state
                total += d * (2 * di + nbc + self.ssm_heads) + di * d
                total += self.ssm_conv * (di + nbc) + 2 * self.ssm_heads
            if k != "ssd" and self.d_ff:
                if self.moe is not None:
                    e = self.moe.top_k if active_only else self.moe.num_experts
                    total += e * (3 * d * self.d_ff) + d * self.moe.num_experts
                else:
                    total += 3 * d * self.d_ff
            total += 2 * d                           # norms
        return total


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


# --------------------------------------------------------------------------
# Shapes (the assigned input-shape set, the same four for every LM arch)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524_288, 1),
}


def cell_supported(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch x shape) is a runnable cell; the reason when not."""
    if shape.name == "long_500k" and not model.supports_long_context:
        return False, ("full-attention KV cache is unbounded at 500k; run only "
                       "for SSM/hybrid archs (DESIGN.md §4)")
    return True, ""


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
class MeshConfig:
    data: int = 16
    model: int = 16
    pod: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model * self.pod

    def axis_names(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.pod > 1 else ("data", "model")

    def shape(self) -> Tuple[int, ...]:
        return ((self.pod, self.data, self.model) if self.pod > 1
                else (self.data, self.model))


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


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = MeshConfig()
    seal: SealConfig = SealConfig()
    train: TrainConfig = TrainConfig()


# The card's constants for the roofline and every bound: NVIDIA H100 80GB
# HBM3 (SXM), 700 W, data sheet (dense rates; a card set below 700 W runs
# slower under load). f32 is outside the tensor cores; NVLink is the card's
# total over its 18 links, both directions together, as the data sheet
# gives it; shared memory is one SM's (up to 227 KB of it for one block).
HW = {
    "peak_flops_bf16": 989e12,   # FLOP/s
    "peak_flops_f32": 67e12,     # FLOP/s
    "hbm_bw": 3.35e12,           # B/s
    "hbm_bytes": 80 * 10**9,
    "nvlink_bw": 900e9,          # B/s
    "smem_bytes": 228 * 2**10,   # per SM
}

# The paper's modelled GPU (GTX480-class) for the analytic perfmodel
PAPER_GPU = {
    "gddr_bw": 177.4e9,          # 384-bit * 3696 MT/s
    "aes_bw_per_engine": 8e9,    # state-of-the-art pipelined AES engine
    "n_mem_controllers": 6,
    "line_bytes": 128,
    "counter_bytes": 8,
    "ctr_cache_hit": {1536: 0.98, 384: 0.78, 96: 0.67, 24: 0.55},  # KB -> hit
}
