"""Architecture registry. Port of ``repro/configs/__init__.py``, holding the
token architectures the reference serves, in the reference's order (its
frontend configs are not ported yet), and the paper's own CNNs."""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "qwen3_moe_30b_a3b",
    "dbrx_132b",
    "internlm2_1_8b",
    "granite_3_2b",
    "deepseek_coder_33b",
    "gemma2_2b",
    "recurrentgemma_9b",
    "mamba2_130m",
]

CNN_IDS = ["vgg16", "resnet18", "resnet34"]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS + CNN_IDS}


def _module(arch_id: str):
    arch_id = _ALIAS.get(arch_id, arch_id)
    if arch_id not in ARCH_IDS + CNN_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS + CNN_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str):
    return _module(arch_id).config()


def get_reduced(arch_id: str):
    return _module(arch_id).reduced()
