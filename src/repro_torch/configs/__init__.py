"""Architecture registry. Port of ``repro/configs/__init__.py``: the
reference's ten token architectures in its order (the two frontend-stub
configs, ``internvl2_1b`` and ``musicgen_medium``, are trained and never
served) and the paper's own CNNs."""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "qwen3_moe_30b_a3b",
    "dbrx_132b",
    "internlm2_1_8b",
    "granite_3_2b",
    "deepseek_coder_33b",
    "gemma2_2b",
    "internvl2_1b",
    "recurrentgemma_9b",
    "musicgen_medium",
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


def all_configs() -> dict:
    return {i: get_config(i) for i in ARCH_IDS}
