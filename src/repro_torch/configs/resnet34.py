"""ResNet-34 [arXiv:1512.03385] — one of the paper's three evaluation CNNs.
Port of ``repro/configs/resnet34.py``.

33 CONV + 1 FC (CIFAR variant: stages [3,4,6,3] x 2 convs).
"""
from repro_torch.config import CNNConfig, ConvSpec
from repro_torch.configs.resnet18 import _stage


def config() -> CNNConfig:
    stages = [ConvSpec("conv", out_ch=64, kernel=3)]
    stages += _stage(64, 3, 1) + _stage(128, 4, 2) + _stage(256, 6, 2) + _stage(512, 3, 2)
    stages += [ConvSpec("fc", out_ch=10)]
    return CNNConfig(name="resnet34", stages=tuple(stages))


def reduced() -> CNNConfig:
    stages = [ConvSpec("conv", out_ch=16, kernel=3)]
    stages += _stage(16, 2, 1) + _stage(32, 2, 2) + _stage(32, 1, 1)
    stages += [ConvSpec("fc", out_ch=10)]
    return CNNConfig(name="resnet34-reduced", stages=tuple(stages), img_size=16)
