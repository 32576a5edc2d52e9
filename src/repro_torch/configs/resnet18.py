"""ResNet-18 [arXiv:1512.03385] — one of the paper's three evaluation CNNs.
Port of ``repro/configs/resnet18.py``.

17 CONV + 1 FC (CIFAR variant: 3x3 stem, stages [2,2,2,2] x 2 convs).
"""
from repro_torch.config import CNNConfig, ConvSpec


def _stage(ch, blocks, first_stride):
    out = []
    for b in range(blocks):
        s = first_stride if b == 0 else 1
        out.append(ConvSpec("conv", out_ch=ch, kernel=3, stride=s, residual=True))
        out.append(ConvSpec("conv", out_ch=ch, kernel=3, stride=1))
    return out


def config() -> CNNConfig:
    stages = [ConvSpec("conv", out_ch=64, kernel=3)]
    stages += _stage(64, 2, 1) + _stage(128, 2, 2) + _stage(256, 2, 2) + _stage(512, 2, 2)
    stages += [ConvSpec("fc", out_ch=10)]
    return CNNConfig(name="resnet18", stages=tuple(stages))


def reduced() -> CNNConfig:
    stages = [ConvSpec("conv", out_ch=16, kernel=3)]
    stages += _stage(16, 1, 1) + _stage(32, 2, 2)
    stages += [ConvSpec("fc", out_ch=10)]
    return CNNConfig(name="resnet18-reduced", stages=tuple(stages), img_size=16)
