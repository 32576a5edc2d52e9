"""VGG-16 [arXiv:1409.1556] — one of the paper's three evaluation CNNs.
Port of ``repro/configs/vgg16.py``.

13 CONV + 5 POOL + 3 FC. Security eval runs on CIFAR-10 (32x32); the
traffic/perf model uses the paper's Figure-4 ImageNet geometry (224x224).
"""
from repro_torch.config import CNNConfig, ConvSpec

_C = lambda c: ConvSpec("conv", out_ch=c, kernel=3)
_P = ConvSpec("pool", kernel=2, stride=2)


def config() -> CNNConfig:
    return CNNConfig(
        name="vgg16",
        stages=(
            _C(64), _C(64), _P,
            _C(128), _C(128), _P,
            _C(256), _C(256), _C(256), _P,
            _C(512), _C(512), _C(512), _P,
            _C(512), _C(512), _C(512), _P,
            ConvSpec("fc", out_ch=512),
            ConvSpec("fc", out_ch=512),
            ConvSpec("fc", out_ch=10),
        ),
    )


def reduced() -> CNNConfig:
    # deep enough that SE has non-boundary layers (first two + last conv
    # and the FCs are always fully encrypted, paper §3.4.1)
    return CNNConfig(
        name="vgg16-reduced",
        stages=(
            _C(16), _C(16), _P,
            _C(32), _C(32), _P,
            _C(32), _C(32),
            ConvSpec("fc", out_ch=32),
            ConvSpec("fc", out_ch=10),
        ),
        img_size=16,
    )
