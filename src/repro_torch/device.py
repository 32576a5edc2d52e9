"""Device selection and float settings shared by the port's entry points.

No counterpart in ``src/repro/``: JAX picks its backend globally, while every
entry point of the port takes an explicit ``device``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises: the port
    never moves to the CPU unless the caller asks for it.

    On the card this also turns off TF32 and bf16 reduced-precision
    reductions in cuBLAS, so plaintext matmuls accumulate in full f32 as the
    sealed kernel does and a sealed-vs-plaintext comparison measures the
    kernel, not cuBLAS settings; and TF32 in cuDNN, whose default is on, so
    the CNNs' convolutions compute in the reference's f32.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port's plain "
                "PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
