"""The port's train step against the reference's for the other half of
``ARCH_IDS``: gemma2-2b, the frontend stubs internvl2-1b and
musicgen-medium (``lm_batch``'s ``embeds``), RecurrentGemma (RG-LRU) and
Mamba2 (SSD). Same settings and tolerances as ``test_torch_train_step.py``.
"""
import pytest
import torch

from repro.configs import ARCH_IDS
from test_torch_train_step import assert_step_close, port_step, reference_step

HERE = ARCH_IDS[5:]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: intra-op threads only contend under pytest-xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", HERE)
def test_train_step_matches_reference_f32(arch):
    ref = reference_step(arch)
    assert_step_close(ref, port_step(arch, ref[0], ref[1]))
