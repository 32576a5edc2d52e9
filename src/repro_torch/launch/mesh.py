"""Process group start and mesh construction. Port of
``repro/launch/mesh.py``.

FUNCTIONS, not module-level constants: importing this module starts no
process group and touches no device, so every module imports alone (the
tests import each in a fresh interpreter).

``init_distributed`` starts the default process group: ``nccl`` for the
card, ``gloo`` only when the caller asks for the CPU, and the ``fake``
group (one process standing in for every rank, no data moved) only for
the dry run. A failed start raises; nothing falls back to another backend.
The world comes from the arguments, else from ``torchrun``'s environment
(``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``), else it is one rank on a
``FileStore`` in a fresh temporary directory.
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile
from typing import Optional

import torch

_STORE_DIR: Optional[str] = None


def init_distributed(device: str = "cuda", *, world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     init_method: Optional[str] = None,
                     fake: bool = False) -> str:
    """Start the default process group unless one is up; returns the mesh
    device type (``"cuda"`` or ``"cpu"``). ``device`` is ``cuda`` (NCCL,
    the rank's card by ``LOCAL_RANK``) or ``cpu`` (gloo); ``fake=True``
    starts the fake group of ``world_size`` ranks (meshes of any size on
    one process, for the dry run)."""
    import torch.distributed as dist

    global _STORE_DIR
    dtype = torch.device(device).type
    if dtype not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dist.is_initialized():
        return dtype
    env = os.environ
    world = world_size if world_size is not None else \
        int(env.get("WORLD_SIZE", 1))
    rk = rank if rank is not None else int(env.get("RANK", 0))
    if fake:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=rk,
                                world_size=world)
        return dtype
    if dtype == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for an NCCL process group: "
                               "pass device='cpu' for gloo on the CPU")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rk)))
    if init_method is None:
        if "MASTER_ADDR" in env:
            init_method = "env://"
        elif world == 1:
            _STORE_DIR = tempfile.mkdtemp(prefix="repro_pg_")
            init_method = "file://" + os.path.join(_STORE_DIR, "store")
        else:
            raise RuntimeError(
                f"a world of {world} ranks needs init_method or torchrun's "
                f"MASTER_ADDR/MASTER_PORT")
    backend = "nccl" if dtype == "cuda" else "gloo"
    kw = {}
    if dtype == "cuda":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init_method, rank=rk,
                            world_size=world, **kw)
    if dtype == "cuda":
        # the first collective creates the communicator: a broken NCCL
        # start raises here, not inside the first training step
        dist.barrier()
    return dtype


def shutdown_distributed() -> None:
    """End the default process group (and remove the one-rank group's
    store directory)."""
    import torch.distributed as dist

    global _STORE_DIR
    if dist.is_initialized():
        dist.destroy_process_group()
    if _STORE_DIR is not None:
        shutil.rmtree(_STORE_DIR, ignore_errors=True)
        _STORE_DIR = None


def world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(device_type: str, shape, axes):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    have = world_size()
    if not dist.is_initialized() or have < n:
        raise RuntimeError(
            f"need a world of {n} ranks for the {'x'.join(map(str, shape))} "
            f"mesh, have {have if dist.is_initialized() else 0} — start "
            f"{n} ranks (torchrun --nproc-per-node) or the fake group "
            f"(init_distributed(fake=True, world_size={n}))")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 (one pod's worth of devices) or 2x16x16 (two pods), over the
    first 256 or 512 ranks of the world."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_host_mesh(data: int = 2, model: int = 2, pod: int = 1,
                   device_type: str = "cuda"):
    """A small mesh over the first ``pod * data * model`` ranks."""
    shape = (pod, data, model) if pod > 1 else (data, model)
    axes = ("pod", "data", "model") if pod > 1 else ("data", "model")
    return _mesh(device_type, shape, axes)
