"""Sealed, async, atomic checkpoints. Port of
``repro/checkpoint/manager.py`` (``_flatten``, ``CheckpointManager``,
``rebuild_tree``).

Fault-tolerance contract, the reference's:
  * atomic: data written to ``step_N.tmp/`` then renamed; a manifest with
    per-leaf SHA-256 digests is written LAST, so a crash mid-write can
    never be mistaken for a complete checkpoint;
  * async: ``save`` snapshots every leaf to host memory before it returns
    (the training step updates params and optimizer state in place, so a
    snapshot that still referenced them would be torn by the next step);
    sealing and writing happen in a background thread (``wait()`` joins
    before the next save or at exit);
  * sealed: leaves are encrypted with a SEAL engine before they reach
    storage, the paper's threat model extended to checkpoints at rest;
  * elastic: ``restore()`` returns host numpy; the caller puts it on any
    device, or on any mesh (``rebuild_tree`` with ``(mesh, specs)``).

A sharded run saves from every rank: each DTensor leaf is gathered whole
(``full_tensor()``, a collective every rank joins), one leaf at a time,
and rank 0 alone keeps a host copy, seals and writes, so a sharded save's
files are byte for byte an unsharded save's; the other ranks drop each
gathered leaf at once. ``wait`` ends with a barrier, so that no rank
reads a checkpoint before rank 0 has finished it. A restore onto a mesh
(``rebuild_tree`` with ``(mesh, specs)``) copies to each card only that
rank's block of each leaf (``rules.place``).

The files are the reference's byte for byte: the same names
(``params__blocks.0.attn.wq.npy``), ``.npy`` payloads (u32 ciphertext
lines when sealed), SHA-256 digests and manifest (less ``meta.time``),
so either package restores the other's checkpoints. The engines run on
the manager's device: on the card a ColoE or Counter save makes its pads
with the ChaCha kernel and a restore unseals a leaf in one
``lines_unseal`` launch; Direct runs the AES kernel.

As in the reference, every leaf is sealed with the engine's default
``nonce2``, line addresses from 0 and write counter 0, so all leaves of
all checkpoints share one keystream (ROADMAP §3); the port keeps it so
that its files stay the reference's.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import u32
from repro_torch.config import SealConfig
from repro_torch.core import engine as E
from repro_torch.device import resolve_device
from repro_torch.sharding.api import is_dtensor
from repro_torch.tree import flatten_with_path, unflatten


def _rank_world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _host_copy(leaf) -> np.ndarray:
    """A numpy copy of a leaf that no later in-place update can reach (a
    DTensor's whole value, gathered from its shards)."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _flatten(tree, keep: bool = True) -> Dict[str, np.ndarray]:
    """{path: host copy} of a tree's leaves; with ``keep`` False (a rank
    that does not write) the DTensor leaves' gathers are joined, leaf by
    leaf, and their results dropped, and nothing is copied to the host."""
    if keep:
        return {"/".join(path): _host_copy(leaf)
                for path, leaf in flatten_with_path(tree)}
    for _, leaf in flatten_with_path(tree):
        if is_dtensor(leaf):
            leaf.full_tensor()
    return {}


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty((0,), np_dtype)).dtype


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((0,), dtype=dtype).numpy().dtype


class CheckpointManager:
    def __init__(self, directory: str, seal: Optional[SealConfig] = None,
                 key_bytes: bytes = bytes(range(32)), keep: int = 3,
                 device=None):
        self.dir = directory
        self.seal = seal if (seal and seal.mode != "none") else None
        self.key = key_bytes
        self.keep = keep
        self.device = resolve_device(device)
        self._engines: Dict[str, E.EngineProtocol] = {}
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def _engine(self, scheme: str):
        if scheme not in self._engines:
            self._engines[scheme] = E.make_engine(scheme, self.key,
                                                  self.device)
        return self._engines[scheme]

    # ---------------- save ----------------
    def save(self, step: int, params, opt_state=None,
             extra: Optional[dict] = None, blocking: bool = False):
        """Snapshot to host memory synchronously, seal and write
        asynchronously."""
        self.wait()
        writer = _rank_world()[0] == 0          # rank 0 writes
        host = {"params": _flatten(params, writer)}
        if opt_state is not None:
            host["opt"] = _flatten(opt_state, writer)
        meta = {"step": step, "time": time.time(),
                "sealed": bool(self.seal), **(extra or {})}
        if not writer:
            if blocking:
                self.wait()
            return
        self._thread = threading.Thread(
            target=self._write, args=(step, host, meta), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _seal_leaf(self, arr: np.ndarray):
        if arr.dtype.itemsize not in (2, 4) or arr.size == 0:
            return arr, None
        s = self._engine(self.seal.mode).encrypt(
            torch.from_numpy(arr).to(self.device))
        payload = u32.to_numpy(s.payload)
        ctr = None if s.counters is None else u32.to_numpy(s.counters)
        return payload, {"orig_len": s.orig_len, "shape": list(s.shape),
                         "dtype": str(arr.dtype), "nonce2": list(s.nonce2),
                         "scheme": s.scheme,
                         "counters": None if ctr is None else ctr.tolist()}

    def _write(self, step: int, host: dict, meta: dict):
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"meta": meta, "leaves": {}}
        for group, leaves in host.items():
            for key, arr in leaves.items():
                fname = f"{group}__{key.replace('/', '.')}.npy"
                seal_meta = None
                data = arr
                if self.seal is not None:
                    data, seal_meta = self._seal_leaf(arr)
                np.save(os.path.join(tmp, fname), data)
                with open(os.path.join(tmp, fname), "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
                manifest["leaves"][f"{group}/{key}"] = {
                    "file": fname, "sha256": digest,
                    "shape": list(arr.shape), "dtype": str(arr.dtype),
                    "seal": seal_meta,
                }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _rank_world()[1] > 1:
            import torch.distributed as dist
            dist.barrier()

    # ---------------- restore ----------------
    def list_steps(self):
        out = []
        for d in sorted(os.listdir(self.dir)):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return out

    def restore(self, step: Optional[int] = None, verify: bool = True):
        """-> (step, {'params': {path: np}, 'opt': {...}}) host arrays."""
        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no complete checkpoint in {self.dir}")
        step = steps[-1] if step is None else step
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for full, info in manifest["leaves"].items():
            group, key = full.split("/", 1)
            path = os.path.join(d, info["file"])
            if verify:
                with open(path, "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
                if digest != info["sha256"]:
                    raise IOError(
                        f"checksum mismatch for {full} at step {step}")
            arr = np.load(path)
            sm = info.get("seal")
            if sm is not None:
                dev = self.device
                buf = E.SealedBuffer(
                    sm["scheme"], u32.words(arr, dev),
                    None if sm["counters"] is None
                    else u32.words(np.array(sm["counters"], np.uint32), dev),
                    sm["orig_len"], tuple(sm["shape"]),
                    _torch_dtype(np.dtype(sm["dtype"])), tuple(sm["nonce2"]))
                arr = self._engine(sm["scheme"]).decrypt(buf).cpu().numpy()
            out.setdefault(group, {})[key] = arr
        return manifest["meta"]["step"], out


def rebuild_tree(template, flat: Dict[str, np.ndarray], device=None):
    """Host dict -> a tree shaped like ``template`` (tensors, ``meta`` ones
    from ``param_spec`` included), each leaf in the template leaf's dtype
    and shape, on ``device`` (the CPU when None), or, when ``device`` is a
    ``(mesh, spec_tree)`` pair, as DTensors on the mesh laid out by the
    specs (the reference's ``rebuild_tree(..., shardings)``), each rank
    copying only its own block of each leaf to its card."""
    if isinstance(device, tuple):
        from repro_torch.sharding.rules import _spec_leaves, place
        mesh, specs = device
        dev = _mesh_device(mesh)
        out = [place(flat["/".join(path)].reshape(tuple(leaf.shape)), mesh,
                     spec, leaf.dtype, dev)
               for spec, (path, leaf) in zip(_spec_leaves(specs),
                                             flatten_with_path(template))]
        return unflatten(template, out)
    out = []
    for path, leaf in flatten_with_path(template):
        arr = flat["/".join(path)].astype(_numpy_dtype(leaf.dtype))
        out.append(torch.from_numpy(arr.reshape(tuple(leaf.shape))).to(device))
    return unflatten(template, out)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
