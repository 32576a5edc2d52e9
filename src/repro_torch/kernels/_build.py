"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. Builds go to
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the sources, so an edited source rebuilds and an
unchanged one loads. Nothing is built at import: a kernel is built at its
first launch, or by ``build_all`` (which starts one ``nvcc`` per source, all
at once). ``load`` sets the ctypes prototype of each function a library
exports (``PROTOTYPES``) once, when it first loads the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("chacha20", "sealed_matmul", "flash_attention",
           "sealed_matmul_tc", "flash_attention_tc", "flash_attention_tc256",
           "sealed_matmul_dec", "chacha20_cache", "chacha20_lines",
           "chacha20_weights", "aes128")

_P, _I, _L, _F, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float, ctypes.c_uint)
# Each library's exported functions and their argument types (pointers and
# the stream as c_void_p, so that ctypes does not cut them to 32 bits); every
# one returns an int error code.
PROTOTYPES = {
    "chacha20": {"chacha20_blocks": [_P, _P, _P, _I, _P, _I, _P]},
    "sealed_matmul": {"sealed_matmul": [_P] * 8 + [_I] * 9 + [_P]},
    "sealed_matmul_tc": {"sealed_matmul_tc": [_P] * 7 + [_I] * 5 + [_P]},
    "sealed_matmul_dec": {"sealed_matmul_dec": [_P] * 9 + [_I] * 7 + [_P]},
    "flash_attention": {"flash_attention": [_P] * 4 + [_I] * 6 + [_L] * 12
                        + [_F, _F, _I, _I, _P]},
    "flash_attention_tc": {"flash_attention_tc": [_P] * 4 + [_I] * 6
                           + [_L] * 12 + [_F, _F, _I, _P]},
    "flash_attention_tc256": {"flash_attention_tc256": [_P] * 4 + [_I] * 6
                              + [_L] * 12 + [_F, _F, _I, _I, _P]},
    "chacha20_cache": {
        "cache_view": [_P] * 3 + [_L] * 2 + [_P] * 5 + [_I] * 4 + [_U] * 6
                      + [_I, _P],
        "cache_splice": [_P] * 3 + [_L] * 4 + [_P] * 7 + [_I] * 8 + [_U] * 6
                        + [_I, _P],
        "cache_copy": [_P] * 3 + [_L] * 4 + [_P] * 5 + [_I] * 3 + [_U] * 6
                      + [_I, _P],
        "cache_tags": [_P] * 4 + [_L] * 4 + [_P] * 5 + [_I] * 3 + [_U] * 6
                      + [_I, _P],
        "cache_verify": [_P] * 4 + [_L] * 4 + [_P] * 2 + [_L] * 2
                        + [_P] * 5 + [_I] * 5 + [_U] * 6 + [_I, _P]},
    "chacha20_lines": {
        "lines_unseal": [_P] * 3 + [_L] * 2 + [_U] * 2 + [_P] * 2,
        "lines_gather_rows": [_P] * 3 + [_U] * 2 + [_P] + [_L] * 3
                             + [_I] * 2 + [_P] * 2},
    "chacha20_weights": {
        "tile_tags": [_P] * 6 + [_I] * 5 + [_U] * 3 + [_I, _P],
        "line_tags": [_P] * 4 + [_L] + [_U] * 4 + [_P] * 2},
    "aes128": {"aes128_encrypt": [_P] * 3 + [_L, _P, _L, _P, _P],
               "aes128_decrypt": [_P] * 4 + [_L] * 2 + [_P] * 2},
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    cand = Path("/usr/local/cuda/bin") / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{name} not found: the CUDA kernels build only where "
                       f"the CUDA toolkit is installed")


def _command(name: str, out: Path) -> List[str]:
    return [_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
            "-v",
            "-I", str(CSRC), "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every listed source that has no up-to-date library, one
    ``nvcc`` per source, all started together. Returns each source's
    compiler report (``-Xptxas -v``: registers, shared memory, spills);
    raises if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs: List[Tuple[str, Path, Path, subprocess.Popen]] = []
    reports: Dict[str, str] = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            reports[name] = "up to date"
            continue
        tmp = out.with_name(f"tmp{os.getpid()}-{out.name}")
        procs.append((name, out, tmp, subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed,
    with its functions' prototypes set."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in PROTOTYPES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def sass_counts(names=SOURCES, opcodes=("HGMMA", "HMMA")) -> Dict[str, Dict]:
    """For each built library, how many SASS instructions of each opcode
    ``cuobjdump -sass`` lists: HGMMA is ``wgmma``, HMMA ``mma.sync``, so a
    non-zero count shows the tensor cores are used."""
    tool = _tool("cuobjdump")
    counts = {}
    for name in names:
        sass = subprocess.run([tool, "-sass", str(_lib_path(name))],
                              capture_output=True, text=True, check=True
                              ).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass))
                        for op in opcodes}
    return counts


def sass_opcodes(name: str, per_function: bool = False) -> Dict:
    """How many SASS instructions of each opcode (with its modifiers, e.g.
    ``IMAD.IADD``, ``LOP3.LUT``, ``SHF.L.W.U32.HI``) ``cuobjdump -sass``
    lists in the built library: the static mix, which tells which pipe an
    unrolled loop such as the ChaCha rounds issues on. ``per_function``:
    one such count for each kernel, keyed by its mangled name."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    line = r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
    parts = re.split(r"Function : (\S+)", sass)
    by_fn: Dict[str, Dict[str, int]] = {}
    for fn, body in zip(parts[1::2], parts[2::2]):
        counts = by_fn.setdefault(fn, {})
        for m in re.finditer(line, body):
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    if per_function:
        return by_fn
    counts: Dict[str, int] = {}
    for fn_counts in by_fn.values():
        for op, n in fn_counts.items():
            counts[op] = counts.get(op, 0) + n
    return counts


def check(rc: int, what: str) -> None:
    """Raise on a non-zero code returned by a launch: a ``cudaError_t``, or
    from the tensor-core kernels 10001 (the driver's
    ``cuTensorMapEncodeTiled`` not found) or 20000 + the ``CUresult`` of a
    tensor map that did not encode."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with code {rc}")
