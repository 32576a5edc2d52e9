"""Fused decrypt-in-matmul over tile-sealed weights: the Hopper kernels and
their plain PyTorch version.

Port of ``repro/kernels/sealed_matmul.py::sealed_matmul`` (kernel body
``_make_kernel``), as three kernels that compute the same function:

* ``csrc/sealed_matmul.cu`` (``sealed_matmul_cuda``): f32 FMAs on the CUDA
  cores, any M; f32 compute, seal tiles with ``bn == 8`` and every shape the
  other two do not take;
* ``csrc/sealed_matmul_dec.cu`` (``sealed_matmul_dec_cuda``): bf16 ``wgmma``
  with swapped operands (the decrypted weight tile is the 64-row A operand)
  fed by a TMA ring, for bf16 compute at decode sizes (M <= 64,
  N % 64 == 0, ``bn >= 16``), split K reduced inside the launch;
* ``csrc/sealed_matmul_tc.cu`` (``sealed_matmul_tc_cuda``): bf16 ``wgmma``
  on the tensor cores with a TMA ring, for bf16 compute at prefill sizes
  (M > 64, N % 128 == 0, ``bn >= 16``).

``sealed_matmul`` picks one by ``_variant`` from dtype and shape alone; each
counts its own launches. The headers of the CUDA sources give the keystream
contract and the designs.

What bounds it on this card: at decode it reads 4 bytes of ciphertext per
weight word and makes one ChaCha block (976 integer operations) per 16
encrypted words. At full internlm2-1.8B width one decode tick reads about
6.8 GB (1.70 B words) and, with every row encrypted, needs about 106 M
blocks; so the bound is the ChaCha arithmetic or the weight reads, whichever
is larger: the arithmetic where more than about 65% of rows are encrypted,
the reads at SE ratio 0.5. The kernels make each pad once per word (all M
rows of a column strip in one block, split-K for occupancy) and skip the
pads of plaintext rows.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.chacha20 import chacha20_blocks_plain

BK, BN = 32, 64          # the CUDA-core kernel's K step and column strip
_TARGET_BLOCKS = 1600    # ~2 waves of resident blocks on 132 SMs
TC_MIN_M = 65            # the tensor-core kernel takes M above decode sizes
TC_BN = 128              # ... and N in whole 128-column tiles
DEC_MAX_M = 64           # the decode kernel takes 1 <= M <= 64,
DEC_BN = 64              # ... N in whole 64-column strips,
DEC_BK = 64              # ... and K in slabs of 64 rows
DEC_SLOTS = 2 * 132      # two resident blocks on each of the H100's 132 SMs


def sealed_matmul_plain(x, w_ct, row_mask, key_words, nonce_words,
                        write_counter, *, bk: int, bn: int,
                        compute_dtype: str = "float32") -> torch.Tensor:
    """Unseal in PyTorch (plain ChaCha rounds), then round both operands to
    ``compute_dtype`` and multiply in f32."""
    cdt = getattr(torch, compute_dtype)
    w = _ref.unseal_weights_ref(w_ct, key_words, nonce_words, bk, bn,
                                row_mask, write_counter,
                                block_fn=chacha20_blocks_plain)
    return x.to(cdt).float() @ w.to(cdt).float()


def _pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


def _variant(m: int, n: int, bk: int, bn: int, compute_dtype: str) -> str:
    """The kernel a CUDA call runs, by dtype and shape only. For bf16 compute
    with seal tiles that are powers of two of at least 16 columns (every
    tile ``sealed_store._pick_block`` picks, but bn = 8):
    ``"sealed_matmul_tc"`` (tensor cores, prefill sizes) for M > 64 and N a
    multiple of 128, ``"sealed_matmul_dec"`` (tensor cores, decode sizes)
    for M <= 64 and N a multiple of 64. Everything else, f32 compute
    included, runs ``"sealed_matmul"`` (CUDA cores)."""
    if compute_dtype == "bfloat16" and bn >= 16 and _pow2(bn) and _pow2(bk):
        if m >= TC_MIN_M and n % TC_BN == 0:
            return "sealed_matmul_tc"
        if m <= DEC_MAX_M and n % DEC_BN == 0:
            return "sealed_matmul_dec"
    return "sealed_matmul"


def dec_geometry(m: int, k: int, n: int) -> Tuple[int, int, int, int]:
    """Launch geometry of the decode kernel: (wgmma width NW, column strips,
    K splits, rows of K per split). NW is M rounded up to 8, 16, 32 or 64;
    a block takes one 64-column strip and one K range of whole 64-row slabs,
    and the split divides the slab count, so every block has the same work.
    The split is the fewest whose slabs per SM slot (``DEC_SLOTS`` blocks
    run at a time) come within 10% of the least, among splits that give at
    least one block per SM: fewer splits mean less split-K traffic and fewer
    fixed costs per block."""
    if not 1 <= m <= DEC_MAX_M:
        raise ValueError(f"M={m}: the decode kernel takes 1 <= M <= "
                         f"{DEC_MAX_M}")
    nw = 8 if m <= 8 else 16 if m <= 16 else 32 if m <= 32 else 64
    strips = n // DEC_BN
    slabs = -(-k // DEC_BK)
    splits = [s for s in range(1, slabs + 1) if slabs % s == 0]
    full = [s for s in splits if strips * s >= DEC_SLOTS // 2]
    splits = full or splits[-1:]
    cost = {s: max(1.0, strips * s / DEC_SLOTS) * (slabs // s)
            for s in splits}
    least = min(cost.values())
    split = min(s for s in splits if cost[s] <= 1.1 * least)
    return nw, strips, split, slabs // split * DEC_BK


# per device: the decode kernel's split-K workspace (splits x N x NW f32
# partial sums) and its per-strip arrival counters (int32, zero between
# launches); grown when a call needs more, never shrunk
_DEC_WORK: Dict[str, Dict[str, torch.Tensor]] = {}


def _dec_workspace(dev, part_numel: int, strips: int):
    work = _DEC_WORK.setdefault(str(dev), {})
    part = work.get("part")
    if part is None or part.numel() < part_numel:
        part = work["part"] = torch.empty((part_numel,), dtype=torch.float32,
                                          device=dev)
    cnt = work.get("counters")
    if cnt is None or cnt.numel() < strips:
        cnt = work["counters"] = torch.zeros((strips,), dtype=torch.int32,
                                             device=dev)
    return part, cnt


def _launch_shape(m: int, k: int, n: int):
    """(bm, splits, rows per split). bm: the fewest rows of M a block takes
    (8, 16, 32 or 64) that hold M; then split K until there are enough
    blocks to fill the card."""
    bm = 8 if m <= 8 else 16 if m <= 16 else 32 if m <= 32 else 64
    tiles = -(-n // BN) * -(-m // bm)
    steps = -(-k // BK)
    want = max(1, min(steps, -(-_TARGET_BLOCKS // tiles)))
    per = -(-steps // want)
    return bm, -(-steps // per), per * BK


def sealed_matmul_cuda(x, w_ct, row_mask, key_words, nonce_words,
                       write_counter, *, bk: int, bn: int,
                       compute_dtype: str = "float32") -> torch.Tensor:
    """Launch ``csrc/sealed_matmul.cu`` on PyTorch's current stream.

    x (M, K) f32 or bf16 (widened to f32: exact); w_ct (K, N) int32 words;
    row_mask (K,) bool/uint8; key (8,) and nonce (3,) int32 words;
    write_counter a (1,) or () int32 word on the card (read by the kernel,
    so no host sync)."""
    x, w_ct, mask, key_words, nonce_words, wc = _checked(
        x, w_ct, row_mask, key_words, nonce_words, write_counter, bk=bk,
        bn=bn, compute_dtype=compute_dtype)
    x = x.float().contiguous()
    m, k = x.shape
    n = w_ct.shape[1]
    dev = x.device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    bm, splits, kps = _launch_shape(m, k, n)
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
            if splits > 1 else out)
    fn = _build.load("sealed_matmul").sealed_matmul
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), w_ct.data_ptr(), mask.data_ptr(),
                key_words.data_ptr(), nonce_words.data_ptr(), wc.data_ptr(),
                part.data_ptr(), out.data_ptr(), m, k, n, bk, bn, bm, splits,
                kps, int(compute_dtype == "bfloat16"), stream)
    _build.check(rc, "sealed_matmul")
    sealed_matmul_cuda.launches += 1
    return out


def sealed_matmul_tc_cuda(x, w_ct, row_mask, key_words, nonce_words,
                          write_counter, *, bk: int, bn: int,
                          compute_dtype: str = "bfloat16") -> torch.Tensor:
    """Launch ``csrc/sealed_matmul_tc.cu`` on PyTorch's current stream.

    Operands as ``sealed_matmul_cuda``; x is rounded to bf16 (round to
    nearest even, the rounding the CUDA-core kernel applies) unless it is
    bf16 already. Takes ``compute_dtype="bfloat16"``, N % 128 == 0 and seal
    tiles that are powers of two with ``bn >= 16`` only; raises on anything
    else."""
    if compute_dtype != "bfloat16":
        raise ValueError("the tensor-core kernel computes in bfloat16 only")
    x, w_ct, mask, key_words, nonce_words, wc = _checked(
        x, w_ct, row_mask, key_words, nonce_words, write_counter, bk=bk,
        bn=bn, compute_dtype=compute_dtype)
    m, k = x.shape
    n = w_ct.shape[1]
    if n % TC_BN or bn < 16 or not (_pow2(bk) and _pow2(bn)):
        raise ValueError(f"N={n}, bk={bk}, bn={bn}: the tensor-core kernel "
                         f"takes N % {TC_BN} == 0 and seal tiles that are "
                         f"powers of two with bn >= 16")
    x = x.to(torch.bfloat16).contiguous()
    for name, t in (("x", x), ("w_ct", w_ct)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned, which TMA "
                             f"needs")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    fn = _build.load("sealed_matmul_tc").sealed_matmul_tc
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w_ct.data_ptr(), mask.data_ptr(),
                key_words.data_ptr(), nonce_words.data_ptr(), wc.data_ptr(),
                out.data_ptr(), m, k, n, bk, bn, stream)
    _build.check(rc, "sealed_matmul_tc")
    sealed_matmul_tc_cuda.launches += 1
    return out


def sealed_matmul_dec_cuda(x, w_ct, row_mask, key_words, nonce_words,
                           write_counter, *, bk: int, bn: int,
                           compute_dtype: str = "bfloat16") -> torch.Tensor:
    """Launch ``csrc/sealed_matmul_dec.cu`` on PyTorch's current stream.

    Operands as ``sealed_matmul_cuda``; x is rounded to bf16 (round to
    nearest even) unless it is bf16 already. Takes
    ``compute_dtype="bfloat16"``, 1 <= M <= 64, N % 64 == 0 and seal tiles
    that are powers of two with ``bn >= 16`` only; raises on anything else.
    The split-K workspace is the device's (``_dec_workspace``): launches that
    share it run one after another on one stream."""
    if compute_dtype != "bfloat16":
        raise ValueError("the decode kernel computes in bfloat16 only")
    x, w_ct, mask, key_words, nonce_words, wc = _checked(
        x, w_ct, row_mask, key_words, nonce_words, write_counter, bk=bk,
        bn=bn, compute_dtype=compute_dtype)
    m, k = x.shape
    n = w_ct.shape[1]
    if m > DEC_MAX_M or n % DEC_BN or bn < 16 or not (_pow2(bk)
                                                      and _pow2(bn)):
        raise ValueError(f"M={m}, N={n}, bk={bk}, bn={bn}: the decode kernel "
                         f"takes M <= {DEC_MAX_M}, N % {DEC_BN} == 0 and seal "
                         f"tiles that are powers of two with bn >= 16")
    x = x.to(torch.bfloat16).contiguous()
    if x.data_ptr() % 16:       # TMA reads from 16-byte aligned rows
        x = x.clone()
    if w_ct.data_ptr() % 16:
        raise ValueError("w_ct is not 16-byte aligned, which TMA needs")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    nw, strips, splits, kps = dec_geometry(m, k, n)
    part, counters = _dec_workspace(x.device, splits * n * nw if splits > 1
                                    else 1, strips)
    fn = _build.load("sealed_matmul_dec").sealed_matmul_dec
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w_ct.data_ptr(), mask.data_ptr(),
                key_words.data_ptr(), nonce_words.data_ptr(), wc.data_ptr(),
                part.data_ptr(), counters.data_ptr(), out.data_ptr(), m, k, n,
                bk, bn, splits, kps, stream)
    _build.check(rc, "sealed_matmul_dec")
    sealed_matmul_dec_cuda.launches += 1
    return out


def _checked(x, w_ct, row_mask, key_words, nonce_words, write_counter, *,
             bk: int, bn: int, compute_dtype: str):
    """Validate the operands of either kernel; return them contiguous, the
    mask as (K,) and the write counter as a tensor on x's device."""
    m, k = x.shape
    k2, n = w_ct.shape
    dev = x.device
    if k != k2:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ "
                         f"{tuple(w_ct.shape)}")
    if k % bk or n % bn or bk % 8 or bn % 8:
        raise ValueError(f"({k}, {n}) not tiled by seal tiles ({bk}, {bn})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w_ct.dtype != torch.int32 or key_words.dtype != torch.int32 or \
            nonce_words.dtype != torch.int32:
        raise TypeError("w_ct / key / nonce must be int32 u32 words")
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {compute_dtype!r}")
    wc = torch.as_tensor(write_counter, device=dev)
    if wc.dtype != torch.int32 or wc.numel() != 1:
        raise TypeError("write_counter must be one int32 word")
    mask = row_mask.reshape(k)
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"row_mask must be bool or uint8, got {mask.dtype}")
    ops = (x, w_ct, mask, key_words, nonce_words, wc)
    if any(t.device != dev for t in ops):
        raise ValueError("sealed_matmul operands must share one device")
    if key_words.numel() != 8 or nonce_words.numel() != 3:
        raise ValueError("key must be 8 words and nonce 3 words")
    if m * n >= 2**31 or k * n >= 2**32:
        raise ValueError(f"shape ({m}, {k}, {n}) exceeds the kernel's indices")
    return tuple(t.contiguous() for t in ops)


def sealed_matmul(x, w_ct, row_mask, key_words, nonce_words, write_counter,
                  *, bk: int, bn: int,
                  compute_dtype: str = "float32") -> torch.Tensor:
    """(M, N) f32. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel ``_variant`` names, or raises."""
    if not x.is_cuda:
        fn = sealed_matmul_plain
    else:
        v = _variant(x.shape[0], w_ct.shape[1], bk, bn, compute_dtype)
        fn = (sealed_matmul_tc_cuda if v == "sealed_matmul_tc" else
              sealed_matmul_dec_cuda if v == "sealed_matmul_dec" else
              sealed_matmul_cuda)
    return fn(x, w_ct, row_mask, key_words, nonce_words, write_counter,
              bk=bk, bn=bn, compute_dtype=compute_dtype)


sealed_matmul_cuda.launches = 0
sealed_matmul_tc_cuda.launches = 0
sealed_matmul_dec_cuda.launches = 0
