#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--report out.json]

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (printing
``-Xptxas -v`` and, from ``cuobjdump -sass``, each library's count of
tensor-core instructions), prints the card's name and power limit, and then
runs:

1. the ChaCha20 kernel against its plain PyTorch version, bitwise; then
   the kernels that make ChaCha pads where they are used (the paged cache's
   view and splice, the line layout's unseal and row gather), each launched
   twice and held bitwise against its plain version at the main path's
   shapes (4 slots x 16 blocks of 8192 words, the splice at C = 1 and 32
   over 24 layers, the embedding's rows at B*S = 4 and 3560) and at the
   edges (partial 16-word units, lengths 0 and full, counts 0, write
   counters at 2^32 - 1, ColoE and counter layouts, mixed SE flags, rows off
   line boundaries), and timed there beside their bounds and plain
   versions; likewise the paged cache's copy-on-write re-key (one pair over
   24 layers, partial units, a masked pair), MAC tags (a view's verdict
   over 4 slots x 16 blocks, a splice's re-tag over 24 layers, partial
   geometries, dead and repeated entries, words with bit 31 set) and the
   pass's MAC check (every layer of 4 slots x 16 blocks in one launch,
   right and with a flipped word in the first layer, the last layer and
   past a slot's length, and partial geometries), the check timed over a
   tick's resident blocks;
2. the three fused decrypt-in-matmul kernels against their plain version
   at the full-width internlm2-1.8B shapes (wq/wo, wk/wv, MLP wi/wo, LM
   head), at phase 10's Qwen3-30B-A3B shapes (wq, wk/wv at N 512, wo
   at K 4096, the head at N 151,936) and at phase 11's (gemma2's K 2304,
   deepseek-coder's wq N 8192, MLP wi N 19,200 and wo K 19,200, head N
   32,256, RecurrentGemma's MLP N/K 12,288 and wk/wv N 256: the decode
   kernel at every decode M, the prefill kernel at each family's prefill
   M): the CUDA-core kernel at decode M and
   at a ragged M of 1000 rows, the decode tensor-core kernel at M of 1, 4,
   8, 16, 32, 33 and 64 (each case launched twice, bitwise equal), the
   prefill tensor-core kernel at M of 128, 1000 and each model's group
   prefill's M, SE 0/0.5/1, write counters 0 and 5;
3. both flash-attention kernels against their plain version: the reference
   test's grid, the group prefill's full-width shape and phase 10's (GQA
   8:1 at head dim 128), a gemma2-like head dim of 256 with window and
   softcap, phase 11's prefills (gemma2 at head dim 256 with softcap 50
   and window 4096, deepseek-coder's GQA 64:8 at 128, RecurrentGemma's
   MQA 16:1 at 256 with window 2048, past it), and a short-query case, in
   f32 and bf16 through the CUDA-core kernel, and the bf16 cases of head
   dim 64 and 128 through the tensor-core kernel
   ``csrc/flash_attention_tc.cu``, of 256 through
   ``csrc/flash_attention_tc256.cu``, under ``flash_attention.bf16_gate``;
4. sealed continuous-batching serving of internlm2-1.8B at full width (ColoE,
   SE ratio 0.5, fused decrypt, sealed KV cache): 8 greedy requests through
   ``ServeEngine``, launch counts read around that run (exactly 24 cache
   views, one splice, one embedding-row gather and one unseal per other
   line leaf per dispatch, and no launch of the keystream kernel
   `chacha20.cu`, which only sealing runs now), the first decode
   tick's logits held against a plaintext engine's on the same tokens (in
   bf16, and in f32 where only sum order separates the two), and a
   reduced-size run on the card held against the CPU plain path;
5. sealed group-drain serving at full width: 8 greedy requests of 512-1024
   prompt tokens through ``launch.serve.drive`` on a sealed
   ``GroupServeEngine`` (one-shot prefill through the flash kernel) and a
   plaintext one, launch counts read around the sealed run (the embedding's
   rows through the gather kernel every dispatch), teacher-forced
   prefill and first-step logits sealed vs plaintext (bf16 and f32), and
   one 1024-token prompt's one-shot prefill held against the chunked path
   of phase 4;
6. prefix sharing and cache integrity at full width: (a) a sealed engine
   with ``prefix_share=True`` on 8 greedy requests behind a common
   203-token prefix (one of them a resubmitted prompt, so a tail block is
   copied on write), gated on shared blocks, copies equal to the copy
   kernel's launches, the mirror, registry-only refcounts after the drain,
   ``evict_lru`` freeing every block, and teacher-forced f32 logits shared
   against unshared at 1e-4; (b) a verified sealed cache on phase 4's
   trace, its tokens equal to the unverified run's, no MAC failure,
   ``mac_checks`` as the reference counts them, one verify launch per
   dispatch and pattern position (every layer's check) and one tag launch
   per splice; (c) each tamper kind detected and recovered, the
   other requests exact, no block leaked; (d) a verified tick beside an
   unverified one and a copy-on-write admission, timed, and the verify
   kernel bitwise and timed at the verified engine's own pools, tables and
   lengths (the operands of its next tick's check);
7. CUDA-event timings of every kernel variant, old beside new (the fused
   matmul's decode kernels on every leaf at M = 4 and 32, and their sum
   over a decode tick's 169 launches; flash beside
   ``scaled_dot_product_attention`` under each backend that runs, the
   fastest as the library yardstick), of the keystream kernel at the two
   kinds of call the serving path made of it before its pads moved into
   the fused ChaCha kernels, of one decode tick and of one
   group prefill and decode step, each kernel beside the least time the
   card could take for the same work, and profiler splits of sealed decode
   ticks and of a sealed and a plaintext group prefill (each ChaCha
   kernel's device time and the idle share among them). A device-side
   sleep before each timed window keeps the host's dispatch out of it; a
   kernel's time is the mean over the launches, logged beside the median
   where a phase reads both, with the host's time in each window;
8. verified sealed weights and sampling at full width: (a) the weight MAC
   kernels ``tile_tags`` and ``line_tags`` bitwise, twice, against their
   plain versions and the stored tags (one stack slice of every tile leaf,
   the head, the norms and the embedding's last 65,536 lines at their own
   addresses), and at small, misaligned and counter-layout shapes, timed
   beside their bounds; (b) ``verify_params`` over the whole image: True,
   one tag launch a leaf, False after a flipped encrypted tile word, head
   word or embedding line word, True once restored and after a bypass-row
   flip, the sweep timed against its bound; (c) phase 4's trace through a
   verified ColoE engine with a sealed cache, its tokens phase 4's, no MAC
   failure, ``mac_checks`` one sweep plus the cache checks, and a weight
   tamper stopping the drain (``SealedIntegrityError("weights")``) before
   any token; (d) phase 4's trace with mixed temperature / top-k / top-p
   settings twice (equal streams, every request complete), the sampler's
   bits and tokens on the card equal to the CPU plain path's on saved
   logits and keys, an all-greedy run with phase 4's launches and no
   device draw, and a sampled tick beside a greedy one (events, host clock,
   profiler);
9. the Direct engine (AES-128-ECB, the paper's baseline) at full width:
   (a) the AES kernel (``csrc/aes128.cu``) bitwise against its plain
   version, each case launched twice: the FIPS-197 C.1 vector both ways,
   runs of blocks, the CTR keystream at two tweaks, line encrypt and
   decrypt at lengths off whole lines and blocks with every kind of flag,
   an odd bf16 leaf, one stack slice of MLP wi and the embedding's last
   65,536 lines at their own offsets in the sealed image (and equal to
   it), timed beside their bounds; (b) the image sealed (one encrypt launch
   a leaf, timed) and unsealed bit for bit; (c) phase 4's trace through a
   Direct engine with a sealed cache: every request complete, tokens equal
   to a plaintext engine's, one decrypt launch a leaf a dispatch and no
   fused matmul or embedding gather, the whole image as plaintext bytes a
   step, teacher-forced prefill and first-tick logits bitwise equal to
   plaintext in bf16 and in f32; (d) the same verified (one line-tag sweep,
   tokens equal) and a flipped enciphered or bypass line word stopping the
   drain with ``SealedIntegrityError("weights")`` before any token; (e) one
   dispatch's decrypt of the whole image against its bound, by events
   after an L2 flush and without it, and by the profiler's kernel time
   over the same calls, and a Direct tick beside a ColoE and a plaintext
   tick (events, host clock, profiler);
10. the MoE family: Qwen3-30B-A3B at its published widths (128 experts of
   d_ff 768, top-8, GQA 32/4, vocab 151,936), 6 of its 48 layers: (a) the
   image sealed and unsealed bit for bit, ``lines_unseal`` over a whole
   4.8 GB stacked expert leaf twice and bitwise against its plain version
   at the leaf's start, across its 2^31- and 2^32-byte offsets and at its
   end, timed against its bound; (b) teacher-forced logits and routes,
   sealed vs plaintext (f32 gated: logits at 1e-4, every expert choice and
   kept flag equal; bf16 reported); (c) a staggered trace on 8 slots with
   padded chunk dispatches, launches gated, tokens against plaintext
   reported, a verified run equal to it (its cache checks, re-tags and
   weight sweep's launches gated) and a flipped expert word stopping the
   drain; the same trace under the Direct engine (tokens equal to
   plaintext, one AES decrypt a leaf a dispatch, its tick and the expert
   leaves' decrypt timed, peak memory); (d) a group drain of
   512-1024-token prompts; (e) a decode tick and a group prefill timed and
   profiled, and peak memory (``phase_moe``);
11. the remaining token families at their published widths
   (``phase_families``): granite-3-2b (10 of 40 layers), gemma2-2b (8
   of 26) and deepseek-coder-33b (4 of 62) through the continuous engine (the image bit for
   bit, f32 sealed-vs-plaintext logits at 1e-4, a staggered trace with
   its launches gated per dispatch, a verified run, Direct for granite
   and gemma2 with tokens equal to plaintext), RecurrentGemma-9B (6 of
   39 layers) and Mamba2-130M through the group engine (the image, f32
   prefill and 6 decode steps at 1e-4, a recurrence step on the card
   against the CPU at 1e-5, drains under ColoE, Counter and Direct with
   their launches gated, the plaintext baseline); each family's tick and
   prefill beside plaintext (the dense families' one-shot prefill also
   counted: one flash launch an attention layer, of the kernel ``_kernel``
   names), the tied embeddings' unseal, the scans alone, flash at each
   family's prefill beside SDPA (at head dim 256 the tensor-core kernel on
   each of its grids, the CUDA-core one, and the plain version), peak
   memory, the phase's wall time;
12. the paper's own CNNs (``phase_cnn``): VGG-16, ResNet-18 and ResNet-34 at
   their published widths (13 / 17 / 33 convs of 64-512 channels) on 32 x 32
   CIFAR geometry, random weights from ``--seed``, f32 (cuDNN with TF32
   off): (a) ``init_cnn`` on the card against the CPU within 1e-6
   relative, logits, loss and the gradients with respect to every
   parameter and the input of a batch of 32 ``image_dataset`` images at
   1e-4 of each tensor's scale, and ``cnn_channel_masks`` at ratios
   0.2 / 0.5 / 0.8 equal on both; (b) the security protocol
   (``evaluate_config`` with ``evaluate``'s defaults: 2,500 training and
   400 test images, SE ratios 0.2 / 0.4 / 0.5 / 0.8, 15 / 12 epochs) for
   ResNet-18 and VGG-16 at full width, gated on every SE substitute's
   plaintext rows equal to the victim's bit for bit at init and after
   training, its learnt rows differing from the victim's and moved in
   training, and every accuracy and transfer rate finite in [0, 1]; the
   report, the victim's loss and each training run's wall time printed;
   a second witness to the victim (``_plain_cnn``, an independent plain
   PyTorch statement of the reference's network and loss under
   ``torch.optim.SGD``) trained from the same init on the same batches,
   its first loss gated against the port's at 1e-4 and its first epoch's
   losses, test accuracy and most predicted class's share printed beside
   the port's (at ``train_cnn``'s default learning rate of 2e-2 the port's
   victims at these widths predict one class; the victim is also trained
   at 1e-3, gated on a test accuracy of 0.5 or more); (c) one
   ``train_cnn`` step (forward,
   backward, update) of each at batch 128, and VGG-16's forward at the
   Figure-4 geometry (224 x 224, batch 16) layer by layer beside
   ``layer_traffic``'s bytes and MACs and each layer's bound (events,
   median of 20, L2 flushed); peak memory and the phase's wall time. No
   kernel of the port lies on this path: its convolutions are cuDNN's, as
   the reference's are XLA's;
13. training (``phase_train``): (a) every ``ARCH_ID``'s reduced config,
   one ``make_train_step`` step in f32 (microbatches 2, remat ``"full"``,
   batch 4, seq 16 of ``lm_batch``) and its full-batch gradients on the
   card against the CPU from the same params: loss, ce, aux and grad_norm
   within 1e-5 relative, every gradient within 1e-4 of its scale, params
   after the step within ``2·lr + 1e-4·scale`` and at least 99.9% of each
   tensor's within ``1e-4·scale``, of the elements whose gradient is 0 or
   far enough from 0 that the gradient gate's allowance cannot move
   AdamW's first step ``lr·g/(|g|+eps)`` by that much; (b) internlm2-1.8B at full width, all
   24 layers, through ``train`` for 12 steps (batch 8, seq 512,
   microbatches 2, remat ``"save_carries"``), gated on finite losses whose
   last three average at least 1 nat below the first, with the step time
   (events), tokens/s, the share of the bf16 peak, ``adamw.update`` alone
   beside its byte bound, one step profiled and peak memory; (c) (a)'s
   gates at full width with 2 of the 24 layers; (d) sealed ColoE
   checkpoints of those 2 layers at full width: 6 steps saving every 3
   (async), the stored leaf ciphertext, a flipped byte caught, a fresh
   ``train`` resuming at step 3 (the restored state the saved one bit for
   bit, its losses the straight run's within 1e-5), the ChaCha kernel at
   every save (one launch or more a leaf), one ``lines_unseal`` a restored
   leaf, no plain sealing version called; the reduced config sealed under
   ColoE, Counter and Direct on the card and on the CPU with equal
   manifests; (e) internvl2-1b and musicgen-medium at their published
   widths, 3 steps each on ``lm_batch``'s embeds, gated on finite losses,
   with step times and peak memory. Training attention is ``_sdpa``, as in
   the reference; the flash kernel has no backward and refuses autograd;
14. the paper's sealed-decode comparison and the step builders
   (``phase_sealed_decode``): (a) ``launch.sealed_dryrun`` at the reduced
   granite-3-2b under its five weight-sealing variants (``baseline``,
   ``counter``, ``coloe``, ``coloe_se``, ``coloe_fused``) in f32 at
   decode_32k's 32,768 cache slots, batch 2: the card's first-step logits
   against the CPU's at 1e-4 relative, the unfused variants' bitwise equal
   to the baseline's, each step's launches gated; (b) granite-3-2b at its
   published 40 layers (2,533,529,600 parameters by ``param_count``, tied
   vocabulary 49,155) in bf16 at decode_32k's 32,768 slots filled from
   ``--seed``, batch 8 in place of 128 (the one cut: 128 rows would make a
   343.6 GB cache), each variant sealed once, stepped twice to warm up and
   timed over 10 (CUDA events, the median), one step profiled: gated on
   the unfused variants' logits bitwise equal to the baseline's, the fused
   variant's within 1e-4 of scale in f32 (the same model at batch 2; in
   bf16 its distance is reported beside that of two right plaintext
   steps, bf16 GEMMs against f32 sums of the same rounded operands, which
   40 random layers part by about 4.5e-2 on an NVIDIA H100 80GB HBM3 at
   700 W), the launches of a step equal to those
   the sealed tree gives (11 ``lines_unseal`` unfused; 280
   ``sealed_matmul_dec`` and 4 ``lines_unseal`` fused; none for the
   baseline; no keystream kernel in any step) and the plaintext bytes a
   step writes equal to the record's count; the kernel the bf16 fused
   step runs, ``sealed_matmul_dec``, held to ``layers.plain_matmul``
   within 2e-2 of scale on slice 0 of each of the 7 tile leaves, sealed
   as the variant seals it, at M = 8 in bf16; each variant's stored,
   materialized and KV bytes, peak and argument memory, its counted byte
   and FLOP bound, its ``roofline_row`` and its median step less the
   baseline's beside the spread of its 10 timed steps printed; (c)
   ``serve.step.make_paged_prefill`` and 16 ``make_paged_decode_step``s
   of internlm2-1.8B at full width on phase 4's prompts, sealed weights
   and sealed pools, teacher-forced on the contiguous plaintext path's
   greedy tokens: every prompt's logits within 2e-2 of that path's scale,
   17 splices and 384 views, no keystream kernel; the phase's wall time;
15. sharding on DTensor (``phase_sharded``), under a real NCCL process
   group of one rank (``launch.mesh.init_distributed``, a ``FileStore`` in
   a temporary directory, torn down at the phase's end) and a 1x1
   ("data", "model") ``DeviceMesh`` on the card: (a) each ``ARCH_ID``'s
   reduced config, one sharded ``make_train_step`` step in f32 (params,
   AdamW state and batch laid out by ``sharding.rules``) against the
   unsharded step on the card from the same params and batch: metrics
   within 1e-6 relative, gradients and params after the step within 1e-6
   of each tensor's scale; (b) internlm2-1.8B at full width, all 24
   layers, through ``train(cfg, tc, mesh)`` for 4 steps at phase 13 (b)'s
   settings: its losses equal 13 (b)'s first 4 within 1e-5 relative, its
   step time printed beside 13 (b)'s (the gap is DTensor's dispatch) with
   its peak memory; (c) 13 (d)'s two full-width layers and their AdamW
   state, saved sealed (ColoE) from the mesh and restored by
   ``elastic.rescale`` onto a fresh 1x1 mesh: the restored state equal to
   the saved one bit for bit, the manifest (every file's SHA-256) that of
   an unsharded save, ``chacha20`` at least once a leaf at the save and
   ``lines_unseal`` once a restored leaf, no plain sealing version called;
   (d) ``torch.distributed.run --standalone --nproc-per-node 1 -m
   repro_torch.launch.train --arch internlm2_1_8b`` twice on one
   checkpoint directory (while (c) runs), the second resuming, both
   exiting 0; (e) in a subprocess started before phase 14, beside which
   it runs (the fake group needs its own process), ``launch.dryrun`` of
   granite_3_2b decode_32k and internlm2_1_8b train_4k (one microbatch)
   on the 16x16 mesh and of granite_3_2b decode_32k on 2x16x16, and of
   qwen3_moe_30b_a3b and
   recurrentgemma_9b train_4k (one microbatch) on 16x16, the cells that
   run the per-shard MoE and RG-LRU regions: status ok, collective bytes
   above 0, ``flops_per_device * devices`` at least the matmul part of
   ``model_flops``, each ``roofline_row`` printed; and (a'), after (a), a
   fresh sharded start of internlm2-1.8B at 24 layers
   (``rules.init_params``, one leaf at a time) equal bit for bit to
   ``init_params``'s blocks, its peak printed beside the whole params;
16. the port's three examples as subprocesses on the card, side by side:
   ``examples/torch_quickstart.py`` (its eight steps; ``quickstart OK``
   last, step 5's fused product within 1e-4 of its scale of the plain one
   with at least one launch of ``csrc/sealed_matmul.cu``),
   ``torch_sealed_serving.py`` (the four modes' generations identical) and
   ``torch_train_lm.py`` at lm_100m for 30 steps (the last loss below the
   first).

Every phase raises on failure, so the script exits non-zero. The line before
the last is a JSON ``{"kernels": [...]}`` record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/`` beside it, it exits non-zero and prints no result.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA's data sheet), at the full 700 W
# power limit: the memory rate and the bf16 and f32 FLOP rates are the
# port's ``repro_torch.config.HW`` (``_hw``). The data sheet gives no
# integer rate. Its 67 TFLOP/s of f32
# outside the tensor cores is 132 SMs x 128 lanes x 2 FLOP
# (an FMA) x 1.98 GHz: one 32-lane warp instruction per clock in each of an
# SM's four schedulers. No 32-bit operation issues faster than that:
# 132 x 128 x 1.98e9 = 33.5e12 32-bit integer operations per second. The
# ChaCha rounds' XORs (LOP3) and rotations (SHF) have no form on the FMA
# pipe and issue on the integer ALU pipe, 16 lanes a clock in each
# scheduler: 132 x 64 x 1.98e9 = 16.7e12 a second (the SASS mix printed at
# build time shows the adds as IMAD.IADD, on the FMA pipe). A pad is held to
# both ceilings: all its operations at the issue rate, its XORs and
# rotations at the ALU rate.
INT32_OPS_PER_S = 132 * 128 * 1.98e9
ALU_OPS_PER_S = 132 * 64 * 1.98e9
# shared memory serves 32 banks x 4 bytes a clock in each SM: at most
# 132 x 32 x 1.98e9 = 8.36e12 table lookups (32-bit words) a second, the
# ceiling of AES's T-table rounds
LDS_WORDS_PER_S = 132 * 32 * 1.98e9
CHACHA_OPS = 976          # 20 rounds x 4 quarter-rounds x 12 ops + 16 adds
CHACHA_ALU_OPS = 640      # ... of which 320 XORs and 320 rotations
CHACHA_XOR_OPS = 16       # XOR of one block into 16 ciphertext words
# a MAC tag's hash, per 16-bit half of the block: its extraction (LOP3 or
# SHF, on the ALU pipe) and one 64-bit multiply-add (IMAD.WIDE, counted twice)
TAG_HALF_OPS = 3
TAG_HALF_ALU_OPS = 1

# SASS opcodes of 32-bit integer work that the ChaCha rounds may compile to
INT_OPCODES = ("IADD3", "IMAD", "LOP3", "SHF", "PRMT", "IADD", "LEA")
# ... and what the AES rounds issue: table reads (LDS) and the ALU work
# around them
AES_OPCODES = ("LDS", "PRMT", "LOP3", "SHF", "IMAD", "IADD3", "LEA", "LDG",
               "STG")

# the CUDA source of each kernel variant whose name is not its file's
SOURCE = {"chacha20_weight_tile_tags": "chacha20_weights",
          "chacha20_weight_line_tags": "chacha20_weights",
          "chacha20_cache_view": "chacha20_cache",
          "chacha20_cache_splice": "chacha20_cache",
          "chacha20_cache_copy": "chacha20_cache",
          "chacha20_cache_tags": "chacha20_cache",
          "chacha20_cache_verify": "chacha20_cache",
          "chacha20_lines_unseal": "chacha20_lines",
          "chacha20_lines_gather": "chacha20_lines",
          "aes128_lines_encrypt": "aes128",
          "aes128_lines_decrypt": "aes128"}

SM_REPLACES = "src/repro/kernels/sealed_matmul.py:94"
CC_REPLACES = "src/repro/kernels/chacha20.py:91"
FA_REPLACES = "src/repro/kernels/flash_attention.py:88"

# the serve phases: slots, requests and new tokens per request
SLOTS, REQUESTS, NEW_TOKENS = 4, 8, 16
# the group phase's prompt lengths and contiguous cache length
GROUP_PROMPT = (512, 1024)
GROUP_MAX_LEN = 1040
# the flash kernel's long-prompt timing shape: one sequence of this length
FLASH_LONG = 8192
# Kernel vs plain version, either compute dtype: both round the same operands
# and sum in f32, so only the order of the sums separates them.
KERNEL_TOL = 1e-4
# CUDA-core flash kernel vs plain version: both sum in f32, so in f32 they
# agree to 2e-5 of the output scale. A bf16 output is held element by element
# against the plain version's f32 result on the same bf16 inputs: one bf16
# rounding of each element (2^-8 of its size) plus the same 2e-5 of the
# scale. The tensor-core kernel rounds the probabilities to bf16 before
# p @ v, and is held to flash_attention.bf16_gate instead.
FLASH_TOL = 2e-5
BF16_ROUNDING = 2.0 ** -8
# device-side sleep before each timed launch (about 1 ms), so that the host
# has enqueued the start event and the launch before the device reaches them
SLEEP_CYCLES = 2_000_000


def flash_allowed(torch, want32, dtype):
    """Per-element tolerance of a flash output in ``dtype`` against the plain
    version's f32 result ``want32``."""
    allowed = FLASH_TOL * want32.abs().max()
    if dtype == torch.bfloat16:
        allowed = allowed + BF16_ROUNDING * want32.abs()
    return allowed


def log(*a):
    print(*a, flush=True)


def _hw():
    """The card's data-sheet constants, ``repro_torch.config.HW`` (the port
    is on the path once ``main`` has found it)."""
    from repro_torch.config import HW
    return HW


def bound_ms(nbytes, int_ops=0.0, bf16_flops=0.0, alu_ops=0.0, lookups=0.0,
             f32_flops=0.0):
    """Least time for the work: the larger of bytes over the memory rate and
    each kind of operation over its peak rate (``alu_ops``: the integer
    operations that only the ALU pipe issues; ``lookups``: 32-bit
    shared-memory table reads; ``f32_flops``: f32 on the CUDA cores, as the
    CNNs' convolutions run with TF32 off). Returns (ms, bound_by)."""
    hw = _hw()
    t_bytes = nbytes / hw["hbm_bw"]
    t_ops = max(int_ops / INT32_OPS_PER_S, alu_ops / ALU_OPS_PER_S,
                bf16_flops / hw["peak_flops_bf16"], lookups / LDS_WORDS_PER_S,
                f32_flops / hw["peak_flops_f32"])
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", default="",
                    help="also write every measured number to this JSON file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1

    from repro_torch.kernels import _build
    t0 = time.time()
    reports = _build.build_all()
    log(f"[build] {time.time() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "ptxas" in line or "spill" in line or "up to date" in line:
                log(f"[build:{name}] {line.strip()}")
    sass = _build.sass_counts()
    for name, counts in sass.items():
        log(f"[build:{name}] SASS tensor-core instructions: "
            + ", ".join(f"{op} {n}" for op, n in counts.items()))
    for name in ("sealed_matmul_tc", "flash_attention_tc",
                 "flash_attention_tc256", "sealed_matmul_dec"):
        if not sass[name]["HGMMA"]:
            raise AssertionError(f"{name} has no wgmma (HGMMA) instruction")
    # which pipes the ChaCha rounds issue on: the integer mix of each
    # library that makes pads (static counts; the rounds are unrolled)
    int_ops = {}
    for name in ("chacha20", "sealed_matmul_dec", "chacha20_cache",
                 "chacha20_lines", "aes128"):
        mix = _build.sass_opcodes(name)
        int_ops[name] = {op: n for op, n in sorted(mix.items())
                         if op.split(".")[0] in INT_OPCODES + ("LDS",)}
        log(f"[build:{name}] SASS integer mix: " + ", ".join(
            f"{op} {n}" for op, n in int_ops[name].items()))
    # the AES kernel's two instantiations apart (by direction): its ten
    # rounds are unrolled, so a tenth of each count is a round's
    import re
    for fn, mix in _build.sass_opcodes("aes128", per_function=True).items():
        kinds = {}
        for op, n in mix.items():
            kinds[op.split(".")[0]] = kinds.get(op.split(".")[0], 0) + n
        m = re.search(r"aes128_kernelILb(\d)E", fn)
        key = (f"aes128:{'decrypt' if m.group(1) == '1' else 'encrypt'}"
               if m else f"aes128:{fn}")
        int_ops[key] = {op: kinds.get(op, 0) for op in AES_OPCODES}
        log(f"[build:{key}] SASS: " + ", ".join(
            f"{op} {n}" for op, n in int_ops[key].items()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)

    report = {"card": card, "device": torch.cuda.get_device_name(0),
              "sass": sass, "sass_int_ops": int_ops}
    dev = torch.device("cuda")
    from repro_torch.device import resolve_device
    resolve_device(dev)
    report["phase_s"] = {}
    t_run = time.time()

    def run(key, phase, *a):
        """report[key] = phase(torch, dev, *a), its wall time logged."""
        t0 = time.time()
        report[key] = phase(torch, dev, *a)
        report["phase_s"][key] = time.time() - t0
        log(f"[main] {key}: {report['phase_s'][key]:.1f} s; "
            f"{time.time() - t_run:.1f} s since the build")

    run("chacha", phase_chacha, args.seed)
    run("chacha_fused", phase_chacha_fused, args.seed)
    run("sealed_matmul", phase_sealed_matmul, args.seed)
    run("flash", phase_flash, args.seed)
    run("serve", phase_serve, args)
    run("group", phase_group, args, report["serve"])
    run("prefix_integrity", phase_prefix_integrity, args, report["serve"])
    # phase 7 lets go of phase 4's engines; phase 8 builds its own from the
    # same weights and trace
    serve = {k: report["serve"][k] for k in ("engine", "params", "prompts")}
    cfg = serve["engine"].cfg
    run("timing", phase_timing, args, report)
    serve.pop("engine")
    run("weights_sampling", phase_weights_sampling, args, cfg,
        serve["params"], serve["prompts"], report["serve"])
    # phase 8 lets go of its engines; phase 9 seals the same weights with
    # the Direct engine and serves the same trace
    run("direct", phase_direct, args, cfg, serve["params"], serve["prompts"])
    del serve
    # phase 10 serves another model: everything above is let go first
    run("moe", phase_moe, args)
    # phase 11 serves five more, one at a time
    run("families", phase_families, args)
    # phase 12: the paper's CNNs, their attacks and timings
    run("cnn", phase_cnn, args)
    # phase 13: training, its optimizer and its sealed checkpoints
    run("train", phase_train, args)
    # phase 15 (e)'s dry run (CPU work, meta tensors) runs beside phase 14
    dry = _start_dryrun()
    try:
        # phase 14: the paper's sealed-decode comparison and the make_*
        # steps
        run("sealed_decode", phase_sealed_decode, args)
        # phase 15: sharding on DTensor under NCCL, and the dry run
        run("sharded", phase_sharded, args, report["train"], dry)
    finally:
        if dry.poll() is None:
            dry.kill()
    # phase 16: the port's three examples
    run("examples", phase_examples, args)

    kernels = kernel_records(report)
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_records(report):
    """The ``{"kernels": [...]}`` entries: every kernel variant with its
    launches on the main path, its worst error against its plain version,
    and its timings beside its bound and library call."""
    t = report["timing"]
    serve = report["serve"]["launches"]        # the continuous run
    group = report["group"]["launches"]        # the group run
    f32 = report["group"]["f32_launches"]     # the f32 path of phase 5
    rows = [  # name, replaces, launches, max_abs_err
        # the bf16 main path runs the CUDA-core fused matmul no more; it is
        # the f32 path's, counted over the f32 teacher-forced group prefill
        # and step of phase 5
        ("sealed_matmul", SM_REPLACES, f32["sealed_matmul"],
         report["sealed_matmul"]["max_abs_err"]),
        ("sealed_matmul_dec", SM_REPLACES, serve["sealed_matmul_dec"],
         report["sealed_matmul"]["max_abs_err_dec"]),
        ("sealed_matmul_tc", SM_REPLACES, group["sealed_matmul_tc"],
         report["sealed_matmul"]["max_abs_err_tc"]),
        # the keystream kernel runs only at sealing: counted over the
        # sealing of phase 4's engine
        ("chacha20", CC_REPLACES, report["serve"]["seal_launches"]["chacha20"],
         report["chacha"]["max_abs_err"]),
        ("chacha20_cache_view", CC_REPLACES, serve["chacha20_cache_view"], 0),
        ("chacha20_cache_splice", CC_REPLACES, serve["chacha20_cache_splice"],
         0),
        # the copy-on-write counted over the prefix-sharing run, the tags
        # and the verify over the verified run (phase 6)
        ("chacha20_cache_copy", CC_REPLACES,
         report["prefix_integrity"]["shared"]["launches"][
             "chacha20_cache_copy"], 0),
        ("chacha20_cache_tags", CC_REPLACES,
         report["prefix_integrity"]["verify"]["launches"][
             "chacha20_cache_tags"], 0),
        ("chacha20_cache_verify", CC_REPLACES,
         report["prefix_integrity"]["verify"]["launches"][
             "chacha20_cache_verify"], 0),
        ("chacha20_lines_unseal", CC_REPLACES, serve["chacha20_lines_unseal"],
         0),
        ("chacha20_lines_gather", CC_REPLACES, serve["chacha20_lines_gather"],
         0),
        # the bf16 main path runs only the tensor-core flash kernel; the
        # CUDA-core one is the f32 path's, counted over the f32
        # teacher-forced group prefill and step of phase 5
        ("flash_attention", FA_REPLACES, f32["flash_attention"],
         report["flash"]["max_abs_err"]),
        ("flash_attention_tc", FA_REPLACES, group["flash_attention_tc"],
         report["flash"]["max_abs_err_tc"]),
        # the same variant at head dim 256 (its own source and count):
        # phase 11's runs of the two families with that head dim, gemma2's
        # counted one-shot prefill and RecurrentGemma's drains
        ("flash_attention_tc256", FA_REPLACES,
         report["families"]["launches"]["flash_attention_tc256"],
         report["flash"]["max_abs_err_tc256"]),
        # the weight MACs, counted over the verified run of phase 8 (c):
        # one sweep, one launch a leaf
        ("chacha20_weight_tile_tags", CC_REPLACES,
         report["weights_sampling"]["verify"]["launches"][
             "chacha20_weight_tile_tags"], 0),
        ("chacha20_weight_line_tags", CC_REPLACES,
         report["weights_sampling"]["verify"]["launches"][
             "chacha20_weight_line_tags"], 0),
        # AES for the Direct engine (phase 9), in place of the reference's
        # jnp AES: the encrypt counted over the sealing of the Direct
        # engine, the decrypt over the Direct run of phase 4's trace
        ("aes128_lines_encrypt", AES_ENC_REPLACES,
         report["direct"]["seal_launches"]["aes128_lines_encrypt"], 0),
        ("aes128_lines_decrypt", AES_DEC_REPLACES,
         report["direct"]["launches"]["aes128_lines_decrypt"], 0),
    ]
    fused = dict(report["chacha_fused"]["timing"])
    fused.update(report["weights_sampling"]["timing"])
    fused.update(report["direct"]["timing"])
    fused.update(report["prefix_integrity"]["timing"])
    for name, recs in fused.items():    # the main path's shape: the first
        t[name] = dict(recs[0])
    # the dh-256 kernel at RecurrentGemma's second group prefill (phase 11:
    # 2 x 2,223, past its window)
    rg = next(r for r in report["families"]["flash"]
              if r["kernel"] == "flash_attention_tc256"
              and not r["warpgroups"] and r["shape"] == "rg prefill 2")
    t["flash_attention_tc256"] = dict(rg, shape=(
        f"RecurrentGemma group prefill b={rg['b']} s={rg['s']} "
        f"{rg['hq']}/{rg['hkv']} heads dh={rg['dh']} window {rg['window']} "
        f"bf16"))
    # phase 10's main path: its continuous trace, the same trace verified
    # and its group drain
    moe = {name: sum(report["moe"][run][name] for run in (
               "launches", "verify_launches", "group_launches"))
           + report["moe"]["direct"]["launches"][name]
           for name, *_ in rows}
    # phase 11's: every gated run of the five families
    family = report["families"]["launches"]
    # phase 13's: the sealed-checkpoint runs of (d), saves and restores
    train = report["train"]["launches"]
    # phase 14's: a step of each full-width variant and the paged builders
    sealed = report["sealed_decode"]["launches"]
    # phase 15's: the sharded checkpoint of (c), its save and its rescale
    sharded = report["sharded"]["launches"]
    kernels = []
    for name, replaces, launches, err in rows:
        tk = t[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{SOURCE.get(name, name)}.cu",
            "replaces": replaces, "launches": launches,
            "moe_launches": moe[name],
            "family_launches": family.get(name, 0),
            "train_launches": train.get(name, 0),
            "sealed_decode_launches": sealed.get(name, 0),
            "sharded_launches": sharded.get(name, 0),
            "max_abs_err": err,
            "ms": tk["ms"], "plain_ms": tk["plain_ms"],
            "bound_ms": tk["bound_ms"], "bound_by": tk["bound_by"],
            "library_ms": tk.get("library_ms"),
            "library": tk.get("library"), "shape": tk["shape"]})
    return kernels


# --------------------------------------------------------------------------
# phase 1: ChaCha20 kernel vs plain, bitwise
# --------------------------------------------------------------------------

def _rand_words(torch, gen, shape, dev):
    return torch.randint(-2**31, 2**31, shape, generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)


def phase_chacha(torch, dev, seed):
    from repro_torch import u32
    from repro_torch.kernels import chacha20 as CC
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    key = _rand_words(torch, gen, (8,), dev)
    cases = 0
    for n in (1, 255, 256, 257, 1000, 65_537):
        for per_block in (False, True):
            for start in (0, 2**32 - 100, None):
                if start is None:
                    ctr = _rand_words(torch, gen, (n,), dev)
                else:
                    ctr = u32.from_i64(torch.arange(start, start + n,
                                                    device=dev))
                nz = _rand_words(torch, gen, (n, 3) if per_block else (3,),
                                 dev)
                got = CC.chacha20_blocks_cuda(key, ctr, nz)
                want = CC.chacha20_blocks_plain(key, ctr, nz)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"chacha20 kernel != plain at n={n} "
                        f"per_block={per_block} start={start}")
                cases += 1
    nz = _rand_words(torch, gen, (3,), dev)
    got = ops.keystream(key, nz, 777, counter0=12345)
    want = ref.chacha20_keystream_ref(
        key, nz, u32.from_i64(torch.arange(12345, 12345 + 777, device=dev)))
    if got.shape != (16, 777) or not torch.equal(got, want):
        raise AssertionError("ops.keystream != chacha20_keystream_ref")
    log(f"[chacha] {cases + 1} cases bitwise equal to the plain version")
    return {"cases": cases + 1, "max_abs_err": 0}


# --------------------------------------------------------------------------
# phase 1b: the fused ChaCha routes vs plain, bitwise, and their times
# --------------------------------------------------------------------------

# the continuous run's paged cache at full width: 4 slots of 256 positions
# in 16-token blocks of 512 words a token (8 kv heads x 128 x bf16), 24
# layers; its chunks are 32 tokens of one slot (the admit width)
CACHE_MB, CACHE_BS, CHUNK = 16, 16, 32


def _pad_bound(nbytes, pads):
    """Bound of a pass that moves ``nbytes`` and makes ``pads`` ChaCha
    blocks, each XORed into 16 words."""
    return bound_ms(nbytes, pads * (CHACHA_OPS + CHACHA_XOR_OPS),
                    alu_ops=pads * (CHACHA_ALU_OPS + CHACHA_XOR_OPS))


def _cache_operands(torch, gen, dev, n, slots, mb, wpb):
    """A stacked (n, NB, wpb) k and v pool of random words (rows strided:
    a view of a wider buffer, as a layer slice of the engine's pool is a
    view), tables of distinct blocks, write counters with every third at
    2^32 - 1, a key and layer ids (the last 2^32 - 1)."""
    nb = 1 + slots * mb
    wide = _rand_words(torch, gen, (2, n, nb, wpb + 4), dev)
    tables = (1 + torch.randperm(nb - 1, generator=gen, device=dev)
              [:slots * mb]).reshape(slots, mb)
    wc = _rand_words(torch, gen, (nb,), dev)
    wc[1::3] = -1
    lids = torch.arange(n, dtype=torch.int32, device=dev)
    lids[-1] = -1
    return (wide[0, ..., :wpb], wide[1, ..., :wpb], tables, wc,
            _rand_words(torch, gen, (8,), dev), lids)


NONCES = ((0x12345678, 2**32 - 1, 7), (2**31, 0, 2**32 - 2))


def _check_view(torch, gen, dev, n, slots, mb, wpb, wpt, lengths, label):
    from repro_torch.kernels import chacha20 as CC
    pk, pv, tables, wc, key, lids = _cache_operands(torch, gen, dev, n, slots,
                                                    mb, wpb)
    lengths = torch.tensor(lengths, device=dev)
    i = n // 2
    args = (key, *NONCES, pk[i], pv[i], lids[i], tables, lengths, wc, wpt)
    got = [CC.cache_view_cuda(*args) for _ in range(2)]
    want = CC.cache_view_plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(g, want) for g in got):
        raise AssertionError(f"cache_view kernel != plain: {label}")
    return label


def _check_splice(torch, gen, dev, n, slots, mb, wpb, wpt, c, lengths, counts,
                  label):
    from repro_torch.kernels import chacha20 as CC
    pk, pv, tables, wc, key, lids = _cache_operands(torch, gen, dev, n, slots,
                                                    mb, wpb)
    new = [_rand_words(torch, gen, (n, slots, c, wpt), dev) for _ in range(2)]
    args = (lids, *new, tables, torch.tensor(lengths, device=dev),
            torch.tensor(counts, device=dev), wc, wpb // wpt)
    want = [pk.clone(), pv.clone()]
    CC.cache_splice_plain(key, *NONCES, *want, *args)
    for _ in range(2):
        got = [pk.clone(), pv.clone()]
        CC.cache_splice_cuda(key, *NONCES, *got, *args)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"cache_splice kernel != plain: {label}")
    if torch.equal(want[0], pk):
        raise AssertionError(f"cache_splice wrote nothing: {label}")
    return label


def _check_copy(torch, gen, dev, n, wpb, pairs, label):
    """The copy-on-write re-key of ``pairs`` ((src, dst, live) each) over n
    layers, k and v, launched twice on copies of the pools."""
    from repro_torch.kernels import chacha20 as CC
    pk, pv, _, wc, key, lids = _cache_operands(torch, gen, dev, n, 1, 15, wpb)
    src, dst, mask = (torch.tensor(c, device=dev) for c in zip(*pairs))
    args = (lids, src, dst, mask, wc)
    want = [pk.clone(), pv.clone()]
    CC.cache_copy_plain(key, *NONCES, *want, *args)
    for _ in range(2):
        got = [pk.clone(), pv.clone()]
        CC.cache_copy_cuda(key, *NONCES, *got, *args)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"cache_copy kernel != plain: {label}")
    if torch.equal(want[0], pk):
        raise AssertionError(f"cache_copy wrote nothing: {label}")
    return label


def _mac(torch, dev):
    from repro_torch.core.mac import mac_context
    return mac_context(bytes(range(32)), "kvcache", dev)


def _check_tags(torch, gen, dev, n, slots, mb, wpb, layer, blocks, live,
                label):
    """Tags of ``blocks`` of every layer (or of one, ``layer``: a view's
    verdict), k and v, words at 0xFFFFFFFF and with bit 31 planted; the
    kernel launched twice against the plain version."""
    from repro_torch.kernels import chacha20 as CC
    pk, pv, _, wc, _, lids = _cache_operands(torch, gen, dev, n, slots, mb,
                                             wpb)
    pk[..., ::5] = -1
    pv[..., 1::3] |= -2**31
    if layer is not None:
        pk, pv, lids = pk[layer][None], pv[layer][None], lids[layer:layer + 1]
    ctx = _mac(torch, dev)
    args = (ctx.key_words, ctx.hash_keys(wpb), ctx.nonce(NONCES[0]),
            ctx.nonce(NONCES[1]), pk, pv, lids,
            torch.as_tensor(blocks, device=dev),
            torch.as_tensor(live, device=dev), wc)
    got = [CC.cache_tags_cuda(*args) for _ in range(2)]
    want = CC.cache_tags_plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(g, want) for g in got):
        raise AssertionError(f"cache_tags kernel != plain: {label}")
    return label


def _check_verify(torch, gen, dev, n, slots, mb, wpb, wpt, lengths, label):
    """A pass's check over every layer, k and v, stored tags from the plain
    ``cache_tags``: right, then a flipped word in a resident block of the
    first layer (the last slot), of the last layer's v (the first slot
    with a resident block), and past the last slot's length; the kernel
    launched twice against the plain version each time."""
    from repro_torch.kernels import chacha20 as CC
    pk, pv, tables, wc, _, lids = _cache_operands(torch, gen, dev, n, slots,
                                                  mb, wpb)
    ctx = _mac(torch, dev)
    hk = ctx.hash_keys(wpb)
    nonces = (ctx.nonce(NONCES[0]), ctx.nonce(NONCES[1]))
    nb = pk.shape[1]
    every = torch.arange(nb, device=dev)
    tags = CC.cache_tags_plain(ctx.key_words, hk, *nonces, pk, pv, lids,
                               every, torch.ones_like(every,
                                                      dtype=torch.bool), wc)
    mac_k, mac_v = tags[:, 0].contiguous(), tags[:, 1].contiguous()
    bs = wpb // wpt
    res = [-(-x // bs) for x in lengths]
    first = min(i for i, r in enumerate(res) if r)
    flips = [(None, None)]
    if res[-1]:
        flips.append(((pk, 0, int(tables[-1, res[-1] - 1])), slots - 1))
    flips.append(((pv, n - 1, int(tables[first, 0])), first))
    if res[-1] < mb:
        flips.append(((pk, n // 2, int(tables[-1, res[-1]])), None))
    lens = torch.tensor(lengths, device=dev)
    args = (ctx.key_words, hk, *nonces, pk, pv, mac_k, mac_v, lids, tables,
            lens, wc, bs)
    for site, slot in flips:
        if site is not None:
            site[0][site[1], site[2], 1] ^= 1 << 9
        got = [CC.cache_verify_cuda(*args) for _ in range(2)]
        want = CC.cache_verify_plain(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(g, want) for g in got):
            raise AssertionError(f"cache_verify kernel != plain: {label}")
        if want.tolist() != [i != slot for i in range(slots)]:
            raise AssertionError(f"cache_verify verdict {want.tolist()}: "
                                 f"{label}, a flip in slot {slot}")
        if site is not None:
            site[0][site[1], site[2], 1] ^= 1 << 9
    return f"{label} ({len(flips)} flips)"


def _tags_bound(tags, wpb):
    """Bound of a ``cache_tags`` launch of ``tags`` live tags: each block's
    words read once, the hash keys once, each tag written (for
    ``cache_verify``: the stored tag read); per 16-bit half an extraction
    and a 64-bit multiply-add, per tag one pad."""
    halves = tags * 2 * wpb
    return bound_ms(tags * (4 * wpb + 4 + 16) + 8 * wpb,
                    halves * TAG_HALF_OPS + tags * CHACHA_OPS,
                    alu_ops=halves * TAG_HALF_ALU_OPS + tags * CHACHA_ALU_OPS)


def _line_operands(torch, gen, dev, n_lines, scheme):
    """Random line-sealed words: ColoE records or counter-layout lines and
    counter words, flags mixed at random, every third write counter at the
    top of its range."""
    if scheme == "coloe":
        payload = _rand_words(torch, gen, (n_lines, 34), dev)
        payload[::3, 32] = -1
        return payload, None
    counters = _rand_words(torch, gen, (n_lines,), dev)
    counters[::3] |= 0x7FFFFFFF
    return _rand_words(torch, gen, (n_lines, 32), dev), counters


def _check_unseal(torch, gen, dev, orig_len, scheme, label):
    from repro_torch.kernels import chacha20 as CC
    payload, counters = _line_operands(torch, gen, dev, -(-orig_len // 32),
                                       scheme)
    key = _rand_words(torch, gen, (8,), dev)
    args = (key, payload, counters, orig_len, NONCES[0][:2])
    got = [CC.lines_unseal_cuda(*args) for _ in range(2)]
    want = CC.lines_unseal_plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(g, want) for g in got):
        raise AssertionError(f"lines_unseal kernel != plain: {label}")
    return label


def _bits(torch, t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _check_gather(torch, dev, key, payload, counters, shape, src, tokens, out,
                  label):
    from repro_torch.kernels import chacha20 as CC
    args = (key, payload, counters, NONCES[1][:2], shape, src, tokens, out)
    got = [CC.lines_gather_rows_cuda(*args) for _ in range(2)]
    want = CC.lines_gather_rows_plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(_bits(torch, g), _bits(torch, want))
               and g.shape == want.shape for g in got):
        raise AssertionError(f"lines_gather_rows kernel != plain: {label}")
    return label


def _view_work(lengths, slots, mb, wpb, wpt):
    """(bytes, pads) a view launch needs: live words read, every word
    written, one pad per live 16-word unit, for k and v."""
    live_units = live_words = 0
    for length in lengths:
        for m in range(mb):
            words = max(0, min(wpb, length * wpt - m * wpb))
            live_words += words
            live_units += -(-words // 16)
    nbytes = 2 * (4 * live_words + 4 * slots * mb * wpb) + 12 * slots * mb
    return nbytes, 2 * live_units


def _splice_work(n, lengths, counts, c, wpb, wpt, bs):
    """(bytes, pads) a splice launch needs over n layers, k and v: each
    touched unit written, read unless all its words are new, the new words
    read, two pads a unit (one where every word is new)."""
    nspan = 1 + (c + bs - 2) // bs
    units = reads = fresh = 0
    for length, cnt in zip(lengths, counts):
        o = length % bs
        if cnt <= 0:
            continue
        fresh += cnt * wpt
        for s in range(nspan):
            if not (s * bs < o + cnt and (s + 1) * bs > o):
                continue
            for u in range(-(-wpb // 16)):
                g0 = s * wpb + 16 * u
                nw = min(16, wpb - 16 * u)
                units += 1
                reads += not (o * wpt - g0 <= 0 and (o + cnt) * wpt - g0 >= nw)
    k = 2 * n                                  # layers, k and v
    nbytes = k * (64 * units + 64 * reads + 4 * fresh)
    return nbytes, k * (units + reads)


def phase_chacha_fused(torch, dev, seed):
    """The paged cache's view and splice and the line layout's unseal and
    row gather, each launched twice and held bitwise against its plain
    version: at the main path's shapes and at the edges (partial units,
    lengths 0 and full, counts 0, write counters at 2^32 - 1, ColoE and
    counter layouts, mixed SE flags, rows off line boundaries); then timed
    at the main path's shapes beside their bounds and plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import chacha20 as CC
    from repro_torch.models.cache import kv_words_per_token
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    cfg = get_config("internlm2_1_8b")
    n, wpt = cfg.num_layers, kv_words_per_token(cfg)
    wpb = CACHE_BS * wpt
    full = CACHE_MB * CACHE_BS
    done = []
    # the view: a decode tick, a chunk's row, and partial units
    done.append(_check_view(torch, gen, dev, n, SLOTS, CACHE_MB, wpb, wpt,
                            [0, 1, 137, full], "tick, lengths 0/1/137/full"))
    done.append(_check_view(torch, gen, dev, n, 1, CACHE_MB, wpb, wpt, [64],
                            "chunk row"))
    for w, t in ((24, 6), (40, 10)):
        done.append(_check_view(torch, gen, dev, 2, 4, 3, w, t,
                                [0, 1, 3 * w // t, 5], f"wpb {w} wpt {t}"))
    # the splice: a decode write, chunk writes, partial units
    done.append(_check_splice(torch, gen, dev, n, SLOTS, CACHE_MB, wpb, wpt, 1,
                              [0, 15, 137, 200], [1, 1, 0, 1], "C=1, tick"))
    done.append(_check_splice(torch, gen, dev, n, 1, CACHE_MB, wpb, wpt, CHUNK,
                              [64], [CHUNK], "C=32, one row"))
    done.append(_check_splice(torch, gen, dev, n, SLOTS, CACHE_MB, wpb, wpt,
                              CHUNK, [0, 15, 16, 100], [32, 0, 20, 32],
                              "C=32, nspan 3"))
    for w, t in ((24, 6), (40, 10)):
        for c in (1, 5):
            done.append(_check_splice(
                torch, gen, dev, 3, 4, 5, w, t, c, [0, 3, 4, 7],
                [c, min(c, 2), 0, c], f"wpb {w} wpt {t} C={c}"))
    # the unseal: the norm leaves, partial final lines, both layouts
    for scheme in ("coloe", "counter"):
        for orig_len in (n * cfg.d_model, cfg.d_model, 1000, 4097):
            done.append(_check_unseal(torch, gen, dev, orig_len, scheme,
                                      f"{scheme} {orig_len} words"))
    # the gather: the full embedding at a tick's and a group prefill's rows
    vocab, d = cfg.vocab_size, cfg.d_model
    key = _rand_words(torch, gen, (8,), dev)
    emb, _ = _line_operands(torch, gen, dev, vocab * d // 32, "coloe")
    tick_tok = torch.randint(0, vocab, (SLOTS, 1), generator=gen, device=dev)
    pre_tok = torch.randint(0, vocab, (SLOTS, 890), generator=gen,
                            device=dev)
    pre_tok[0, :2] = torch.tensor([0, vocab - 1])
    for tok, out in ((tick_tok, torch.bfloat16), (pre_tok, torch.bfloat16),
                     (tick_tok, torch.float32)):
        done.append(_check_gather(torch, dev, key, emb, None, (vocab, d),
                                  torch.float32, tok, out,
                                  f"embedding, {tok.numel()} rows, {out}"))
    pay, ctr = _line_operands(torch, gen, dev, 4096 * d // 32, "counter")
    done.append(_check_gather(torch, dev, key, pay, ctr, (4096, d),
                              torch.float32, tick_tok.remainder(4096),
                              torch.bfloat16, "counter layout, 4 rows"))
    for dd, src in ((24, torch.float32), (40, torch.float32),
                    (33, torch.bfloat16), (64, torch.bfloat16)):
        size = torch.empty((), dtype=src).element_size()
        pay, ctr = _line_operands(torch, gen, dev,
                                  -(-300 * dd * size // 128), "counter")
        tok = torch.tensor([[0, 299, 7], [7, 150, 1]], device=dev)
        for out in (torch.bfloat16, torch.float32):
            done.append(_check_gather(torch, dev, key, pay, ctr, (300, dd), src,
                                      tok, out, f"D={dd} {src} -> {out}"))
    # the copy-on-write: one pair over every layer (an admission's), and
    # partial units with a masked pair
    done.append(_check_copy(torch, gen, dev, n, wpb, [(3, 9, True)],
                            "COW, one pair x 24 layers"))
    for w in (24, 40, 18):
        done.append(_check_copy(
            torch, gen, dev, 3, w, [(3, 9, True), (7, 10, True),
                                    (2, 11, False)],
            f"COW wpb {w}, a masked pair"))
    # the tags: a view's verdict (one layer, a tick's 4 slots x 16 blocks),
    # a tick's splice re-tag (24 layers x 4 blocks), partial geometries with
    # dead and repeated entries
    nb = 1 + SLOTS * CACHE_MB
    done.append(_check_tags(torch, gen, dev, n, SLOTS, CACHE_MB, wpb, n // 2,
                            list(range(1, nb)), [True] * (nb - 1),
                            "view verdict, 4 slots x 16 blocks"))
    done.append(_check_tags(torch, gen, dev, n, SLOTS, CACHE_MB, wpb, None,
                            [5, 21, 37, 53], [True] * 4,
                            "splice re-tag, 24 layers x 4 blocks"))
    for w in (24, 40, 18):
        done.append(_check_tags(torch, gen, dev, 3, 2, 4, w, None,
                                [3, 0, 8, 3, 7], [True, False, True, True,
                                                  True],
                                f"tags wpb {w}, dead and repeated entries"))
    # the verify: a pass's check of every layer (4 slots x 16 blocks x 24
    # layers, lengths 0 to full), partial geometries
    done.append(_check_verify(torch, gen, dev, n, SLOTS, CACHE_MB, wpb, wpt,
                              [0, 1, 137, 200], "verify, 24 layers"))
    for w, t in ((24, 6), (40, 10), (18, 6)):
        done.append(_check_verify(torch, gen, dev, 3, 4, 3, w, t,
                                  [0, 1, 3 * w // t, 5],
                                  f"verify wpb {w} wpt {t}"))
    log(f"[chacha_fused] {len(done)} cases, each kernel launched twice and "
        f"bitwise equal to its plain version: " + "; ".join(done))

    # times at the main path's shapes (L2 flushed before each launch)
    scratch = torch.empty((64 * 2**20,), dtype=torch.int32, device=dev)
    flush = lambda: scratch.zero_()
    times = {}

    def rec(name, shape, run, plain, nbytes, pads, iters=20):
        ms = _time_ms(torch, run, iters, flush)
        plain_ms = _time_ms(torch, plain, 2)
        b_ms, b_by = _pad_bound(nbytes, pads)
        times.setdefault(name, []).append(
            {"shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
             "bound_by": b_by, "bytes": nbytes, "pads": pads})
        log(f"[time] {name} {shape}: {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.2f} MB, {pads} pads;"
            f" {b_ms / ms:.2f} of the kernel's time)")

    pk, pv, tables, wc, key, lids = _cache_operands(torch, gen, dev, n, SLOTS,
                                                    CACHE_MB, wpb)
    lengths = [full] * SLOTS
    args = (key, *NONCES, pk[n // 2], pv[n // 2], lids[n // 2], tables,
            torch.tensor(lengths, device=dev), wc, wpt)
    rec("chacha20_cache_view", f"{SLOTS} slots x {CACHE_MB} blocks, all live",
        lambda: CC.cache_view_cuda(*args), lambda: CC.cache_view_plain(*args),
        *_view_work(lengths, SLOTS, CACHE_MB, wpb, wpt))
    for rows, c, lens, cnts in ((SLOTS, 1, [3, 40, 137, 200], [1] * SLOTS),
                                (1, CHUNK, [64], [CHUNK])):
        new = [_rand_words(torch, gen, (n, rows, c, wpt), dev)
               for _ in range(2)]
        sargs = (key, *NONCES, pk, pv, lids, *new, tables[:rows],
                 torch.tensor(lens, device=dev),
                 torch.tensor(cnts, device=dev), wc, CACHE_BS)
        rec("chacha20_cache_splice", f"C={c}, {rows} rows x {n} layers",
            lambda: CC.cache_splice_cuda(*sargs),
            lambda: CC.cache_splice_plain(*sargs),
            *_splice_work(n, lens, cnts, c, wpb, wpt, CACHE_BS))
    norm, _ = _line_operands(torch, gen, dev, n * d // 32, "coloe")
    flags = int((norm[:, 33] & 1).sum())
    uargs = (key, norm, None, n * d, NONCES[0][:2])
    rec("chacha20_lines_unseal", f"norm leaf ({n}, {d}) f32, ColoE",
        lambda: CC.lines_unseal_cuda(*uargs),
        lambda: CC.lines_unseal_plain(*uargs),
        norm.numel() * 4 + n * d * 4, 2 * flags)
    for tok in (tick_tok, pre_tok):
        gargs = (key, emb, None, NONCES[1][:2], (vocab, d), torch.float32,
                 tok, torch.bfloat16)
        halves = torch.unique(tok.reshape(-1)[:, None] * (d // 16)
                              + torch.arange(d // 16, device=dev)).numel()
        lines = torch.unique(tok) * (d // 32)
        lines = (lines[:, None] + torch.arange(d // 32, device=dev))
        pads = 2 * int((emb[lines.reshape(-1), 33] & 1).sum())
        rec("chacha20_lines_gather",
            f"embedding ({vocab}, {d}) f32, {tok.numel()} rows -> bf16",
            lambda: CC.lines_gather_rows_cuda(*gargs),
            lambda: CC.lines_gather_rows_plain(*gargs),
            halves * 68 + tok.numel() * (8 + 2 * d), pads,
            iters=20 if tok.numel() < 100 else 10)
    # the copy-on-write of one admission (one pair, every layer, k and v):
    # each unit read, written and padded twice
    cpb = -(-wpb // 16)
    cargs = (key, *NONCES, pk, pv, lids, torch.tensor([3], device=dev),
             torch.tensor([9], device=dev), torch.tensor([True], device=dev),
             wc)
    units = 2 * n * cpb
    rec("chacha20_cache_copy", f"1 pair x {n} layers, k and v",
        lambda: CC.cache_copy_cuda(*cargs),
        lambda: CC.cache_copy_plain(*cargs), 128 * units + 40, 2 * units)
    # the tags of a view's verdict (one layer, every block of a tick's
    # slots) and of a tick's splice (every layer, one block a slot)
    ctx = _mac(torch, dev)
    hk = ctx.hash_keys(wpb)
    entries = tables.reshape(-1)
    for label, layers, blk in (
            (f"view verdict, 1 layer x {SLOTS} slots x {CACHE_MB} blocks",
             slice(n // 2, n // 2 + 1), entries),
            (f"splice re-tag, {n} layers x {SLOTS} blocks", slice(0, n),
             tables[:, 3].contiguous())):
        live = torch.ones_like(blk, dtype=torch.bool)
        targs = (ctx.key_words, hk, ctx.nonce(NONCES[0]),
                 ctx.nonce(NONCES[1]), pk[layers], pv[layers], lids[layers],
                 blk, live, wc)
        tags = 2 * (layers.stop - layers.start) * blk.numel()
        ms = _time_ms(torch, lambda: CC.cache_tags_cuda(*targs), 20, flush)
        plain_ms = _time_ms(torch, lambda: CC.cache_tags_plain(*targs), 2)
        b_ms, b_by = _tags_bound(tags, wpb)
        times.setdefault("chacha20_cache_tags", []).append(
            {"shape": label, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "tags": tags})
        log(f"[time] chacha20_cache_tags {label}: {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; {tags} tags of "
            f"{4 * wpb} bytes; {b_ms / ms:.2f} of the kernel's time)")
    del emb, pk, pv, scratch
    torch.cuda.empty_cache()
    return {"cases": done, "max_abs_err": 0, "timing": times}


# --------------------------------------------------------------------------
# phase 2: sealed_matmul kernel vs plain at the main path's shapes
# --------------------------------------------------------------------------

def _shapes():
    from repro_torch.configs import get_config
    cfg = get_config("internlm2_1_8b")
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    return {"wq": (d, cfg.q_dim), "wk": (d, cfg.kv_dim), "mlp_wi": (d, f),
            "mlp_wo": (f, d), "head": (d, v)}


def _moe_shapes():
    """Phase 10's fused leaves (Qwen3-30B-A3B, GQA 32/4 heads of 128): wq,
    wk/wv at N 512, wo at K 4096 and the LM head at N 151,936."""
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    d, v = cfg.d_model, cfg.vocab_size
    return {"moe_wq": (d, cfg.q_dim), "moe_wk": (d, cfg.kv_dim),
            "moe_wo": (cfg.q_dim, d), "moe_head": (d, v)}


# phase 11's families with fused leaves, by the prefix that names their
# cases (Mamba2's projections are all line leaves)
FAMILY_FUSED = (("granite", "granite_3_2b"), ("gemma2", "gemma2_2b"),
                ("deepseek", "deepseek_coder_33b"),
                ("rg", "recurrentgemma_9b"))


def _family_shapes():
    """Phase 11's fused leaves that the grid above lacks: the (K, N) of
    every attention projection (wq, wk/wv, wo over the padded heads), MLP
    leaf (wi/wg, wo) and untied LM head of each family in ``FAMILY_FUSED``,
    less the pairs that ``_shapes`` and ``_moe_shapes`` hold. A pair that
    two leaves share is named once, by both (``rg_wq/wo``)."""
    from repro_torch.configs import get_config
    seen = set(_shapes().values()) | set(_moe_shapes().values())
    names = {}
    for prefix, arch in FAMILY_FUSED:
        c = get_config(arch)
        d, q = c.d_model, c.heads_eff * c.head_dim
        leaves = {}
        if any(k in ("attn", "local_attn") for k in c.pattern):
            leaves.update(wq=(d, q), wk=(d, c.kv_dim), wo=(q, d))
        if c.d_ff and any(k != "ssd" for k in c.pattern):
            leaves.update(mlp_wi=(d, c.d_ff), mlp_wo=(c.d_ff, d))
        if not c.tie_embeddings:
            leaves["head"] = (d, c.vocab_size)
        for leaf, kn in leaves.items():
            if kn in seen and (prefix, kn) not in names:
                continue
            names.setdefault((prefix, kn), []).append(leaf)
            seen.add(kn)
    return {f"{prefix}_{'/'.join(leaves)}": kn
            for (prefix, kn), leaves in names.items()}


def _family_prefill_rows(seed):
    """The M of phase 11's bf16 prefills for each family prefix of
    ``_family_shapes``: the dense families' one-shot prefill of their
    trace's first 4 prompts, RecurrentGemma's two groups."""
    return {prefix: tuple(b * s for b, s, *_ in shapes)
            for prefix, shapes in _family_attention(seed).items()}


def _moe_group_prompts(seed):
    """Phase 10's group drain prompts: ``MOE_GROUP`` of 512-1024 tokens."""
    import numpy as np
    from repro_torch.configs import get_config
    vocab = get_config(MOE_ARCH).vocab_size
    rng = np.random.RandomState(seed + 24)
    return [rng.randint(0, vocab, rng.randint(GROUP_PROMPT[0],
                                              GROUP_PROMPT[1] + 1)
                        ).astype(np.int32) for _ in range(MOE_GROUP)]


def _sealed_operands(torch, dev, gen, k, n, ratio, wc, bk, bn):
    from repro_torch import u32
    from repro_torch.kernels import ref
    w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
    mask = torch.rand((k,), generator=gen, device=dev) < ratio
    key = _rand_words(torch, gen, (8,), dev)
    nonce = _rand_words(torch, gen, (3,), dev)
    ct = ref.seal_weights_ref(w, key, nonce, bk, bn, mask, wc)
    wcw = torch.tensor(u32.const(wc), dtype=torch.int32, device=dev)
    return w, mask, key, nonce, ct, wcw


def phase_sealed_matmul(torch, dev, seed):
    from repro_torch.core.sealed_store import _pick_block
    from repro_torch.kernels import ref
    from repro_torch.kernels import sealed_matmul as SMK
    from repro_torch.kernels.chacha20 import chacha20_blocks_plain
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    combos = [(m, r, wc, cdt) for m in (4, 32) for r in (0.0, 0.5, 1.0)
              for wc in (0, 5) for cdt in ("float32", "bfloat16")]
    seals = [(r, wc) for r in (0.0, 0.5, 1.0) for wc in (0, 5)]
    tc_rows = (128, 1000, 3560)            # 3560: the group prefill's M
    # phase 10's group prefill: MOE_GROUP right-aligned prompts
    moe_tc_rows = (128, 1000, MOE_GROUP * max(
        len(p) for p in _moe_group_prompts(seed)))
    # decode ticks (4 slots; 8 in phase 10) and chunks
    dec_rows = (1, 4, 8, 16, 32, 33, 64)
    cases = []
    shapes = dict(_shapes())
    shapes["bn8"] = (2048, 2056)           # N = 8 * 257: seal tile bn = 8
    shapes.update(_moe_shapes())
    family_rows = _family_prefill_rows(seed)
    shapes.update(_family_shapes())
    for name, (k, n) in shapes.items():
        bk, bn = _pick_block(k), _pick_block(n)
        rows = moe_tc_rows if name.startswith("moe_") else tc_rows
        family = family_rows.get(name.split("_")[0])
        if family is not None:
            # phase 11's leaves: the CUDA-core kernel at decode M in f32
            # (its f32 gates), the decode kernel at every M at SE 0.5 and
            # at M 4 under SE 0 and 1, the prefill kernel at M 128 under
            # SE 0 and 1 and at the family's prefills' M
            mine = [(4, 0.5, 5, "float32", "sealed_matmul")]
            mine += [(m, 0.5, 5, "bfloat16", "sealed_matmul_dec")
                     for m in dec_rows]
            mine += [(4, r, wc, "bfloat16", "sealed_matmul_dec")
                     for r, wc in ((0.0, 0), (1.0, 5))]
            mine += [(128, r, wc, "bfloat16", "sealed_matmul_tc")
                     for r, wc in ((0.0, 0), (1.0, 5))]
            mine += [(m, 0.5, 5, "bfloat16", "sealed_matmul_tc")
                     for m in family]
            if name.endswith("_head"):      # a prefill's head: one row each
                mine = [c for c in mine if c[-1] != "sealed_matmul_tc"]
        elif name == "wq":
            mine = combos                  # the whole grid
        else:                              # each value of each axis
            mine = [c for i, c in enumerate(combos) if i % 4 == i // 4 % 4]
        if family is None:
            mine = [c + ("sealed_matmul",) for c in mine]
        if name in ("wq", "mlp_wi"):       # a ragged M on the CUDA cores
            mine += [(1000, 0.5, 5, cdt, "sealed_matmul")
                     for cdt in ("float32", "bfloat16")]
        if name != "bn8" and family is None:
            # the tensor cores: each seal at one of the
            # three M (SE 0.5, wc 5 at 128) and SE 0.5, wc 5 at all three
            mine += [(rows[i % 3], r, wc, "bfloat16", "sealed_matmul_tc")
                     for i, (r, wc) in enumerate(seals)]
            mine += [(m, 0.5, 5, "bfloat16", "sealed_matmul_tc")
                     for m in rows[1:]]
            # the decode kernel: every M at every seal
            mine += [(m, r, wc, "bfloat16", "sealed_matmul_dec")
                     for m in dec_rows for r, wc in seals]
        by_seal = {}
        for m, ratio, wc, cdt, kern in mine:
            by_seal.setdefault((ratio, wc), []).append((m, cdt, kern))
        for (ratio, wc), runs in by_seal.items():
            w, mask, key, nonce, ct, wcw = _sealed_operands(
                torch, dev, gen, k, n, ratio, wc, bk, bn)
            # the plain unseal must give the weight back bit for bit
            w_plain = ref.unseal_weights_ref(ct, key, nonce, bk, bn, mask,
                                             wcw, block_fn=chacha20_blocks_plain)
            if not torch.equal(w_plain.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(f"{name}: seal/unseal roundtrip differs")
            dec_share = 0.0
            for m, cdt, kern in runs:
                x = torch.randn((m, k), generator=gen, device=dev)
                c = getattr(torch, cdt)
                want = x.to(c).float() @ w_plain.to(c).float()
                launch = {"sealed_matmul_tc": SMK.sealed_matmul_tc_cuda,
                          "sealed_matmul_dec": SMK.sealed_matmul_dec_cuda,
                          "sealed_matmul": SMK.sealed_matmul_cuda}[kern]
                # the tensor-core kernels take x as the model hands it: bf16
                xin = x if kern == "sealed_matmul" else x.to(c)
                got = launch(xin, ct, mask, key, nonce, wcw, bk=bk, bn=bn,
                             compute_dtype=cdt)
                same = True
                if kern == "sealed_matmul_dec":   # deterministic split-K
                    same = torch.equal(got, launch(
                        xin, ct, mask, key, nonce, wcw, bk=bk, bn=bn,
                        compute_dtype=cdt))
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                share = err / (KERNEL_TOL * scale)
                ok = (bool(torch.isfinite(got).all()) and share <= 1.0
                      and same)
                cases.append({"kernel": kern, "leaf": name, "K": k, "N": n,
                              "bk": bk, "bn": bn, "M": m, "ratio": ratio,
                              "wc": wc, "compute_dtype": cdt,
                              "max_abs_err": err, "out_scale": scale,
                              "share_of_tol": share, "repeatable": same})
                if kern == "sealed_matmul_dec":
                    dec_share = max(dec_share, share)
                else:
                    log(f"[sealed_matmul] {kern} {name} K={k} N={n} bk={bk} "
                        f"bn={bn} M={m} ratio={ratio} wc={wc} {cdt}: "
                        f"max_abs_err={err:.3e} (scale {scale:.3e}, tol "
                        f"{KERNEL_TOL:g} x scale)")
                if not ok:
                    raise AssertionError(f"sealed_matmul disagrees: {cases[-1]}")
                del x, want, got
            if any(kern == "sealed_matmul_dec" for _, _, kern in runs):
                log(f"[sealed_matmul] sealed_matmul_dec {name} K={k} N={n} "
                    f"bk={bk} bn={bn} ratio={ratio} wc={wc} bf16, M "
                    f"{'/'.join(str(m) for m in dec_rows)}: worst error at "
                    f"{dec_share:.3f} of the tolerance ({KERNEL_TOL:g} x "
                    f"scale), two launches bitwise equal")
        del w, ct, w_plain
        torch.cuda.empty_cache()
    count = {kern: sum(c["kernel"] == kern for c in cases)
             for kern in ("sealed_matmul", "sealed_matmul_dec",
                          "sealed_matmul_tc")}
    worst = {kern: max(c["share_of_tol"] for c in cases
                       if c["kernel"] == kern) for kern in count}
    log(f"[sealed_matmul] within {KERNEL_TOL:g} of the output scale: "
        + ", ".join(f"{kern} {count[kern]} cases (worst at "
                    f"{worst[kern]:.3f} of the tolerance)" for kern in count))
    return {"cases": cases, "worst_share_of_tol": worst,
            "max_abs_err": max(c["max_abs_err"] for c in cases
                               if c["kernel"] == "sealed_matmul"),
            "max_abs_err_tc": max(c["max_abs_err"] for c in cases
                                  if c["kernel"] == "sealed_matmul_tc"),
            "max_abs_err_dec": max(c["max_abs_err"] for c in cases
                                   if c["kernel"] == "sealed_matmul_dec")}


# --------------------------------------------------------------------------
# phase 3: flash-attention kernel vs plain
# --------------------------------------------------------------------------

# b, s, t, hq, hkv, dh, window, softcap
FLASH_CASES = [
    (2, 256, 256, 4, 2, 32, 0, 0.0),          # the reference test's grid
    (1, 512, 512, 8, 1, 32, 128, 50.0),
    (2, 256, 256, 6, 6, 16, 0, 0.0),
    (1, 128, 128, 2, 2, 64, 32, 0.0),
    (4, 1000, 1000, 16, 8, 128, 0, 0.0),      # the group prefill, full width
    (1, 4608, 4608, 8, 4, 256, 4096, 50.0),   # gemma2-like
    (2, 300, 700, 16, 8, 128, 0, 0.0),        # s < t: top-left causal
]


def _flash_inputs(torch, gen, dev, b, s, t, hq, hkv, dh, dtype):
    """q as a strided view (heads sliced out of a wider tensor), as the
    model hands it over; k and v contiguous."""
    q = torch.randn((b, s, hq + 1, dh), generator=gen, device=dev)[:, :, 1:]
    k = torch.randn((b, t, hkv, dh), generator=gen, device=dev)
    v = torch.randn((b, t, hkv, dh), generator=gen, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _moe_flash_case(seed):
    """Phase 10's group prefill: GQA 8:1 at head dim 128, full width."""
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    s = max(len(p) for p in _moe_group_prompts(seed))
    return (MOE_GROUP, s, s, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.window, cfg.attn_softcap)


def phase_flash(torch, dev, seed):
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    tc_launch = {"flash_attention_tc": FA.flash_attention_tc_cuda,
                 "flash_attention_tc256": FA.flash_attention_tc256_cuda}
    cases = []
    for b, s, t, hq, hkv, dh, win, cap in (FLASH_CASES
                                           + [_moe_flash_case(seed)]
                                           + _family_flash_cases(seed)):
        for dname in ("float32", "bfloat16"):
            q, k, v = _flash_inputs(torch, gen, dev, b, s, t, hq, hkv, dh,
                                    getattr(torch, dname))
            kw = dict(scale=dh ** -0.5, softcap=cap, window=win)
            # the plain version's f32 result on the same (bf16) inputs,
            # before any rounding to the output dtype
            want = FA.flash_attention_plain(q.float(), k.float(), v.float(),
                                            **kw)
            scale = float(want.abs().max())
            shape = (f"b={b} s={s} t={t} heads {hq}/{hkv} dh={dh} "
                     f"window={win} softcap={cap} {dname}")
            kerns = ["flash_attention"]
            if FA._kernel(q.dtype, dh) in tc_launch:
                kerns.append(FA._kernel(q.dtype, dh))
            for kern in kerns:
                rec = {"kernel": kern, "b": b, "s": s, "t": t, "hq": hq,
                       "hkv": hkv, "dh": dh, "window": win, "softcap": cap,
                       "dtype": dname, "out_scale": scale}
                if kern in tc_launch:
                    got = tc_launch[kern](q, k, v, **kw)
                    torch.cuda.synchronize()
                    ok, share, rms = FA.bf16_gate(q, k, v, got, **kw)
                    rec.update(max_abs_err=float((got.float() - want).abs()
                                                 .max()),
                               worst_share_of_tol=share, rms_ratio=rms)
                    log(f"[flash] {kern} {shape}: max_abs_err="
                        f"{rec['max_abs_err']:.3e} (scale {scale:.3e}); "
                        f"bf16 gate: worst element at {share:.3f} of 2^-8 "
                        f"(|want| + P|v|) + {FLASH_TOL:g} x scale, rms "
                        f"error {rms:.3e} of rms(want) (tol 2^-8 = "
                        f"{BF16_ROUNDING:.3e})")
                else:
                    got = FA.flash_attention_cuda(q, k, v, **kw)
                    torch.cuda.synchronize()
                    diff = (got.float() - want).abs()
                    share = float((diff / flash_allowed(torch, want, q.dtype))
                                  .max())
                    ok = bool(torch.isfinite(got).all()) and share <= 1.0
                    rec.update(max_abs_err=float(diff.max()),
                               worst_share_of_tol=share)
                    tol = (f"{FLASH_TOL:g} x scale" if dname == "float32" else
                           f"2^-8 x |want| + {FLASH_TOL:g} x scale, per "
                           f"element")
                    log(f"[flash] {kern} {shape}: max_abs_err="
                        f"{rec['max_abs_err']:.3e} (scale {scale:.3e}; tol "
                        f"{tol}; worst element at {share:.3f} of its tol)")
                cases.append(rec)
                if not (ok and got.dtype == q.dtype):
                    raise AssertionError(f"flash kernel disagrees: {rec}")
                del got
            del q, k, v, want
    torch.cuda.empty_cache()
    out = {"cases": cases}
    for kern in ("flash_attention", *tc_launch):
        out["max_abs_err" + kern[len("flash_attention"):]] = max(
            c["max_abs_err"] for c in cases if c["kernel"] == kern)
    return out


# --------------------------------------------------------------------------
# phase 4: sealed serving at full width
# --------------------------------------------------------------------------

def _prompts(seed, count, vocab):
    import numpy as np
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, rng.randint(64, 201)).astype(np.int32)
            for _ in range(count)]


def _chunked_prefill(torch, cfg, params, cache_seal, pools, wc, tables,
                     prompts, starts, dev, chunk=32):
    """Chunked prefill of ``prompts[i][starts[i]:]`` into the blocks of
    ``tables`` (the first ``starts[i]`` tokens already in the cache),
    through the paged functions the engine runs. Returns each prompt's
    last-token logits, stacked."""
    from repro_torch.models import paged as PG
    b = len(prompts)
    lengths = torch.tensor(starts, dtype=torch.int64, device=dev)
    last = [None] * b
    longest = max(len(p) - s0 for p, s0 in zip(prompts, starts))
    for off in range(0, longest, chunk):
        toks = torch.zeros((b, chunk), dtype=torch.int64)
        cl = torch.zeros((b,), dtype=torch.int64)
        for i, (p, s0) in enumerate(zip(prompts, starts)):
            seg = p[s0 + off:s0 + off + chunk]
            toks[i, :len(seg)] = torch.as_tensor(seg, dtype=torch.int64)
            cl[i] = len(seg)
        toks, cl = toks.to(dev), cl.to(dev)
        logits, ups, _ = PG.chunk_logits(cfg, params, pools, tables, lengths,
                                         wc, toks, cl, cache_seal)
        PG.append_tokens(cfg, cache_seal, pools, ups, tables, lengths, cl, wc)
        for i, (p, s0) in enumerate(zip(prompts, starts)):
            if off < len(p) - s0 <= off + chunk:
                last[i] = logits[i]
        lengths = lengths + cl
    return torch.stack(last)


def first_tick_logits(torch, cfg, params, cache_seal, prompts, forced, dev,
                      block_size=16, chunk=32):
    """Chunked prefill of every prompt at once, then one teacher-forced
    decode tick on ``forced`` (or on the prefill argmax when None), through
    the same paged functions the engine runs. Returns (prefill logits,
    decode logits, tokens fed)."""
    from repro_torch.models import cache as MC
    from repro_torch.models import paged as PG
    b = len(prompts)
    longest = max(len(p) for p in prompts)
    mb = -(-(longest + 1) // block_size)
    pools = MC.paged_pool_init(cfg, 1 + b * mb, block_size, dev)
    tables = (1 + torch.arange(b, device=dev)[:, None] * mb
              + torch.arange(mb, device=dev)[None, :])
    wc = torch.zeros((1 + b * mb,), dtype=torch.int32, device=dev)
    prefill = _chunked_prefill(torch, cfg, params, cache_seal, pools, wc,
                               tables, prompts, [0] * b, dev, chunk)
    if forced is None:
        forced = prefill.argmax(dim=-1)
    lengths = torch.tensor([len(p) for p in prompts], device=dev)
    dec, _, _ = PG.decode_logits(cfg, params, pools, tables, lengths, wc,
                                 forced[:, None], cache_seal)
    return prefill, dec, forced


def shared_tick_logits(torch, cfg, params, cache_seal, donor, sharers,
                       forced, dev, block_size=16, chunk=32):
    """The same as ``first_tick_logits`` for ``sharers``, but over a cache a
    donor filled first: the donor's prompt is prefilled and registered in a
    ``PrefixRegistry``, each sharer takes the blocks it matches, its shared
    tail block is copied (``paged.copy_blocks``), and only its own tokens
    are prefilled. Returns (prefill logits, decode logits, tokens shared
    per sharer, copies made)."""
    from repro_torch.models import cache as MC
    from repro_torch.models import paged as PG
    b = len(sharers)
    mb = -(-(max(len(p) for p in [donor] + sharers) + 1) // block_size)
    nb = 1 + (1 + b) * mb
    pools = MC.paged_pool_init(cfg, nb, block_size, dev)
    wc = torch.zeros((nb,), dtype=torch.int32, device=dev)
    alloc = MC.BlockAllocator(nb)
    registry = MC.PrefixRegistry(alloc, block_size)
    own = alloc.alloc(mb)
    _chunked_prefill(torch, cfg, params, cache_seal, pools, wc,
                     torch.tensor([own], device=dev), [donor], [0], dev,
                     chunk)
    registry.register(donor, own)
    tables, starts, pairs = [], [], []
    for p in sharers:
        full, partial, n_shared = registry.match(p)
        priv = alloc.alloc(mb - len(full))
        if partial is not None:
            pairs.append((partial[0], priv[0]))
        tables.append(full + priv)
        starts.append(n_shared)
    if pairs:
        src, dst = (torch.tensor(c, device=dev) for c in zip(*pairs))
        ok = PG.copy_blocks(cfg, cache_seal, pools, wc, src, dst,
                            torch.ones_like(src, dtype=torch.bool))
        if not bool(ok):
            raise AssertionError("a clean shared block failed its MAC")
    tables = torch.tensor(tables, device=dev)
    prefill = _chunked_prefill(torch, cfg, params, cache_seal, pools, wc,
                               tables, sharers, starts, dev, chunk)
    lengths = torch.tensor([len(p) for p in sharers], device=dev)
    dec, _, _ = PG.decode_logits(cfg, params, pools, tables, lengths, wc,
                                 forced[:, None], cache_seal)
    return prefill, dec, starts, len(pairs)


def _rel_err(torch, got, want):
    got, want = got.float().cpu(), want.float().cpu()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - want).abs().max() / want.abs().max())


def phase_serve(torch, dev, args):
    from repro_torch.config import SealConfig
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.core import sealed_store as SS
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tree import map_leaves

    out = {}
    # 3a. small input, held against the CPU plain path (f32)
    small = get_reduced("internlm2_1_8b").with_(dtype="float32")
    p_small = T.init_params(small, seed=args.seed, device="cpu")
    prompts = _prompts(args.seed, 3, small.vocab_size)
    pre_c, dec_c, forced = first_tick_logits(torch, small, p_small, None,
                                             prompts, None, "cpu")
    p_gpu = map_leaves(lambda t: t.to(dev), p_small)
    sp = SS.seal_params(p_gpu, SealConfig(), bytes(range(32)))
    pre_g, dec_g, _ = first_tick_logits(
        torch, small, SS.serving_params(sp, bytes(range(32))),
        SS.cache_seal_config(bytes(range(32)), dev), prompts,
        forced.to(dev), dev)
    err_small = max(_rel_err(torch, pre_g, pre_c), _rel_err(torch, dec_g, dec_c))
    out["reduced_vs_cpu_rel_err"] = err_small
    log(f"[serve] reduced f32: sealed on the card vs plain on the CPU, "
        f"max rel err {err_small:.3e} (tol 1e-4)")
    if not err_small <= 1e-4:
        raise AssertionError("reduced-size card run disagrees with the CPU")

    # 3b. full width
    cfg = get_config("internlm2_1_8b")
    t0 = time.time()
    params = T.init_params(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model},"
        f" {n_params / 1e9:.3f} B params, init {time.time() - t0:.1f} s")
    prompts = _prompts(args.seed + 7, REQUESTS, cfg.vocab_size)
    seal = SealConfig()                   # ColoE, SE 0.5, fused decrypt
    t0 = time.time()
    ops.reset_launch_counts()            # sealing: the keystream kernel
    eng = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=256,
                      seal=seal, device=dev)
    torch.cuda.synchronize()
    out["seal_s"] = time.time() - t0
    out["seal_launches"] = ops.launch_counts()
    fused = eng.stats["fused_matmul_leaves"]
    log(f"[serve] sealed in {out['seal_s']:.1f} s: {fused} fused leaf kinds, "
        f"stored {eng.sealed.stored_bytes() / 1e9:.3f} GB, plaintext per step "
        f"{eng.stats['weights_plaintext_bytes_per_step'] / 1e9:.3f} GB")
    handles = [eng.submit(p, max_tokens=NEW_TOKENS) for p in prompts]

    ops.reset_launch_counts()            # the main path starts here
    torch.cuda.synchronize()
    t0 = time.time()
    eng.run()
    torch.cuda.synchronize()
    launches = ops.launch_counts()       # ... and ends here
    serve_s = time.time() - t0
    out["launches"] = launches
    out["serve_s"] = serve_s
    out["stats"] = {k: v for k, v in eng.stats.items()}
    dispatches = eng.stats["prefills"] + eng.stats["decode_steps"]
    per_dispatch = cfg.n_superblocks() * (fused - 1) + 1
    log(f"[serve] sealed run: {serve_s:.2f} s, {eng.stats['tokens']} tokens, "
        f"{eng.stats['prefills']} chunk + {eng.stats['decode_steps']} decode "
        f"dispatches, launches {launches}")
    if not all(h.done and len(h.out) == NEW_TOKENS for h in handles):
        raise AssertionError("not every request completed")
    fused_launches = (launches["sealed_matmul"] + launches["sealed_matmul_tc"]
                      + launches["sealed_matmul_dec"])
    if fused_launches != dispatches * per_dispatch:
        raise AssertionError(
            f"the fused matmul kernels launched {fused_launches} times, "
            f"expected {per_dispatch} per dispatch x {dispatches}")
    # a decode tick has M = slots rows and a chunk at most 32 per slot's
    # chunk, all <= 64: every fused contraction of the bf16 run takes the
    # decode tensor-core kernel, none the CUDA-core one
    if (launches["sealed_matmul_dec"] != dispatches * per_dispatch
            or launches["sealed_matmul"]):
        raise AssertionError(
            f"sealed_matmul_dec launched {launches['sealed_matmul_dec']} "
            f"times and sealed_matmul {launches['sealed_matmul']}, expected "
            f"{dispatches * per_dispatch} and 0")
    # every pad of the run is made where it is used: one cache view a layer
    # and one splice a write per dispatch, one row gather of the embedding
    # and one unseal of each other line leaf; no keystream to device memory
    want = _chacha_launches(eng, dispatches, paged=True)
    got = {name: launches[name] for name in want}
    log(f"[serve] ChaCha launches: {got} over {dispatches} dispatches")
    if got != want:
        raise AssertionError(f"ChaCha launches {got}, expected {want}")
    eng.check_device_mirror()

    plain = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=256,
                        seal=None, device=dev)
    ph = [plain.submit(p, max_tokens=NEW_TOKENS) for p in prompts]
    plain.run()
    same = sum(a == b for h, g in zip(handles, ph)
               for a, b in zip(h.out, g.out))
    total = sum(len(h.out) for h in handles)
    out["greedy_agreement"] = same / total
    log(f"[serve] greedy tokens equal to the plaintext engine's: "
        f"{same}/{total} = {same / total:.3f}")

    # teacher-forced first decode tick, sealed vs plaintext, one prompt per
    # slot, both fed the plaintext prefill's argmax
    first = prompts[:SLOTS]
    pre_p, dec_p, forced = first_tick_logits(torch, cfg, params, None, first,
                                             None, dev)
    pre_s, dec_s, _ = first_tick_logits(torch, cfg, eng.params(),
                                        eng.cache_seal, first, forced, dev)
    err_pre, err_dec = (_rel_err(torch, pre_s, pre_p),
                        _rel_err(torch, dec_s, dec_p))
    out["first_tick_rel_err"] = {"prefill": err_pre, "decode": err_dec}
    log(f"[serve] teacher-forced logits, sealed vs plaintext: prefill max rel "
        f"err {err_pre:.3e}, first decode tick {err_dec:.3e} (tol 2e-2)")
    if not (err_pre <= 2e-2 and err_dec <= 2e-2):
        raise AssertionError("sealed logits disagree with plaintext")
    # the same weights and forced tokens in f32: without bf16 roundings the
    # two paths differ only in sum order, so a kernel fault that grows
    # through the layers like the bf16 gap would show here
    cfg32 = cfg.with_(dtype="float32")
    pre_p32, dec_p32, _ = first_tick_logits(torch, cfg32, params, None, first,
                                            forced, dev)
    pre_s32, dec_s32, _ = first_tick_logits(torch, cfg32, eng.params(),
                                            eng.cache_seal, first, forced, dev)
    err32 = (_rel_err(torch, pre_s32, pre_p32),
             _rel_err(torch, dec_s32, dec_p32))
    out["first_tick_rel_err_f32"] = {"prefill": err32[0], "decode": err32[1]}
    log(f"[serve] the same in f32: prefill max rel err {err32[0]:.3e}, first "
        f"decode tick {err32[1]:.3e} (tol 1e-4)")
    if not max(err32) <= 1e-4:
        raise AssertionError("sealed f32 logits disagree with plaintext")
    out["tokens"] = [h.out for h in handles]
    out["engine"] = eng
    out["plain_engine"] = plain
    out["params"] = params
    out["prompts"] = prompts
    return out


def _leaves(tree):
    from repro_torch.tree import leaves
    return leaves(tree)


def _chacha_launches(eng, dispatches, paged):
    """Launches of each ChaCha kernel a ChaCha-sealed (ColoE or Counter)
    engine's run of ``dispatches`` must show: per dispatch one
    ``lines_gather_rows`` for an untied embedding (a tied one is the LM
    head too, so it is unsealed whole), one ``lines_unseal`` per other line
    leaf and, over a paged cache, one view per attention layer and one
    splice per attention pattern position; never ``chacha20_blocks``."""
    cfg = eng.cfg
    if eng.seal.mode not in ("coloe", "counter"):
        raise AssertionError(f"{eng.seal.mode} is not a ChaCha seal")
    lines = sum(st.meta.layout == "lines" for st in eng.sealed.tensors.values())
    kept = 0 if cfg.tie_embeddings else 1
    return {"chacha20": 0,
            "chacha20_lines_gather": dispatches * kept,
            "chacha20_lines_unseal": dispatches * (lines - kept),
            "chacha20_cache_view": dispatches * cfg.num_layers if paged else 0,
            "chacha20_cache_splice":
                dispatches * len(cfg.pattern) if paged else 0}


# --------------------------------------------------------------------------
# phase 5: sealed group-drain serving at full width
# --------------------------------------------------------------------------

def _group_tokens(torch, prompts, dev):
    from repro_torch.serve.engine import right_align
    return torch.from_numpy(right_align(prompts)).to(dev)


def group_logits(torch, cfg, params, toks, forced, max_len):
    """One-shot prefill of a group, then one decode step teacher-forced on
    ``forced`` (or on the prefill argmax when None), through the functions
    the group engine runs. Returns (prefill logits, step logits, forced)."""
    from repro_torch.models import transformer as T
    pre, cache = T.prefill(cfg, params, toks, max_len)
    if forced is None:
        forced = pre.argmax(dim=-1)
    dec, _, _ = T.decode_step(cfg, params, cache, forced[:, None],
                              toks.shape[1])
    return pre, dec, forced


def _fused_launches(eng, rows, head_rows):
    """Launches of each fused-matmul kernel in one dispatch of a sealed
    engine whose layer contractions have ``rows`` rows and whose LM head
    has ``head_rows``, by ``sealed_matmul._variant``."""
    from repro_torch.kernels import sealed_matmul as SMK
    counts = {"sealed_matmul": 0, "sealed_matmul_tc": 0,
              "sealed_matmul_dec": 0}
    for path, st in eng.sealed.tensors.items():
        if st.meta.layout != "tiles":
            continue
        layers = st.meta.shape[0] if st.meta.n_batch else 1
        m = head_rows if path.startswith("head") else rows
        counts[SMK._variant(m, st.n_size, st.meta.bk, st.meta.bn,
                            eng.cfg.dtype)] += layers
    return counts


def phase_group(torch, dev, args, serve):
    import numpy as np
    from repro_torch.config import SealConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import drive
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import GroupServeEngine

    cfg, params = serve["engine"].cfg, serve["params"]
    rng = np.random.RandomState(args.seed + 11)
    prompts = [rng.randint(0, cfg.vocab_size,
                           rng.randint(GROUP_PROMPT[0], GROUP_PROMPT[1] + 1)
                           ).astype(np.int32) for _ in range(REQUESTS)]
    out = {"prompt_lens": [len(p) for p in prompts]}
    eng = GroupServeEngine(cfg, params, batch_slots=SLOTS,
                           max_len=GROUP_MAX_LEN, seal=SealConfig(),
                           device=dev)
    arrivals = np.zeros((REQUESTS,))
    kw = dict(max_tokens=NEW_TOKENS)
    ops.reset_launch_counts()            # the group path starts here
    torch.cuda.synchronize()
    t0 = time.time()
    handles = drive(eng, prompts, arrivals, kw)
    torch.cuda.synchronize()
    launches = ops.launch_counts()       # ... and ends here
    out["serve_s"] = time.time() - t0
    out["launches"] = launches
    out["stats"] = dict(eng.stats)
    st = eng.stats
    dispatches = st["prefills"] + st["decode_steps"]
    per_dispatch = cfg.n_superblocks() * (st["fused_matmul_leaves"] - 1) + 1
    log(f"[group] sealed run: {out['serve_s']:.2f} s, prompts "
        f"{min(out['prompt_lens'])}-{max(out['prompt_lens'])} tokens, "
        f"{st['prefills']} prefills + {st['decode_steps']} decode steps, "
        f"launches {launches}")
    if not all(h.done and len(h.out) == NEW_TOKENS for h in handles):
        raise AssertionError("not every group request completed")
    # a prefill's layer contractions have (group size x prompt length) rows,
    # its LM head (last position) and every decode step one row per member:
    # each takes the kernel _variant names for it (at full width: every
    # layer contraction of a prefill on the prefill tensor-core kernel, the
    # heads and decode steps on the decode one); attention runs the
    # tensor-core flash kernel
    want = {"sealed_matmul": 0, "sealed_matmul_tc": 0, "sealed_matmul_dec": 0,
            "flash_attention_tc": st["prefills"] * cfg.num_layers,
            "flash_attention": 0, "flash_attention_tc256": 0}
    groups = [prompts[i:i + SLOTS] for i in range(0, len(prompts), SLOTS)]
    for g in groups:
        for rows, head_rows in ((len(g) * max(len(p) for p in g), len(g)),):
            for name, n in _fused_launches(eng, rows, head_rows).items():
                want[name] += n
    steps = st["decode_steps"]
    for name, n in _fused_launches(eng, SLOTS, SLOTS).items():
        want[name] += steps * n
    if len(groups) != st["prefills"]:
        raise AssertionError(f"{st['prefills']} prefills for {len(groups)} "
                             f"groups")
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in the group run, expected {n}")
    cc_want = _chacha_launches(eng, dispatches, paged=False)
    cc_got = {name: launches[name] for name in cc_want}
    log(f"[group] ChaCha launches: {cc_got} over {dispatches} dispatches")
    if cc_got != cc_want:
        raise AssertionError(f"group ChaCha launches {cc_got}, expected "
                             f"{cc_want}")

    plain = GroupServeEngine(cfg, params, batch_slots=SLOTS,
                             max_len=GROUP_MAX_LEN, seal=None, device=dev)
    ph = drive(plain, prompts, arrivals, kw)
    same = sum(a == b for h, g in zip(handles, ph)
               for a, b in zip(h.out, g.out))
    total = sum(len(h.out) for h in handles)
    out["greedy_agreement"] = same / total
    log(f"[group] greedy tokens equal to the plaintext group engine's: "
        f"{same}/{total} = {same / total:.3f}")

    # teacher-forced prefill and first step, sealed vs plaintext, on the
    # first group, both fed the plaintext prefill's argmax
    toks = _group_tokens(torch, prompts[:SLOTS], dev)
    out["prefill_rows"] = int(toks.numel())
    cfg32 = cfg.with_(dtype="float32")
    errs = {}
    for label, c in (("bf16", cfg), ("f32", cfg32)):
        pre_p, dec_p, forced = group_logits(torch, c, params, toks, None,
                                            GROUP_MAX_LEN)
        ops.reset_launch_counts()        # the f32 path: CUDA-core kernels
        pre_s, dec_s, _ = group_logits(torch, c, eng.params(), toks, forced,
                                       GROUP_MAX_LEN)
        torch.cuda.synchronize()
        if label == "f32":
            out["f32_launches"] = ops.launch_counts()
        errs[label] = (_rel_err(torch, pre_s, pre_p),
                       _rel_err(torch, dec_s, dec_p))
    out["teacher_forced_rel_err"] = errs
    log(f"[group] teacher-forced logits, sealed vs plaintext: bf16 prefill "
        f"{errs['bf16'][0]:.3e}, first step {errs['bf16'][1]:.3e} (tol 2e-2);"
        f" f32 {errs['f32'][0]:.3e}, {errs['f32'][1]:.3e} (tol 1e-4)")
    if not max(errs["bf16"]) <= 2e-2:
        raise AssertionError("sealed group logits disagree with plaintext")
    if not max(errs["f32"]) <= 1e-4:
        raise AssertionError("sealed f32 group logits disagree with "
                             "plaintext")
    f32 = out["f32_launches"]
    log(f"[group] launches of the f32 sealed prefill and step: {f32}")
    if (f32["flash_attention"] != cfg.num_layers or f32["sealed_matmul"]
            != 2 * per_dispatch or f32["sealed_matmul_tc"]
            or f32["sealed_matmul_dec"] or f32["flash_attention_tc"]
            or f32["flash_attention_tc256"]):
        raise AssertionError("the f32 path did not run the CUDA-core "
                             "kernels")

    # one unpadded prompt of the longest length, f32: the one-shot prefill
    # (flash) against the chunked path of phase 4 (_sdpa over the paged
    # view)
    long_prompt = rng.randint(0, cfg.vocab_size, GROUP_PROMPT[1])
    one_shot, _ = T.prefill(cfg32, params,
                            torch.as_tensor(long_prompt[None]).to(dev),
                            GROUP_MAX_LEN)
    chunked, _, _ = first_tick_logits(torch, cfg32, params, None,
                                      [long_prompt], None, dev)
    err = _rel_err(torch, one_shot, chunked)
    out["one_shot_vs_chunked_rel_err"] = err
    log(f"[group] one-shot prefill vs chunked prefill, {len(long_prompt)} "
        f"tokens, f32: "
        f"max rel err {err:.3e} (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError("one-shot prefill disagrees with the chunked "
                             "path")
    out["engine"], out["plain_engine"] = eng, plain
    out["prompts"] = prompts
    return out


# --------------------------------------------------------------------------
# phase 6: prefix sharing and cache integrity at full width
# --------------------------------------------------------------------------

# the shared-prefix trace: a common prefix of 12 full blocks and an 11-token
# tail, then 16-120 own tokens a prompt. A sharer copies a block only when a
# donor's prompt ENDS inside it (the registry's partial entry): request 0's
# own tokens are cut so that its prompt, like the prefix, ends 11 tokens
# into a block, and request 5 resubmits it, sharing every token but the
# last and copying the tail block
PREFIX_TOKENS, OWN_TOKENS, CLONE, TAIL = 203, (16, 120), (5, 0), 11
# the tamper runs: two slots, three short requests
TAMPER_LENS, TAMPER_NEW = (40, 23, 33), 10


def _prefix_prompts(seed, vocab):
    import numpy as np
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, PREFIX_TOKENS)
    prompts = [np.concatenate([prefix, rng.randint(
        0, vocab, rng.randint(OWN_TOKENS[0], OWN_TOKENS[1] + 1))]).astype(
            np.int32) for _ in range(REQUESTS)]
    donor = prompts[CLONE[1]]
    donor = donor[:len(donor) - (len(donor) - TAIL) % 16]
    prompts[CLONE[1]], prompts[CLONE[0]] = donor, donor.copy()
    return prompts


def _drain(torch, eng, prompts, new_tokens, settings=()):
    """Submit every prompt (with ``settings[i % len(settings)]`` as its
    sampling settings when given), run the engine dry; returns (handles,
    the launch counts of the run, seconds). The counts are zeroed just
    before and read just after the run."""
    from repro_torch.kernels import ops
    handles = [eng.submit(p, max_tokens=new_tokens,
                          **(settings[i % len(settings)] if settings else {}))
               for i, p in enumerate(prompts)]
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    eng.run()
    torch.cuda.synchronize()
    return handles, ops.launch_counts(), time.time() - t0


def phase_prefix_integrity(torch, dev, args, serve):
    """(a) prefix sharing over sealed weights and a sealed cache, (b) the
    verified cache, (c) the four tamper kinds, (d) the verified tick and a
    copy-on-write admission timed; internlm2-1.8B at full width, bf16."""
    from repro_torch.config import SealConfig
    from repro_torch.core.security.tamper import FAULT_KINDS, TamperInjector
    from repro_torch.serve.engine import ServeEngine
    cfg, params = serve["engine"].cfg, serve["params"]
    out = {}

    # (a) prefix sharing: the shared run's launches are the copy kernel's
    # main path; its streams are reported against an unshared run
    prompts = _prefix_prompts(args.seed + 13, cfg.vocab_size)
    max_len = PREFIX_TOKENS + OWN_TOKENS[1] + NEW_TOKENS + 16
    kw = dict(batch_slots=SLOTS, max_len=max_len, seal=SealConfig(),
              device=dev)
    unshared = ServeEngine(cfg, params, **kw)
    uh, _, _ = _drain(torch, unshared, prompts, NEW_TOKENS)
    del unshared
    eng = ServeEngine(cfg, params, prefix_share=True, **kw)
    handles, launches, secs = _drain(torch, eng, prompts, NEW_TOKENS)
    st = eng.stats
    dispatches = st["prefills"] + st["decode_steps"]
    out["shared"] = {"stats": dict(st), "launches": launches, "serve_s": secs,
                     "greedy_agreement": sum(
                         x == y for h, u in zip(handles, uh)
                         for x, y in zip(h.out, u.out))
                     / sum(len(h.out) for h in handles)}
    log(f"[prefix] shared run: {secs:.2f} s, {st['prefills']} chunk + "
        f"{st['decode_steps']} decode dispatches, shared "
        f"{st['shared_prefix_blocks']} blocks / "
        f"{st['shared_prefix_tokens']} tokens, {st['cow_copies']} "
        f"copy-on-write, launches {launches}")
    log(f"[prefix] greedy tokens equal to the unshared run's: "
        f"{out['shared']['greedy_agreement']:.3f}")
    if not all(h.done and len(h.out) == NEW_TOKENS for h in handles):
        raise AssertionError("not every shared request completed")
    if st["shared_prefix_blocks"] <= 0 or st["cow_copies"] < 1:
        raise AssertionError("the shared run shared no block or copied none")
    want = _chacha_launches(eng, dispatches, paged=True)
    want.update(chacha20_cache_copy=st["cow_copies"], chacha20_cache_tags=0,
                chacha20_cache_verify=0)
    got = {name: launches[name] for name in want}
    if got != want:
        raise AssertionError(f"shared run ChaCha launches {got}, expected "
                             f"{want}")
    eng.check_device_mirror()
    reg = eng._registry
    held = [0] * eng.num_blocks
    for b in list(reg._full.values()) + [b for b, _ in reg._partial.values()]:
        held[b] += 1
    if eng._alloc.refcount != held:
        raise AssertionError("after the drain a block is held by more than "
                             "the registry")
    # (d) a copy-on-write admission: the clone of a registered prompt
    clone = eng.submit(prompts[CLONE[1]], max_tokens=NEW_TOKENS)
    cow0 = st["cow_copies"]
    torch.cuda.synchronize()
    t0 = time.time()
    eng._admit()
    torch.cuda.synchronize()
    out["cow_admission_ms"] = 1e3 * (time.time() - t0)
    if st["cow_copies"] != cow0 + 1 or clone in eng.queue:
        raise AssertionError("the clone was not admitted by copy-on-write")
    eng.run()
    reg.evict_lru(eng.num_blocks)
    if eng._alloc.free_count != eng.num_blocks - 1:
        raise AssertionError("evict_lru left blocks allocated")
    log(f"[prefix] refcounts registry-only after the drain; evict_lru freed "
        f"every block; a copy-on-write admission took "
        f"{out['cow_admission_ms']:.2f} ms (host clock, synchronized)")
    # teacher-forced, f32: the clone (shares all but its last token, its
    # tail block copied) and a sharer of the 12 prefix blocks, each against
    # its unshared prefill
    cfg32 = cfg.with_(dtype="float32")
    sharers = [prompts[CLONE[0]], prompts[1]]
    view = eng.params()
    pre_u, dec_u, forced = first_tick_logits(torch, cfg32, view,
                                             eng.cache_seal, sharers, None,
                                             dev)
    pre_s, dec_s, starts, copies = shared_tick_logits(
        torch, cfg32, view, eng.cache_seal, prompts[CLONE[1]], sharers,
        forced, dev)
    errs = (_rel_err(torch, pre_s, pre_u), _rel_err(torch, dec_s, dec_u))
    out["shared_vs_unshared_rel_err_f32"] = errs
    log(f"[prefix] teacher-forced f32 logits, shared ({starts} tokens "
        f"shared, {copies} copied block) vs unshared: prefill {errs[0]:.3e},"
        f" first decode tick {errs[1]:.3e} (tol 1e-4)")
    if not (max(errs) <= 1e-4 and copies == 1 and min(starts) > 0):
        raise AssertionError("shared logits disagree with unshared")
    del eng, view
    torch.cuda.empty_cache()

    # (b) the verified cache on phase 4's trace: the tags kernel's main path
    vprompts = serve["prompts"]
    kw = dict(batch_slots=SLOTS, max_len=256, seal=None, seal_cache=True,
              device=dev)
    plain = ServeEngine(cfg, params, **kw)
    ph, plain_launches, plain_s = _drain(torch, plain, vprompts, NEW_TOKENS)
    ver = ServeEngine(cfg, params, verify=True, **kw)
    vh, launches, secs = _drain(torch, ver, vprompts, NEW_TOKENS)
    st = ver.stats
    dispatches = st["prefills"] + st["decode_steps"]
    checks = st["prefill_chunks"] + st["tokens"] - len(vprompts)
    want = {"chacha20": 0, "chacha20_lines_gather": 0,
            "chacha20_lines_unseal": 0, "chacha20_cache_copy": 0,
            "chacha20_cache_view": dispatches * cfg.num_layers,
            "chacha20_cache_splice": dispatches * len(cfg.pattern),
            "chacha20_cache_tags": dispatches * len(cfg.pattern),
            "chacha20_cache_verify": dispatches * len(cfg.pattern)}
    got = {name: launches[name] for name in want}
    out["verify"] = {"stats": dict(st), "launches": launches,
                     "serve_s": secs, "plain_serve_s": plain_s}
    log(f"[verify] verified run: {secs:.2f} s (unverified {plain_s:.2f} s), "
        f"{dispatches} dispatches, mac_checks {st['mac_checks']} (expected "
        f"{checks}), mac_failures {st['mac_failures']}, launches {launches}")
    if [h.out for h in vh] != [h.out for h in ph]:
        raise AssertionError("verified tokens differ from unverified ones")
    if st["mac_failures"] or st["retries"] or st["mac_checks"] != checks:
        raise AssertionError("the verified run's MAC counts are wrong")
    if got != want:
        raise AssertionError(f"verified ChaCha launches {got}, expected "
                             f"{want}")
    ver.check_device_mirror()
    # (d) a verified tick against an unverified one, every slot decoding
    ticks = {}
    for label, e in (("verified", ver), ("unverified", plain)):
        for p in vprompts[:SLOTS]:
            e.submit(p, max_tokens=64)
        while any(r is None or e._pending[i] is not None
                  for i, r in enumerate(e._active)):
            e.step()
        ms = _time_ms(torch, e._decode_tick, 5)
        wall = []
        for _ in range(5):
            t0 = time.time()
            e._decode_tick()               # ends in the tokens' d2h copy
            wall.append(1e3 * (time.time() - t0))
        ticks[label] = {"ms": ms, "host_ms": sorted(wall)[len(wall) // 2]}
        log(f"[time] decode tick, {SLOTS} slots, sealed cache, {label}: "
            f"{ms:.2f} ms (device events), {ticks[label]['host_ms']:.2f} ms "
            f"(host clock)")
    for label, e in (("verified", ver), ("unverified", plain)):
        prof = _profile(torch, e._decode_tick, 3,
                        f"{label} sealed-cache decode ticks")
        ticks[label]["device_busy_ms"] = prof["device_busy_ms"] / 3
        ticks[label]["idle_share"] = prof["idle_share"]
        ticks[label]["chacha_device_ms"] = _chacha_device_ms(prof)
    log(f"[profile] device ms per tick: verified "
        f"{ticks['verified']['device_busy_ms']:.2f}, unverified "
        f"{ticks['unverified']['device_busy_ms']:.2f}; ChaCha kernels per "
        f"verified tick {ticks['verified']['chacha_device_ms']}")
    out["ticks"] = ticks
    out["timing"] = {"chacha20_cache_verify": [_verify_at_tick(
        torch, dev, ver, ticks["verified"]["chacha_device_ms"][
            "chacha20_cache_verify"])]}
    del ver, plain
    torch.cuda.empty_cache()

    # (c) each tamper kind: detected, the victim re-prefilled, the others'
    # tokens those of a clean run, no block leaked
    import numpy as np
    rng = np.random.RandomState(args.seed + 17)
    tprompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
                for n in TAMPER_LENS]
    kw = dict(batch_slots=2, max_len=64, seal=None, seal_cache=True,
              verify=True, device=dev)
    clean, _, _ = _drain(torch, ServeEngine(cfg, params, **kw), tprompts,
                         TAMPER_NEW)
    out["tamper"] = {}
    for kind in FAULT_KINDS:
        inj = TamperInjector(kind, slot=0, start_step=3)
        e = ServeEngine(cfg, params, fault_hooks=(inj,), **kw)
        hs, _, _ = _drain(torch, e, tprompts, TAMPER_NEW)
        st = e.stats
        others = [h.out == c.out for h, c in zip(hs, clean)
                  if h.retries == 0]
        rec = {"fired": inj.fired, "mac_failures": st["mac_failures"],
               "retries": st["retries"], "mac_checks": st["mac_checks"],
               "victims": [h.rid for h in hs if h.retries],
               "others_exact": all(others),
               "free": e._alloc.free_count, "blocks": e.num_blocks}
        out["tamper"][kind] = rec
        log(f"[tamper] {kind}: {rec}")
        if not (inj.fired and st["mac_failures"] >= 1 and st["retries"] >= 1
                and rec["victims"] and all(others)
                and all(h.done and h.error is None
                        and len(h.out) == TAMPER_NEW for h in hs)
                and rec["free"] == e.num_blocks - 1):
            raise AssertionError(f"tamper {kind} was not detected and "
                                 f"recovered: {rec}")
        e.check_device_mirror()
        del e
    torch.cuda.empty_cache()
    return out


def _verify_at_tick(torch, dev, eng, in_tick_ms):
    """The verify kernel at a verified engine's own operands (its pools,
    tables, lengths and counters, as its next tick's check reads them):
    bitwise against the plain version and every slot intact, then timed
    after an L2 flush by writes (the kernels' yardstick: the flush leaves
    dirty lines for the kernel to write back), after one by reads (clean
    lines) and without one, beside its bound over the resident blocks and
    its device time inside a profiled tick (``in_tick_ms``)."""
    from repro_torch.kernels import chacha20 as CC
    from repro_torch.models import cache as MC
    if len(eng._pools) != 1:
        raise AssertionError("the verify timing reads one pattern position")
    seal, state, pool = eng.cache_seal, eng._state, eng._pools[0]
    wpb = pool["k"].shape[-1]
    bs = wpb // MC.kv_words_per_token(eng.cfg)
    mac = seal.mac
    vargs = (mac.key_words, mac.hash_keys(wpb), *seal.mac_nonces(),
             pool["k"], pool["v"], pool["mac_k"], pool["mac_v"], pool["lid"],
             state.tables, state.lengths, state.wc, bs)
    got = [CC.cache_verify_cuda(*vargs) for _ in range(2)]
    want = CC.cache_verify_plain(*vargs)
    torch.cuda.synchronize()
    if not all(torch.equal(g, want) for g in got) or not bool(want.all()):
        raise AssertionError(f"cache_verify at a tick's operands: "
                             f"{[g.tolist() for g in got]}, plain "
                             f"{want.tolist()}")
    mb = state.tables.shape[1]
    resident = int(((state.lengths + bs - 1) // bs).clamp(max=mb).sum())
    n = pool["k"].shape[0]
    tags = 2 * n * resident
    scratch = torch.empty((64 * 2**20,), dtype=torch.int32, device=dev)
    cold = _time_stats(torch, lambda: CC.cache_verify_cuda(*vargs), 20,
                       lambda: scratch.zero_())
    clean = _time_stats(torch, lambda: CC.cache_verify_cuda(*vargs), 20,
                        lambda: scratch.sum())
    warm = _time_stats(torch, lambda: CC.cache_verify_cuda(*vargs), 20)
    plain_ms = _time_ms(torch, lambda: CC.cache_verify_plain(*vargs), 2)
    b_ms, b_by = _tags_bound(tags, wpb)
    label = (f"a tick's check, {n} layers x {state.tables.shape[0]} slots "
             f"x {mb} blocks, lengths {state.lengths.tolist()}, {resident} "
             f"resident")
    log(f"[time] chacha20_cache_verify {label}: {cold['ms']:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; {tags} tags of "
        f"{4 * wpb} bytes; {b_ms / cold['ms']:.2f} of the kernel's time); "
        f"{in_tick_ms:.4f} ms inside a profiled tick")
    log(f"[time]   events, L2 flushed by writes: {_stats_text(cold)}")
    log(f"[time]   events, L2 flushed by reads: {_stats_text(clean)}")
    log(f"[time]   events, not flushed: {_stats_text(warm)}")
    del scratch
    return {"shape": label, "ms": cold["ms"], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "tags": tags,
            "lengths": state.lengths.tolist(), "stats": cold,
            "read_flushed": clean, "unflushed": warm,
            "in_tick_ms": in_tick_ms}


# --------------------------------------------------------------------------
# phase 7: timings
# --------------------------------------------------------------------------

def _gc_runs():
    return sum(g["collections"] for g in gc.get_stats())


def _time_stats(torch, fn, iters, flush=None):
    """CUDA-event times of ``fn`` over ``iters`` launches after one warm-up;
    ``flush`` (if given) runs between launches, outside the timed window,
    so every launch finds a cold L2. Before each start event the stream gets
    a device-side sleep of about 1 ms, so the host has enqueued the start
    event and ``fn``'s launches before the device reaches them: a short call
    is timed by the device, not by the host's dispatch. Returns the mean
    (``ms``) and the median of the launches' times, each launch's time,
    the host's time from recording the start event to recording the end
    one (``host_ms``: where it passes the sleep, the device may have waited
    for the host inside the window; ``host_past_sleep`` counts those
    windows) and the garbage collections the host ran in that time
    (``gc``)."""
    sleep_ms = _sleep_ms(torch)
    fn()
    torch.cuda.synchronize()
    times, host, gcs = [], [], []
    for _ in range(iters):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        g0, t0 = _gc_runs(), time.perf_counter()
        a.record()
        fn()
        b.record()
        host.append(1e3 * (time.perf_counter() - t0))
        gcs.append(_gc_runs() - g0)
        b.synchronize()
        times.append(a.elapsed_time(b))
    return {"ms": statistics.fmean(times),
            "median_ms": statistics.median(times), "times": times,
            "host_ms": host, "gc": gcs, "sleep_ms": sleep_ms,
            "host_past_sleep": sum(h > sleep_ms for h in host)}


def _time_ms(torch, fn, iters, flush=None):
    """The mean CUDA-event time of ``fn`` (``_time_stats``)."""
    return _time_stats(torch, fn, iters, flush)["ms"]


_SLEEP_MS = []


def _sleep_ms(torch):
    """How long the device-side sleep before each timed window lasts
    (measured once)."""
    if _SLEEP_MS:
        return _SLEEP_MS[0]
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    b.record()
    b.synchronize()
    _SLEEP_MS.append(a.elapsed_time(b))
    return _SLEEP_MS[0]


def _stats_text(st):
    """A ``_time_stats`` result in a log line."""
    return (f"mean {st['ms']:.4f} ms, median {st['median_ms']:.4f}, "
            f"launches {[round(x, 4) for x in st['times']]}, host "
            f"{[round(x, 3) for x in st['host_ms']]} ms "
            f"({st['host_past_sleep']} past the {st['sleep_ms']:.3f} ms "
            f"sleep), gc {sum(st['gc'])}")


def _sealed_bound(m, k, n, enc_rows, x_bytes):
    """Least time of one fused matmul: x, the ciphertext and the mask read
    once, the f32 output written once; the ChaCha pads of the encrypted
    rows made once; the products on the bf16 tensor cores."""
    nbytes = x_bytes * m * k + 4 * k * n + k + 4 * m * n + 48
    pads = enc_rows * (n // 16)
    return bound_ms(nbytes, pads * (CHACHA_OPS + CHACHA_XOR_OPS),
                    2.0 * m * k * n, pads * (CHACHA_ALU_OPS + CHACHA_XOR_OPS))


def phase_timing(torch, dev, args, report):
    from repro_torch.core.sealed_store import _pick_block
    from repro_torch.kernels import chacha20 as CC
    from repro_torch.kernels import sealed_matmul as SMK
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    scratch = torch.empty((64 * 2**20,), dtype=torch.int32, device=dev)
    flush = lambda: scratch.zero_()           # 256 MB > the 50 MB L2
    out = {"sealed_matmul_shapes": []}

    # the fused matmul kernels at each main-path leaf shape, SE 0.5, bf16:
    # at decode M (a tick's 4 rows, a chunk's 32) the decode tensor-core
    # kernel beside the CUDA-core one, in turns (old, new, new, old); at the
    # group prefill's M = 3560 the CUDA-core kernel (its old path) beside the
    # prefill tensor-core kernel
    prefill_m = report["group"]["prefill_rows"]
    launchers = {"sealed_matmul": SMK.sealed_matmul_cuda,
                 "sealed_matmul_dec": SMK.sealed_matmul_dec_cuda,
                 "sealed_matmul_tc": SMK.sealed_matmul_tc_cuda}
    for name, (k, n) in _shapes().items():
        bk, bn = _pick_block(k), _pick_block(n)
        w, mask, key, nonce, ct, wcw = _sealed_operands(
            torch, dev, gen, k, n, 0.5, 5, bk, bn)
        enc_rows = int(mask.sum())
        runs = [("sealed_matmul", 4), ("sealed_matmul_dec", 4),
                ("sealed_matmul_dec", 32), ("sealed_matmul", 32),
                ("sealed_matmul", prefill_m), ("sealed_matmul_tc", prefill_m)]
        if name in ("head", "wk"):  # a prefill runs the head on its last
            # row only; wk/wv are timed at decode sizes
            runs.remove(("sealed_matmul", prefill_m))
        plain_at = {}
        for kern, m in runs:
            # the tensor-core kernels take x as the model hands it: bf16
            bf16_x = kern != "sealed_matmul"
            x = torch.randn((m, k), generator=gen, device=dev)
            if bf16_x:
                x = x.to(torch.bfloat16)
            launch = launchers[kern]
            run = lambda: launch(x, ct, mask, key, nonce, wcw, bk=bk, bn=bn,
                                 compute_dtype="bfloat16")
            plain = lambda: SMK.sealed_matmul_plain(
                x, ct, mask, key, nonce, wcw, bk=bk, bn=bn,
                compute_dtype="bfloat16")
            ms = _time_ms(torch, run, 3 if m > 64 and not bf16_x else 10,
                          flush)
            if m not in plain_at and (m == 4 or (
                    kern == "sealed_matmul_tc" and name == "mlp_wi")):
                plain_at[m] = _time_ms(torch, plain, 2)
            plain_ms = plain_at.get(m)
            b_ms, b_by = _sealed_bound(m, k, n, enc_rows, 2 if bf16_x else 4)
            rec = {"kernel": kern, "leaf": name, "M": m, "K": k, "N": n,
                   "bk": bk, "bn": bn, "enc_rows": enc_rows, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
            out["sealed_matmul_shapes"].append(rec)
            pm = f"{plain_ms:.3f}" if plain_ms is not None else "-"
            log(f"[time] {kern} {name} M={m} K={k} N={n}: {ms:.4f} ms, "
                f"plain {pm} ms, bound {b_ms:.4f} ms ({b_by})")
            del x
        del w, ct
        torch.cuda.empty_cache()
    # the tensor-core kernel's time against the share of encrypted rows:
    # at SE 0 no pad is made, so the difference is the pads' cost
    k, n = _shapes()["mlp_wi"]
    x = torch.randn((prefill_m, k), generator=gen,
                    device=dev).to(torch.bfloat16)
    out["sealed_matmul_tc_by_ratio"] = {}
    for ratio in (0.0, 0.5, 1.0):
        w, mask, key, nonce, ct, wcw = _sealed_operands(
            torch, dev, gen, k, n, ratio, 5, 128, 128)
        ms = _time_ms(torch, lambda: SMK.sealed_matmul_tc_cuda(
            x, ct, mask, key, nonce, wcw, bk=128, bn=128,
            compute_dtype="bfloat16"), 10, flush)
        out["sealed_matmul_tc_by_ratio"][ratio] = ms
        log(f"[time] sealed_matmul_tc mlp_wi M={prefill_m} SE {ratio}: "
            f"{ms:.4f} ms")
        del w, ct
    del x
    recs = out["sealed_matmul_shapes"]
    by = {(r["kernel"], r["leaf"], r["M"]): r for r in recs}
    for name in _shapes():
        for m in (4, 32):
            old, new = (by[("sealed_matmul", name, m)],
                        by[("sealed_matmul_dec", name, m)])
            log(f"[time] decode fused matmul {name} M={m}: sealed_matmul_dec "
                f"{new['ms']:.4f} ms, sealed_matmul {old['ms']:.4f} ms "
                f"({old['ms'] / new['ms']:.2f}x), bound {new['bound_ms']:.4f}"
                f" ms ({new['bound_by']}; {new['bound_ms'] / new['ms']:.2f} "
                f"of the new kernel's time)")
    for kern, m in (("sealed_matmul", 4), ("sealed_matmul_dec", 4),
                    ("sealed_matmul_tc", prefill_m)):
        main = next(r for r in recs if r["kernel"] == kern
                    and r["leaf"] == "mlp_wi" and r["M"] == m)
        out[kern] = {"ms": main["ms"], "plain_ms": main["plain_ms"],
                     "bound_ms": main["bound_ms"],
                     "bound_by": main["bound_by"],
                     "shape": f"mlp_wi M={m} K={main['K']} N={main['N']} "
                              f"SE0.5 bf16"}
    old = next(r for r in recs if r["kernel"] == "sealed_matmul"
               and r["leaf"] == "mlp_wi" and r["M"] == prefill_m)
    speedup = old["ms"] / out["sealed_matmul_tc"]["ms"]
    out["sealed_matmul_tc"]["speedup_over_cuda_cores"] = speedup
    log(f"[time] fused matmul, mlp_wi M={prefill_m} SE 0.5 bf16: tensor "
        f"cores {out['sealed_matmul_tc']['ms']:.3f} ms, CUDA cores "
        f"{old['ms']:.3f} ms ({speedup:.1f}x), plain "
        f"{out['sealed_matmul_tc']['plain_ms']:.3f} ms, bound "
        f"{out['sealed_matmul_tc']['bound_ms']:.4f} ms")

    # the keystream kernel at the two kinds of call the serving path made
    # of it before its pads moved into the fused kernels: the embedding's
    # line OTP
    # (two blocks per 128 B line, per-block nonces), and one cache-block OTP
    from repro_torch import u32
    cfg = report["serve"]["engine"].cfg
    n_embed = 2 * (-(-cfg.vocab_size * cfg.d_model // 32))
    key = _rand_words(torch, gen, (8,), dev)
    out["chacha_shapes"] = []
    for label, nblk in (("embed line OTP", n_embed),
                        ("KV view OTP, 4 slots x 16 blocks", 4 * 16 * 512)):
        ctr = u32.from_i64(torch.arange(nblk, device=dev))
        nz = _rand_words(torch, gen, (nblk, 3), dev)
        ms = _time_ms(torch, lambda: CC.chacha20_blocks_cuda(key, ctr, nz),
                      20, flush)
        plain_ms = _time_ms(torch,
                            lambda: CC.chacha20_blocks_plain(key, ctr, nz), 2)
        b_ms, b_by = bound_ms(nblk * (64 + 4 + 12) + 32, nblk * CHACHA_OPS,
                              alu_ops=nblk * CHACHA_ALU_OPS)
        out["chacha_shapes"].append({"call": label, "blocks": nblk, "ms": ms,
                                     "plain_ms": plain_ms, "bound_ms": b_ms,
                                     "bound_by": b_by})
        log(f"[time] chacha20 {label}: {nblk} blocks, {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    for rec in out["chacha_shapes"]:
        log(f"[time] chacha20 {rec['call']}: {rec['ms']:.4f} ms against a "
            f"{rec['bound_ms']:.4f} ms bound ({rec['bound_ms'] / rec['ms']:.2f})")
    c0 = out["chacha_shapes"][0]
    out["chacha20"] = {"ms": c0["ms"], "plain_ms": c0["plain_ms"],
                       "bound_ms": c0["bound_ms"], "bound_by": c0["bound_by"],
                       "shape": f"{c0['blocks']} blocks, per-block nonces"}

    # one decode tick with every slot decoding, sealed and plaintext
    serve = report["serve"]
    ticks = {}
    for label, eng in (("sealed", serve["engine"]),
                       ("plaintext", serve["plain_engine"])):
        for p in serve["prompts"][:eng.slots]:
            eng.submit(p, max_tokens=64)
        while any(r is None or eng._pending[i] is not None
                  for i, r in enumerate(eng._active)):
            eng.step()
        ms = _time_ms(torch, eng._decode_tick, 5)
        wall = []
        for _ in range(5):
            t0 = time.time()
            eng._decode_tick()            # ends in the tokens' d2h copy
            wall.append(1e3 * (time.time() - t0))
        ticks[label] = {"ms": ms, "host_ms": sorted(wall)[len(wall) // 2]}
        eng.queue.clear()
        log(f"[time] decode tick, {eng.slots} slots, {label}: {ms:.2f} ms "
            f"(device events), {ticks[label]['host_ms']:.2f} ms (host clock)")
    # the tick's sealed matmuls alone, at their bound: every fused leaf at
    # M = slots, with the image's own masks
    eng = serve["engine"]
    tb_bytes, tb_ops, tb_alu = 0.0, 0.0, 0.0
    for path, st in eng.sealed.tensors.items():
        if st.meta.layout != "tiles":
            continue
        layers = st.meta.shape[0] if st.meta.n_batch else 1
        k, n = st.k_size, st.n_size
        enc = int(st.row_mask.sum())
        tb_bytes += layers * (4 * k * n + k) + layers * 4 * eng.slots * (k + n)
        tb_ops += enc * (n // 16) * (CHACHA_OPS + CHACHA_XOR_OPS)
        tb_alu += enc * (n // 16) * (CHACHA_ALU_OPS + CHACHA_XOR_OPS)
    b_ms, b_by = bound_ms(tb_bytes, tb_ops, alu_ops=tb_alu)
    ticks["sealed_matmul_bound_ms"] = b_ms
    ticks["sealed_matmul_bound_by"] = b_by
    log(f"[time] the tick's sealed matmuls at their bound: {b_ms:.3f} ms "
        f"({b_by}; {tb_bytes / 1e9:.2f} GB, {tb_ops / 1e9:.1f} G int ops, "
        f"{tb_alu / 1e9:.1f} G of them on the ALU pipe)")
    # the 169 launches of a tick (M = 4) and of a 32-row chunk, summed from
    # the per-leaf times above (each launch timed alone, L2 flushed)
    shape_leaf = {kn: name for name, kn in _shapes().items()}
    sums = {}
    for kern in ("sealed_matmul", "sealed_matmul_dec"):
        for m in (4, 32):
            total = 0.0
            for path, st in eng.sealed.tensors.items():
                if st.meta.layout != "tiles":
                    continue
                layers = st.meta.shape[0] if st.meta.n_batch else 1
                leaf = shape_leaf[(st.k_size, st.n_size)]
                total += layers * by[(kern, leaf, m)]["ms"]
            sums[f"{kern} M={m}"] = total
    ticks["fused_matmul_sum_ms"] = sums
    log(f"[time] the 169 fused matmuls of a dispatch, summed: " + ", ".join(
        f"{key_} {v:.3f} ms" for key_, v in sums.items())
        + f" (the tick's bound {b_ms:.3f} ms)")
    out["decode_tick"] = ticks
    prof = _profile(torch, serve["engine"]._decode_tick, 3,
                    "sealed decode ticks")
    out["tick_profile"] = prof
    if any("splitk_reduce" in name for name in prof["device_ms"]):
        raise AssertionError("a sealed decode tick still runs splitk_reduce")
    dec_ms = sum(v for name, v in prof["device_ms"].items()
                 if "sealed_matmul_dec" in name) / prof["reps"]
    ticks["sealed_matmul_dec_device_ms_per_tick"] = dec_ms
    log(f"[profile] sealed_matmul_dec: {dec_ms:.3f} ms of device time per "
        f"tick (bound {b_ms:.3f} ms); no splitk_reduce")
    ticks["chacha_device_ms_per_tick"] = _chacha_device_ms(prof)
    log(f"[profile] ChaCha kernels per sealed tick (device ms): "
        f"{ticks['chacha_device_ms_per_tick']}; idle share "
        f"{prof['idle_share']:.3f}; the tick {ticks['sealed']['ms']:.2f} ms "
        f"between events")
    for key_ in ("engine", "plain_engine", "params", "prompts"):
        serve.pop(key_)
    out.update(_time_group(torch, dev, gen, flush, report["group"]))
    return out


def _time_group(torch, dev, gen, flush, group):
    """Both flash kernels at the group prefill's shape and at 8192 tokens,
    beside their plain version, their bound and SDPA; one sealed and one
    plaintext group prefill and decode step; profiles of a sealed and a
    plaintext prefill."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as T
    eng, plain = group["engine"], group["plain_engine"]
    cfg = eng.cfg
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    toks = _group_tokens(torch, group["prompts"][:eng.slots], dev)
    b, plen = toks.shape
    out = {"flash_shapes": []}
    for bb, ss in ((b, plen), (1, FLASH_LONG)):
        q, k, v = _flash_inputs(torch, gen, dev, bb, ss, ss, hq, hkv, dh,
                                torch.bfloat16)
        q = q.contiguous()
        scale = dh ** -0.5
        nbytes = 2 * (2 * bb * ss * hq * dh + 2 * bb * ss * hkv * dh)
        flops = 4.0 * bb * hq * dh * ss * (ss + 1) / 2
        b_ms, b_by = bound_ms(nbytes, bf16_flops=flops)
        plain_ms = _time_ms(torch, lambda: FA.flash_attention_plain(
            q, k, v, scale=scale), 2)
        lib_ms, lib_name, lib_all, lib_err = _time_sdpa(
            torch, F, q, k, v, scale, flush,
            FA.flash_attention_tc_cuda(q, k, v, scale=scale))
        for kern, launch in (("flash_attention", FA.flash_attention_cuda),
                             ("flash_attention_tc",
                              FA.flash_attention_tc_cuda)):
            ms = _time_ms(torch, lambda: launch(q, k, v, scale=scale), 10,
                          flush)
            rec = {"kernel": kern, "b": bb, "s": ss, "hq": hq, "hkv": hkv,
                   "dh": dh, "dtype": "bfloat16", "ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "library": lib_name, "library_backends_ms": lib_all,
                   "library_max_abs_diff_tc": lib_err, "bound_ms": b_ms,
                   "bound_by": b_by}
            out["flash_shapes"].append(rec)
            log(f"[time] {kern} b={bb} s={ss} heads {hq}/{hkv} dh={dh} bf16:"
                f" {ms:.4f} ms, plain {plain_ms:.3f} ms, SDPA {lib_ms:.4f} ms"
                f" ({lib_name}; {lib_all}), bound {b_ms:.4f} ms ({b_by})")
        old_ms, new_ms = (r["ms"] for r in out["flash_shapes"][-2:])
        log(f"[time] flash at b={bb} s={ss}: tensor cores {new_ms:.4f} ms, "
            f"CUDA cores {old_ms:.4f} ms ({old_ms / new_ms:.1f}x), SDPA "
            f"{lib_ms:.4f} ms ({new_ms / lib_ms:.2f}x of it), bound "
            f"{b_ms:.4f} ms ({b_ms / new_ms:.3f} of the kernel's time)")
        del q, k, v
        torch.cuda.empty_cache()
    for kern in ("flash_attention", "flash_attention_tc"):
        f0 = next(r for r in out["flash_shapes"] if r["kernel"] == kern)
        out[kern] = {key: f0[key] for key in (
            "ms", "plain_ms", "library_ms", "library", "bound_ms",
            "bound_by")}
        out[kern]["shape"] = (f"group prefill b={b} s={plen} {hq}/{hkv} "
                              f"heads dh={dh} bf16")

    steps = {}
    for label, e in (("sealed", eng), ("plaintext", plain)):
        pre = lambda: T.prefill(cfg, e.params(), toks, e.max_len)
        pre_ms = _time_ms(torch, pre, 3)
        _, cache = pre()
        nxt = toks[:, -1:]
        step = lambda: T.decode_step(cfg, e.params(), cache, nxt, plen)
        step_ms = _time_ms(torch, step, 5)
        steps[label] = {"prefill_ms": pre_ms, "decode_step_ms": step_ms}
        log(f"[time] group of {b} x {plen} tokens, {label}: prefill "
            f"{pre_ms:.1f} ms, decode step {step_ms:.2f} ms (device events)")
        del cache
    out["group_steps"] = steps
    out["prefill_profile"] = _profile(
        torch, lambda: T.prefill(cfg, eng.params(), toks, eng.max_len), 1,
        "sealed group prefill")
    out["prefill_profile"]["chacha_device_ms"] = _chacha_device_ms(
        out["prefill_profile"])
    log(f"[profile] ChaCha kernels in a sealed group prefill (device ms): "
        f"{out['prefill_profile']['chacha_device_ms']}")
    out["plain_prefill_profile"] = _profile(
        torch, lambda: T.prefill(cfg, plain.params(), toks, plain.max_len), 1,
        "plaintext group prefill")
    for key_ in ("engine", "plain_engine", "prompts"):
        group.pop(key_)
    return out


def _time_sdpa(torch, F, q, k, v, scale, flush, ref):
    """``scaled_dot_product_attention`` on the same inputs (heads first, as
    it takes them) under each backend that runs at this shape: flash,
    memory-efficient, cuDNN. Returns (fastest ms, its backend, every
    backend's ms or the reason it did not run, the fastest one's largest
    difference from ``ref``)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    times, errs = {}, {}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        name = backend.name.lower()

        def lib():
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True, scale=scale)
        try:         # the yardstick only: a backend may refuse this shape
            got = lib()
            torch.cuda.synchronize()
        except RuntimeError as e:
            times[name] = f"did not run: {str(e).splitlines()[0][:80]}"
            continue
        errs[name] = float((got.transpose(1, 2).float() - ref.float())
                           .abs().max())
        times[name] = _time_ms(torch, lib, 10, flush)
    ran = {n: t for n, t in times.items() if not isinstance(t, str)}
    if not ran:
        raise AssertionError(f"no SDPA backend ran: {times}")
    best = min(ran, key=ran.get)
    return ran[best], best, times, errs[best]


# profiler names of the ChaCha kernels (demangled device functions)
# --------------------------------------------------------------------------
# phase 8: verified sealed weights and sampling at full width
# --------------------------------------------------------------------------

# the stack slice of each block leaf held tag for tag (a middle layer: SE
# 0.5 leaves bypass rows there), and the embedding's last lines held at
# their own addresses
WEIGHT_SLICE, EMBED_LINES = 12, 65536
# small and misaligned tile cases: (K, N, bk, bn, stack, words off a 16-byte
# boundary)
TILE_CASES = ((64, 96, 32, 32, (), 0), (40, 24, 8, 8, (3,), 0),
              (128, 256, 128, 64, (2,), 1), (16, 128, 16, 16, (), 3))
# counter-layout and partial cases of line tags: (lines, first address)
LINE_CASES = ((1, 0), (127, 3), (1000, 2**32 - 5))
# the sampled trace: phase 4's prompts, settings in turn
SAMPLING = (dict(), dict(temperature=0.8), dict(temperature=1.0, top_k=50),
            dict(temperature=0.7, top_p=0.9),
            dict(temperature=1.2, top_k=20, top_p=0.95))


def _tile_bound(enc_rows, rows, n, tiles, bk, bn):
    """Bound of a ``tile_tags`` launch: the encrypted rows' words read once
    (bypass rows are not read), the row flags and the hash keys once, a tag
    written per tile; per 16-bit half an extraction and a 64-bit
    multiply-add, per tile one pad."""
    halves = 2 * enc_rows * n
    return bound_ms(4 * enc_rows * n + rows + 8 * bk * bn + 4 * tiles,
                    halves * TAG_HALF_OPS + tiles * CHACHA_OPS,
                    alu_ops=halves * TAG_HALF_ALU_OPS + tiles * CHACHA_ALU_OPS)


def _line_bound(lines, width):
    """Bound of a ``line_tags`` launch of ``lines`` records of ``width``
    words: each record read once, a tag written; per half an extraction and
    a multiply-add, per line one pad."""
    halves = 2 * width * lines
    return bound_ms(lines * (4 * width + 4) + 8 * width,
                    halves * TAG_HALF_OPS + lines * CHACHA_OPS,
                    alu_ops=halves * TAG_HALF_ALU_OPS + lines * CHACHA_ALU_OPS)


def _tile_operands(SS, ctx, st, i):
    """Stack slice ``i`` (or the whole unstacked leaf) of a tile leaf as
    ``tile_tags`` arguments, and its stored tags."""
    m = st.meta
    ct, mask, wc, macs = SS._tiles2d(st.payload, m), st.row_mask, st.wc, \
        st.macs
    if m.n_batch:
        ct, mask, wc, macs = ct[i], mask[i], wc[i], macs[i]
    return (ctx.key_words, ctx.hash_keys(m.bk * m.bn), ctx.nonce(m.nonce),
            ct, mask, wc, m.bk, m.bn), macs


def _line_operands_of(SS, ctx, path, st, first=0):
    """Lines [first, L) of a line leaf as ``line_tags`` arguments, and
    their stored tags."""
    pay = st.payload[first:]
    cnt = None if st.counters is None else st.counters[first:]
    width = pay.shape[1] + (0 if cnt is None else 1)
    return (ctx.key_words, ctx.hash_keys(width),
            ctx.nonce(SS._line_tweak(path)), pay, cnt, first), \
        st.macs[first:]


def _twice_equal(torch, kernel, plain, args, label, stored=None):
    got = [kernel(*args) for _ in range(2)]
    want = plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(g, want) for g in got):
        raise AssertionError(f"{kernel.__name__} != plain: {label}")
    if stored is not None and not torch.equal(want, stored):
        raise AssertionError(f"tags != the stored tags: {label}")
    return label


def phase_weights_sampling(torch, dev, args, cfg, params, prompts, serve):
    """(a) the weight MAC kernels, (b) the sweep over the full image, (c) a
    verified sealed engine on phase 4's trace and a weight tamper, (d)
    sampling on phase 4's trace; internlm2-1.8B at full width, bf16."""
    import numpy as np
    from repro_torch import prng
    from repro_torch.config import SealConfig
    from repro_torch.core import sealed_store as SS
    from repro_torch.core.mac import SealedIntegrityError
    from repro_torch.kernels import chacha20 as CC
    from repro_torch.kernels import ops
    from repro_torch.serve import sampling as SM
    from repro_torch.serve.engine import ServeEngine
    key = bytes(range(32))
    out = {}
    scratch = torch.empty((64 * 2**20,), dtype=torch.int32, device=dev)
    flush = lambda: scratch.zero_()           # 256 MB > the 50 MB L2

    # the verified engine: sealing makes every leaf's tags
    torch.cuda.synchronize()
    t0 = time.time()
    ver = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=256,
                      seal=SealConfig(), verify=True, device=dev)
    torch.cuda.synchronize()
    out["seal_verify_s"] = time.time() - t0
    sp = ver.sealed
    ctx = sp.engine(key).mac_ctx
    tile_paths = [p for p, st in sp.tensors.items()
                  if st.meta.layout == "tiles"]
    line_paths = [p for p in sp.tensors if p not in tile_paths]
    log(f"[weights] sealed with MACs in {out['seal_verify_s']:.1f} s (phase "
        f"4 without: {serve['seal_s']:.1f} s): {SS.n_macs(sp)} tags, "
        f"{len(tile_paths)} tile leaves, {len(line_paths)} line leaves")
    # the tags' cost at sealing: the image sealed without and with MACs in
    # turns (without, with, with, without), host clock around synchronized
    # calls
    seal_ms = {False: [], True: []}
    for verify in (False, True, True, False):
        torch.cuda.synchronize()
        t0 = time.time()
        img = SS.seal_params(params, SealConfig(verify=verify), key)
        torch.cuda.synchronize()
        seal_ms[verify].append(1e3 * (time.time() - t0))
        del img
        torch.cuda.empty_cache()
    out["seal_ms"] = {"without_macs": seal_ms[False],
                      "with_macs": seal_ms[True]}
    log(f"[weights] sealing the image (host clock, in turns): without MACs "
        f"{seal_ms[False]} ms, with {seal_ms[True]} ms")

    # (a) each kernel bitwise against its plain version, twice, and the
    # plain version against the tags stored at sealing
    done = []
    for path in tile_paths:
        targs, stored = _tile_operands(SS, ctx, sp.tensors[path],
                                       WEIGHT_SLICE)
        k, n = targs[3].shape
        done.append(_twice_equal(
            torch, CC.tile_tags_cuda, CC.tile_tags_plain, targs,
            f"{path} ({k}, {n}) bk {targs[6]} bn {targs[7]}, "
            f"{int(targs[4].sum())}/{k} rows encrypted", stored))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 23)
    for k, n, bk, bn, lead, shift in TILE_CASES:
        size = int(np.prod(lead + (k, n)))
        flat = _rand_words(torch, gen, (size + 8,), dev)
        flat[::7] = -1
        ct = flat[shift:shift + size].view(lead + (k, n))
        mask = torch.rand(lead + (k,), generator=gen, device=dev) < 0.5
        mask[..., :bk] = False
        wc = _rand_words(torch, gen, lead, dev)
        wc.view(-1)[::2] = -1
        done.append(_twice_equal(
            torch, CC.tile_tags_cuda, CC.tile_tags_plain,
            (ctx.key_words, ctx.hash_keys(bk * bn), ctx.nonce(NONCES[0]), ct,
             mask, wc, bk, bn),
            f"({k}, {n}) bk {bk} bn {bn} stack {lead}, {shift} words off"))
    for path in line_paths:
        st = sp.tensors[path]
        first = st.payload.shape[0] - EMBED_LINES if path == SS.EMBED else 0
        largs, stored = _line_operands_of(SS, ctx, path, st, first)
        done.append(_twice_equal(
            torch, CC.line_tags_cuda, CC.line_tags_plain, largs,
            f"{path} lines [{first}, {st.payload.shape[0]})", stored))
    for n_lines, first in LINE_CASES:
        for scheme, width in (("coloe", 34), ("counter", 32)):
            pay = _rand_words(torch, gen, (n_lines, width), dev)
            pay[:, ::5] = -1
            cnt = (None if scheme == "coloe"
                   else _rand_words(torch, gen, (n_lines,), dev))
            done.append(_twice_equal(
                torch, CC.line_tags_cuda, CC.line_tags_plain,
                (ctx.key_words, ctx.hash_keys(width + (scheme != "coloe")),
                 ctx.nonce(NONCES[1]), pay, cnt, first),
                f"{scheme} {n_lines} lines from {first}"))
    log(f"[weights] {len(done)} tag cases bitwise, each launched twice: "
        + "; ".join(done))
    out["cases"] = done

    # the kernels timed at the sweep's shapes: one slice of MLP wi (the
    # largest block leaf) and the head; the whole embedding and a norm leaf
    times = {}
    for path in ("blocks/0/mlp/wi", "head/w"):
        targs, _ = _tile_operands(SS, ctx, sp.tensors[path], WEIGHT_SLICE)
        k, n = targs[3].shape
        bk, bn = targs[6], targs[7]
        enc, tiles = int(targs[4].sum()), (k // bk) * (n // bn)
        ms = _time_ms(torch, lambda: CC.tile_tags_cuda(*targs), 10, flush)
        plain_ms = _time_ms(torch, lambda: CC.tile_tags_plain(*targs), 1)
        b_ms, b_by = _tile_bound(enc, k, n, tiles, bk, bn)
        label = (f"{path} ({k}, {n}), {enc}/{k} rows encrypted, {tiles} "
                 f"tiles of {bk}x{bn}")
        times.setdefault("chacha20_weight_tile_tags", []).append(
            {"shape": label, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
             "bound_by": b_by})
        log(f"[time] chacha20_weight_tile_tags {label}: {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"{b_ms / ms:.2f} of the kernel's time)")
    for path in (SS.EMBED, "blocks/0/norm1/scale"):
        largs, _ = _line_operands_of(SS, ctx, path, sp.tensors[path])
        lines, width = largs[3].shape[0], largs[1].shape[0] // 2
        ms = _time_ms(torch, lambda: CC.line_tags_cuda(*largs), 10, flush)
        plain_ms = _time_ms(torch, lambda: CC.line_tags_plain(*largs), 1)
        b_ms, b_by = _line_bound(lines, width)
        label = f"{path}: {lines} lines of {width} words"
        times.setdefault("chacha20_weight_line_tags", []).append(
            {"shape": label, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
             "bound_by": b_by})
        log(f"[time] chacha20_weight_line_tags {label}: {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"{b_ms / ms:.2f} of the kernel's time)")
    out["timing"] = times

    # (b) the sweep over the whole image: one device bool, one launch a leaf
    ops.reset_launch_counts()
    ok = SS.verify_params(sp, key)
    sweep_launches = ops.launch_counts()
    if not (bool(ok) and ok.device.type == dev.type and ok.shape == ()):
        raise AssertionError("verify_params rejects the intact image")
    if (sweep_launches["chacha20_weight_tile_tags"] != len(tile_paths)
            or sweep_launches["chacha20_weight_line_tags"] != len(line_paths)):
        raise AssertionError(f"the sweep launched {sweep_launches}")
    sweep_ms = _time_ms(torch, lambda: SS.verify_params(sp, key), 3, flush)
    tot = [0.0, 0.0, 0.0]                     # bytes, int ops, ALU ops
    for path, st in sp.tensors.items():
        m = st.meta
        if m.layout == "tiles":
            k, n = st.k_size, st.n_size
            rows = st.row_mask.numel()
            enc = int(st.row_mask.sum())
            tiles = (rows // m.bk) * (n // m.bn)
            halves = 2 * enc * n
            tot[0] += 4 * enc * n + rows + 8 * m.bk * m.bn + 4 * tiles
            tot[1] += halves * TAG_HALF_OPS + tiles * CHACHA_OPS
            tot[2] += halves * TAG_HALF_ALU_OPS + tiles * CHACHA_ALU_OPS
        else:
            lines = st.payload.shape[0]
            width = st.payload.shape[1] + (st.counters is not None)
            tot[0] += lines * (4 * width + 4) + 8 * width
            tot[1] += 2 * width * lines * TAG_HALF_OPS + lines * CHACHA_OPS
            tot[2] += (2 * width * lines * TAG_HALF_ALU_OPS
                       + lines * CHACHA_ALU_OPS)
    b_ms, b_by = bound_ms(tot[0], tot[1], alu_ops=tot[2])
    out["sweep"] = {"ms": sweep_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "bytes": tot[0], "launches": sweep_launches}
    log(f"[weights] verify_params over the image: True, {sweep_launches} "
        f"launches; {sweep_ms:.3f} ms (device events) against a {b_ms:.3f} "
        f"ms bound ({b_by}; {tot[0] / 1e9:.3f} GB; {b_ms / sweep_ms:.2f})")
    wi = sp.tensors["blocks/0/mlp/wi"]
    mask = wi.row_mask[WEIGHT_SLICE]
    k, n = mask.shape[0], wi.n_size
    enc_row, by_row = int(torch.nonzero(mask)[-1]), int(
        torch.nonzero(~mask)[0])
    sites = [("an encrypted tile word", "blocks/0/mlp/wi",
              (WEIGHT_SLICE * k + enc_row) * n + 3, False),
             ("a head word", "head/w", 7 * sp.tensors["head/w"].n_size + 11,
              False),
             ("an embedding line word", SS.EMBED,
              2 * sp.tensors[SS.EMBED].payload.shape[1] + 9, False),
             ("a bypass-row word", "blocks/0/mlp/wi",
              (WEIGHT_SLICE * k + by_row) * n + 5, True)]
    verdicts = {}
    for what, path, idx, want in sites:
        words = sp.tensors[path].payload.view(-1)
        words[idx] ^= 1 << 4
        got = bool(SS.verify_params(sp, key))
        words[idx] ^= 1 << 4
        again = bool(SS.verify_params(sp, key))
        verdicts[what] = got
        if got != want or not again:
            raise AssertionError(f"verify_params after a flip of {what}: "
                                 f"{got}, restored: {again}")
    out["flips"] = verdicts
    log(f"[weights] verify_params after one flipped bit: {verdicts}; True "
        f"again after each restore")

    # (c) the verified engine on phase 4's trace
    handles, launches, secs = _drain(torch, ver, prompts, NEW_TOKENS)
    st = ver.stats
    dispatches = st["prefills"] + st["decode_steps"]
    checks = 1 + st["prefill_chunks"] + st["tokens"] - len(prompts)
    want = _chacha_launches(ver, dispatches, paged=True)
    want.update(chacha20_cache_copy=0,
                chacha20_cache_tags=dispatches * len(cfg.pattern),
                chacha20_cache_verify=dispatches * len(cfg.pattern),
        chacha20_weight_tile_tags=len(tile_paths),
        chacha20_weight_line_tags=len(line_paths))
    got = {name: launches[name] for name in want}
    same = [h.out for h in handles] == serve["tokens"]
    out["verify"] = {"stats": dict(st), "launches": launches, "serve_s": secs,
                     "tokens_equal_phase4": same}
    log(f"[weights] verified sealed run: {secs:.2f} s, {dispatches} "
        f"dispatches, mac_checks {st['mac_checks']} (expected {checks}: one "
        f"sweep + the cache's), mac_failures {st['mac_failures']}, tokens "
        f"equal to phase 4's: {same}, launches {launches}")
    if not same:
        raise AssertionError("verified tokens differ from phase 4's")
    if st["mac_failures"] or st["retries"] or st["mac_checks"] != checks:
        raise AssertionError("the verified run's MAC counts are wrong")
    if got != want:
        raise AssertionError(f"verified launches {got}, expected {want}")
    ver.check_device_mirror()
    # a weight tamper: the drain stops at the sweep, before any token
    words = wi.payload.view(-1)
    words[sites[0][2]] ^= 1 << 4
    hs = [ver.submit(p, max_tokens=NEW_TOKENS) for p in prompts[:2]]
    tokens0, fails0 = st["tokens"], st["mac_failures"]
    try:
        ver.run()
        raise AssertionError("a tampered weight image was served")
    except SealedIntegrityError as e:
        scope = e.scope
    words[sites[0][2]] ^= 1 << 4
    out["tamper"] = {"scope": scope, "tokens": st["tokens"] - tokens0,
                     "mac_failures": st["mac_failures"] - fails0}
    log(f"[weights] weight tamper: SealedIntegrityError({scope!r}), "
        f"{out['tamper']}")
    if scope != "weights" or any(h.out for h in hs) or \
            out["tamper"] != {"scope": "weights", "tokens": 0,
                              "mac_failures": 1}:
        raise AssertionError("the weight tamper was not fail-stop")
    del ver, sp, wi, words
    torch.cuda.empty_cache()

    # (d) sampling: phase 4's trace, mixed settings, twice; the draws on the
    # card counted by the threefry calls on its tensors, one sampled
    # call's logits and keys saved for the card-vs-CPU check
    real_threefry, real_sample = prng.threefry2x32, SM.sample_logits
    draws = [0]
    saved = {}

    def counted(k1, *a):
        draws[0] += int(k1.device.type == dev.type)
        return real_threefry(k1, *a)

    def saving(logits, keys=None, temperature=None, top_k=None, top_p=None,
               *, greedy=True):
        if not greedy and not saved:
            saved.update(logits=logits.clone(), keys=keys.clone(),
                         temperature=temperature.clone(),
                         top_k=top_k.clone(), top_p=top_p.clone())
        return real_sample(logits, keys, temperature, top_k, top_p,
                           greedy=greedy)

    prng.threefry2x32, SM.sample_logits = counted, saving
    try:
        runs, eng = [], None
        for _ in range(2):                # two engines: the same request ids
            del eng
            torch.cuda.empty_cache()
            eng = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=256,
                              seal=SealConfig(), sample_seed=args.seed,
                              device=dev)
            draws[0] = 0
            hs, _, secs = _drain(torch, eng, prompts, NEW_TOKENS, SAMPLING)
            runs.append({"tokens": [h.out for h in hs], "draws": draws[0],
                         "serve_s": secs,
                         "complete": all(h.done and len(h.out) == NEW_TOKENS
                                         for h in hs)})
        # an all-greedy run of phase 4's trace on the second engine
        draws[0] = 0
        gh, greedy_launches, _ = _drain(torch, eng, prompts, NEW_TOKENS)
        greedy_draws = draws[0]
    finally:
        prng.threefry2x32, SM.sample_logits = real_threefry, real_sample
    out["sampled"] = {"runs": [{k: v for k, v in r.items() if k != "tokens"}
                               for r in runs],
                      "equal": runs[0]["tokens"] == runs[1]["tokens"],
                      "greedy_draws": greedy_draws,
                      "greedy_launches_equal_phase4":
                          greedy_launches == serve["launches"],
                      "greedy_tokens_equal_phase4":
                          [h.out for h in gh] == serve["tokens"]}
    log(f"[sample] two sampled runs of phase 4's trace: "
        f"{out['sampled']['runs']}, streams equal: "
        f"{out['sampled']['equal']}; an all-greedy run: {greedy_draws} "
        f"device draws, launches equal to phase 4's: "
        f"{out['sampled']['greedy_launches_equal_phase4']}, tokens equal: "
        f"{out['sampled']['greedy_tokens_equal_phase4']}")
    if not all(r["complete"] and r["draws"] > 0 for r in runs):
        raise AssertionError("a sampled request did not complete, or drew "
                             "nothing on the card")
    if not out["sampled"]["equal"]:
        raise AssertionError("two sampled runs of one trace differ")
    if greedy_draws or greedy_launches != serve["launches"]:
        raise AssertionError(f"the all-greedy run drew {greedy_draws} times "
                             f"or launched {greedy_launches}, phase 4 "
                             f"{serve['launches']}")
    # the sampler on saved logits and keys: the card against the CPU
    v = saved["logits"].shape[1]
    bits = [prng.random_bits(saved["keys"].to(d), v).cpu()
            for d in (dev, "cpu")]
    toks = [real_sample(*(saved[n].to(d) for n in (
        "logits", "keys", "temperature", "top_k", "top_p")),
        greedy=False).cpu() for d in (dev, "cpu")]
    noise = [prng.gumbel(saved["keys"].to(d), v).cpu() for d in (dev, "cpu")]
    gap = float((noise[0] - noise[1]).abs().max())
    out["sampler_vs_cpu"] = {"bits_equal": torch.equal(*bits),
                             "tokens_equal": torch.equal(*toks),
                             "gumbel_max_abs_diff": gap,
                             "rows": int(saved["logits"].shape[0])}
    log(f"[sample] the sampler on the card vs the CPU on a saved tick's "
        f"logits and keys: {out['sampler_vs_cpu']}")
    if not (torch.equal(*bits) and torch.equal(*toks)):
        raise AssertionError("the sampler on the card differs from the CPU")

    # a sampled tick beside a greedy one, every slot decoding, one engine
    ticks = {}
    for label, kw in (("greedy", {}), ("sampled", SAMPLING[-1])):
        for p in prompts[:SLOTS]:
            eng.submit(p, max_tokens=64, **kw)
        while any(r is None or eng._pending[i] is not None
                  for i, r in enumerate(eng._active)):
            eng.step()
        ms = _time_ms(torch, eng._decode_tick, 5)
        wall = []
        for _ in range(5):
            t0 = time.time()
            eng._decode_tick()               # ends in the tokens' d2h copy
            wall.append(1e3 * (time.time() - t0))
        prof = _profile(torch, eng._decode_tick, 3,
                        f"{label} sealed decode ticks")
        ticks[label] = {"ms": ms, "host_ms": sorted(wall)[len(wall) // 2],
                        "device_busy_ms": prof["device_busy_ms"] / 3,
                        "idle_share": prof["idle_share"],
                        "kernel_launches": prof["kernel_launches"] / 3}
        log(f"[time] decode tick, {SLOTS} slots, sealed, {label}: {ms:.2f} "
            f"ms (device events), {ticks[label]['host_ms']:.2f} ms (host "
            f"clock), device busy {ticks[label]['device_busy_ms']:.2f} ms, "
            f"{ticks[label]['kernel_launches']:.0f} kernel launches a tick")
        eng.run()
    out["ticks"] = ticks
    del eng
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 9: the Direct engine (AES-128-ECB) at full width
# --------------------------------------------------------------------------

# the reference's AES, plain jnp (no Pallas kernel stands behind it)
AES_ENC_REPLACES = "src/repro/core/cipher.py:107"
AES_DEC_REPLACES = "src/repro/core/cipher.py:158"
# table lookups of one enciphered 16-byte block: 16 a round, 10 rounds
AES_LOOKUPS = 160
# FIPS-197 appendix C.1
FIPS_KEY = bytes(range(16))
FIPS_PT = bytes.fromhex("00112233445566778899aabbccddeeff")
FIPS_CT = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")
# line edge cases: (words, flags pattern), flags by line
AES_EDGES = ((5, "enc"), (1001, "mixed"), (4097, "bypass"), (32, "enc"),
             (33, "mixed"), (96 * 32 + 7, "mixed"))


def _aes_bound(lines, out_words, enc_lines):
    """Bound of one pass over ``lines`` 128-byte lines: each line and its
    flag word read once, ``out_words`` words written once; 160 shared-memory
    table lookups for each enciphered 16-byte block (8 a line)."""
    return bound_ms(lines * (128 + 4) + 4 * out_words,
                    lookups=AES_LOOKUPS * 8 * enc_lines)


def _aes_twice(torch, kernel, plain, args, label):
    got = [kernel(*args) for _ in range(2)]
    want = plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(g.reshape(-1), want.reshape(-1)) for g in got):
        raise AssertionError(f"{kernel.__name__} != plain: {label}")
    return label


def _int_view(t):
    import torch
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def phase_direct(torch, dev, args, cfg, params, prompts):
    """(a) the AES kernel against its plain version, (b) sealing the full
    image and unsealing it exactly, (c) phase 4's trace through a Direct
    engine with a sealed cache, bitwise to plaintext, (d) the same verified
    and a weight tamper, (e) timings; internlm2-1.8B at full width, bf16."""
    import numpy as np
    from repro_torch.config import SealConfig
    from repro_torch.core import cipher as C
    from repro_torch.core import engine as E
    from repro_torch.core import sealed_store as SS
    from repro_torch.core.mac import SealedIntegrityError
    from repro_torch.kernels import aes128 as AES
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeEngine
    key = bytes(range(32))
    out = {}
    torch.cuda.empty_cache()
    log(f"[direct] device memory at the start: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    scratch = torch.empty((64 * 2**20,), dtype=torch.int32, device=dev)
    flush = lambda: scratch.zero_()           # 256 MB > the 50 MB L2

    # (a) the kernel against its plain version, bitwise, each case twice
    done = []
    rk = C.round_keys_tensor(C.aes128_key_schedule(
        np.frombuffer(FIPS_KEY, np.uint8)), dev)
    pt = torch.tensor(list(FIPS_PT), dtype=torch.uint8, device=dev)[None]
    ct = AES.encrypt_blocks(pt, rk)
    back = AES.decrypt_blocks(ct, rk)
    if bytes(ct.cpu().reshape(-1).tolist()) != FIPS_CT or \
            bytes(back.cpu().reshape(-1).tolist()) != FIPS_PT:
        raise AssertionError("AES kernel fails the FIPS-197 C.1 vector")
    done.append("FIPS-197 C.1 forward and inverse")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 31)
    blocks = torch.randint(0, 256, (1000, 16), generator=gen, device=dev,
                           dtype=torch.uint8)
    done.append(_aes_twice(torch, AES.encrypt_blocks,
                           AES.encrypt_blocks_plain, (blocks, rk),
                           "1000 blocks forward"))
    done.append(_aes_twice(torch, AES.decrypt_blocks,
                           AES.decrypt_blocks_plain, (blocks, rk),
                           "1000 blocks inverse"))
    ids = _rand_words(torch, gen, (4099,), dev)
    for tweak in (0, 0x0123456789ABCDEF):
        ks = C.aes128_ctr_keystream(rk, ids, tweak)
        want = C.aes128_ctr_keystream(rk, ids.cpu(), tweak)
        if not torch.equal(ks.cpu(), want):
            raise AssertionError(f"CTR keystream tweak {tweak:#x} != plain")
        done.append(f"CTR keystream, 4099 blocks, tweak {tweak:#x}")
    eng = E.DirectEngine(key, dev)
    rk = eng.round_keys
    for n, pattern in AES_EDGES:
        words = _rand_words(torch, gen, (n,), dev)
        lines = -(-n // 32)
        flags = {"enc": torch.ones((lines,), dtype=torch.int32, device=dev),
                 "bypass": torch.zeros((lines,), dtype=torch.int32,
                                       device=dev),
                 "mixed": torch.randint(0, 4, (lines,), generator=gen,
                                        device=dev,
                                        dtype=torch.int32)}[pattern]
        done.append(_aes_twice(torch, AES.lines_encrypt_cuda,
                               AES.lines_encrypt_plain, (rk, words, flags),
                               f"encrypt {n} words, {pattern} flags"))
        payload = AES.lines_encrypt_plain(rk, words, flags)
        done.append(_aes_twice(torch, AES.lines_decrypt_cuda,
                               AES.lines_decrypt_plain,
                               (rk, payload, flags, n),
                               f"decrypt {n} words, {pattern} flags"))
    x = torch.randn((3, 7), generator=gen, device=dev).to(torch.bfloat16)
    sb = eng.encrypt(x, enc_flags=torch.ones((1,), dtype=torch.int32,
                                             device=dev))
    if not torch.equal(_int_view(eng.decrypt(sb)), _int_view(x)):
        raise AssertionError("a bf16 leaf of 21 elements did not round trip")
    done.append(_aes_twice(torch, AES.lines_decrypt_cuda,
                           AES.lines_decrypt_plain,
                           (rk, sb.payload, sb.counters, sb.orig_len),
                           "bf16 leaf (3, 7), 11 words"))

    # (b) the full image sealed (the engine's construction seals it)
    plain_engine = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=256,
                               seal=None, device=dev)
    seal = SealConfig(mode="direct")            # SE 0.5
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.time()
    direct = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=256,
                         seal=seal, device=dev)
    torch.cuda.synchronize()
    out["seal_s"] = time.time() - t0
    out["seal_launches"] = ops.launch_counts()
    sp = direct.sealed
    n_leaves = len(sp.tensors)
    image = sum(t.numel() * t.element_size() for t in _leaves(params))
    lines = sum(st.payload.shape[0] for st in sp.tensors.values())
    enc_lines = sum(int((st.counters & 1).sum()) for st in sp.tensors.values())
    out_words = sum(st.meta.orig_len for st in sp.tensors.values())
    out["image"] = {"bytes": image, "lines": lines, "enc_lines": enc_lines,
                    "stored_bytes": sp.stored_bytes(), "leaves": n_leaves}
    log(f"[direct] sealed {image / 1e9:.3f} GB in {out['seal_s']:.2f} s "
        f"(host clock): {n_leaves} leaves, {lines} lines, {enc_lines} "
        f"enciphered ({enc_lines / lines:.3f}), stored "
        f"{sp.stored_bytes() / 1e9:.3f} GB, launches "
        f"{out['seal_launches']['aes128_lines_encrypt']} aes128_lines_encrypt")
    if out["seal_launches"]["aes128_lines_encrypt"] != n_leaves or \
            sp.fused_paths() or any(st.meta.scheme != "direct"
                                    for st in sp.tensors.values()):
        raise AssertionError(f"sealing launched {out['seal_launches']}")
    back = SS.unseal_params(sp, key)
    for (p, a), b in zip(flatten_paths(back), _leaves(params)):
        if not torch.equal(_int_view(a), _int_view(b)):
            raise AssertionError(f"unseal_params differs at {p}")
    del back
    torch.cuda.empty_cache()
    log("[direct] unseal_params equals the params bitwise, leaf for leaf")

    # the kernel at the main path's shapes: one stack slice of MLP wi and
    # the embedding's last lines, at their own offsets in the sealed image
    wi = sp.tensors["blocks/0/mlp/wi"]
    per = wi.payload.shape[0] // wi.meta.shape[0]
    emb = sp.tensors[SS.EMBED]
    cases = (("blocks/0/mlp/wi", wi, WEIGHT_SLICE * per, per),
             (SS.EMBED, emb, emb.payload.shape[0] - EMBED_LINES, EMBED_LINES))
    by_path = dict(flatten_paths(params))
    plain_words = {p: by_path[p].reshape(-1).view(torch.int32)
                   for p, *_ in cases}
    times = {}
    for path, st, first, n_lines in cases:
        pay = st.payload[first:first + n_lines]
        fl = st.counters[first:first + n_lines]
        n_words = min(32 * n_lines, st.meta.orig_len - 32 * first)
        words = plain_words[path][32 * first:32 * first + n_words]
        label = (f"{path} lines [{first}, {first + n_lines}), "
                 f"{int((fl & 1).sum())} enciphered")
        done.append(_aes_twice(torch, AES.lines_decrypt_cuda,
                               AES.lines_decrypt_plain,
                               (rk, pay, fl, n_words), "decrypt " + label))
        done.append(_aes_twice(torch, AES.lines_encrypt_cuda,
                               AES.lines_encrypt_plain, (rk, words, fl),
                               "encrypt " + label))
        if not torch.equal(AES.lines_decrypt_cuda(rk, pay, fl, n_words),
                           words) or not torch.equal(
                AES.lines_encrypt_cuda(rk, words, fl).reshape(pay.shape),
                pay):
            raise AssertionError(f"kernel != the sealed image: {label}")
        enc = int((fl & 1).sum())
        for name, kern, plain, a in (
                ("aes128_lines_decrypt", AES.lines_decrypt_cuda,
                 AES.lines_decrypt_plain, (rk, pay, fl, n_words)),
                ("aes128_lines_encrypt", AES.lines_encrypt_cuda,
                 AES.lines_encrypt_plain, (rk, words, fl))):
            st = _time_stats(torch, lambda: kern(*a), 10, flush)
            ms = st["ms"]
            plain_ms = _time_ms(torch, lambda: plain(*a), 1)
            b_ms, b_by = _aes_bound(n_lines, n_words if "decrypt" in name
                                    else 32 * n_lines, enc)
            times.setdefault(name, []).append(
                {"shape": label, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                 "stats": st})
            log(f"[time] {name} {label}: {ms:.4f} ms, plain {plain_ms:.3f} "
                f"ms, bound {b_ms:.4f} ms ({b_by}; {b_ms / ms:.2f} of the "
                f"kernel's time); {_stats_text(st)}")
    log(f"[direct] {len(done)} AES cases bitwise, each kernel launched "
        f"twice: " + "; ".join(done))
    out["cases"] = done
    out["timing"] = times

    # (c) phase 4's trace: Direct with a sealed cache, beside plaintext
    handles, launches, secs = _drain(torch, direct, prompts, NEW_TOKENS)
    ph, _, plain_s = _drain(torch, plain_engine, prompts, NEW_TOKENS)
    st = direct.stats
    dispatches = st["prefills"] + st["decode_steps"]
    want = {"aes128_lines_decrypt": dispatches * n_leaves,
            "aes128_lines_encrypt": 0, "chacha20": 0,
            "chacha20_lines_unseal": 0, "chacha20_lines_gather": 0,
            "chacha20_cache_view": dispatches * cfg.num_layers,
            "chacha20_cache_splice": dispatches * len(cfg.pattern),
            "sealed_matmul": 0, "sealed_matmul_dec": 0,
            "sealed_matmul_tc": 0}
    got = {name: launches[name] for name in want}
    same = [h.out for h in handles] == [h.out for h in ph]
    out["launches"] = launches
    out["serve"] = {"stats": dict(st), "serve_s": secs, "plain_s": plain_s,
                    "tokens_equal_plaintext": same}
    log(f"[direct] sealed run: {secs:.2f} s (plaintext {plain_s:.2f} s), "
        f"{dispatches} dispatches, tokens equal to the plaintext engine's: "
        f"{same}, plaintext per step "
        f"{st['weights_plaintext_bytes_per_step'] / 1e9:.3f} GB, launches "
        f"{launches}")
    if not all(h.done and len(h.out) == NEW_TOKENS for h in handles):
        raise AssertionError("not every Direct request completed")
    if not same:
        raise AssertionError("Direct tokens differ from plaintext")
    if got != want:
        raise AssertionError(f"Direct launches {got}, expected {want}")
    if st["weights_plaintext_bytes_per_step"] != image or \
            st["fused_matmul_leaves"]:
        raise AssertionError("Direct should materialize the whole image")
    direct.check_device_mirror()
    first = prompts[:SLOTS]
    for dtype in ("bfloat16", "float32"):
        c = cfg.with_(dtype=dtype)
        pre_p, dec_p, forced = first_tick_logits(torch, c, params, None,
                                                 first, None, dev)
        pre_d, dec_d, _ = first_tick_logits(torch, c, direct.params(),
                                            direct.cache_seal, first, forced,
                                            dev)
        equal = torch.equal(pre_d, pre_p) and torch.equal(dec_d, dec_p)
        out[f"first_tick_equal_{dtype}"] = equal
        log(f"[direct] teacher-forced prefill and first decode tick logits, "
            f"Direct vs plaintext, {dtype}: bitwise equal {equal}")
        if not equal:
            raise AssertionError(f"Direct {dtype} logits differ from "
                                 f"plaintext")

    # (d) verified: the sweep over the Direct image, and weight tampers
    ver = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=256,
                      seal=seal, verify=True, device=dev)
    vh, vl, vsecs = _drain(torch, ver, prompts, NEW_TOKENS)
    vst = ver.stats
    checks = 1 + vst["prefill_chunks"] + vst["tokens"] - len(prompts)
    vsame = [h.out for h in vh] == [h.out for h in handles]
    vwant = dict(want, aes128_lines_decrypt=dispatches * n_leaves,
                 chacha20_weight_line_tags=n_leaves,
                 chacha20_weight_tile_tags=0,
                 chacha20_cache_tags=dispatches * len(cfg.pattern),
                 chacha20_cache_verify=dispatches * len(cfg.pattern))
    vgot = {name: vl[name] for name in vwant}
    out["verify"] = {"stats": dict(vst), "launches": vl, "serve_s": vsecs,
                     "tokens_equal": vsame}
    log(f"[direct] verified run: {vsecs:.2f} s, mac_checks "
        f"{vst['mac_checks']} (expected {checks}), mac_failures "
        f"{vst['mac_failures']}, tokens equal to (c): {vsame}, launches {vl}")
    if not vsame or vst["mac_failures"] or vst["mac_checks"] != checks:
        raise AssertionError("the verified Direct run is wrong")
    if vgot != vwant:
        raise AssertionError(f"verified launches {vgot}, expected {vwant}")
    vwi = ver.sealed.tensors["blocks/0/mlp/wi"]
    fl = vwi.counters
    sites = (("an enciphered line word", 32 * int(torch.nonzero(
                 fl == 1)[0]) + 3),
             ("a bypass line word", 32 * int(torch.nonzero(fl == 0)[0]) + 5))
    verdicts = {}
    for what, idx in sites:
        vwi.payload.view(-1)[idx] ^= 1 << 4
        hs = [ver.submit(p, max_tokens=NEW_TOKENS) for p in prompts[:2]]
        tokens0 = vst["tokens"]
        try:
            ver.run()
            raise AssertionError(f"a flipped {what} was served")
        except SealedIntegrityError as err:
            verdicts[what] = err.scope
        vwi.payload.view(-1)[idx] ^= 1 << 4
        if verdicts[what] != "weights" or any(h.out for h in hs) or \
                vst["tokens"] != tokens0:
            raise AssertionError(f"a flipped {what} was not fail-stop")
        ver.queue.clear()
    if not bool(SS.verify_params(ver.sealed, key)):
        raise AssertionError("the restored Direct image fails its sweep")
    out["tamper"] = verdicts
    log(f"[direct] weight tamper: SealedIntegrityError scopes {verdicts}, "
        f"no token served; True again once restored")
    del ver, vwi, fl
    torch.cuda.empty_cache()

    # (e) one dispatch's decrypt of the whole image, and three ticks: the
    # decrypt by events after an L2 flush (the yardstick of the kernels'
    # rows), by events without the flush, and by the profiler's kernel time
    # over flush, sleep and decrypt, as the events window sees them
    view = lambda: SS.serving_params(sp, key)
    b_ms, b_by = _aes_bound(lines, out_words, enc_lines)
    sleep_ms = _sleep_ms(torch)
    cold = _time_stats(torch, view, 5, flush)
    warm = _time_stats(torch, view, 5)

    def windowed():
        flush()
        torch.cuda._sleep(SLEEP_CYCLES)
        view()

    prof = _profile(torch, windowed, 3, "flushed image decrypts",
                    launches_of="aes128_kernel")
    aes_prof = sum(v for k, v in prof["device_ms"].items()
                   if "aes128_kernel" in k) / 3
    bare = _profile(torch, view, 3, "image decrypts back to back",
                    launches_of="aes128_kernel")
    aes_bare = sum(v for k, v in bare["device_ms"].items()
                   if "aes128_kernel" in k) / 3
    out["dispatch_decrypt"] = {"ms": cold["ms"], "bound_ms": b_ms,
                               "bound_by": b_by, "flushed": cold,
                               "unflushed": warm, "profiled_aes_ms": aes_prof,
                               "profiled_launch_ms": prof.get("launch_ms"),
                               "back_to_back_aes_ms": aes_bare,
                               "sleep_ms": sleep_ms}
    log(f"[time] one Direct dispatch's decrypt of the image ({n_leaves} "
        f"launches, {image / 1e9:.3f} GB) against a {b_ms:.3f} ms bound "
        f"({b_by}; {b_ms / cold['ms']:.2f}); the sleep before a window "
        f"{sleep_ms:.3f} ms")
    log(f"[time]   events, L2 flushed: {_stats_text(cold)}")
    log(f"[time]   events, not flushed: {_stats_text(warm)}")
    log(f"[time]   profiler, AES kernels of one flushed window: "
        f"{aes_prof:.3f} ms; of one of three decrypts back to back: "
        f"{aes_bare:.3f} ms (the profiler kept {len(prof['launch_ms'])} "
        f"and {len(bare['launch_ms'])} AES launch records of "
        f"{3 * n_leaves})")
    coloe = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=256,
                        seal=SealConfig(), device=dev)
    ticks = {}
    for label, e in (("direct", direct), ("coloe", coloe),
                     ("plaintext", plain_engine)):
        for p in prompts[:SLOTS]:
            e.submit(p, max_tokens=64)
        while any(r is None or e._pending[i] is not None
                  for i, r in enumerate(e._active)):
            e.step()
        ms = _time_ms(torch, e._decode_tick, 5)
        wall = []
        for _ in range(5):
            t0 = time.time()
            e._decode_tick()                 # ends in the tokens' d2h copy
            wall.append(1e3 * (time.time() - t0))
        prof = _profile(torch, e._decode_tick, 3, f"{label} decode ticks",
                        launches_of="aes128_kernel")
        aes_ms = sum(v for k, v in prof["device_ms"].items()
                     if "aes128_kernel" in k) / 3
        ticks[label] = {"ms": ms, "host_ms": sorted(wall)[len(wall) // 2],
                        "device_busy_ms": prof["device_busy_ms"] / 3,
                        "idle_share": prof["idle_share"],
                        "aes_device_ms": aes_ms,
                        "kernel_launches": prof["kernel_launches"] / 3}
        ticks[label]["aes_records"] = len(prof["launch_ms"])
        log(f"[time] decode tick, {SLOTS} slots, {label}: {ms:.2f} ms "
            f"(device events), {ticks[label]['host_ms']:.2f} ms (host "
            f"clock), device busy {ticks[label]['device_busy_ms']:.2f} ms "
            f"(AES {aes_ms:.2f} ms from {len(prof['launch_ms'])} AES launch "
            f"records of the {3 * n_leaves if label == 'direct' else 0} "
            f"made), idle share {prof['idle_share']:.3f}")
        e.queue.clear()
    out["ticks"] = ticks
    del direct, coloe, plain_engine, sp, wi, emb
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 10: the MoE family (Qwen3-30B-A3B) at full width
# --------------------------------------------------------------------------

MOE_ARCH = "qwen3_moe_30b_a3b"
# 6 of its 48 layers: the serving view decrypts every line-sealed leaf
# whole each dispatch, and 48 layers of f32 experts are 116 GB of it
MOE_LAYERS = 6
MOE_SLOTS, MOE_REQUESTS, MOE_GROUP, MOE_TF_PROMPTS = 8, 12, 4, 4
# the trace's mean gap between arrivals (scheduler steps): a prompt that
# arrives alone prefills alone, beside a padding row
MOE_STAGGER = 4.0
# lines of each window of the expert leaf held against the plain unseal
MOE_WINDOW = 65_536
MOE_LEAF = "blocks/0/mlp/wi"


class _Routes:
    """While active, records every ``moe_router`` call's (token, k) expert
    choices and every ``capacity_slots`` call's choices and kept set, on
    the host."""

    def __init__(self, L):
        self.L, self.idx, self.keep, self.slot_idx = L, [], [], []

    def __enter__(self):
        L = self.L
        self._router, self._slots = L.moe_router, L.capacity_slots

        def router(*a, **k):
            out = self._router(*a, **k)
            self.idx.append(out[1].cpu())
            return out

        def slots(*a, **k):
            out = self._slots(*a, **k)
            self.keep.append(out[0].cpu())
            self.slot_idx.append(a[0].cpu())
            return out

        L.moe_router, L.capacity_slots = router, slots
        return self

    def __exit__(self, *exc):
        self.L.moe_router, self.L.capacity_slots = self._router, self._slots

    def agreement(self, torch, other):
        """(share of equal (token, k) choices, share of equal kept flags);
        None when the calls' shapes differ."""
        def share(a, b):
            if [t.shape for t in a] != [t.shape for t in b]:
                return None
            same = sum(int((x == y).sum()) for x, y in zip(a, b))
            return same / max(1, sum(x.numel() for x in a))
        return share(self.idx, other.idx), share(self.keep, other.keep)


def _moe_logits(torch, L, cfg, params, cache_seal, prompts, toks, forced,
                max_len, dev):
    """Teacher-forced logits of the chunked path (every 32-token chunk of
    ``prompts``, then one decode tick) and of the one-shot prefill of
    ``toks`` and one decode step, each MoE layer's routes recorded.
    Returns ([chunked prefill, tick, one-shot prefill, step], routes,
    forced tokens)."""
    with _Routes(L) as routes:
        pre, dec, f1 = first_tick_logits(torch, cfg, params, cache_seal,
                                         prompts, forced and forced[0], dev)
        gpre, gdec, f2 = group_logits(torch, cfg, params, toks,
                                      forced and forced[1], max_len)
    return [pre, dec, gpre, gdec], routes, (f1, f2)


def _real_entries(torch, prompts, layers, top_k, chunk=32):
    """For each capacity call of ``_moe_logits`` in order (every chunk of
    the chunked prefill, then the one-shot prefill; ``layers`` calls each),
    a (t * top_k,) bool: True at the (token, k) entries of the prompts' own
    tokens, False at a chunk's zero tail or a finished prompt's zero row,
    and at the left padding of the right-aligned group."""
    lens = torch.tensor([len(p) for p in prompts])
    longest = int(lens.max())
    masks = []
    for off in range(0, longest, chunk):
        m = torch.arange(chunk)[None, :] < (lens - off).clamp(0, chunk)[:, None]
        masks += [m.reshape(-1).repeat_interleave(top_k)] * layers
    m = torch.arange(longest)[None, :] >= (longest - lens)[:, None]
    masks += [m.reshape(-1).repeat_interleave(top_k)] * layers
    return masks


def _kept_by_layer(routes, real, layers, experts):
    """Per layer, for the chunked prefill's dispatches and the one-shot
    prefill apart: the share of the prompts' (token, k) entries kept, and
    the most loaded expert's entries over the mean load (each call's, then
    their mean)."""
    n_chunk = len(real) - layers
    split = {}
    for kind, calls in (("chunks", range(n_chunk)),
                        ("one-shot", range(n_chunk, len(real)))):
        kept, skew = [], []
        for layer in range(layers):
            js = [j for j in calls if j % layers == layer]
            kept.append(sum(int(routes.keep[j][real[j]].sum()) for j in js)
                        / sum(int(real[j].sum()) for j in js))
            loads = [routes.slot_idx[j].reshape(-1).bincount(minlength=experts)
                     for j in js]
            skew.append(sum(float(c.max()) * experts / float(c.sum())
                            for c in loads) / len(js))
        split[kind] = {"kept_real": kept, "max_load_over_mean": skew}
    return split


def _gib(n):
    return n / 2**30


def phase_moe(torch, dev, args):
    """Phase 10: Qwen3-30B-A3B at its published widths (d_model 2048, GQA
    32/4 heads of 128, 128 experts of d_ff 768, top-8, vocab 151,936), its
    depth cut to ``MOE_LAYERS``, random weights from ``--seed``, bf16 unless
    said, the default ``SealConfig`` (ColoE, SE 0.5, fused).

    (a) The image sealed under ColoE gives back every leaf bit for bit;
    ``lines_unseal`` runs over the whole stacked ``wi`` expert leaf (4.8 GB,
    past 2^31 and 2^32 bytes) twice, bitwise, and windows of 65,536 lines
    at its start, across its 2^31- and 2^32-byte offsets and at its end
    equal the plain version at their own line addresses; the whole leaf's
    unseal is timed against its bound.
    (b) Teacher-forced logits, sealed against plaintext on the same prompts
    and forced tokens: every chunk of a chunked prefill, the first decode
    tick, a one-shot prefill and its first step. Gated in f32: logits
    within 1e-4 of their scale, every (token, k) expert choice and every
    capacity-kept flag equal; the share of entries kept within capacity
    is reported apart for the prompts' own tokens and for zero padding
    (chunk tails, finished prompts' zero rows, the group's left padding).
    In bf16 the two paths round differently (the fused kernels against
    cuBLAS), and one route flipped at a bf16 near-tie among 128 experts
    moves a token's MLP output wholesale, so the bf16 logit error and
    route agreement are reported, not gated.
    (c) A staggered trace through the continuous engine, 8 slots (admit
    width 2), ColoE weights and cache: every request completes, chunk
    dispatches with a padding row counted (gated above 0), the launches of
    each kernel per dispatch gated, tokens against a plaintext engine
    reported; a verified engine (weight sweep and cache MACs, their
    launches gated) gives the same tokens; a flipped word in an
    enciphered expert line stops the drain with
    ``SealedIntegrityError("weights")`` before any token.
    (d) A group drain of 4 prompts of 512-1024 tokens (prefill through
    ``flash_attention_tc``, GQA 8:1, and ``sealed_matmul_tc``) completes
    with its launches gated.
    (e) A sealed decode tick and a sealed group prefill: events, host
    clock, the profiler's top kernels and idle share; peak memory after
    sealing and over the drain; the phase's wall time.
    One engine is built at a time and released before the next."""
    import numpy as np
    from repro_torch.config import SealConfig
    from repro_torch.configs import get_config
    from repro_torch.core import sealed_store as SS
    from repro_torch.core.mac import SealedIntegrityError
    from repro_torch.kernels import chacha20 as CC
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import drive, poisson_arrivals
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import GroupServeEngine, ServeEngine

    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"held_before_gib": _gib(torch.cuda.memory_allocated(dev))}
    cfg = get_config(MOE_ARCH).with_(num_layers=MOE_LAYERS)
    key = bytes(range(32))
    params = T.init_params(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    out["params_gib"] = _gib(4 * n_params)
    log(f"[moe] {cfg.name}: {cfg.num_layers} of 48 layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.head_dim}, {cfg.moe.num_experts} experts of d_ff {cfg.d_ff} "
        f"top-{cfg.moe.top_k}, vocab {cfg.vocab_size}: {n_params / 1e9:.3f} B "
        f"params ({out['params_gib']:.2f} GiB f32); "
        f"{out['held_before_gib']:.2f} GiB held from earlier phases")

    # (a) sealing
    kw = dict(batch_slots=MOE_SLOTS, max_len=256, chunk_tokens=32, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    ops.reset_launch_counts()
    eng = ServeEngine(cfg, params, seal=SealConfig(), **kw)
    torch.cuda.synchronize()
    out["seal_s"] = time.time() - t0
    out["seal_launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    out["peak_after_seal_gib"] = _gib(torch.cuda.max_memory_allocated(dev))
    sp = eng.sealed
    out["image_gib"] = _gib(sp.stored_bytes())
    log(f"[moe] sealed in {out['seal_s']:.1f} s ({out['seal_launches']}): "
        f"image {out['image_gib']:.2f} GiB, {len(sp.fused_paths())} tile "
        f"leaves, plaintext per step "
        f"{_gib(eng.stats['weights_plaintext_bytes_per_step']):.2f} GiB; "
        f"peak allocated {out['peak_after_seal_gib']:.2f} GiB")
    for path in ("blocks/0/mlp/router", "blocks/0/mlp/wi", "blocks/0/mlp/wg",
                 "blocks/0/mlp/wo"):
        if sp.tensors[path].meta.layout != "lines":
            raise AssertionError(f"{path} is not line-sealed")
    seng = sp.engine(key)
    for path, leaf in flatten_paths(params):      # one leaf at a time
        back = SS._unseal_tensor(seng, sp.tensors[path])
        if back.dtype != leaf.dtype or not torch.equal(
                back.view(torch.int32), leaf.view(torch.int32)):
            raise AssertionError(f"unsealing {path} lost bits")
        del back
    log(f"[moe] every leaf unseals bit for bit")
    st = sp.tensors[MOE_LEAF]
    n_lines, orig = st.payload.shape[0], st.meta.orig_len
    uargs = (seng.key_words, st.payload, None, orig, st.meta.nonce)
    got = CC.lines_unseal_cuda(*uargs)
    again = CC.lines_unseal_cuda(*uargs)
    if not torch.equal(got, again):
        raise AssertionError("lines_unseal differs between two launches")
    del again
    rec_bytes = 4 * st.payload.shape[1]
    starts = {"start": 0,
              "across 2^31 B": 2**31 // rec_bytes - MOE_WINDOW // 2,
              "across 2^32 B": 2**32 // rec_bytes - MOE_WINDOW // 2,
              "end": n_lines - MOE_WINDOW}
    starts = {k: min(max(a, 0), n_lines - MOE_WINDOW)
              for k, a in starts.items()}
    for label, a in starts.items():
        w = slice(a, a + MOE_WINDOW)
        want = CC.lines_unseal_plain(seng.key_words, st.payload[w], None,
                                     32 * MOE_WINDOW, st.meta.nonce, line0=a)
        if not torch.equal(got[32 * a:32 * (a + MOE_WINDOW)], want):
            raise AssertionError(f"lines_unseal != plain at {label} "
                                 f"(line {a})")
    if not torch.equal(got.view(torch.float32).reshape(st.meta.shape),
                       params["blocks"][0]["mlp"]["wi"]):
        raise AssertionError("the expert leaf's unseal is not the leaf")
    del got
    enc = int((st.payload[:, 33] & 1).sum())
    nbytes = st.payload.numel() * 4 + orig * 4
    b_ms, b_by = _pad_bound(nbytes, 2 * enc)
    ts = _time_stats(torch, lambda: CC.lines_unseal_cuda(*uargs), 3)
    out["expert_unseal"] = {
        "leaf": MOE_LEAF, "lines": n_lines, "enc_lines": enc,
        "bytes": nbytes, "ms": ts["ms"], "median_ms": ts["median_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "windows": starts}
    log(f"[moe] lines_unseal over {MOE_LEAF} ({n_lines} lines, "
        f"{nbytes / 1e9:.2f} GB moved, {enc / n_lines:.3f} ciphered) twice "
        f"bitwise, windows at {starts} equal to the plain version; "
        f"{_stats_text(ts)}; bound {b_ms:.3f} ms ({b_by}), "
        f"{b_ms / ts['ms']:.3f} of it")

    # (b) teacher-forced logits, sealed vs plaintext
    tf_prompts = _prompts(args.seed + 21, MOE_TF_PROMPTS, cfg.vocab_size)
    toks = _group_tokens(torch, tf_prompts, dev)
    cfg32 = cfg.with_(dtype="float32")
    real = _real_entries(torch, tf_prompts, cfg.num_layers, cfg.moe.top_k)
    n_real = sum(int(m.sum()) for m in real)
    n_pad = sum(int((~m).sum()) for m in real)
    tf = {}
    for label, c in (("f32", cfg32), ("bf16", cfg)):
        plain_l, plain_r, forced = _moe_logits(
            torch, L, c, params, None, tf_prompts, toks, None, 256, dev)
        sealed_l, sealed_r, _ = _moe_logits(
            torch, L, c, eng.params(), eng.cache_seal, tf_prompts, toks,
            forced, 256, dev)
        errs = [_rel_err(torch, s, p) for s, p in zip(sealed_l, plain_l)]
        routes, kept = sealed_r.agreement(torch, plain_r)
        kept_share = (sum(int(k.sum()) for k in plain_r.keep)
                      / max(1, sum(k.numel() for k in plain_r.keep)))
        if [m.shape for m in real] != [k.shape for k in plain_r.keep]:
            raise AssertionError("the capacity calls are not the chunks and "
                                 "the one-shot prefill of the prompts")
        kept_real = sum(int(k[m].sum()) for k, m in zip(plain_r.keep, real))
        kept_pad = sum(int(k[~m].sum()) for k, m in zip(plain_r.keep, real))
        tf[label] = {"rel_err": errs, "route_agreement": routes,
                     "kept_agreement": kept, "kept_share": kept_share,
                     "kept_share_real": kept_real / n_real,
                     "kept_share_padding": kept_pad / max(1, n_pad),
                     "real_entries": n_real, "padding_entries": n_pad,
                     "by_layer": _kept_by_layer(plain_r, real,
                                                cfg.num_layers,
                                                cfg.moe.num_experts),
                     "router_calls": len(plain_r.idx),
                     "dispatch_calls": len(plain_r.keep)}
        log(f"[moe] teacher-forced {label}, sealed vs plaintext: max rel err"
            f" chunked prefill {errs[0]:.3e}, tick {errs[1]:.3e}, one-shot "
            f"prefill {errs[2]:.3e}, step {errs[3]:.3e}; (token, k) expert "
            f"choices equal {routes}, kept flags equal {kept} over "
            f"{len(plain_r.idx)} router and {len(plain_r.keep)} capacity "
            f"calls; {kept_share:.4f} of the (token, k) entries kept "
            f"within capacity: {kept_real / n_real:.4f} of the {n_real} of "
            f"the prompts' tokens, {kept_pad / max(1, n_pad):.4f} of the "
            f"{n_pad} of zero padding")
        for kind, v in tf[label]["by_layer"].items():
            log(f"[moe] {label} {kind}, by layer: kept share of the "
                f"prompts' entries "
                f"{', '.join(f'{x:.3f}' for x in v['kept_real'])}; the most "
                f"loaded expert over the mean load "
                f"{', '.join(f'{x:.2f}' for x in v['max_load_over_mean'])}")
        del plain_l, sealed_l, plain_r, sealed_r
    out["teacher_forced"] = tf
    if not (max(tf["f32"]["rel_err"]) <= 1e-4
            and tf["f32"]["route_agreement"] == 1.0
            and tf["f32"]["kept_agreement"] == 1.0):
        raise AssertionError("sealed f32 MoE logits or routes disagree with "
                             "plaintext")

    # (c) the staggered trace through the continuous engine
    prompts = _prompts(args.seed + 22, MOE_REQUESTS, cfg.vocab_size)
    arrivals = poisson_arrivals(MOE_REQUESTS, MOE_STAGGER,
                                np.random.RandomState(args.seed + 23))
    submit = dict(max_tokens=NEW_TOKENS)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()            # the MoE path starts here
    torch.cuda.synchronize()
    t0 = time.time()
    handles = drive(eng, prompts, arrivals, submit)
    torch.cuda.synchronize()
    launches = ops.launch_counts()       # ... and ends here
    out["serve_s"] = time.time() - t0
    out["peak_drain_gib"] = _gib(torch.cuda.max_memory_allocated(dev))
    out["launches"] = launches
    st_ = dict(eng.stats)
    out["stats"] = st_
    dispatches = st_["prefills"] + st_["decode_steps"]
    pad_rows = eng._admit_n * st_["prefills"] - st_["prefill_chunks"]
    out["padded_rows"] = pad_rows
    log(f"[moe] continuous run: {out['serve_s']:.2f} s, "
        f"{st_['tokens']} tokens, {st_['prefills']} chunk dispatches "
        f"({st_['prefill_chunks']} rows, {pad_rows} padding rows at admit "
        f"width {eng._admit_n}: {pad_rows} dispatches carried a padding "
        f"row) + {st_['decode_steps']} decode ticks; peak "
        f"allocated {out['peak_drain_gib']:.2f} GiB; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if not all(h.done and len(h.out) == NEW_TOKENS for h in handles):
        raise AssertionError("not every MoE request completed")
    if eng._admit_n != 2 or pad_rows <= 0:
        raise AssertionError("no chunk dispatch carried a padding row")
    want = _fused_launches(eng, 64, 64)     # chunk rows and ticks: <= 64
    want = {k: v * dispatches for k, v in want.items()}
    want.update(_chacha_launches(eng, dispatches, paged=True))
    got_ = {k: launches[k] for k in want}
    if got_ != want or not want["sealed_matmul_dec"]:
        raise AssertionError(f"MoE launches {got_}, expected {want}")
    eng.check_device_mirror()
    tokens = [h.out for h in handles]

    # (e) a sealed decode tick with every slot decoding
    for p in prompts[:MOE_SLOTS]:
        eng.submit(p, max_tokens=64)
    while any(r is None or eng._pending[i] is not None
              for i, r in enumerate(eng._active)):
        eng.step()
    tick = _time_stats(torch, eng._decode_tick, 3)
    wall = []
    for _ in range(3):
        t0 = time.time()
        eng._decode_tick()
        wall.append(1e3 * (time.time() - t0))
    prof = _profile(torch, eng._decode_tick, 2, "sealed MoE decode ticks",
                    top=15, launches_of="lines_unseal")
    # the serving view of a dispatch: every line leaf but the embedding
    # unsealed (one lines_unseal launch each), timed alone by events; the
    # profiler keeps only some of these long launches' records
    view = [t for p, t in sp.tensors.items()
            if t.meta.layout == "lines" and p != SS.EMBED]
    view_bytes = sum(t.payload.numel() * 4 + t.meta.orig_len * 4
                     for t in view)
    view_pads = sum(2 * int((t.payload[:, 33] & 1).sum()) for t in view)
    vb_ms, vb_by = _pad_bound(view_bytes, view_pads)
    vts = _time_stats(torch, eng.params, 3)
    kept = len(prof.get("launch_ms", []))
    out["tick"] = {"ms": tick["ms"], "median_ms": tick["median_ms"],
                   "host_ms": sorted(wall)[1], "profile": prof,
                   "view_ms": vts["ms"], "view_bound_ms": vb_ms,
                   "view_bound_by": vb_by, "view_bytes": view_bytes,
                   "unseal_records": kept,
                   "unseal_launches": prof["reps"] * len(view)}
    log(f"[moe] sealed decode tick, {MOE_SLOTS} slots: {_stats_text(tick)};"
        f" host clock {out['tick']['host_ms']:.2f} ms; a dispatch's view "
        f"({len(view)} line leaves unsealed, {view_bytes / 1e9:.2f} GB "
        f"moved): {_stats_text(vts)}, bound {vb_ms:.3f} ms ({vb_by}); the "
        f"profiler kept {kept} of the {prof['reps'] * len(view)} "
        f"lines_unseal records")
    eng.queue.clear()
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    plain = ServeEngine(cfg, params, seal=None, **kw)
    ph = drive(plain, prompts, arrivals, submit)
    same = sum(a == b for h, g in zip(tokens, ph) for a, b in zip(h, g.out))
    total = sum(len(h) for h in tokens)
    out["greedy_agreement"] = same / total
    log(f"[moe] greedy tokens equal to the plaintext engine's: {same}/"
        f"{total} = {same / total:.3f} (bf16 near-ties; not gated)")
    plain_tokens = [g.out for g in ph]
    del plain, ph
    gc.collect()
    torch.cuda.empty_cache()

    ver = ServeEngine(cfg, params, seal=SealConfig(), verify=True, **kw)
    ops.reset_launch_counts()            # the verified MoE path starts here
    torch.cuda.synchronize()
    vh = drive(ver, prompts, arrivals, submit)
    torch.cuda.synchronize()
    vlaunch = ops.launch_counts()        # ... and ends here
    out["verified_stats"] = dict(ver.stats)
    out["verify_launches"] = vlaunch
    if [h.out for h in vh] != tokens:
        raise AssertionError("verified MoE tokens differ from unverified")
    # one weight sweep, a cache check a chunk row and a decode token (every
    # token but each request's first, which its last chunk samples)
    if ver.stats["mac_failures"] or ver.stats["mac_checks"] != 1 + \
            st_["prefill_chunks"] + st_["tokens"] - MOE_REQUESTS:
        raise AssertionError(f"verified run's MAC stats {ver.stats}")
    # per dispatch the unverified run's launches, a cache check and a
    # re-tag per pattern position; one tag launch a leaf for the sweep
    vdisp = ver.stats["prefills"] + ver.stats["decode_steps"]
    layouts = [t.meta.layout for t in ver.sealed.tensors.values()]
    vwant = {k: v * vdisp for k, v in _fused_launches(ver, 64, 64).items()}
    vwant.update(_chacha_launches(ver, vdisp, paged=True))
    vwant.update(chacha20_cache_copy=0,
                 chacha20_cache_tags=vdisp * len(cfg.pattern),
                 chacha20_cache_verify=vdisp * len(cfg.pattern),
                 chacha20_weight_tile_tags=layouts.count("tiles"),
                 chacha20_weight_line_tags=layouts.count("lines"))
    vgot = {k: vlaunch[k] for k in vwant}
    log(f"[moe] verified run's launches over {vdisp} dispatches: "
        f"{ {k: v for k, v in vlaunch.items() if v} }")
    if vgot != vwant:
        raise AssertionError(f"verified MoE launches {vgot}, expected "
                             f"{vwant}")
    vst = ver.sealed.tensors[MOE_LEAF]
    line = int(torch.nonzero(vst.payload[:, 33] & 1)[-1])
    vst.payload[line, 7] ^= 1 << 9
    victim = ver.submit(prompts[0], max_tokens=4)
    tokens0 = ver.stats["tokens"]
    try:
        ver.run()
        raise AssertionError("a flipped expert word went unnoticed")
    except SealedIntegrityError as e:
        if e.scope != "weights" or victim.out or \
                ver.stats["tokens"] != tokens0:
            raise AssertionError(f"the expert flip raised {e!r} after "
                                 f"tokens") from e
    vst.payload[line, 7] ^= 1 << 9
    log(f"[moe] verified run: tokens equal to unverified, mac_checks "
        f"{out['verified_stats']['mac_checks']}; a flipped word in "
        f"enciphered line {line} of {MOE_LEAF} stopped the drain with "
        f"SealedIntegrityError('weights') before any token")
    del ver, vh, vst
    gc.collect()
    torch.cuda.empty_cache()
    out["direct"] = _moe_direct(torch, dev, cfg, params, prompts, arrivals,
                                plain_tokens, kw)

    # (d) the group drain
    gprompts = _moe_group_prompts(args.seed)
    geng = GroupServeEngine(cfg, params, batch_slots=MOE_GROUP,
                            max_len=GROUP_MAX_LEN, seal=SealConfig(),
                            device=dev)
    ops.reset_launch_counts()            # the MoE group path starts here
    torch.cuda.synchronize()
    t0 = time.time()
    gh = drive(geng, gprompts, np.zeros((MOE_GROUP,)), submit)
    torch.cuda.synchronize()
    glaunch = ops.launch_counts()        # ... and ends here
    out["group_s"] = time.time() - t0
    out["group_launches"] = glaunch
    gst = geng.stats
    if not all(h.done and len(h.out) == NEW_TOKENS for h in gh):
        raise AssertionError("not every MoE group request completed")
    plen = max(len(p) for p in gprompts)
    want = {"flash_attention_tc": gst["prefills"] * cfg.num_layers,
            "flash_attention": 0, "flash_attention_tc256": 0}
    for rows, head_rows, times in ((MOE_GROUP * plen, MOE_GROUP,
                                    gst["prefills"]),
                                   (MOE_GROUP, MOE_GROUP,
                                    gst["decode_steps"])):
        for name, n in _fused_launches(geng, rows, head_rows).items():
            want[name] = want.get(name, 0) + n * times
    got_ = {k: glaunch[k] for k in want}
    log(f"[moe] group drain: {out['group_s']:.2f} s, prompts "
        f"{min(len(p) for p in gprompts)}-{plen} tokens, {gst['prefills']} "
        f"prefill + {gst['decode_steps']} steps; launches {got_}")
    if got_ != want or not want["sealed_matmul_tc"]:
        raise AssertionError(f"MoE group launches {got_}, expected {want}")

    # (e) a sealed group prefill
    gtoks = _group_tokens(torch, gprompts, dev)
    pre = lambda: T.prefill(cfg, geng.params(), gtoks, geng.max_len)
    pts = _time_stats(torch, pre, 2)
    t0 = time.time()
    pre()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.time() - t0)
    pprof = _profile(torch, pre, 1, "sealed MoE group prefill", top=15)
    out["prefill"] = {"rows": int(gtoks.numel()), "ms": pts["ms"],
                      "median_ms": pts["median_ms"], "host_ms": host_ms,
                      "profile": pprof}
    log(f"[moe] sealed prefill of {MOE_GROUP} x {gtoks.shape[1]} tokens: "
        f"{_stats_text(pts)}; host clock {host_ms:.1f} ms")
    del geng, gh, params, sp, seng, st
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.time() - t_phase
    log(f"[moe] phase 10: {out['wall_s']:.1f} s")
    return out


MOE_EXPERT_LEAVES = ("blocks/0/mlp/wi", "blocks/0/mlp/wg", "blocks/0/mlp/wo")


def _moe_direct(torch, dev, cfg, params, prompts, arrivals, plain_tokens,
                kw):
    """Phase 10 (c'): the staggered trace under the Direct engine. Gated:
    every request completes with the plaintext engine's tokens bit for bit
    (the Direct view is the plaintext weights, rounded at each use as the
    plaintext engine stores them), and one ``aes128_lines_decrypt`` a leaf
    a dispatch. A tick with every slot decoding is timed (events, host
    clock, profiler), and so is the AES decrypt of the stacked expert
    leaves and of the whole view by events (the profiler drops records of
    long launches); peak memory over the drain."""
    from repro_torch.config import SealConfig
    from repro_torch.kernels import aes128 as AES
    from repro_torch.serve.engine import ServeEngine
    torch.cuda.reset_peak_memory_stats(dev)
    direct = ServeEngine(cfg, params, seal=SealConfig(mode="direct"), **kw)
    handles, launches, secs = _drive_counted(torch, direct, prompts,
                                             arrivals)
    st = dict(direct.stats)
    disp = st["prefills"] + st["decode_steps"]
    want = _direct_launches(direct, disp, True)
    same = [h.out for h in handles] == plain_tokens
    out = {"launches": launches, "stats": st, "serve_s": secs,
           "tokens_equal_plaintext": same,
           "peak_drain_gib": _gib(torch.cuda.max_memory_allocated(dev))}
    log(f"[moe] Direct run: {secs:.2f} s, {disp} dispatches "
        f"({st['prefill_chunks']} chunk rows in {st['prefills']} chunk "
        f"dispatches), tokens equal to plaintext: {same}; peak allocated "
        f"{out['peak_drain_gib']:.2f} GiB; launches {_nonzero(launches)}")
    if not same:
        raise AssertionError("Direct MoE tokens differ from plaintext")
    _gate("Direct MoE", {k: launches[k] for k in want}, want)
    _fill_slots(direct, prompts)
    tick = _time_stats(torch, direct._decode_tick, 3)
    t0 = time.time()
    direct._decode_tick()
    host = 1e3 * (time.time() - t0)
    prof = _profile(torch, direct._decode_tick, 1, "Direct MoE decode tick",
                    top=10, launches_of="aes128")
    eng = direct.sealed.engine(bytes(range(32)))
    experts = [direct.sealed.tensors[p] for p in MOE_EXPERT_LEAVES]
    ex = _time_stats(torch, lambda: [AES.lines_decrypt_cuda(
        eng.round_keys, t.payload, t.counters, t.meta.orig_len)
        for t in experts], 3)
    view = _time_stats(torch, direct.params, 3)
    ex_lines = sum(t.payload.shape[0] for t in experts)
    ex_bytes = sum(t.payload.numel() * 4 + t.counters.numel() * 4
                   + t.meta.orig_len * 4 for t in experts)
    b_ms, b_by = _aes_bound(ex_lines, sum(t.meta.orig_len for t in experts),
                            sum(int((t.counters & 1).sum()) for t in experts))
    out["tick"] = {"ms": tick["ms"], "median_ms": tick["median_ms"],
                   "host_ms": host, "profile": prof,
                   "expert_decrypt_ms": ex["ms"],
                   "expert_decrypt_bound_ms": b_ms,
                   "expert_decrypt_bound_by": b_by,
                   "expert_bytes": ex_bytes, "view_ms": view["ms"]}
    log(f"[moe] Direct decode tick, {direct.slots} slots: "
        f"{_stats_text(tick)}; host clock {host:.2f} ms; the AES decrypt "
        f"of the 3 stacked expert leaves ({ex_bytes / 1e9:.2f} GB moved): "
        f"{_stats_text(ex)}, bound {b_ms:.3f} ms ({b_by}); the whole view "
        f"(one decrypt a leaf): {_stats_text(view)}")
    direct.queue.clear()
    del direct, experts, eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 11: the remaining token families at full width
# --------------------------------------------------------------------------

# (arch, layers run: 0 for the full depth) of the dense families served
# through the continuous engine, and of the recurrent ones served through
# the group engine (the reference serves them only there)
FAMILY_DENSE = (("granite_3_2b", 10), ("gemma2_2b", 8),
                ("deepseek_coder_33b", 4))
FAMILY_RECURRENT = (("recurrentgemma_9b", 6), ("mamba2_130m", 0))
# the dense families that also run the Direct engine
FAMILY_DIRECT = ("granite_3_2b", "gemma2_2b")
# the dense trace's mean gap between arrivals (scheduler steps)
FAMILY_STAGGER = 2.0
# RecurrentGemma's trace: 4 prompts of 512-1024 tokens, then 2 of
# 2100-2300 (past its 2048-slot ring); Mamba2's: groups of 4 whose longest
# prompt is 128, 512 and 1024 tokens (SSD takes no other length over 128)
RG_PROMPTS = ((4, 512, 1024), (2, 2100, 2300))
MAMBA_GROUPS = (128, 512, 1024)
FAMILY_SLOTS = 4
# teacher-forced decode steps of the recurrent families' f32 gate
FAMILY_TF_STEPS = 6


def _family_trace(arch, seed, vocab):
    """(prompts, arrivals, max_len) of a family's trace: the dense families
    8 prompts of 64-200 tokens at Poisson arrivals; the recurrent ones
    their groups (all arriving at once)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    if arch == "recurrentgemma_9b":
        prompts = [rng.randint(0, vocab, rng.randint(lo, hi + 1))
                   .astype(np.int32) for n, lo, hi in RG_PROMPTS
                   for _ in range(n)]
    elif arch == "mamba2_130m":
        prompts = []
        for top in MAMBA_GROUPS:     # the group's longest prompt is ``top``
            lens = [top] + [rng.randint(64, top + 1) for _ in range(3)]
            prompts += [rng.randint(0, vocab, n).astype(np.int32)
                        for n in lens]
    else:
        prompts = _prompts(seed, REQUESTS, vocab)
        arrivals = np.cumsum(rng.exponential(FAMILY_STAGGER, REQUESTS))
        return prompts, arrivals, 256
    longest = max(len(p) for p in prompts)
    return prompts, np.zeros((len(prompts),)), longest + NEW_TOKENS + 16


# the flash kernels' launch counts (``flash_attention._kernel``)
FLASH_KERNELS = ("flash_attention", "flash_attention_tc",
                 "flash_attention_tc256")


def _flash_want(torch, cfg, prefills):
    """Flash launches of ``prefills`` one-shot prefills of ``cfg``: one an
    attention layer, all counted where ``_kernel`` says for its dtype and
    head dim."""
    from repro_torch.kernels import flash_attention as FA
    attn = cfg.n_superblocks() * sum(k in ("attn", "local_attn")
                                     for k in cfg.pattern)
    want = dict.fromkeys(FLASH_KERNELS, 0)
    want[FA._kernel(getattr(torch, cfg.dtype), cfg.head_dim)] = (
        attn * prefills)
    return want


def _group_launch_want(torch, eng, prompts):
    """Launches of each fused-matmul and flash kernel a sealed group
    engine's drain of ``prompts`` (groups of ``eng.slots`` in order, each
    decoding ``NEW_TOKENS - 1`` steps) must show, by ``_variant``: a
    prefill's contractions have (members x longest prompt) rows, its head
    and each step one row a member; one flash launch a prefill and
    attention layer."""
    cfg = eng.cfg
    groups = range(0, len(prompts), eng.slots)
    want = {"sealed_matmul": 0, "sealed_matmul_tc": 0,
            "sealed_matmul_dec": 0}
    want.update(_flash_want(torch, cfg, len(groups)))
    for i in groups:
        g = prompts[i:i + eng.slots]
        if eng.sealed is None or not eng.sealed.fused_paths():
            continue
        for rows, head_rows, times in ((len(g) * max(len(p) for p in g),
                                        len(g), 1),
                                       (len(g), len(g), NEW_TOKENS - 1)):
            for name, n in _fused_launches(eng, rows, head_rows).items():
                want[name] += n * times
    return want


def _direct_launches(eng, dispatches, paged):
    """A Direct engine's run: one AES decrypt a leaf a dispatch, no ChaCha
    line kernel and no fused matmul; over a paged cache, its view and
    splice."""
    cfg = eng.cfg
    return {"aes128_lines_decrypt": dispatches * len(eng.sealed.tensors),
            "aes128_lines_encrypt": 0, "chacha20": 0,
            "chacha20_lines_unseal": 0, "chacha20_lines_gather": 0,
            "chacha20_cache_view": dispatches * cfg.num_layers if paged else 0,
            "chacha20_cache_splice":
                dispatches * len(cfg.pattern) if paged else 0,
            "sealed_matmul": 0, "sealed_matmul_dec": 0,
            "sealed_matmul_tc": 0}


def _check_image(torch, SS, sp, params, key):
    """Every leaf of ``params`` unseals from ``sp`` bit for bit."""
    eng = sp.engine(key)
    for path, leaf in flatten_paths(params):      # one leaf at a time
        back = SS._unseal_tensor(eng, sp.tensors[path])
        if back.dtype != leaf.dtype or not torch.equal(
                back.view(torch.int32), leaf.view(torch.int32)):
            raise AssertionError(f"unsealing {path} lost bits")
        del back


def _gate(label, got, want):
    if got != want:
        raise AssertionError(f"{label} launches {got}, expected {want}")


def _drive_counted(torch, eng, prompts, arrivals):
    """``launch.serve.drive`` of the trace with every launch count set to
    0 just before and read just after; returns (handles, counts, s)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import drive
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    handles = drive(eng, prompts, arrivals, dict(max_tokens=NEW_TOKENS))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if not all(h.done and len(h.out) == NEW_TOKENS for h in handles):
        raise AssertionError(f"not every {eng.cfg.name} request completed")
    return handles, counts, time.time() - t0


def _fill_slots(eng, prompts):
    """Submit a long request per slot and step until every one of them
    decodes (no prompt left pending), so that a timed tick decodes in every
    slot."""
    for p in prompts[:eng.slots]:
        eng.submit(p, max_tokens=64)
    while eng.queue or any(p is not None for p in eng._pending):
        eng.step()


def _nonzero(d):
    return {k: v for k, v in d.items() if v}


def _time_each(torch, label, fns, reps=3):
    """Events, host clock and the profiler's split of each of ``fns``
    ({label: fn}), sealed beside plaintext in one call."""
    out = {}
    for name, fn in fns.items():
        st = _time_stats(torch, fn, reps)
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        host = 1e3 * (time.time() - t0)
        prof = _profile(torch, fn, 1, f"{name} {label}", top=8)
        out[name] = {"ms": st["ms"], "median_ms": st["median_ms"],
                     "host_ms": host, "idle_share": prof["idle_share"],
                     "device_busy_ms": prof["device_busy_ms"],
                     "top": prof["top"]}
        log(f"[family] {label} {name}: {_stats_text(st)}; host clock "
            f"{host:.2f} ms; profiler: device busy "
            f"{prof['device_busy_ms']:.2f} ms, idle share "
            f"{prof['idle_share']:.3f}")
    return out


def _dense_family(torch, dev, args, arch, layers):
    from repro_torch.config import SealConfig
    from repro_torch.configs import get_config
    from repro_torch.core import sealed_store as SS
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine

    t_fam = time.time()
    cfg = get_config(arch)
    full = cfg.num_layers
    if layers:
        cfg = cfg.with_(num_layers=layers)
    key = bytes(range(32))
    torch.cuda.reset_peak_memory_stats(dev)
    params = T.init_params(cfg, seed=args.seed, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    out = {"layers": cfg.num_layers, "of": full,
           "params_gib": _gib(4 * n_params)}
    log(f"[family] {cfg.name}: {cfg.num_layers} of {full} layers, d_model "
        f"{cfg.d_model}, {cfg.heads_eff}/{cfg.num_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, pattern "
        f"{cfg.pattern}, window {cfg.window}, softcaps {cfg.attn_softcap}/"
        f"{cfg.logit_softcap}, tied {cfg.tie_embeddings}: "
        f"{n_params / 1e9:.3f} B params ({out['params_gib']:.2f} GiB f32)")
    kw = dict(batch_slots=FAMILY_SLOTS, max_len=256, chunk_tokens=32,
              device=dev)
    prompts, arrivals, _ = _family_trace(arch, args.seed + 31, cfg.vocab_size)

    # the image
    eng = ServeEngine(cfg, params, seal=SealConfig(), **kw)
    _check_image(torch, SS, eng.sealed, params, key)
    log(f"[family] {cfg.name}: sealed (ColoE, SE 0.5), "
        f"{len(eng.sealed.fused_paths())} tile leaves; every leaf unseals "
        f"bit for bit")

    # f32 teacher-forced logits, sealed vs plaintext: a chunked prefill and
    # a decode tick, a one-shot prefill and its step
    cfg32 = cfg.with_(dtype="float32")
    tf = prompts[:FAMILY_SLOTS]
    toks = _group_tokens(torch, tf, dev)
    pre, dec, f1 = first_tick_logits(torch, cfg32, params, None, tf, None,
                                     dev)
    gpre, gdec, f2 = group_logits(torch, cfg32, params, toks, None, 256)
    spre, sdec, _ = first_tick_logits(torch, cfg32, eng.params(),
                                      eng.cache_seal, tf, f1, dev)
    sgpre, sgdec, _ = group_logits(torch, cfg32, eng.params(), toks, f2, 256)
    errs = [_rel_err(torch, a, b) for a, b in ((spre, pre), (sdec, dec),
                                               (sgpre, gpre), (sgdec, gdec))]
    out["f32_rel_err"] = errs
    log(f"[family] {cfg.name} f32 teacher-forced, sealed vs plaintext: max "
        f"rel err chunked prefill {errs[0]:.3e}, tick {errs[1]:.3e}, "
        f"one-shot prefill {errs[2]:.3e}, step {errs[3]:.3e} (gate 1e-4)")
    if max(errs) > 1e-4:
        raise AssertionError(f"{cfg.name}: sealed f32 logits disagree")
    del pre, dec, gpre, gdec, spre, sdec, sgpre, sgdec

    # the staggered trace, launches gated per dispatch
    handles, launches, secs = _drive_counted(torch, eng, prompts, arrivals)
    st = dict(eng.stats)
    disp = st["prefills"] + st["decode_steps"]
    want = {k: v * disp for k, v in _fused_launches(eng, 64, 64).items()}
    want.update(_chacha_launches(eng, disp, paged=True))
    want.update(dict.fromkeys(FLASH_KERNELS, 0))
    log(f"[family] {cfg.name} sealed trace: {secs:.2f} s, {st['tokens']} "
        f"tokens, {st['prefills']} chunk dispatches + {st['decode_steps']} "
        f"ticks; launches {_nonzero(launches)}")
    _gate(cfg.name, {k: launches[k] for k in want}, want)
    eng.check_device_mirror()
    tokens = [h.out for h in handles]
    out.update(launches=launches, stats=st, serve_s=secs)

    # a tick with every slot decoding, sealed, and the one-shot prefill
    _fill_slots(eng, prompts)
    timing = {"tick": _time_each(torch, "decode tick", {
        "sealed": eng._decode_tick})}
    timing["prefill"] = _time_each(torch, f"one-shot prefill of "
                                    f"{tuple(toks.shape)}", {
        "sealed": lambda: T.prefill(cfg, eng.params(), toks, 256)})
    # that prefill once more, counted: the dense families' only flash
    # launches in this phase (their continuous path runs none)
    t0 = time.time()
    ops.reset_launch_counts()
    T.prefill(cfg, eng.params(), toks, 256)
    torch.cuda.synchronize()
    out["prefill_launches"] = ops.launch_counts()
    want = _flash_want(torch, cfg, 1)
    log(f"[family] {cfg.name} one-shot prefill of {tuple(toks.shape)}, "
        f"counted: {time.time() - t0:.2f} s, launches "
        f"{_nonzero(out['prefill_launches'])}")
    _gate(f"{cfg.name} one-shot prefill",
          {k: out["prefill_launches"][k] for k in want}, want)
    if cfg.tie_embeddings:
        timing["embed_unseal"] = _time_embed_unseal(torch, eng.sealed, key)
    eng.queue.clear()
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    plain = ServeEngine(cfg, params, seal=None, **kw)
    ph, plaunch, psecs = _drive_counted(torch, plain, prompts, arrivals)
    same = sum(a == b for h, g in zip(tokens, ph) for a, b in zip(h, g.out))
    total = sum(len(h) for h in tokens)
    out["greedy_agreement"] = same / total
    log(f"[family] {cfg.name} plaintext trace {psecs:.2f} s; sealed greedy "
        f"tokens equal to plaintext: {same}/{total} (bf16 near-ties; "
        f"reported)")
    _fill_slots(plain, prompts)
    timing["tick"].update(_time_each(torch, "decode tick", {
        "plaintext": plain._decode_tick}))
    timing["prefill"].update(_time_each(torch, "one-shot prefill", {
        "plaintext": lambda: T.prefill(cfg, plain.params(), toks, 256)}))
    plain.queue.clear()
    plain_tokens = [h.out for h in ph]
    del plain, ph
    gc.collect()
    torch.cuda.empty_cache()

    # verified: the same tokens, its MAC launches gated
    ver = ServeEngine(cfg, params, seal=SealConfig(), verify=True, **kw)
    vh, vl, _ = _drive_counted(torch, ver, prompts, arrivals)
    if [h.out for h in vh] != tokens:
        raise AssertionError(f"{cfg.name}: verified tokens differ")
    vst = ver.stats
    if vst["mac_failures"] or vst["mac_checks"] != 1 + st["prefill_chunks"] \
            + st["tokens"] - len(prompts):
        raise AssertionError(f"{cfg.name}: verified MAC stats {vst}")
    vd = vst["prefills"] + vst["decode_steps"]
    layouts = [t.meta.layout for t in ver.sealed.tensors.values()]
    vwant = {k: v * vd for k, v in _fused_launches(ver, 64, 64).items()}
    vwant.update(_chacha_launches(ver, vd, paged=True))
    vwant.update(chacha20_cache_copy=0,
                 chacha20_cache_tags=vd * len(cfg.pattern),
                 chacha20_cache_verify=vd * len(cfg.pattern),
                 chacha20_weight_tile_tags=layouts.count("tiles"),
                 chacha20_weight_line_tags=layouts.count("lines"))
    _gate(f"{cfg.name} verified", {k: vl[k] for k in vwant}, vwant)
    out["verify_launches"] = vl
    log(f"[family] {cfg.name} verified run: tokens equal, mac_checks "
        f"{vst['mac_checks']}, launches gated")
    del ver, vh
    gc.collect()
    torch.cuda.empty_cache()

    if arch in FAMILY_DIRECT:
        direct = ServeEngine(cfg, params, seal=SealConfig(mode="direct"),
                             **kw)
        dh, dl, dsecs = _drive_counted(torch, direct, prompts, arrivals)
        dd = direct.stats["prefills"] + direct.stats["decode_steps"]
        _gate(f"{cfg.name} Direct", {k: dl[k] for k in _direct_launches(
            direct, dd, True)}, _direct_launches(direct, dd, True))
        dsame = [h.out for h in dh] == plain_tokens
        log(f"[family] {cfg.name} Direct trace {dsecs:.2f} s, one AES "
            f"decrypt a leaf a dispatch; tokens equal to plaintext: {dsame}")
        if not dsame:
            raise AssertionError(f"{cfg.name}: Direct tokens differ from "
                                 f"plaintext")
        out["direct_launches"] = dl
        del direct, dh
        gc.collect()
        torch.cuda.empty_cache()
    out["timing"] = timing
    out["peak_gib"] = _gib(torch.cuda.max_memory_allocated(dev))
    out["wall_s"] = time.time() - t_fam
    log(f"[family] {cfg.name}: tick sealed "
        f"{timing['tick']['sealed']['ms']:.2f} / plaintext "
        f"{timing['tick']['plaintext']['ms']:.2f} ms, prefill sealed "
        f"{timing['prefill']['sealed']['ms']:.2f} / plaintext "
        f"{timing['prefill']['plaintext']['ms']:.2f} ms (events); peak "
        f"allocated {out['peak_gib']:.2f} GiB; {out['wall_s']:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _time_embed_unseal(torch, sp, key):
    """One dispatch's unseal of a tied embedding (the serving view decrypts
    it whole to serve as the head), by events, beside its bound."""
    from repro_torch.core import sealed_store as SS
    from repro_torch.kernels import chacha20 as CC
    st = sp.tensors[SS.EMBED]
    eng = sp.engine(key)
    args = (eng.key_words, st.payload, st.counters, st.meta.orig_len,
            st.meta.nonce)
    enc = int((st.payload[:, 33] & 1).sum()) if st.counters is None else \
        st.payload.shape[0]
    nbytes = st.payload.numel() * 4 + st.meta.orig_len * 4
    b_ms, b_by = _pad_bound(nbytes, 2 * enc)
    ts = _time_stats(torch, lambda: CC.lines_unseal_cuda(*args), 5)
    rec = {"lines": st.payload.shape[0], "bytes": nbytes, "ms": ts["ms"],
           "median_ms": ts["median_ms"], "bound_ms": b_ms, "bound_by": b_by}
    log(f"[family] tied embedding {tuple(st.meta.shape)} unsealed whole a "
        f"dispatch: {_stats_text(ts)}; {nbytes / 1e9:.2f} GB moved, bound "
        f"{b_ms:.3f} ms ({b_by})")
    return rec


def _recurrent_family(torch, dev, args, arch, layers):
    from repro_torch.config import SealConfig
    from repro_torch.configs import get_config
    from repro_torch.core import sealed_store as SS
    from repro_torch.models import blocks as B
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import GroupServeEngine

    t_fam = time.time()
    cfg = get_config(arch)
    full = cfg.num_layers
    if layers:
        cfg = cfg.with_(num_layers=layers)
    key = bytes(range(32))
    torch.cuda.reset_peak_memory_stats(dev)
    params = T.init_params(cfg, seed=args.seed, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    out = {"layers": cfg.num_layers, "of": full,
           "params_gib": _gib(4 * n_params)}
    geometry = (f"RG-LRU width {cfg.rglru_block_width}, {cfg.heads_eff}/"
                f"{cfg.num_kv_heads} heads of {cfg.head_dim}, window "
                f"{cfg.window}, d_ff {cfg.d_ff}" if "rglru" in cfg.pattern
                else f"SSD {cfg.ssm_heads} heads of {cfg.ssm_head_dim}, "
                     f"state {cfg.ssm_state}, conv {cfg.ssm_conv}")
    log(f"[family] {cfg.name}: {cfg.num_layers} of {full} layers, d_model "
        f"{cfg.d_model}, pattern {cfg.pattern}, {geometry}, vocab "
        f"{cfg.vocab_size}: {n_params / 1e9:.3f} B params "
        f"({out['params_gib']:.2f} GiB f32)")
    prompts, arrivals, max_len = _family_trace(arch, args.seed + 41,
                                               cfg.vocab_size)
    kw = dict(batch_slots=FAMILY_SLOTS, max_len=max_len, device=dev)
    groups = [prompts[i:i + FAMILY_SLOTS]
              for i in range(0, len(prompts), FAMILY_SLOTS)]
    out["groups"] = [[len(p) for p in g] for g in groups]

    eng = GroupServeEngine(cfg, params, seal=SealConfig(), **kw)
    _check_image(torch, SS, eng.sealed, params, key)
    log(f"[family] {cfg.name}: sealed (ColoE, SE 0.5), "
        f"{len(eng.sealed.fused_paths())} tile leaves; every leaf unseals "
        f"bit for bit; groups {out['groups']}, max_len {max_len}")

    # f32: a one-shot prefill and 6 decode steps, sealed vs plaintext on
    # the plaintext run's tokens
    cfg32 = cfg.with_(dtype="float32")
    toks = _group_tokens(torch, groups[0][:2], dev)
    errs = []
    lp, cp = T.prefill(cfg32, params, toks, max_len)
    ls, cs = T.prefill(cfg32, eng.params(), toks, max_len)
    errs.append(_rel_err(torch, ls, lp))
    for i in range(FAMILY_TF_STEPS):
        nxt = lp.argmax(dim=-1)[:, None]
        lp, cp, _ = T.decode_step(cfg32, params, cp, nxt, toks.shape[1] + i)
        ls, cs, _ = T.decode_step(cfg32, eng.params(), cs, nxt,
                                  toks.shape[1] + i)
        errs.append(_rel_err(torch, ls, lp))
    state_err = max(_rel_err(torch, a[k], b[k]) for a, b in zip(cs, cp)
                    for k in a if a[k].is_floating_point())
    out["f32_rel_err"] = errs
    out["f32_state_rel_err"] = state_err
    log(f"[family] {cfg.name} f32, sealed vs plaintext: prefill "
        f"{errs[0]:.3e}, decode steps {[f'{e:.3e}' for e in errs[1:]]}, "
        f"caches {state_err:.3e} (gate 1e-4)")
    if max(errs) > 1e-4:
        raise AssertionError(f"{cfg.name}: sealed f32 logits disagree")

    # one decode step's recurrence on the card against the CPU, f32
    kind = cfg.pattern[0]
    lp0 = {k: v[0] for k, v in params["blocks"][0][
        "rec" if kind == "rglru" else "ssd"].items()}
    gen = torch.Generator().manual_seed(args.seed + 42)
    if kind == "rglru":
        w = cfg.rglru_block_width
        xa = torch.randn((FAMILY_SLOTS, 1, w), generator=gen)
        h0 = torch.randn((FAMILY_SLOTS, w), generator=gen)
        fn = lambda p, *a: B.rglru_step(p, *a)
        ins = (xa, h0)
    else:
        h, ph, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        b = FAMILY_SLOTS
        ins = (torch.randn((b, h, ph), generator=gen),
               torch.rand((b, h), generator=gen) * 0.1,
               -torch.exp(lp0["A_log"].cpu()),
               torch.randn((b, n), generator=gen),
               torch.randn((b, n), generator=gen),
               torch.randn((b, h, ph, n), generator=gen))
        fn = lambda p, *a: B.ssd_step(*a)
    cpu_p = {k: v.cpu() for k, v in lp0.items()}
    want = fn(cpu_p, *ins)
    got = fn(lp0, *[t.to(dev) for t in ins])
    card_err = max(_rel_err(torch, g, w_) for g, w_ in zip(got, want))
    out["step_card_vs_cpu"] = card_err
    log(f"[family] {cfg.name} one {kind} decode step on the card vs the "
        f"CPU, f32: {card_err:.3e} of scale (gate 1e-5)")
    if card_err > 1e-5:
        raise AssertionError(f"{cfg.name}: the {kind} step on the card "
                             f"differs from the CPU")
    del lp, cp, ls, cs

    # the drains under ColoE, Counter and Direct, launches gated
    drains = {}
    tokens = None
    for mode in ("coloe", "counter", "direct"):
        if eng is None:
            eng = GroupServeEngine(cfg, params, seal=SealConfig(mode=mode),
                                   **kw)
        handles, launches, secs = _drive_counted(torch, eng, prompts,
                                                 arrivals)
        st = dict(eng.stats)
        disp = st["prefills"] + st["decode_steps"]
        if mode == "direct":
            want = _direct_launches(eng, disp, False)
        else:
            want = _chacha_launches(eng, disp, paged=False)
        want.update(_group_launch_want(torch, eng, prompts))
        _gate(f"{cfg.name} {mode}", {k: launches[k] for k in want}, want)
        toks_ = [h.out for h in handles]
        if tokens is None:
            tokens = toks_
        if mode == "direct":
            direct_tokens = toks_
        drains[mode] = {"launches": launches, "stats": st, "serve_s": secs,
                        "tokens_equal_coloe": toks_ == tokens}
        log(f"[family] {cfg.name} {mode} drain: {secs:.2f} s, "
            f"{st['prefills']} prefills + {st['decode_steps']} steps; "
            f"tokens equal to ColoE's: {toks_ == tokens}; launches "
            f"{_nonzero(launches)}")
        if mode == "coloe":      # timed at the largest group's shape
            gtoks = _group_tokens(torch, max(
                groups, key=lambda g: len(g) * max(map(len, g))), dev)
            timing = {"prefill": _time_each(torch, f"group prefill of "
                                             f"{tuple(gtoks.shape)}", {
                "sealed": lambda: T.prefill(cfg, eng.params(), gtoks,
                                            max_len)})}
            _, cache = T.prefill(cfg, eng.params(), gtoks, max_len)
            nxt = gtoks[:, -1:]
            timing["tick"] = _time_each(torch, "decode step", {
                "sealed": lambda: T.decode_step(cfg, eng.params(), cache,
                                                nxt, gtoks.shape[1])})
            timing["embed_unseal"] = _time_embed_unseal(torch, eng.sealed,
                                                        key)
            del cache
        eng = None
        gc.collect()
        torch.cuda.empty_cache()
    out["drains"] = drains

    plain = GroupServeEngine(cfg, params, seal=None, **kw)
    ph, plaunch, psecs = _drive_counted(torch, plain, prompts, arrivals)
    _gate(f"{cfg.name} plaintext", {k: plaunch[k] for k in FLASH_KERNELS}, {
        k: v for k, v in _group_launch_want(torch, plain, prompts).items()
        if k in FLASH_KERNELS})
    same = sum(a == b for h, g in zip(tokens, ph) for a, b in zip(h, g.out))
    total = sum(len(h) for h in tokens)
    out["greedy_agreement"] = same / total
    dsame = direct_tokens == [h.out for h in ph]
    log(f"[family] {cfg.name} plaintext drain {psecs:.2f} s; sealed greedy "
        f"tokens equal to plaintext: {same}/{total} (bf16; reported); "
        f"Direct's equal to plaintext: {dsame}")
    if not dsame:
        raise AssertionError(f"{cfg.name}: Direct tokens differ from "
                             f"plaintext")
    timing["prefill"].update(_time_each(torch, "group prefill", {
        "plaintext": lambda: T.prefill(cfg, plain.params(), gtoks,
                                       max_len)}))
    _, cache = T.prefill(cfg, plain.params(), gtoks, max_len)
    timing["tick"].update(_time_each(torch, "decode step", {
        "plaintext": lambda: T.decode_step(cfg, plain.params(), cache, nxt,
                                           gtoks.shape[1])}))
    del cache, plain, ph

    # the recurrences alone, by events, at the group prefill's shape
    if kind == "rglru":
        xa = torch.randn((gtoks.shape[0], gtoks.shape[1],
                          cfg.rglru_block_width), device=dev,
                         dtype=torch.bfloat16)
        a, b_ = B._rglru_coeffs(lp0, xa)
        ts = _time_stats(torch, lambda: B.linear_scan(a, b_), 5)
        nbytes = 3 * a.numel() * 4
        label = f"RG-LRU doubling scan over {tuple(a.shape)} f32"
        del xa, a, b_
    else:
        bb, s = gtoks.shape
        xh = torch.randn((bb, s, cfg.ssm_heads, cfg.ssm_head_dim),
                         device=dev)
        dt = torch.rand((bb, s, cfg.ssm_heads), device=dev) * 0.1
        A = -torch.exp(lp0["A_log"])
        Bm = torch.randn((bb, s, cfg.ssm_state), device=dev)
        Cm = torch.randn((bb, s, cfg.ssm_state), device=dev)
        ts = _time_stats(torch, lambda: B.ssd_chunked(xh, dt, A, Bm, Cm), 5)
        nbytes = 4 * (2 * xh.numel() + dt.numel() + Bm.numel() + Cm.numel())
        label = f"SSD chunked pass over x {tuple(xh.shape)} f32"
        del xh, dt, Bm, Cm
    b_ms, b_by = bound_ms(nbytes)
    timing["recurrence"] = {"what": label, "ms": ts["ms"],
                            "median_ms": ts["median_ms"],
                            "bound_ms": b_ms, "bound_by": b_by}
    log(f"[family] {cfg.name} {label}: {_stats_text(ts)}; bytes bound "
        f"{b_ms:.4f} ms")
    out["timing"] = timing
    out["peak_gib"] = _gib(torch.cuda.max_memory_allocated(dev))
    out["wall_s"] = time.time() - t_fam
    log(f"[family] {cfg.name}: decode step sealed "
        f"{timing['tick']['sealed']['ms']:.2f} / plaintext "
        f"{timing['tick']['plaintext']['ms']:.2f} ms, prefill sealed "
        f"{timing['prefill']['sealed']['ms']:.2f} / plaintext "
        f"{timing['prefill']['plaintext']['ms']:.2f} ms (events); peak "
        f"allocated {out['peak_gib']:.2f} GiB; {out['wall_s']:.1f} s")
    del params, lp0
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _family_flash(torch, dev, seed):
    """The flash kernel that ``_kernel`` names at this phase's bf16 prefill
    shapes (all on the tensor cores: 64 and 128 granite, deepseek; 256
    gemma2, RecurrentGemma), beside its bound and SDPA (causal only: SDPA
    takes no softcap, and a window only as a mask, so where those bind it
    is a yardstick, not the same function). At head dim 256 also the
    kernel with its grid forced to one q head a block and (an even group)
    to two, each bitwise equal to the kernel's own pick; the CUDA-core
    kernel, which ran there before ``flash_attention_tc256.cu``; and the
    plain version."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(seed + 43)
    scratch = torch.empty((64 * 2**20,), dtype=torch.int32, device=dev)
    flush = lambda: scratch.zero_()
    out = []
    shapes = [(f"{prefix} prefill {i + 1}", shape)
              for prefix, group in _family_attention(seed).items()
              for i, shape in enumerate(group)]
    for label, (b, s, hq, hkv, dh, win, cap) in shapes:
        q, k, v = _flash_inputs(torch, gen, dev, b, s, s, hq, hkv, dh,
                                torch.bfloat16)
        q = q.contiguous()
        kw = dict(scale=dh ** -0.5, softcap=cap, window=win)
        span = min(win, s) if win else s
        pairs = b * hq * sum(min(i + 1, span) for i in range(s))
        nbytes = 2 * (2 * b * s * hq * dh + 2 * b * s * hkv * dh)
        b_ms, b_by = bound_ms(nbytes, bf16_flops=4.0 * dh * pairs)
        lib_ms, lib_name, lib_all, _ = _time_sdpa(
            torch, F, q, k, v, dh ** -0.5, flush,
            FA.flash_attention_plain(q, k, v, scale=dh ** -0.5))
        kern = FA._kernel(q.dtype, dh)
        # (kernel, warpgroups: 0 for the kernel's own grid, launch)
        runs = [(kern, 0, {"flash_attention_tc": FA.flash_attention_tc_cuda,
                           "flash_attention_tc256":
                               FA.flash_attention_tc256_cuda}[kern])]
        plain_ms = None
        t0 = time.time()
        if dh == 256:
            even = (hq // hkv) % 2 == 0
            want = FA.flash_attention_tc256_cuda(q, k, v, **kw)
            for w in (1, 2) if even else (1,):
                launch = functools.partial(FA.flash_attention_tc256_cuda,
                                           warpgroups=w)
                if not torch.equal(launch(q, k, v, **kw), want):
                    raise AssertionError(f"flash_attention_tc256 at {label}:"
                                         f" the grid of {w} warpgroups "
                                         f"differs from the kernel's pick")
                runs.append((kern, w, launch))
            runs.append(("flash_attention", 0, FA.flash_attention_cuda))
            plain_ms = _time_ms(torch, lambda: FA.flash_attention_plain(
                q, k, v, **kw), 2)
            del want
        for name, w, launch in runs:
            ms = _time_ms(torch, lambda: launch(q, k, v, **kw), 5, flush)
            rec = {"shape": label, "kernel": name, "warpgroups": w, "b": b,
                   "s": s, "hq": hq, "hkv": hkv, "dh": dh, "window": win,
                   "softcap": cap, "ms": ms, "bound_ms": b_ms,
                   "bound_by": b_by, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "library": lib_name,
                   "library_backends_ms": lib_all}
            out.append(rec)
            grid = f" (grid forced: {w} warpgroups a block)" if w else ""
            log(f"[family] {name}{grid} {label} b={b} s={s} heads "
                f"{hq}/{hkv} dh={dh} window {win} softcap {cap} bf16: "
                f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                f"{b_ms / ms:.3f}), SDPA causal {lib_ms:.4f} ms ({lib_name}"
                f"; {lib_all})"
                + (f", plain {plain_ms:.3f} ms" if plain_ms else ""))
        if dh == 256:
            recs = out[-len(runs):]
            new_ms, old_ms = recs[0]["ms"], recs[-1]["ms"]
            log(f"[family] flash at {label} dh=256: tensor cores "
                f"{new_ms:.4f} ms (its own grid; "
                + ", ".join(f"forced {r['warpgroups']}: {r['ms']:.4f} ms"
                            for r in recs[1:-1])
                + f"), CUDA cores {old_ms:.4f} ms ({old_ms / new_ms:.1f}x), "
                f"SDPA causal {lib_ms:.4f} ms ({new_ms / lib_ms:.2f}x of "
                f"it), bound {b_ms:.4f} ms ({b_ms / new_ms:.3f} of the "
                f"kernel's time); the grids' check, the CUDA-core and "
                f"plain timings took {time.time() - t0:.2f} s")
        del q, k, v
    torch.cuda.empty_cache()
    return out


def _family_matmul(torch, dev, seed):
    """The fused matmul kernels at phase 11's new leaf shapes, SE 0.5 bf16:
    the decode kernel at a tick's M (4 slots) and the prefill kernel at
    the family's prefill M, each beside its bound."""
    from repro_torch.core.sealed_store import _pick_block
    from repro_torch.kernels import sealed_matmul as SMK
    gen = torch.Generator(device=dev).manual_seed(seed + 44)
    scratch = torch.empty((64 * 2**20,), dtype=torch.int32, device=dev)
    flush = lambda: scratch.zero_()
    rows = _family_prefill_rows(seed)
    out = []
    for name, (k, n) in _family_shapes().items():
        bk, bn = _pick_block(k), _pick_block(n)
        w, mask, key, nonce, ct, wcw = _sealed_operands(
            torch, dev, gen, k, n, 0.5, 5, bk, bn)
        enc = int(mask.sum())
        runs = [("sealed_matmul_dec", FAMILY_SLOTS)]
        if not name.endswith("head"):
            runs.append(("sealed_matmul_tc", max(rows[name.split("_")[0]])))
        for kern, m in runs:
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            launch = {"sealed_matmul_dec": SMK.sealed_matmul_dec_cuda,
                      "sealed_matmul_tc": SMK.sealed_matmul_tc_cuda}[kern]
            ms = _time_ms(torch, lambda: launch(
                x, ct, mask, key, nonce, wcw, bk=bk, bn=bn,
                compute_dtype="bfloat16"), 5, flush)
            b_ms, b_by = _sealed_bound(m, k, n, enc, 2)
            out.append({"kernel": kern, "leaf": name, "M": m, "K": k,
                        "N": n, "ms": ms, "bound_ms": b_ms,
                        "bound_by": b_by})
            log(f"[family] {kern} {name} M={m} K={k} N={n} SE 0.5 bf16: "
                f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                f"{b_ms / ms:.3f} of the kernel's time)")
            del x
        del w, ct
        torch.cuda.empty_cache()
    return out


def _family_attention(seed):
    """(b, s, hq, hkv, dh, window, softcap) of phase 11's bf16 one-shot
    prefills, by family prefix: granite's, gemma2's and deepseek's of the
    trace's first 4 prompts (GQA 32:8 at head dim 64; 256 with window and
    softcaps; GQA 64:8 at 128), RecurrentGemma's two groups (MQA 16:1 at
    256, the second past its window)."""
    from repro_torch.configs import get_config
    out = {}
    for prefix, arch, seed_off in (("granite", "granite_3_2b", 31),
                                   ("gemma2", "gemma2_2b", 31),
                                   ("deepseek", "deepseek_coder_33b", 31),
                                   ("rg", "recurrentgemma_9b", 41)):
        c = get_config(arch)
        p, _, _ = _family_trace(arch, seed + seed_off, c.vocab_size)
        groups = ([p[:FAMILY_SLOTS]] if prefix != "rg" else
                  [p[i:i + FAMILY_SLOTS]
                   for i in range(0, len(p), FAMILY_SLOTS)])
        out[prefix] = [(len(g), max(len(x) for x in g), c.heads_eff,
                        c.num_kv_heads, c.head_dim, c.window,
                        c.attn_softcap) for g in groups]
    return out


def _family_flash_cases(seed):
    """Phase 3's cases of ``_family_attention`` (as FLASH_CASES rows)."""
    return [(b, s, s, hq, hkv, dh, win, cap)
            for shapes in _family_attention(seed).values()
            for b, s, hq, hkv, dh, win, cap in shapes]


def phase_families(torch, dev, args):
    """Phase 11: the remaining token families at their published widths,
    random weights from ``--seed``, bf16 unless said, ColoE SE 0.5 fused.

    (a) granite-3-2b (10 of 40 layers), gemma2-2b (8 of 26; local/global
    attention with a 4096 window, softcaps 50/30, head dim 256, tied head)
    and deepseek-coder-33b (4 of its 62 layers; 56 query heads padded to
    64, GQA 8:1) through the continuous engine: the image sealed and
    unsealed bit for bit; f32 teacher-forced logits (a chunked prefill and
    a tick, a one-shot prefill and a step), sealed vs plaintext within
    1e-4 of scale; a staggered trace (4 slots, 8 requests of 64-200
    prompt tokens, 16 new) completing with each kernel's launches per
    dispatch as ``_variant`` predicts; a verified run with the same tokens
    and its MAC launches gated; greedy tokens against plaintext reported;
    granite and gemma2 also under Direct, tokens equal to plaintext.
    (b) RecurrentGemma-9B (6 of 39 layers: 2 super-blocks of RG-LRU,
    RG-LRU, local attention with a 2048 window, MQA 16:1, head dim 256)
    and Mamba2-130M (24 SSD layers) through the group engine: the image
    bit for bit; f32 prefill and 6 decode steps sealed vs plaintext within
    1e-4; one decode step's RG-LRU or SSD state update on the card against
    the CPU at 1e-5; drains under ColoE, Counter and Direct completing
    with their launches gated (Direct's tokens equal to the plaintext
    baseline's), and the plaintext baseline's.
    (c) Each family's decode tick (or group decode step) and prefill,
    sealed beside plaintext: events, host clock, the profiler's idle share
    and top kernels; the dense families' one-shot prefill once more with
    its flash launches gated; the tied models' per-dispatch unseal of the
    embedding; the RG-LRU scan and SSD chunked pass alone; flash at each
    prefill shape beside SDPA (at head dim 256 the tensor-core kernel
    beside the CUDA-core one and the plain version); each family's peak
    memory, and the phase's wall time. One model is held at a time."""
    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"held_before_gib": _gib(torch.cuda.memory_allocated(dev))}
    for arch, layers in FAMILY_DENSE:
        out[arch] = _dense_family(torch, dev, args, arch, layers)
    for arch, layers in FAMILY_RECURRENT:
        out[arch] = _recurrent_family(torch, dev, args, arch, layers)
    out["flash"] = _family_flash(torch, dev, args.seed)
    out["matmul"] = _family_matmul(torch, dev, args.seed)
    # the phase's launches: every gated run
    runs = []
    for arch, _ in FAMILY_DENSE + FAMILY_RECURRENT:
        fam = out[arch]
        runs += [fam[k] for k in ("launches", "verify_launches",
                                  "direct_launches", "prefill_launches")
                 if k in fam]
        runs += [d["launches"] for d in fam.get("drains", {}).values()]
    out["launches"] = {n: sum(r[n] for r in runs) for n in runs[0]}
    log(f"[family] flash launches over the phase's gated runs: "
        f"{ {k: out['launches'][k] for k in FLASH_KERNELS} }")
    if not out["launches"]["flash_attention_tc256"]:
        raise AssertionError("the dh-256 tensor-core flash kernel ran no "
                             "time on phase 11's main path")
    out["wall_s"] = time.time() - t_phase
    log(f"[family] phase 11: {out['wall_s']:.1f} s; peak allocated by "
        f"family (GiB): "
        + ", ".join(f"{a} {out[a]['peak_gib']:.2f}"
                    for a, _ in FAMILY_DENSE + FAMILY_RECURRENT))
    return out


# --------------------------------------------------------------------------
# phase 12: the paper's CNNs, the SE-substitute attacks, per-layer timings
# --------------------------------------------------------------------------

CNN_IDS = ("vgg16", "resnet18", "resnet34")
# the protocol's training batch, at the CIFAR geometry of config()
CNN_BATCH = 128
# (a)'s batch: five gradient passes, three of them on the host
CNN_PARITY_BATCH = 32
# the networks run through the full security protocol
CNN_PROTOCOL = ("resnet18", "vgg16")
CNN_RATIOS = (0.2, 0.5, 0.8)
# card vs CPU: both f32 (TF32 off), only the order of sums differs
CNN_TOL = 1e-4
# prng.normal on the card vs the CPU (the same f64 arithmetic; the
# tolerance it is held to against jax.random.normal)
NORMAL_TOL = 1e-6
# train_cnn's default learning rate (2e-2, as the reference's) collapses the
# published widths to one class; the victim is also trained at this rate,
# which learns, and gated on this test accuracy
CNN_LEARNING_LR = 1e-3
CNN_LEARNING_ACC = 0.5
# VGG-16's Figure-4 geometry: image size and batch of the layer timings
FIG4_IMG, FIG4_BATCH = 224, 16
CNN_TIMING_ITERS = 20


def _kink_forward(torch, C, cfg, params, x, pins=None):
    """``cnn_forward`` with its two kinds of kink made explicit: every ReLU
    a multiply by a mask, every max pool a gather at argmax indices. With
    ``pins`` None each mask and index comes from this pass's own values,
    and the pass computes ``cnn_forward``'s function with its gradients;
    given another pass's decisions, it takes those. Returns the logits and
    the pass's decisions, each (mask or indices, the detached tensor it
    was taken from)."""
    import torch.nn.functional as F
    made = []

    def relu(h):
        m = (h > 0) if pins is None else pins[len(made)][0]
        made.append((m, h.detach()))
        return h * m

    def pool(h):
        # NHWC throughout, as max_pool's channels_last tensors are
        (hl, hh), (wl, wh) = (C.same_pads(h.shape[1], 2, 2),
                              C.same_pads(h.shape[2], 2, 2))
        if hh or wh:
            h = F.pad(h, (0, 0, wl, wh, hl, hh), value=float("-inf"))
        if pins is None:    # indices into each (n, c) plane's H x W
            idx = F.max_pool2d(h.detach().permute(0, 3, 1, 2), 2, 2,
                               return_indices=True)[1].permute(0, 2, 3, 1)
        else:
            idx = pins[len(made)][0]
        made.append((idx, h.detach()))
        n, ho, wo, c = idx.shape
        return h.reshape(n, -1, c).gather(1, idx.reshape(n, -1, c)).view(
            n, ho, wo, c)

    i, n, flat, stages = 0, len(cfg.stages), None, cfg.stages
    while i < n:
        sp, p = stages[i], params[i]
        if sp.kind == "conv" and sp.residual:
            sp2, p2 = stages[i + 1], params[i + 1]
            h = C.conv2d(x, p["w"], sp.stride) + p["b"]
            h = relu(C.chan_ln(h, p["ln_s"], p["ln_b"]))
            h = C.conv2d(h, p2["w"], sp2.stride) + p2["b"]
            h = C.chan_ln(h, p2["ln_s"], p2["ln_b"])
            skip = x if "proj" not in p else C.conv2d(x, p["proj"], sp.stride)
            x = relu(h + skip)
            i += 2
        elif sp.kind == "conv":
            h = C.conv2d(x, p["w"], sp.stride) + p["b"]
            x = relu(C.chan_ln(h, p["ln_s"], p["ln_b"]))
            i += 1
        elif sp.kind == "pool":
            x = pool(x)
            i += 1
        else:
            if flat is None:
                flat = x.mean(dim=(1, 2))
            flat = flat @ p["w"] + p["b"]
            if i < n - 1:
                flat = relu(flat)
            i += 1
    return flat, made


def _cnn_grads(torch, C, cfg, p_cpu, x, y, dev, pins="port"):
    """Logits, loss and the gradients (every parameter, then the input) on
    ``dev`` from the CPU's initial weights: through the port's
    ``cnn_loss`` (``pins`` "port"), or ``_kink_forward`` under ``pins``
    (None: its own decisions). Returns (tensors, names, decisions)."""
    params = [{k: v.detach().to(dev).requires_grad_(True)
               for k, v in p.items()} for p in p_cpu]
    leaves = flatten_paths(params)
    xt = torch.from_numpy(x).to(dev).requires_grad_(True)
    yt = torch.from_numpy(y).to(dev).long()
    made = None
    if pins == "port":
        loss = C.cnn_loss(cfg, params, {"x": xt, "y": yt})[0]
        with torch.no_grad():
            logits = C.cnn_forward(cfg, params, xt)
    else:
        logits, made = _kink_forward(torch, C, cfg, params, xt, pins)
        loss = (torch.logsumexp(logits, dim=-1)
                - logits.gather(-1, yt[:, None])[:, 0]).mean()
    grads = torch.autograd.grad(loss, [t for _, t in leaves] + [xt])
    names = ["logits", "loss"] + [f"d/d {p}" for p, _ in leaves] + ["d/d x"]
    return [logits.detach(), loss.detach()] + list(grads), names, made


def _cnn_parity(torch, dev, cid, seed):
    """(a): init, logits, loss, gradients and SE masks, card vs CPU.

    The gradients of ReLU and max pool jump where an input crosses zero or
    a window's two largest values cross; the card's and the CPU's sums
    round differently, so an input within rounding of such a kink can fall
    on either side on either device (a few units a layer at full width).
    So the card's gradients (through ``cnn_loss``) are held at 1e-4 of
    scale to the CPU's computed under the card's own ReLU masks and pool
    indices (``_kink_forward``), each differing decision is checked to lie
    within 1e-5 of its layer's scale of its kink on the CPU, and
    ``_kink_forward`` is checked against ``cnn_loss`` on both devices (at a
    tenth of the tolerance: they differ only in memory layouts). The
    unpinned gradient differences are reported."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.criticality import cnn_channel_masks
    from repro_torch.data.synthetic import image_dataset
    from repro_torch.models import cnn as C
    cfg = get_config(cid)
    t0 = time.time()
    p_cpu = C.init_cnn(cfg, prng.key(seed), device="cpu")
    p_dev = C.init_cnn(cfg, prng.key(seed), device=dev)
    init_rel, equal, total = 0.0, 0, 0
    for (path, a), (_, b) in zip(flatten_paths(p_cpu), flatten_paths(p_dev)):
        b = b.cpu()
        rel = ((b.double() - a.double()).abs()
               / a.double().abs().clamp_min(1e-30)).max()
        init_rel = max(init_rel, float(rel))
        equal += int((a == b).sum())
        total += a.numel()
    if init_rel > NORMAL_TOL:
        raise AssertionError(f"{cid}: init_cnn on the card is {init_rel:.3g} "
                             f"relative from the CPU's")
    mask_rows = {}
    for r in CNN_RATIOS:
        want = cnn_channel_masks(cfg, p_cpu, r)
        got = cnn_channel_masks(cfg, [{k: v.to(dev) for k, v in p.items()}
                                      for p in p_cpu], r)
        bad = [i for i in want if not torch.equal(got[i].cpu(), want[i])]
        if bad:
            raise AssertionError(f"{cid}: SE masks at ratio {r} differ at "
                                 f"stages {bad}")
        mask_rows[r] = sum(int(m.sum()) for m in want.values())

    def errs(got, want):
        return [_rel_err(torch, g, w) for g, w in zip(got, want)]

    x, y = image_dataset(CNN_PARITY_BATCH, img=cfg.img_size, seed=seed)
    card, names, _ = _cnn_grads(torch, C, cfg, p_cpu, x, y, dev)
    cpu, _, _ = _cnn_grads(torch, C, cfg, p_cpu, x, y, "cpu")
    card_own, _, card_pins = _cnn_grads(torch, C, cfg, p_cpu, x, y, dev,
                                        None)
    cpu_own, _, cpu_pins = _cnn_grads(torch, C, cfg, p_cpu, x, y, "cpu",
                                      None)
    pinned, _, _ = _cnn_grads(
        torch, C, cfg, p_cpu, x, y, "cpu",
        [(m.cpu(), t.cpu()) for m, t in card_pins])
    # _kink_forward under its own decisions is cnn_loss's function
    oracle = [max(errs(card_own, card)), max(errs(cpu_own, cpu))]
    log(f"[cnn] {cid}: _kink_forward under its own decisions vs cnn_loss: "
        f"card {oracle[0]:.3g}, CPU {oracle[1]:.3g} of scale")
    if max(oracle) > CNN_TOL / 10:
        raise AssertionError(f"{cid}: _kink_forward is {max(oracle):.3g} of "
                             f"scale from cnn_loss")
    # every decision the devices take differently lies at its kink
    flips, worst_kink = [], 0.0
    for (mc, tc), (md, _) in zip(cpu_pins, card_pins):
        md = md.cpu()
        scale = float(tc[torch.isfinite(tc)].abs().max())
        if mc.dtype == torch.bool:        # a ReLU: |input| at the flips
            diff = mc != md
            gap = float(tc[diff].abs().max()) if diff.any() else 0.0
        else:                             # a pool: the two maxima's gap
            diff = mc != md
            n, c = tc.shape[0], tc.shape[-1]
            flat = tc.reshape(n, -1, c)
            va = flat.gather(1, mc.reshape(n, -1, c))
            vb = flat.gather(1, md.reshape(n, -1, c))
            gap = float((va - vb).abs().max())
        flips.append(int(diff.sum()))
        worst_kink = max(worst_kink, gap / scale)
    if worst_kink > 1e-5:
        raise AssertionError(f"{cid}: a ReLU or pool decision differs at "
                             f"{worst_kink:.3g} of its scale from its kink")
    plain, held = errs(card, cpu), errs(card, pinned)
    worst = max(range(len(held)), key=held.__getitem__)
    if max(plain[:2]) > CNN_TOL or held[worst] > CNN_TOL:
        raise AssertionError(
            f"{cid}: card vs CPU logits {plain[0]:.3g}, loss {plain[1]:.3g},"
            f" {names[worst]} {held[worst]:.3g} of scale under the card's "
            f"decisions")
    top = sorted(range(len(plain)), key=plain.__getitem__)[-3:]
    out = {"init_max_rel": init_rel, "init_equal_share": equal / total,
           "params": total, "logits_rel": plain[0], "loss_rel": plain[1],
           "max_rel_pinned": held[worst], "worst_pinned": names[worst],
           "max_rel_unpinned": plain[top[-1]], "worst_unpinned":
           names[top[-1]], "input_grad_rel_unpinned": plain[-1],
           "decisions_differing": flips, "kink_gap": worst_kink,
           "oracle_rel": oracle, "encrypted_rows": mask_rows,
           "s": time.time() - t0}
    log(f"[cnn] {cid} ({total:,} params) card vs CPU: init within "
        f"{init_rel:.3g} relative ({total - equal} of {total:,} values not "
        f"bitwise equal); SE "
        f"masks equal at {CNN_RATIOS} (encrypted rows {mask_rows}); logits "
        f"{plain[0]:.3g}, loss {plain[1]:.3g} of scale; under the card's "
        f"ReLU and pool decisions every gradient within {held[worst]:.3g} "
        f"({names[worst]}); {sum(flips)} decisions differ ({flips}), each "
        f"within {worst_kink:.3g} of its scale of the kink; unpinned "
        + ", ".join(f"{names[i]} {plain[i]:.3g}" for i in top)
        + f"; {out['s']:.1f} s")
    return out


def _cnn_protocol(torch, dev, cid, seed):
    """(b): the security protocol at full width, gated."""
    import dataclasses
    import math
    from repro_torch.configs import get_config
    from repro_torch.core.security.evaluate import evaluate_config
    rec = {}
    cfg = get_config(cid)
    t0 = time.time()
    rep = evaluate_config(cid, cfg, seed=seed, device=dev, record=rec)
    wall = time.time() - t0
    victim = rec["victim"]
    plain_rows = {}
    for r, (init, masks, sub) in rec["se"].items():
        plain_rows[r] = 0
        for i, m in masks.items():
            w = victim[i]["w"]
            enc = (m[None, None, :, None] if w.ndim == 4
                   else m[:, None]).expand_as(w)
            if not torch.equal(init[i]["w"][~enc], w[~enc]):
                raise AssertionError(f"{cid} SE({r}): stage {i}'s plaintext "
                                     f"rows differ from the victim's at init")
            if not torch.equal(sub[i]["w"][~enc], w[~enc]):
                raise AssertionError(f"{cid} SE({r}): stage {i}'s plaintext "
                                     f"rows moved in training")
            if torch.equal(sub[i]["w"][enc], w[enc]):
                raise AssertionError(f"{cid} SE({r}): stage {i}'s learnt "
                                     f"rows equal the victim's")
            if torch.equal(sub[i]["w"][enc], init[i]["w"][enc]):
                raise AssertionError(f"{cid} SE({r}): stage {i}'s learnt "
                                     f"rows did not move in training")
            plain_rows[r] += int((~m).sum())
    rates = ([rep.victim_acc, rep.white_acc, rep.black_acc,
              rep.white_transfer, rep.black_transfer]
             + list(rep.se_acc.values()) + list(rep.se_transfer.values()))
    if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in rates):
        raise AssertionError(f"{cid}: a rate outside [0, 1]: {rep}")
    # the victim's mean loss over its first training batch (ln 10 = 2.3026
    # for a network that predicts every class alike)
    from repro_torch.data.synthetic import image_dataset
    from repro_torch.models import cnn as C
    xb, yb = image_dataset(CNN_BATCH, img=cfg.img_size, seed=seed, noise=0.45)
    with torch.no_grad():
        victim_loss = float(C.cnn_loss(cfg, victim, {
            "x": torch.from_numpy(xb).to(dev),
            "y": torch.from_numpy(yb).to(dev)})[0])
    witness = _cnn_witness(torch, dev, cid, seed, victim)
    log(f"[cnn] {cid} protocol at full width: {rep}; the victim's loss on "
        f"its first {CNN_BATCH} images {victim_loss:.4f}")
    log(f"[cnn] {cid} training runs (s, device work included): "
        + ", ".join(f"{k} {v:.2f}" for k, v in rec["train_s"].items())
        + f"; plaintext rows by ratio {plain_rows}; protocol {wall:.1f} s")
    report = dataclasses.asdict(rep)
    for k in ("se_acc", "se_transfer"):
        report[k] = {str(r): v for r, v in report[k].items()}
    return {"report": report, "train_s": rec["train_s"], "wall_s": wall,
            "plain_rows": {str(r): n for r, n in plain_rows.items()},
            "victim_loss": victim_loss, "witness": witness}


def _victim_data(cfg, seed):
    """The protocol's victim training set, test set and epochs, as
    ``evaluate_config``'s defaults make them."""
    import inspect
    from repro_torch.core.security.evaluate import evaluate_config
    from repro_torch.data.synthetic import image_dataset
    d = {k: v.default for k, v in
         inspect.signature(evaluate_config).parameters.items()}
    n_train = d["n_train"]
    x, y = image_dataset(n_train + d["n_test"], img=cfg.img_size, seed=seed,
                         noise=0.45)
    n_vic = int(0.9 * n_train)
    return x[:n_vic], y[:n_vic], x[n_train:], y[n_train:], d["epochs"]


def _cnn_victim_lr(torch, dev, cid, seed):
    """(d): the protocol's victim trained at full width with ``train_cnn``
    at ``CNN_LEARNING_LR`` instead of its default 2e-2 (the protocol's
    data split, epochs and batch), gated on test accuracy of at least
    ``CNN_LEARNING_ACC``."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.security import attacks as A
    from repro_torch.models import cnn as C
    cfg = get_config(cid)
    xv, yv, xte, yte, epochs = _victim_data(cfg, seed)
    t0 = time.time()
    victim = A.train_cnn(cfg, C.init_cnn(cfg, prng.key(seed), device=dev),
                         xv, yv, epochs=epochs, lr=CNN_LEARNING_LR,
                         device=dev)
    acc = A.accuracy(cfg, victim, xte, yte, device=dev)
    wall = time.time() - t0
    log(f"[cnn] {cid} victim at lr {CNN_LEARNING_LR:g}: test accuracy "
        f"{acc:.4f} ({wall:.1f} s)")
    if acc < CNN_LEARNING_ACC:
        raise AssertionError(f"{cid}: the victim at lr {CNN_LEARNING_LR:g} "
                             f"reaches only {acc:.4f} test accuracy")
    return {"lr": CNN_LEARNING_LR, "test_acc": acc, "s": wall}


def _plain_cnn(torch, cfg, params):
    """The witness's network: an independent plain PyTorch statement of the
    reference's forward and loss (NCHW through ``torch.nn.functional``;
    OIHW and (out, in) copies of ``params``; its own "SAME" pads;
    ``layer_norm`` over channels; ``max_pool2d`` in ceil mode, whose
    windows past the edge hold -inf; ``cross_entropy``). Returns
    (loss(x, y), logits(x), its leaves), x NHWC as the port's."""
    import torch.nn.functional as F
    ws = [{k: (v.detach().permute(3, 2, 0, 1) if v.ndim == 4
               else v.detach().t() if k == "w" else v.detach())
           .contiguous().clone().requires_grad_(True)
           for k, v in p.items()} for p in params]

    def conv(h, p, stride, w="w"):
        k, n = p[w].shape[-1], h.shape[-1]
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        h = F.pad(h, (total // 2, total - total // 2) * 2)
        return F.conv2d(h, p[w], p["b"] if w == "w" else None, stride)

    def norm(h, p):
        return F.layer_norm(h.permute(0, 2, 3, 1), (h.shape[1],), p["ln_s"],
                            p["ln_b"], 1e-5).permute(0, 3, 1, 2)

    def logits(x):
        h, flat, i, st = x.permute(0, 3, 1, 2), None, 0, cfg.stages
        while i < len(st):
            sp, p = st[i], ws[i]
            if sp.kind == "conv" and sp.residual:
                z = F.relu(norm(conv(h, p, sp.stride), p))
                z = norm(conv(z, ws[i + 1], st[i + 1].stride), ws[i + 1])
                skip = h if "proj" not in p else conv(h, p, sp.stride, "proj")
                h = F.relu(z + skip)
                i += 2
            elif sp.kind == "conv":
                h = F.relu(norm(conv(h, p, sp.stride), p))
                i += 1
            elif sp.kind == "pool":
                h = F.max_pool2d(h, 2, 2, ceil_mode=True)
                i += 1
            else:
                if flat is None:
                    flat = h.mean(dim=(2, 3))
                flat = F.linear(flat, p["w"], p["b"])
                if i < len(st) - 1:
                    flat = F.relu(flat)
                i += 1
        return flat

    return (lambda x, y: F.cross_entropy(logits(x), y), logits,
            [t for q in ws for t in q.values()])


def _top_share(torch, fwd, x, dev):
    """Test accuracy's companion: the share of ``x`` given the most
    predicted class by ``fwd``."""
    with torch.no_grad():
        pred = torch.cat([fwd(torch.from_numpy(x[i:i + 256]).to(dev))
                          .argmax(-1) for i in range(0, len(x), 256)])
    return float(torch.bincount(pred).max()) / len(x), pred.cpu().numpy()


def _cnn_witness(torch, dev, cid, seed, victim):
    """(e): a second witness to the protocol's victim at full width. The
    port's ``sgd_step`` and ``_plain_cnn`` under ``torch.optim.SGD``
    (momentum 0.9) train from the same init on the same batches in the
    same order at ``train_cnn``'s default learning rate and schedule; the
    first epoch's losses of both are printed, the first step's gated at
    ``CNN_TOL``. The plain run goes on for all of the victim's epochs; its
    test accuracy and most predicted class's share are printed beside
    those of the protocol's victim (``victim``)."""
    import inspect
    import numpy as np
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.security import attacks as A
    from repro_torch.models import cnn as C
    cfg = get_config(cid)
    xv, yv, xte, yte, epochs = _victim_data(cfg, seed)
    lr = inspect.signature(A.train_cnn).parameters["lr"].default
    xs, ys = torch.from_numpy(xv).to(dev), torch.from_numpy(yv).to(dev).long()
    init = C.init_cnn(cfg, prng.key(seed), device=dev)
    loss_fn, logits_fn, leaves = _plain_cnn(torch, cfg, init)
    opt = torch.optim.SGD(leaves, lr=lr, momentum=0.9)
    port_step = A.sgd_step(cfg, init)
    rng = np.random.RandomState(seed)
    t0 = time.time()
    port, plain = [], []
    for ep in range(epochs):
        perm = torch.from_numpy(rng.permutation(len(xv))).to(dev)
        cur = lr * 0.5 ** (ep // 5)
        for g in opt.param_groups:
            g["lr"] = cur
        for s in range(len(xv) // CNN_BATCH):
            idx = perm[s * CNN_BATCH:(s + 1) * CNN_BATCH]
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(xs[idx], ys[idx])
            loss.backward()
            opt.step()
            if ep == 0:
                plain.append(float(loss.detach()))
                port.append(float(port_step(xs[idx], ys[idx], cur)))
    wall = time.time() - t0
    first = abs(port[0] - plain[0]) / abs(plain[0])
    if first > CNN_TOL:
        raise AssertionError(f"{cid}: the witness's first loss {plain[0]} is "
                             f"{first:.3g} relative from the port's {port[0]}")
    share, pred = _top_share(torch, logits_fn, xte, dev)
    acc = float((pred == yte).mean())
    vshare, vpred = _top_share(
        torch, lambda b: C.cnn_forward(cfg, victim, b), xte, dev)
    out = {"lr": lr, "port_epoch1": port, "plain_epoch1": plain,
           "first_rel": first, "plain_acc": acc, "plain_top_share": share,
           "victim_acc": float((vpred == yte).mean()),
           "victim_top_share": vshare, "s": wall}
    log(f"[cnn] {cid} witness at lr {lr:g}: first epoch's losses, port "
        f"{[round(v, 4) for v in port]}, plain {[round(v, 4) for v in plain]}"
        f" (first step {first:.3g} apart); after {epochs} epochs the plain "
        f"run's test accuracy {acc:.4f}, most predicted class {share:.4f} of "
        f"the test set; the protocol's victim {out['victim_acc']:.4f}, "
        f"{vshare:.4f}; {wall:.1f} s")
    return out


def _cnn_step(torch, dev, cid, seed, flush):
    """(c): one train_cnn step (forward, backward, update) at batch 128,
    beside the least time of its f32 work (3 x the forward's MACs: the
    forward, the input gradients and the weight gradients)."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.security import attacks as A
    from repro_torch.data.synthetic import image_dataset
    from repro_torch.models import cnn as C
    cfg = get_config(cid)
    params = C.init_cnn(cfg, prng.key(seed), device=dev)
    step = A.sgd_step(cfg, params)
    x, y = image_dataset(CNN_BATCH, img=cfg.img_size, seed=seed)
    bx = torch.from_numpy(x).to(dev)
    by = torch.from_numpy(y).to(dev).long()
    st = _time_stats(torch, lambda: step(bx, by, 2e-2), CNN_TIMING_ITERS,
                     flush)
    macs = CNN_BATCH * sum(t["macs"] for t in C.layer_traffic(cfg)
                           if t["kind"] != "pool")
    bound, by_ = bound_ms(0, f32_flops=3 * 2 * macs)
    log(f"[cnn] {cid} train step, batch {CNN_BATCH}: median "
        f"{st['median_ms']:.3f} ms, {_stats_text(st)}; bound {bound:.3f} ms "
        f"({by_}; {3 * 2 * macs / 1e9:.1f} GFLOP)")
    return {"median_ms": st["median_ms"], "ms": st["ms"],
            "host_past_sleep": st["host_past_sleep"], "bound_ms": bound,
            "gflop": 3 * 2 * macs / 1e9}


def _vgg_layers(torch, dev, seed, flush):
    """(c): VGG-16's forward at the Figure-4 geometry, layer by layer (the
    layer as ``cnn_forward`` runs it: conv + bias + channel norm + ReLU, a
    pool, an FC; and the conv alone), each beside ``layer_traffic``'s bytes
    (weights once, feature maps a batch) and 2 x MACs over the f32 peak."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import image_dataset
    from repro_torch.models import cnn as C
    cfg = get_config("vgg16").with_(img_size=FIG4_IMG)
    params = C.init_cnn(cfg, prng.key(seed), device=dev)
    traffic = C.layer_traffic(cfg)
    x = torch.from_numpy(image_dataset(FIG4_BATCH, img=FIG4_IMG,
                                       seed=seed)[0]).to(dev)
    rows, h, flat = [], x, None
    median = lambda fn: _time_stats(torch, fn, CNN_TIMING_ITERS,
                                    flush)["median_ms"]
    with torch.no_grad():
        whole = median(lambda: C.cnn_forward(cfg, params, x))
        for i, (sp, p, t) in enumerate(zip(cfg.stages, params, traffic)):
            conv_ms = None
            if sp.kind == "conv":
                def layer(h=h, p=p, sp=sp):
                    z = C.conv2d(h, p["w"], sp.stride) + p["b"]
                    return torch.relu(C.chan_ln(z, p["ln_s"], p["ln_b"]))
                conv_ms = median(lambda h=h, p=p, sp=sp:
                                 C.conv2d(h, p["w"], sp.stride))
            elif sp.kind == "pool":
                layer = lambda h=h: C.max_pool(h)
            else:
                if flat is None:
                    flat = h.mean(dim=(1, 2))
                last = i == len(cfg.stages) - 1
                def layer(f=flat, p=p, last=last):
                    z = f @ p["w"] + p["b"]
                    return z if last else torch.relu(z)
            ms = median(layer)
            nbytes = t["weight_bytes"] + FIG4_BATCH * (t["in_fm_bytes"]
                                                       + t["out_fm_bytes"])
            flops = 2 * FIG4_BATCH * t["macs"]
            bound, by_ = bound_ms(nbytes, f32_flops=flops)
            rows.append({"stage": i, "kind": t["kind"], "in_ch": t["in_ch"],
                         "out_ch": t["out_ch"], "bytes": nbytes,
                         "flops": flops, "ms": ms, "conv_ms": conv_ms,
                         "bound_ms": bound, "bound_by": by_})
            log(f"[cnn] vgg16 {FIG4_IMG}px x{FIG4_BATCH} stage {i:2d} "
                f"{t['kind']:4s} {t['in_ch']:3d}->{t['out_ch']:3d}: layer "
                f"{ms:.4f} ms"
                + (f" (conv {conv_ms:.4f})" if conv_ms is not None else "")
                + f", bound {bound:.4f} ({by_}; {nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.2f} GFLOP), {bound / ms:.2f} of it")
            if sp.kind == "fc":
                flat = layer()
            else:
                h = layer()
    total_bound = sum(r["bound_ms"] for r in rows)
    log(f"[cnn] vgg16 {FIG4_IMG}px x{FIG4_BATCH} forward: {whole:.3f} ms "
        f"whole, layers {sum(r['ms'] for r in rows):.3f}, bound "
        f"{total_bound:.3f}")
    return {"forward_ms": whole, "layers": rows, "bound_ms": total_bound}


def phase_cnn(torch, dev, args):
    """Phase 12: the paper's CNNs at their published widths (module
    docstring, 12)."""
    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"parity": {c: _cnn_parity(torch, dev, c, args.seed)
                      for c in CNN_IDS},
           "protocol": {c: _cnn_protocol(torch, dev, c, args.seed)
                        for c in CNN_PROTOCOL},
           "victim_lr": {c: _cnn_victim_lr(torch, dev, c, args.seed)
                         for c in CNN_PROTOCOL}}
    scratch = torch.empty((64 * 2**20,), dtype=torch.int32, device=dev)
    flush = lambda: scratch.zero_()           # 256 MB > the 50 MB L2
    out["step"] = {c: _cnn_step(torch, dev, c, args.seed, flush)
                   for c in CNN_IDS}
    out["vgg_layers"] = _vgg_layers(torch, dev, args.seed, flush)
    out["peak_gib"] = _gib(torch.cuda.max_memory_allocated(dev))
    out["wall_s"] = time.time() - t_phase
    log(f"[cnn] phase 12: {out['wall_s']:.1f} s; peak allocated "
        f"{out['peak_gib']:.2f} GiB")
    return out


# --------------------------------------------------------------------------
# phase 13: training — the step, AdamW, the loop, sealed checkpoints
# --------------------------------------------------------------------------

TRAIN_ARCH = "internlm2_1_8b"
# (b): internlm2-1.8B at full width, all 24 layers
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 512, 2, 12
# (b)'s gate on learning: the mean of the last 3 losses below the first by
# at least this many nats (PERF.md §6 holds the prediction it comes from)
TRAIN_LOSS_DROP = 1.0
# (c) and (d): 2 of internlm2's 24 layers at full width
TRAIN_CUT_LAYERS = 2
CKPT_STEPS, CKPT_EVERY = 6, 3
# (e): the frontend-stub architectures at their published widths
FRONTEND_ARCHS = ("internvl2_1b", "musicgen_medium")
FRONTEND_BATCH, FRONTEND_SEQ, FRONTEND_STEPS = 4, 512, 3
# (a) and (c), card vs CPU in f32: only the order of sums differs
TRAIN_REL = 1e-5          # loss, ce, aux, grad_norm
TRAIN_GRAD_TOL = 1e-4     # of each tensor's scale (gradients, params)
TRAIN_SHARE = 0.999       # params within TRAIN_GRAD_TOL of scale, of the
                          # elements whose step rounding cannot move
                          # (``_step_gates``)
# AdamW reads params, m, v and the gradient once and writes params, m, v
ADAMW_PASSES = 7


def _train_tc(**kw):
    from repro_torch.config import TrainConfig
    return TrainConfig(**kw)


def _host_leaves(torch, tree):
    """[(path, f32 CPU tensor)] of a tree of tensors."""
    return [(p, t.detach().float().cpu()) for p, t in flatten_paths(tree)]


def _step_gates(torch, label, cpu, card, eps):
    """(a)'s gates: card against CPU. ``cpu`` and ``card``: (grads, params
    after the step, metrics, step count), the trees as ``_host_leaves``.
    Raises past a gate; returns the worst of each measure."""
    g_cpu, p_cpu, m_cpu, s_cpu = cpu
    g_dev, p_dev, m_dev, s_dev = card
    if s_cpu != 1 or s_dev != 1:
        raise AssertionError(f"[train] {label}: step count {s_dev}/{s_cpu}")
    out = {"metric_rel": {}, "accuracy": (m_dev["accuracy"],
                                          m_cpu["accuracy"])}
    for k in ("loss", "ce", "aux", "grad_norm"):
        rel = abs(m_dev[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30)
        out["metric_rel"][k] = rel
        if not rel <= TRAIN_REL:
            raise AssertionError(f"[train] {label}: {k} {m_dev[k]} on the "
                                 f"card, {m_cpu[k]} on the CPU ({rel:.2e})")
    worst_g = 0.0
    for (path, want), (path2, got) in zip(g_cpu, g_dev):
        assert path == path2
        err = float((got - want).abs().max() / want.abs().max().clamp(
            min=1e-30))
        worst_g = max(worst_g, err)
        if not err <= TRAIN_GRAD_TOL:
            raise AssertionError(f"[train] {label}: gradient of {path} "
                                 f"{err:.2e} of its scale")
    lr = m_cpu["lr"]
    worst_p, least_share, least_all, near0 = 0.0, 1.0, 1.0, 0
    grads = dict(g_cpu)
    for (path, want), (path2, got) in zip(p_cpu, p_dev):
        assert path == path2
        tol = TRAIN_GRAD_TOL * float(want.abs().max())
        diff = (got - want).abs()
        worst_p = max(worst_p, float(diff.max()) / (2 * lr + tol))
        within = diff <= tol
        least_all = min(least_all, float(within.float().mean()))
        # AdamW's first step is lr * g / (|g| + eps), whose slope in g is
        # lr * eps / (|g| + eps)^2: where the gradient gate's allowance
        # (TRAIN_GRAD_TOL of the gradient's scale) can move the step by
        # more than tol, g is within rounding of 0 and the two devices'
        # steps may part by up to 2 lr. The share counts the other elements
        # and those whose gradient is exactly 0 (a token absent from the
        # batch: 0 on both)
        g = grads[path].abs()
        slack = TRAIN_GRAD_TOL * float(g.max())
        far = (g == 0) | (lr * eps * slack / (g + eps) ** 2 <= tol)
        near0 += int((~far).sum())
        share = float(within[far].float().mean()) if bool(far.any()) else 1.0
        least_share = min(least_share, share)
        if not (float(diff.max()) <= 2 * lr + tol and share >= TRAIN_SHARE):
            raise AssertionError(
                f"[train] {label}: {path} after the step: max diff "
                f"{float(diff.max()):.3e} (2 lr + tol = {2 * lr + tol:.3e}), "
                f"{share:.5f} of the elements whose gradient is not near 0 "
                f"within tol")
    out.update(grad_err=worst_g, param_err=worst_p, param_share=least_share,
               param_share_all=least_all, near0=near0)
    log(f"[train] {label}: card vs CPU, loss {m_dev['loss']:.6f} / "
        f"{m_cpu['loss']:.6f}, metrics rel "
        + ", ".join(f"{k} {v:.1e}" for k, v in out["metric_rel"].items())
        + f"; gradients {worst_g:.2e} of scale; params after the step "
        f"{worst_p:.3f} of (2 lr + 1e-4 scale), least share within 1e-4 "
        f"scale {least_share:.5f} ({least_all:.5f} counting the {near0} "
        f"elements whose gradient is within rounding of 0); accuracy "
        f"{m_dev['accuracy']:.4f} / "
        f"{m_cpu['accuracy']:.4f}")
    return out


def _train_parity(torch, dev, cfg, seed, label):
    """One ``make_train_step`` step (microbatches 2, remat ``"full"``,
    batch 4, seq 16 of ``lm_batch``) and ``make_grad_fn``'s full-batch
    gradients, on the card and on the CPU from the same params, held to
    (a)'s gates."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_grad_fn, make_train_step
    from repro_torch.tree import map_leaves
    tc = _train_tc(microbatches=2, remat="full", total_steps=10)
    t0 = time.time()
    nb = lm_batch(cfg, 4, 16, seed)
    res = {}
    for name, where in (("cpu", torch.device("cpu")), ("card", dev)):
        params = T.init_params(cfg, seed, "cpu")
        if where.type == "cuda":
            params = map_leaves(lambda t: t.to(where), params)
        batch = {k: torch.from_numpy(v).to(where) for k, v in nb.items()}
        _, grads = make_grad_fn(cfg, "full")(params, batch)
        grads = _host_leaves(torch, grads)
        params, opt, m = make_train_step(cfg, tc)(params,
                                                 adamw.init(params), batch)
        res[name] = (grads, _host_leaves(torch, params),
                     {k: float(v) for k, v in m.items()}, int(opt["step"]))
        del params, opt, batch
    out = _step_gates(torch, label, res["cpu"], res["card"], tc.eps)
    out["wall_s"] = time.time() - t0
    return out


def _timed_train(torch, cfg, tc, dev, **kw):
    """``train_loop.train`` with CUDA events around each step (the loop's
    step factory wrapped for the call). Returns (train's result, each
    step's event ms, the log's records)."""
    from repro_torch.train import loop as TL
    made, events = TL.make_train_step, []

    def factory(cfg_, tc_):
        fn = made(cfg_, tc_)

        def timed(params, opt, batch):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(params, opt, batch)
            b.record()
            events.append((a, b))
            return out
        return timed

    TL.make_train_step = factory
    try:
        out = TL.train(cfg, tc, dev, **kw)
    finally:
        TL.make_train_step = made
    torch.cuda.synchronize()
    recs = []
    if kw.get("log_path"):
        with open(kw["log_path"]) as f:
            recs = [json.loads(x) for x in f]
    return out, [a.elapsed_time(b) for a, b in events], recs


def _param_counts(torch, cfg):
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves
    n = sum(p.numel() for p in leaves(T.param_spec(cfg)))
    return n, cfg.vocab_size * cfg.d_model


def _train_flops(cfg, n_non_embed, batch, seq):
    """A step's FLOPs: 6 N T of the forward and backward, 2 N T of the
    remat forward, and attention's s x s scores and values (``_sdpa``
    computes the whole rectangle): 4 s dh per query head, layer and token
    a pass, four passes (forward, remat forward, two in the backward)."""
    tokens = batch * seq
    attn = 16 * seq * cfg.head_dim * cfg.heads_eff * cfg.num_layers * tokens
    return 8 * n_non_embed * tokens + attn


def _train_full(torch, dev, args, tmp):
    """(b): internlm2-1.8B at full width, all 24 layers, through ``train``;
    then ``adamw.update`` alone and one step profiled."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import map_leaves
    cfg = get_config(TRAIN_ARCH)
    n, n_embed = _param_counts(torch, cfg)
    tc = _train_tc(learning_rate=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS,
                   microbatches=TRAIN_MICRO, remat="save_carries",
                   checkpoint_every=10 * TRAIN_STEPS,
                   checkpoint_dir=os.path.join(tmp, "full"), seed=args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    (params, opt, _), ms, recs = _timed_train(
        torch, cfg, tc, dev, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        log_path=os.path.join(tmp, "full.log"))
    wall = time.time() - t0
    losses = [r["loss"] for r in recs if "loss" in r]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[train] full width: losses {losses}")
    drop = losses[0] - statistics.fmean(losses[-3:])
    log(f"[train] internlm2-1.8B, {cfg.num_layers} layers, {n:,} params: "
        f"losses {[round(x, 4) for x in losses]}; the last 3 below the "
        f"first by {drop:.3f} nats (gate {TRAIN_LOSS_DROP})")
    if not drop >= TRAIN_LOSS_DROP:
        raise AssertionError(f"[train] full width learnt {drop:.3f} nats in "
                             f"{TRAIN_STEPS} steps, under {TRAIN_LOSS_DROP}")
    step_ms = statistics.median(ms[2:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = _train_flops(cfg, n - n_embed, TRAIN_BATCH, TRAIN_SEQ)
    share = flops / (step_ms / 1e3) / _hw()["peak_flops_bf16"]
    peak = _gib(torch.cuda.max_memory_allocated(dev))
    host = [r["sec"] for r in recs if "sec" in r]
    log(f"[train] step (events) {[round(x, 2) for x in ms]} ms; median of "
        f"steps 3-{TRAIN_STEPS} {step_ms:.2f} ms, "
        f"{tokens / step_ms * 1e3:,.0f} tokens/s; {flops / 1e12:.2f} TFLOP "
        f"a step, {share:.4f} of the bf16 peak; host clock a step "
        f"{[round(x * 1e3, 1) for x in host]} ms; peak allocated "
        f"{peak:.2f} GiB; train() {wall:.1f} s")
    out = {"params": n, "losses": losses, "loss_drop": drop, "step_ms": ms,
           "median_step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
           "flops": flops, "bf16_share": share, "peak_gib": peak,
           "host_step_s": host, "wall_s": wall}
    # adamw.update alone, on the trained state, beside its byte bound
    grads = map_leaves(lambda p: torch.full_like(p, 1e-3), params)
    lr = torch.tensor(1e-5, device=dev)
    st = _time_stats(torch, lambda: adamw.update(params, opt, grads, lr, tc),
                     3)
    b_ms, b_by = bound_ms(ADAMW_PASSES * 4 * n)
    prof = _profile(torch, lambda: adamw.update(params, opt, grads, lr, tc),
                    1, "adamw.update", top=6)
    log(f"[train] adamw.update over {n:,} f32 elements: {_stats_text(st)}; "
        f"bound {b_ms:.3f} ms ({b_by}: {ADAMW_PASSES} passes, "
        f"{ADAMW_PASSES * 4 * n / 1e9:.1f} GB); {prof['kernel_launches']} "
        f"kernel launches")
    out["adamw"] = {"ms": st["ms"], "median_ms": st["median_ms"],
                    "bound_ms": b_ms, "bound_by": b_by,
                    "launches": prof["kernel_launches"],
                    "top": prof["top"]}
    del grads
    # one step profiled: where its time goes
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             lm_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS,
                      seed=args.seed).items()}
    step = make_train_step(cfg, tc)
    prof = _profile(torch, lambda: step(params, opt, batch), 1, "train step",
                    top=15)
    out["profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                           "idle_share", "kernel_launches",
                                           "top")}
    del params, opt, batch
    return out


class _PlainCalls:
    """Counts calls of the plain versions of the sealing kernels while
    installed: on the card's path there must be none."""
    NAMES = (("chacha20", "chacha20_blocks_plain"),
             ("chacha20", "lines_unseal_plain"),
             ("aes128", "lines_encrypt_plain"),
             ("aes128", "lines_decrypt_plain"))

    def __init__(self):
        import importlib
        self.calls, self._saved = 0, []
        for mod, name in self.NAMES:
            m = importlib.import_module(f"repro_torch.kernels.{mod}")
            fn = getattr(m, name)
            self._saved.append((m, name, fn))

            def counted(*a, _fn=fn, **k):
                self.calls += 1
                return _fn(*a, **k)
            setattr(m, name, counted)

    def close(self):
        for m, name, fn in self._saved:
            setattr(m, name, fn)


def _recording_manager(record):
    """The checkpoint manager with its save (the blocking snapshot), its
    background write and its restore timed; a host copy of what step
    ``record["keep"]`` saved and of each restore's result kept."""
    from repro_torch.checkpoint.manager import CheckpointManager, _flatten

    class Recording(CheckpointManager):
        def save(self, step, params, opt_state=None, extra=None,
                 blocking=False):
            if step == record["keep"]:
                record["saved"] = {"params": _flatten(params),
                                   "opt": _flatten(opt_state)}
            t0 = time.perf_counter()
            super().save(step, params, opt_state, extra, blocking)
            record["save_s"].append(time.perf_counter() - t0)

        def _write(self, step, host, meta):
            t0 = time.perf_counter()
            super()._write(step, host, meta)
            record["write_s"].append(time.perf_counter() - t0)

        def restore(self, step=None, verify=True):
            t0 = time.perf_counter()
            out = super().restore(step, verify)
            record["restore_s"].append(time.perf_counter() - t0)
            record["restored"] = out[1]
            return out
    return Recording


def _dir_bytes(d):
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def _checkpoint_full(torch, dev, args, tmp):
    """(d): sealed ColoE checkpoints of 2 of internlm2's 24 layers at full
    width: a straight run of 6 steps saving every 3 (async), the step-6
    checkpoint checked and dropped, and a fresh ``train`` resuming at 3."""
    from repro_torch.config import SealConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.train import loop as TL
    import numpy as np
    cfg = get_config(TRAIN_ARCH).with_(num_layers=TRAIN_CUT_LAYERS)
    n, _ = _param_counts(torch, cfg)
    need = 2 * 3 * 4 * n * 34 // 32 + 2**30   # two checkpoints, m and v
    free = shutil.disk_usage(tmp).free
    log(f"[train] checkpoints under {tmp}: {free / 1e9:.1f} GB free, "
        f"{need / 1e9:.1f} GB needed")
    if free < need:
        raise AssertionError(f"[train] {free / 1e9:.1f} GB free under {tmp}, "
                             f"{need / 1e9:.1f} GB needed")
    d = os.path.join(tmp, "ckpt")
    tc = _train_tc(learning_rate=3e-4, warmup_steps=2, total_steps=CKPT_STEPS,
                   microbatches=TRAIN_MICRO, remat="save_carries",
                   checkpoint_every=CKPT_EVERY, checkpoint_dir=d,
                   async_checkpoint=True, seed=args.seed)
    seal = SealConfig(mode="coloe")
    record = {"keep": CKPT_EVERY, "save_s": [], "write_s": [],
              "restore_s": []}
    made = TL.CheckpointManager
    TL.CheckpointManager = _recording_manager(record)
    plain = _PlainCalls()
    try:
        ops.reset_launch_counts()
        (params, opt, _), ms_a, recs_a = _timed_train(
            torch, cfg, tc, dev, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seal=seal,
            log_path=os.path.join(tmp, "straight.log"))
        straight = ops.launch_counts()
        n_leaves = 3 * len(flatten_paths(params)) + 1
        del params, opt
        step_dir = os.path.join(d, f"step_{CKPT_STEPS:08d}")
        written = _dir_bytes(step_dir)
        leaf = np.load(os.path.join(step_dir, "params__embed.w.npy"),
                       mmap_mode="r")
        if leaf.dtype != np.uint32 or leaf.shape[1] != 34:
            raise AssertionError(f"[train] stored embedding {leaf.dtype} "
                                 f"{leaf.shape}: not ColoE ciphertext lines")
        del leaf
        # a flipped byte in the first leaf the restore reads
        with open(os.path.join(step_dir, "manifest.json")) as f:
            first = next(iter(json.load(f)["leaves"].values()))["file"]
        with open(os.path.join(step_dir, first), "r+b") as f:
            f.seek(-7, os.SEEK_END)
            b = f.read(1)
            f.seek(-7, os.SEEK_END)
            f.write(bytes([b[0] ^ 0x20]))
        try:
            made(d, seal=seal, device=dev).restore(CKPT_STEPS)
        except IOError as e:
            corrupt = str(e)
        else:
            raise AssertionError("[train] a flipped byte went unnoticed")
        shutil.rmtree(step_dir)
        ops.reset_launch_counts()
        (params, opt, _), ms_b, recs_b = _timed_train(
            torch, cfg, tc, dev, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seal=seal,
            log_path=os.path.join(tmp, "resumed.log"))
        resumed = ops.launch_counts()
        del params, opt
    finally:
        TL.CheckpointManager = made
        plain.close()
    la = {r["step"]: r["loss"] for r in recs_a if "loss" in r}
    lb = {r["step"]: r["loss"] for r in recs_b if "loss" in r}
    events = [r["event"] for r in recs_b if "event" in r]
    if events != ["resumed"] or sorted(lb) != list(range(CKPT_EVERY,
                                                         CKPT_STEPS)):
        raise AssertionError(f"[train] the second run: events {events}, "
                             f"steps {sorted(lb)}")
    rel = max(abs(lb[s] - la[s]) / abs(la[s]) for s in lb)
    bitwise = all(lb[s] == la[s] for s in lb)
    if not rel <= TRAIN_REL:
        raise AssertionError(f"[train] resumed losses {lb} against the "
                             f"straight run's {la} ({rel:.2e})")
    saved, restored = record["saved"], record["restored"]
    for group in saved:
        if saved[group].keys() != restored[group].keys():
            raise AssertionError(f"[train] restored {group} leaves differ")
        for k, v in saved[group].items():
            r = restored[group][k]
            if r.dtype != v.dtype or r.shape != v.shape or \
                    r.tobytes() != v.tobytes():
                raise AssertionError(f"[train] restored {group}/{k} is not "
                                     f"the saved one bit for bit")
    if not straight["chacha20"] >= 2 * n_leaves or \
            straight["chacha20_lines_unseal"] != 0:
        raise AssertionError(f"[train] straight run's launches {straight}")
    if resumed["chacha20_lines_unseal"] != n_leaves or \
            not resumed["chacha20"] >= n_leaves:
        raise AssertionError(f"[train] resumed run's launches {resumed}")
    if plain.calls:
        raise AssertionError(f"[train] {plain.calls} calls of a plain "
                             f"sealing version on the card's path")
    out = {"params": n, "leaves": n_leaves, "bytes_written": written,
           "save_s": record["save_s"], "write_s": record["write_s"],
           "restore_s": record["restore_s"], "losses": la, "resumed": lb,
           "resumed_rel": rel, "resumed_bitwise": bitwise,
           "launches": {k: straight[k] + resumed[k] for k in straight},
           "straight_launches": straight, "resumed_launches": resumed,
           "step_ms": ms_a, "resumed_step_ms": ms_b, "corrupt": corrupt}
    log(f"[train] checkpoints, {TRAIN_CUT_LAYERS} of 24 layers, {n:,} "
        f"params, {n_leaves} sealed leaves: {written / 1e9:.3f} GB a "
        f"checkpoint; save (blocking snapshot) "
        f"{[round(x, 3) for x in record['save_s']]} s, background seal and "
        f"write {[round(x, 3) for x in record['write_s']]} s, restore "
        f"{[round(x, 3) for x in record['restore_s']]} s; launches: straight "
        f"{_nonzero(straight)}, resumed {_nonzero(resumed)}; restored state "
        f"bit for bit the saved one; resumed losses {lb} against {la}: "
        f"{rel:.2e} relative, bitwise {bitwise}; a flipped byte: {corrupt}")
    return out


def _checkpoint_parity(torch, dev, args, tmp):
    """(d): the reduced config's params and AdamW state sealed under ColoE,
    Counter and Direct on the card and on the CPU: the manifests (their
    SHA-256 digests of every file) equal."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.config import SealConfig
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.tree import map_leaves
    cfg = get_reduced(TRAIN_ARCH)
    p_cpu = T.init_params(cfg, args.seed, "cpu")
    o_cpu = adamw.init(p_cpu)
    p_dev, o_dev = (map_leaves(lambda t: t.to(dev), t) for t in (p_cpu,
                                                                 o_cpu))
    out = {}
    for mode in ("coloe", "counter", "direct"):
        manifests = {}
        for name, where, p, o in (("cpu", "cpu", p_cpu, o_cpu),
                                  ("card", dev, p_dev, o_dev)):
            d = os.path.join(tmp, f"reduced_{mode}_{name}")
            ops.reset_launch_counts()
            CheckpointManager(d, seal=SealConfig(mode=mode),
                              device=where).save(1, p, o, blocking=True)
            counts = ops.launch_counts()
            with open(os.path.join(d, "step_00000001",
                                   "manifest.json")) as f:
                manifests[name] = json.load(f)["leaves"]
            shutil.rmtree(d)
        if manifests["card"] != manifests["cpu"]:
            raise AssertionError(f"[train] reduced checkpoint under {mode}: "
                                 f"the card's manifest is not the CPU's")
        kernel = "aes128_lines_encrypt" if mode == "direct" else "chacha20"
        if not counts[kernel] >= len(manifests["card"]):
            raise AssertionError(f"[train] {mode} on the card: {counts}")
        out[mode] = {"leaves": len(manifests["card"]), "launches": counts}
    log("[train] reduced checkpoints: manifests (every file's SHA-256) on "
        "the card equal the CPU's under "
        + ", ".join(f"{m} ({v['leaves']} leaves)" for m, v in out.items()))
    return out


def _train_frontend(torch, dev, args, tmp, arch):
    """(e): a frontend-stub architecture at its published widths through
    ``train``, ``lm_batch``'s embeds for its inputs."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    n, _ = _param_counts(torch, cfg)
    tc = _train_tc(learning_rate=3e-4, warmup_steps=2,
                   total_steps=FRONTEND_STEPS,
                   checkpoint_every=10 * FRONTEND_STEPS,
                   checkpoint_dir=os.path.join(tmp, arch), seed=args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _, ms, recs = _timed_train(torch, cfg, tc, dev, batch=FRONTEND_BATCH,
                               seq=FRONTEND_SEQ,
                               log_path=os.path.join(tmp, f"{arch}.log"))
    losses = [r["loss"] for r in recs if "loss" in r]
    if len(losses) != FRONTEND_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[train] {arch}: losses {losses}")
    peak = _gib(torch.cuda.max_memory_allocated(dev))
    log(f"[train] {cfg.name} ({cfg.num_layers} layers, {n:,} params, "
        f"heads {cfg.num_heads}->{cfg.heads_eff}/{cfg.num_kv_heads}, "
        f"{cfg.norm}, {cfg.act}): losses {[round(x, 4) for x in losses]}; "
        f"step (events) {[round(x, 2) for x in ms]} ms; peak allocated "
        f"{peak:.2f} GiB")
    return {"params": n, "losses": losses, "step_ms": ms, "peak_gib": peak}


def phase_train(torch, dev, args):
    """Phase 13: training (module docstring, 13)."""
    import tempfile
    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.configs import ARCH_IDS, get_config, get_reduced
    out = {"parity": {}}
    for arch in ARCH_IDS:
        out["parity"][arch] = _train_parity(
            torch, dev, get_reduced(arch).with_(dtype="float32"), args.seed,
            f"(a) {arch} reduced")
    cut = get_config(TRAIN_ARCH).with_(num_layers=TRAIN_CUT_LAYERS,
                                       dtype="float32")
    out["parity_full_width"] = _train_parity(
        torch, dev, cut, args.seed,
        f"(c) internlm2-1.8B full width, {TRAIN_CUT_LAYERS} layers, f32")
    tmp = tempfile.mkdtemp(prefix="repro_train_")
    try:
        out["full"] = _train_full(torch, dev, args, tmp)
        out["checkpoint"] = _checkpoint_full(torch, dev, args, tmp)
        out["checkpoint_parity"] = _checkpoint_parity(torch, dev, args, tmp)
        out["frontend"] = {a: _train_frontend(torch, dev, args, tmp, a)
                           for a in FRONTEND_ARCHS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = out["checkpoint"]["launches"]
    out["wall_s"] = time.time() - t_phase
    log(f"[train] phase 13: {out['wall_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 14: the paper's sealed-decode comparison, and the paged step builders
# --------------------------------------------------------------------------

SEALED_ARCH = "granite_3_2b"
SEALED_SHAPE = "decode_32k"
# decode_32k's global batch of 128 would make a 32,768-slot KV cache of
# 343.6 GB (about 4.3 cards); 8 rows make 21.5 GB. The one cut of (b).
SEALED_BATCH = 8
SEALED_REDUCED_BATCH = 2
SEALED_WARMUP, SEALED_ITERS = 2, 10
# granite-3-2b's tree: 7 tile leaves of 40 slices and 4 line leaves (the
# tied embedding and three norms); 2,533,529,600 parameters by
# ``param_count``
GRANITE_PARAMS = 2_533_529_600
GRANITE_TILE_LEAVES, GRANITE_LINE_LEAVES, GRANITE_LEAVES = 7, 4, 11
GRANITE_SLICES = GRANITE_TILE_LEAVES * 40
BF16_GATE = 2e-2          # phase 4's sealed-vs-plaintext gate in bf16
F32_GATE = 1e-4
# (b)'s f32 check of the fused variant at full width: batch 2 keeps the f32
# cache at 10.7 GB
SEALED_F32_BATCH = 2
PAGED_ARCH = "internlm2_1_8b"
PAGED_STEPS = 16
PAGED_BLOCK = 16


def _state_on(state, dev):
    """A copy of a ``sealed_dryrun.DecodeState`` on ``dev`` (the same
    params, cache and batch; no logits yet)."""
    import dataclasses
    from repro_torch.tree import map_leaves
    return dataclasses.replace(
        state, params=map_leaves(lambda t: t.to(dev), state.params),
        cache=tuple({k: t.to(dev) for k, t in c.items()}
                    for c in state.cache),
        batch={k: t.to(dev) for k, t in state.batch.items()}, logits={})


def _want_launches(rec, matmul):
    """The kernels one step launches, from the variant's sealed tree: one
    ``lines_unseal`` a line leaf holding ciphertext lines and one fused
    matmul (``matmul``: the variant ``_variant`` takes at the step's shapes)
    a tile-leaf slice; nothing else, the keystream kernel included."""
    want = {}
    if rec["unsealed_line_leaves"]:
        want["chacha20_lines_unseal"] = rec["unsealed_line_leaves"]
    if rec["fused_matmul_slices"]:
        want[matmul] = rec["fused_matmul_slices"]
    return want


def _sealed_reduced(torch, dev, args):
    """14 (a): the reduced granite under the five variants in f32, the card
    against the CPU from the same params, cache and tokens."""
    from repro_torch.launch import sealed_dryrun as SD
    cpu = SD.decode_state(SEALED_ARCH, SEALED_SHAPE, reduced=True,
                          batch=SEALED_REDUCED_BATCH, dtype="float32",
                          device="cpu", seed=args.seed)
    card = _state_on(cpu, dev)
    out = {}
    for v in SD.VARIANTS:
        kw = dict(reduced=True, warmup=1, iters=1)
        SD.sealed_decode_variant(SEALED_ARCH, SEALED_SHAPE, v, state=cpu,
                                 **kw)
        rec = SD.sealed_decode_variant(SEALED_ARCH, SEALED_SHAPE, v,
                                       state=card, **kw)
        err = _rel_err(torch, card.logits[v], cpu.logits[v])
        err_base = _rel_err(torch, card.logits[v], card.logits["baseline"])
        want = _want_launches(rec, "sealed_matmul")
        out[v] = {"card_vs_cpu_rel_err": err, "vs_baseline_rel_err": err_base,
                  "launches_per_step": rec["launches_per_step"]}
        log(f"[sealed] (a) {v}: card vs CPU max rel err {err:.3e} (tol "
            f"{F32_GATE}), vs the card's baseline {err_base:.3e}, launches "
            f"a step {rec['launches_per_step']} (expected {want})")
        if not err <= F32_GATE or not err_base <= F32_GATE:
            raise AssertionError(f"(a) {v}: the card's f32 logits disagree")
        if v != "coloe_fused" and not torch.equal(card.logits[v],
                                                  card.logits["baseline"]):
            raise AssertionError(f"(a) {v}: logits differ from baseline's")
        if rec["launches_per_step"] != want:
            raise AssertionError(f"(a) {v}: launches {rec['launches_per_step']}"
                                 f", expected {want}")
    return out


def _slim_profile(prof):
    return {k: prof[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                 "kernel_launches", "top")}


def _sealed_full(torch, dev, args):
    """14 (b): granite-3-2b at its published width under the five
    variants, bf16, decode_32k's 32,768 cache slots at batch 8."""
    from repro_torch.launch import roofline
    from repro_torch.launch import sealed_dryrun as SD
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    state = SD.decode_state(SEALED_ARCH, SEALED_SHAPE, batch=SEALED_BATCH,
                            device=dev, seed=args.seed)
    torch.cuda.synchronize()
    cfg = state.cfg
    n_params = sum(t.numel() for t in _leaves(state.params))
    n_leaves = len(_leaves(state.params))
    kv_gb = sum(t.numel() * t.element_size()
                for c in state.cache for t in c.values()) / 1e9
    log(f"[sealed] (b) {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {n_params:,} params ({n_leaves} leaves), "
        f"{cfg.dtype}; cache {state.shape.seq_len} slots x batch "
        f"{state.shape.global_batch}: {kv_gb:.2f} GB; cut: {state.reduced}; "
        f"made in {time.time() - t0:.1f} s")
    # ``param_count`` (the roofline's) leaves out the final norm's d_model
    if cfg.param_count() != GRANITE_PARAMS or \
            n_params != GRANITE_PARAMS + cfg.d_model or \
            n_leaves != GRANITE_LEAVES:
        raise AssertionError(f"(b) {n_params} params in {n_leaves} leaves")
    out = {"variants": {}, "cut": state.reduced, "kv_gb": kv_gb}
    for v in SD.VARIANTS:
        rec = SD.sealed_decode_variant(
            SEALED_ARCH, SEALED_SHAPE, v, state=state, warmup=SEALED_WARMUP,
            iters=SEALED_ITERS,
            probe=lambda fn, v=v: _slim_profile(
                _profile(torch, fn, 1, f"(b) {v}: one step")))
        logits = state.logits[v]
        want = _want_launches(rec, "sealed_matmul_dec")
        for_granite = ({} if v == "baseline" else
                 {"chacha20_lines_unseal": GRANITE_LEAVES}
                 if v != "coloe_fused" else
                 {"chacha20_lines_unseal": GRANITE_LINE_LEAVES,
                  "sealed_matmul_dec": GRANITE_SLICES})
        bound, by = bound_ms(rec["bytes_per_device"],
                             bf16_flops=rec["flops_per_device"])
        row = roofline.roofline_row(rec)
        err = _rel_err(torch, logits, state.logits["baseline"])
        agree = float((logits.argmax(-1) == state.logits["baseline"]
                       .argmax(-1)).float().mean())
        rec.update(bound_ms=bound, bound_by=by, roofline=row,
                   vs_baseline_rel_err=err, greedy_agreement=agree)
        out["variants"][v] = rec
        prof = rec["probe"]
        log(f"[sealed] (b) {v}: step median {rec['step_ms']:.3f} ms (mean "
            f"{statistics.fmean(rec['step_ms_each']):.3f}, "
            f"{[round(x, 3) for x in rec['step_ms_each']]}); one step "
            f"profiled: busy {prof['device_busy_ms']:.3f} ms, idle share "
            f"{prof['idle_share']:.3f}; bound {bound:.3f} ms ({by}: "
            f"{rec['bytes_per_device'] / 1e9:.3f} GB, "
            f"{rec['flops_per_device'] / 1e12:.4f} TFLOP)")
        log(f"[sealed] (b) {v}: stored {rec['stored_param_bytes_global']:,} "
            f"B, materialized {rec['plaintext_bytes_materialized_per_step']:,}"
            f" B a step (written {rec['plaintext_bytes_written']:,}), KV "
            f"{rec['kv_cache_plaintext_bytes_per_step']:,} B; peak "
            f"{rec['peak_gib']:.2f} GiB, args {rec['arg_gib']:.2f} GiB; "
            f"sealed in {rec['seal_s']:.2f} s {rec['seal_launches']}; "
            f"launches a step {rec['launches_per_step']} (expected {want})")
        log(f"[sealed] (b) {v}: roofline {json.dumps(row)}")
        log(f"[sealed] (b) {v}: logits vs baseline max rel err {err:.3e}, "
            f"greedy tokens equal {agree:.3f}")
        if not bool(torch.isfinite(logits).all()) or \
                tuple(logits.shape) != (SEALED_BATCH, cfg.vocab_size):
            raise AssertionError(f"(b) {v}: logits {tuple(logits.shape)} "
                                 f"not finite of (batch, vocab)")
        if rec["launches_per_step"] != want or want != for_granite:
            raise AssertionError(f"(b) {v}: launches a step "
                                 f"{rec['launches_per_step']}, from the tree "
                                 f"{want}, for granite {for_granite}")
        if rec["plaintext_bytes_written"] != \
                rec["plaintext_bytes_materialized_per_step"]:
            raise AssertionError(f"(b) {v}: wrote "
                                 f"{rec['plaintext_bytes_written']} B of "
                                 f"plaintext, counted "
                                 f"{rec['plaintext_bytes_materialized_per_step']}")
        if v != "coloe_fused" and \
                not torch.equal(logits, state.logits["baseline"]):
            raise AssertionError(f"(b) {v}: logits differ from baseline's")
        gc.collect()
        torch.cuda.empty_cache()
    out["timing_vs_baseline"] = _vs_baseline(out["variants"])
    out["fused_kernel"] = _fused_kernel_check(torch, state, args)
    out["bf16_noise"] = _bf16_noise(torch, state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    out["f32"] = _sealed_full_f32(torch, dev, args)
    return out


def _vs_baseline(variants):
    """Each variant's median step ms less the baseline's, beside the spread
    (max - min) of its own timed steps: the difference the paper's
    comparison reads, and whether it stands above the steps' noise."""
    base = variants["baseline"]["step_ms"]
    out = {}
    for v, rec in variants.items():
        each = rec["step_ms_each"]
        out[v] = {"diff_ms": rec["step_ms"] - base,
                  "spread_ms": max(each) - min(each)}
        log(f"[sealed] (b) {v}: median step - baseline's "
            f"{out[v]['diff_ms']:+.3f} ms; spread of its {len(each)} timed "
            f"steps {out[v]['spread_ms']:.3f} ms")
    return out


def _fused_kernel_check(torch, state, args):
    """(b)'s gate of the fused kernel the bf16 step runs: slice 0 of each of
    granite's tile leaves, sealed as ``coloe_fused`` seals it (the same
    structural mask and write counter), times M = 8 bf16 rows, through
    ``SealedTensor.matmul``, which must launch ``sealed_matmul_dec`` once
    a leaf; held to ``layers.plain_matmul`` on the same rows and plaintext
    slice at phase 4's bf16 gate. One product, so no depth amplifies its
    roundings: a wrong pad, mask or tile lands far outside the gate."""
    from repro_torch.config import SealConfig
    from repro_torch.core import engine as E
    from repro_torch.kernels import ops
    from repro_torch.launch import sealed_dryrun as SD
    from repro_torch.models import layers as L
    from repro_torch.tree import flatten_with_path
    dev, dt = state.cache[0]["pos"].device, torch.bfloat16
    seal = SealConfig(mode="coloe", smart_ratio=0.5)
    eng = E.make_engine("coloe", SD.KEY, dev)
    ratios = SD.synthetic_masks(state.params, seal)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 14)
    errs, counts = {}, {}
    for pt, leaf in flatten_with_path(state.params):
        path = "/".join(pt)
        lf = SD._seal_leaf(eng, "coloe_fused", seal, pt, leaf[:1],
                           ratios[path])
        if not lf.tiled:
            continue
        st = lf.st.slice(0)
        x = torch.randn((SEALED_BATCH, st.k_size), generator=gen,
                        device=dev).to(dt)
        c0 = ops.launch_counts()
        got = st.matmul(x, compute_dtype="bfloat16")
        counts[path] = {k: n - c0[k] for k, n in ops.launch_counts().items()
                        if n != c0[k]}
        want = L.plain_matmul(x, leaf[0].reshape(st.k_size, st.n_size), dt)
        errs[path] = _rel_err(torch, got, want)
        del lf, st
    log(f"[sealed] (b) sealed_matmul_dec on slice 0 of each tile leaf, M = "
        f"{SEALED_BATCH}, bf16, vs plain_matmul: max rel err "
        f"{ {p: f'{e:.3e}' for p, e in errs.items()} } (tol {BF16_GATE}); "
        f"launches {counts}")
    if len(errs) != GRANITE_TILE_LEAVES:
        raise AssertionError(f"(b) {len(errs)} tile leaves checked")
    if any(c != {"sealed_matmul_dec": 1} for c in counts.values()):
        raise AssertionError(f"(b) the check ran {counts}, not one "
                             f"sealed_matmul_dec a leaf")
    if not max(errs.values()) <= BF16_GATE:
        raise AssertionError(f"(b) sealed_matmul_dec {errs} of scale from "
                             f"plain_matmul")
    return {"rel_err": errs, "launches": counts}


class _F32Sums:
    """Within the block, ``layers.plain_matmul`` on the card multiplies the
    operands rounded to the compute dtype with f32 sums on cuBLAS's f32
    path (TF32 off) and rounds the result to it: the fused kernel's
    arithmetic contract in another order of sums than the bf16 GEMM's."""

    def __enter__(self):
        import torch
        from repro_torch.models import layers as L
        self._layers, self._orig = L, L.plain_matmul
        L.plain_matmul = lambda x2d, w2d, dt: torch.mm(
            x2d.to(dt).float(), w2d.to(dt).float()).to(dt)

    def __exit__(self, *exc):
        self._layers.plain_matmul = self._orig


def _bf16_noise(torch, state):
    """How far two right bf16 computations of (b)'s plaintext step part at
    40 layers: the baseline's bf16 GEMMs against ``_F32Sums``' on the same
    params, cache and tokens; beside it the fused variant's distance from
    both. Reported: any change of the order of a matmul's sums moves a
    rounding of its bf16 result, and 40 random layers amplify it."""
    from repro_torch.serve.step import make_decode_step
    with _F32Sums():
        witness = make_decode_step(state.cfg)(
            state.params, state.cache, state.batch, state.pos)[0]
    state.reset()
    witness = witness.float().cpu()
    base, fused = state.logits["baseline"], state.logits["coloe_fused"]
    out = {"baseline_vs_f32_sums": _rel_err(torch, base, witness),
           "fused_vs_f32_sums": _rel_err(torch, fused, witness),
           "fused_vs_baseline": _rel_err(torch, fused, base)}
    log(f"[sealed] (b) bf16 logits at 40 layers: fused vs baseline "
        f"{out['fused_vs_baseline']:.3e} of scale; two right plaintext "
        f"steps apart (bf16 GEMMs vs f32 sums of the same rounded operands) "
        f"{out['baseline_vs_f32_sums']:.3e}; fused vs f32 sums "
        f"{out['fused_vs_f32_sums']:.3e} (reported; the gate is in f32)")
    return out


def _sealed_full_f32(torch, dev, args):
    """(b) in f32 at batch 2: the fused variant's logits within 1e-4 of
    scale of the baseline's at the published width and depth, where no
    bf16 rounding separates the two (phase 4's f32 gate)."""
    from repro_torch.launch import sealed_dryrun as SD
    state = SD.decode_state(SEALED_ARCH, SEALED_SHAPE,
                            batch=SEALED_F32_BATCH, dtype="float32",
                            device=dev, seed=args.seed)
    launches = {}
    for v in ("baseline", "coloe_fused"):
        rec = SD.sealed_decode_variant(SEALED_ARCH, SEALED_SHAPE, v,
                                       state=state, warmup=1, iters=1)
        launches[v] = rec["launches_per_step"]
    err = _rel_err(torch, state.logits["coloe_fused"],
                   state.logits["baseline"])
    want = {"chacha20_lines_unseal": GRANITE_LINE_LEAVES,
            "sealed_matmul": GRANITE_SLICES}
    log(f"[sealed] (b) f32 at batch {SEALED_F32_BATCH}: fused vs baseline "
        f"max rel err {err:.3e} (tol {F32_GATE}); launches a fused step "
        f"{launches['coloe_fused']} (expected {want})")
    if not err <= F32_GATE:
        raise AssertionError(f"(b) f32 fused logits {err:.3e} of scale from "
                             f"baseline's")
    if launches["coloe_fused"] != want or launches["baseline"]:
        raise AssertionError(f"(b) f32 launches {launches}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return {"fused_vs_baseline": err, "launches": launches}


def _paged_builders(torch, dev, args):
    """14 (c): ``make_paged_prefill`` and 16 ``make_paged_decode_step``s of
    internlm2-1.8B at full width on phase 4's prompts, sealed weights
    (``serving_params``) and sealed pools, teacher-forced on the contiguous
    plaintext path's greedy tokens, held to that path's logits."""
    import numpy as np
    from repro_torch.config import SealConfig
    from repro_torch.configs import get_config
    from repro_torch.core import sealed_store as SS
    from repro_torch.kernels import ops
    from repro_torch.models import cache as MC
    from repro_torch.models import transformer as T
    from repro_torch.serve import step as ST
    key = bytes(range(32))
    cfg = get_config(PAGED_ARCH)
    params = T.init_params(cfg, seed=args.seed, device=dev)
    prompts = _prompts(args.seed + 7, REQUESTS, cfg.vocab_size)
    a, bs = len(prompts), PAGED_BLOCK
    sb = -(-max(len(p) for p in prompts) // bs) * bs        # the bucket
    mb = -(-(sb + PAGED_STEPS) // bs)
    # the contiguous plaintext path, one prompt at a time, as wide as a
    # slot's paged view
    t0 = time.time()
    want, forced = [], np.zeros((a, PAGED_STEPS), np.int64)
    for i, p in enumerate(prompts):
        toks = torch.as_tensor(p, dtype=torch.int64, device=dev)[None]
        logits, cache = T.prefill(cfg, params, toks, mb * bs)
        seq = [logits[0]]
        for t in range(PAGED_STEPS):
            forced[i, t] = int(seq[-1].argmax())
            logits, cache, _ = T.decode_step(
                cfg, params, cache, torch.tensor([[forced[i, t]]],
                                                 device=dev), len(p) + t)
            seq.append(logits[0])
        want.append(torch.stack(seq))
        del cache
    want = torch.stack(want, dim=1)                         # (1 + S, A, V)
    contiguous_s = time.time() - t0
    sp = SS.seal_params(params, SealConfig(), key)

    def materialize(tensors):
        return SS.serving_params(
            SS.SealedParams(tensors, sp.plans, sp.skeleton, sp.seal,
                            sp._engines), key, cfg.tie_embeddings)

    cache_seal = SS.cache_seal_config(key, dev)
    nb = 1 + a * mb
    pools = MC.paged_pool_init(cfg, nb, bs, dev)
    tables = (1 + torch.arange(a, device=dev)[:, None] * mb
              + torch.arange(mb, device=dev)[None, :])
    bt = tables[:, :sb // bs]
    tokens = torch.zeros((a, sb), dtype=torch.int64)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.as_tensor(p, dtype=torch.int64)
    tokens = tokens.to(dev)
    lengths = torch.tensor([len(p) for p in prompts], device=dev)
    wc = torch.zeros((nb,), dtype=torch.int32, device=dev)
    kd = torch.zeros((a, 2), dtype=torch.int32, device=dev)
    temp = torch.zeros((a,), device=dev)
    topk = torch.zeros((a,), dtype=torch.int64, device=dev)
    topp = torch.ones((a,), device=dev)
    ones = torch.ones((a * mb,), dtype=torch.int32, device=dev)
    forced_d = torch.as_tensor(forced, device=dev)
    prefill = ST.make_paged_prefill(cfg, materialize, cache_seal)
    step = ST.make_paged_decode_step(cfg, materialize, cache_seal)
    torch.cuda.synchronize()
    ops.reset_launch_counts()            # the builders' path starts here
    t0 = time.time()
    wc.index_add_(0, bt.reshape(-1), ones[:bt.numel()])     # bumped first
    _, logits, pools = prefill(sp.tensors, pools, tokens, lengths, bt, wc,
                               kd, temp, topk, topp)
    got = [logits]
    for t in range(PAGED_STEPS):
        _, logits, pools = step(sp.tensors, pools, tables, lengths, wc,
                                forced_d[:, t:t + 1], kd,
                                torch.full((a,), t + 1, device=dev), temp,
                                topk, topp)
        tail = tables[torch.arange(a, device=dev), lengths // bs]
        wc.index_add_(0, tail, ones[:a])  # the host's mirror of the bump
        lengths = lengths + 1
        got.append(logits)
    torch.cuda.synchronize()
    paged_s = time.time() - t0
    launches = ops.launch_counts()       # ... and ends here
    got = torch.stack(got)
    errs = [_rel_err(torch, got[:, i], want[:, i]) for i in range(a)]
    views = cfg.num_layers * PAGED_STEPS
    out = {"launches": launches, "rel_err": errs, "bucket": sb,
           "contiguous_s": contiguous_s, "paged_s": paged_s}
    log(f"[sealed] (c) {cfg.name} paged builders: prefill of {a} x {sb} "
        f"(prompts {[len(p) for p in prompts]}) + {PAGED_STEPS} decode "
        f"steps in {paged_s:.2f} s (contiguous path {contiguous_s:.2f} s); "
        f"logits vs the contiguous plaintext path, max rel err per prompt "
        f"{[f'{e:.3e}' for e in errs]} (tol {BF16_GATE}); launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    if not max(errs) <= BF16_GATE:
        raise AssertionError("(c) paged builders disagree with the "
                             "contiguous path")
    if (launches["chacha20_cache_splice"] != 1 + PAGED_STEPS
            or launches["chacha20_cache_view"] != views
            or launches["chacha20"]):
        raise AssertionError(f"(c) launches {launches}: expected "
                             f"{1 + PAGED_STEPS} splices, {views} views, no "
                             f"keystream kernel")
    del params, sp, pools
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_sealed_decode(torch, dev, args):
    """Phase 14 (module docstring, 14)."""
    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"reduced": _sealed_reduced(torch, dev, args)}
    out["full"] = _sealed_full(torch, dev, args)
    out["paged"] = _paged_builders(torch, dev, args)
    # the phase's launches: one step of each full-width variant, and the
    # paged builders' prefill and steps
    runs = [r["launches_per_step"] for r in out["full"]["variants"].values()]
    runs.append(out["paged"]["launches"])
    out["launches"] = {}
    for r in runs:
        for name, n in r.items():
            out["launches"][name] = out["launches"].get(name, 0) + n
    out["wall_s"] = time.time() - t_phase
    log(f"[sealed] phase 14: {out['wall_s']:.1f} s")
    return out


def flatten_paths(tree):
    from repro_torch.tree import flatten_with_path
    return [("/".join(p), t) for p, t in flatten_with_path(tree)]


CHACHA_KERNELS = {"chacha20": "chacha20_blocks_kernel",
                  "chacha20_cache_view": "cache_view_kernel",
                  "chacha20_cache_splice": "cache_splice_kernel",
                  "chacha20_cache_copy": "cache_copy_kernel",
                  "chacha20_cache_tags": "cache_tags_kernel",
                  "chacha20_cache_verify": "cache_verify_kernel",
                  "chacha20_lines_unseal": "lines_unseal_kernel",
                  "chacha20_lines_gather": "lines_gather_kernel",
                  "chacha20_weight_tile_tags": "tile_tags_kernel",
                  "chacha20_weight_line_tags": "line_tags_kernel"}


def _chacha_device_ms(prof):
    """Device ms of each ChaCha kernel per call of a ``_profile`` window."""
    return {name: sum(v for key, v in prof["device_ms"].items()
                      if fn in key) / prof["reps"]
            for name, fn in CHACHA_KERNELS.items()}


def _profile(torch, fn, reps, label, top=12, launches_of=None):
    """Device time by kernel over ``reps`` calls of ``fn``, and the share
    of the window in which the device ran nothing (torch.profiler);
    ``launches_of``: also each launch's ms, in order, of the kernels whose
    name holds that text."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    rows = []
    for ev in prof.key_averages():
        # kernel rows only: an operator's row repeats its kernels' time
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    out = {"reps": reps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": max(0.0, 1 - busy_ms / wall_ms),
           "kernel_launches": sum(r[2] for r in rows),
           "device_ms": {k: us / 1e3 for us, k, _ in rows},
           "top": [{"kernel": k[:90], "calls": c, "device_ms": us / 1e3}
                   for us, k, c in rows[:top]]}
    log(f"[profile] {reps} {label}: wall {wall_ms:.2f} ms, "
        f"device busy {busy_ms:.2f} ms, idle share {out['idle_share']:.3f}")
    for r in out["top"]:
        log(f"[profile]   {r['device_ms']:9.3f} ms  x{r['calls']:<6d} "
            f"{r['kernel']}")
    if launches_of is not None:
        evs = [ev for ev in prof.events()
               if str(getattr(ev, "device_type", "")).endswith("CUDA")
               and launches_of in ev.name]
        evs.sort(key=lambda ev: ev.time_range.start)
        out["launch_ms"] = [ev.time_range.elapsed_us() / 1e3 for ev in evs]
        log(f"[profile]   each {launches_of} in start order: "
            f"{[round(x, 4) for x in out['launch_ms']]} ms")
    return out


# --------------------------------------------------------------------------
# phase 15: sharding on DTensor, under a real NCCL group of one rank
# --------------------------------------------------------------------------

SHARD_REL = 1e-6           # (a): sharded vs unsharded on the card
SHARD_STEPS = 4            # (b): 13 (b)'s first 4 steps, through the mesh
SHARD_LOSS_REL = 1e-5
LAUNCH_STEPS = (2, 4)      # (d): the launcher's two runs, the second resumes
DRY_CELLS = (("granite_3_2b", "decode_32k", False, 0),
             ("internlm2_1_8b", "train_4k", False, 1),
             ("granite_3_2b", "decode_32k", True, 0),
             # the cells that run the per-shard regions: MoE, RG-LRU
             ("qwen3_moe_30b_a3b", "train_4k", False, 1),
             ("recurrentgemma_9b", "train_4k", False, 1))
WHOLE_PARAMS_GB = 7.56     # internlm2-1.8B's f32 params (its tree), for (a')


def _whole(t):
    """A DTensor's whole value (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _sharded_parity(torch, dev, mesh, cfg, seed, label):
    """(a): one ``make_train_step`` step and ``make_grad_fn``'s gradients,
    unsharded and on the mesh, from the same params and batch on the card."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as R
    from repro_torch.sharding.api import use_mesh
    from repro_torch.train.step import make_grad_fn, make_train_step
    tc = _train_tc(microbatches=2, remat="full", total_steps=10)
    nb = lm_batch(cfg, 4, 16, seed)
    res = {}
    for name in ("plain", "mesh"):
        params = T.init_params(cfg, seed, dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
        opt = adamw.init(params)
        scope = contextlib.nullcontext()
        if name == "mesh":
            params = R.distribute_tree(params, mesh,
                                       R.param_pspecs(cfg, mesh))
            opt = R.distribute_tree(opt, mesh, R.opt_pspecs(cfg, mesh))
            batch = R.distribute_tree(batch, mesh,
                                      R.batch_pspecs(cfg, mesh, "train"))
            scope = use_mesh(mesh, R.arch_rules(cfg, mesh))
        with scope:
            _, grads = make_grad_fn(cfg, "full")(params, batch)
            grads = [(p, _whole(g).cpu()) for p, g in flatten_paths(grads)]
            params, opt, m = make_train_step(cfg, tc)(params, opt, batch)
        res[name] = (grads, [(p, _whole(t).cpu()) for p, t in
                             flatten_paths(params)],
                     {k: float(_whole(v)) for k, v in m.items()})
        del params, opt, batch
    out = {"metric_rel": 0.0, "grad_err": 0.0, "param_err": 0.0}
    (g0, p0, m0), (g1, p1, m1) = res["plain"], res["mesh"]
    for k in m0:
        out["metric_rel"] = max(out["metric_rel"], abs(m1[k] - m0[k]) /
                                max(abs(m0[k]), 1e-30))
    for key, a, b in (("grad_err", g0, g1), ("param_err", p0, p1)):
        for (path, want), (path2, got) in zip(a, b):
            assert path == path2
            err = float((got - want).abs().max() /
                        want.abs().max().clamp(min=1e-30))
            out[key] = max(out[key], err)
    out["bitwise"] = all(bool(torch.equal(x, y)) for (_, x), (_, y) in
                         zip(g0 + p0, g1 + p1))
    log(f"[sharded] {label}: mesh vs unsharded, metrics rel "
        f"{out['metric_rel']:.2e}, gradients {out['grad_err']:.2e} and "
        f"params after the step {out['param_err']:.2e} of scale (bitwise "
        f"{out['bitwise']})")
    if not (out["metric_rel"] <= SHARD_REL and out["grad_err"] <= SHARD_REL
            and out["param_err"] <= SHARD_REL):
        raise AssertionError(f"[sharded] {label}: {out}")
    return out


def _sharded_init(torch, dev, args, mesh):
    """(a'): a fresh sharded start of internlm2-1.8B, all 24 layers
    (``rules.init_params``: one leaf drawn at a time, each rank keeping its
    block), against ``init_params`` on the card, bit for bit; its peak
    beside the whole params (on a 1x1 mesh the blocks are the whole
    leaves)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules as R
    cfg = get_config(TRAIN_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    fresh = R.init_params(cfg, args.seed, mesh, dev)
    torch.cuda.synchronize(dev)
    secs = time.time() - t0
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    blocks = sum(t.to_local().numel() * 4 for _, t in flatten_paths(fresh))
    largest = max(t.numel() * 4 for _, t in flatten_paths(fresh))
    whole = T.init_params(cfg, args.seed, dev)
    same = True
    for (path, f), (_, w) in zip(flatten_paths(fresh), flatten_paths(whole)):
        blk = R.local_block(tuple(w.shape), mesh, f.placements)
        got, want = f.to_local(), w[blk]
        same &= bool(got.shape == want.shape and torch.equal(
            got.view(torch.int32), want.view(torch.int32)))
    del fresh, whole
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[sharded] (a') fresh sharded start of internlm2-1.8B, 24 layers, "
        f"on the 1x1 mesh: bitwise init_params's blocks {same}; init peak "
        f"{peak:.3f} GB against the whole params' {WHOLE_PARAMS_GB} GB "
        f"(blocks {blocks / 1e9:.3f} GB, largest leaf {largest / 1e9:.3f} "
        f"GB); {secs:.1f} s")
    if not same or peak > (blocks + largest) / 1e9:
        raise AssertionError(f"[sharded] (a') fresh start: bitwise {same}, "
                             f"peak {peak} GB")
    return {"bitwise": same, "peak_gb": peak, "blocks_gb": blocks / 1e9,
            "largest_leaf_gb": largest / 1e9, "secs": secs}


def _sharded_full(torch, dev, args, mesh, full13, tmp):
    """(b): internlm2-1.8B, all 24 layers, through ``train(cfg, tc, mesh)``
    at 13 (b)'s settings for its first 4 steps."""
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH)
    tc = _train_tc(learning_rate=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS,
                   microbatches=TRAIN_MICRO, remat="save_carries",
                   checkpoint_every=10 * TRAIN_STEPS,
                   checkpoint_dir=os.path.join(tmp, "full"), seed=args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    (params, opt, _), ms, recs = _timed_train(
        torch, cfg, tc, mesh, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=SHARD_STEPS, log_path=os.path.join(tmp, "full.log"))
    wall = time.time() - t0
    del params, opt
    losses = [r["loss"] for r in recs if "loss" in r]
    want = full13["losses"][:SHARD_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    peak = _gib(torch.cuda.max_memory_allocated(dev))
    step_ms = statistics.median(ms[1:])
    ratio = step_ms / full13["median_step_ms"]
    log(f"[sharded] (b) internlm2-1.8B, 24 layers, on the 1x1 mesh: losses "
        f"{[round(x, 6) for x in losses]} against 13 (b)'s {want}: "
        f"{rel:.2e} relative; step (events) {[round(x, 2) for x in ms]} ms, "
        f"median of steps 2-{SHARD_STEPS} {step_ms:.2f} ms against 13 (b)'s "
        f"median {full13['median_step_ms']:.2f} ms (x{ratio:.3f}); peak "
        f"allocated {peak:.2f} GiB "
        f"(13 (b): {full13['peak_gib']:.2f}); train() {wall:.1f} s")
    if len(losses) != SHARD_STEPS or not rel <= SHARD_LOSS_REL:
        raise AssertionError(f"[sharded] (b) losses {losses} against {want}")
    return {"losses": losses, "loss_rel": rel, "step_ms": ms,
            "median_step_ms": step_ms,
            "unsharded_median_step_ms": full13["median_step_ms"],
            "peak_gib": peak, "wall_s": wall}


def _sharded_checkpoint(torch, dev, args, mesh, tmp):
    """(c): 13 (d)'s two full-width layers and their AdamW state (after one
    step, so m and v are not zero) saved sealed from the mesh, restored
    by ``elastic.rescale`` onto a fresh 1x1 mesh; the same state saved
    unsharded for its manifest."""
    from repro_torch.checkpoint.manager import CheckpointManager, _flatten
    from repro_torch.config import SealConfig
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.runtime import elastic
    from repro_torch.sharding import rules as R
    from repro_torch.train.step import make_train_step
    cfg = get_config(TRAIN_ARCH).with_(num_layers=TRAIN_CUT_LAYERS)
    params = T.init_params(cfg, args.seed, dev)
    opt = adamw.init(params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             lm_batch(cfg, 2, 64, args.seed).items()}
    make_train_step(cfg, _train_tc(total_steps=10))(params, opt, batch)
    del batch
    seal = SealConfig(mode="coloe")
    dirs = {k: os.path.join(tmp, f"ckpt_{k}") for k in ("mesh", "plain")}
    plain = _PlainCalls()
    t0 = time.time()
    try:
        p_mesh = R.distribute_tree(params, mesh, R.param_pspecs(cfg, mesh))
        o_mesh = R.distribute_tree(opt, mesh, R.opt_pspecs(cfg, mesh))
        saved = {"params": _flatten(p_mesh), "opt": _flatten(o_mesh)}
        n_leaves = sum(len(v) for v in saved.values())
        ops.reset_launch_counts()
        CheckpointManager(dirs["mesh"], seal=seal, device=dev).save(
            1, p_mesh, o_mesh, blocking=True)
        at_save = ops.launch_counts()
        CheckpointManager(dirs["plain"], seal=seal, device=dev).save(
            1, params, opt, blocking=True)
        del p_mesh, o_mesh, params, opt
        manifests = {}
        for k, d in dirs.items():
            with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
                manifests[k] = json.load(f)["leaves"]
        shutil.rmtree(dirs["plain"])
        ops.reset_launch_counts()
        step, p2, o2, mesh2 = elastic.rescale(
            cfg, CheckpointManager(dirs["mesh"], seal=seal, device=dev))
        at_restore = ops.launch_counts()
        restored = {"params": _flatten(p2), "opt": _flatten(o2)}
        del p2, o2
    finally:
        plain.close()
    wall = time.time() - t0
    if manifests["mesh"] != manifests["plain"]:
        raise AssertionError("[sharded] (c) the sharded save's files are not "
                             "an unsharded save's")
    if step != 1 or tuple(mesh2.shape) != (1, 1):
        raise AssertionError(f"[sharded] (c) rescale: step {step}, mesh "
                             f"{tuple(mesh2.shape)}")
    for group, leaves in saved.items():
        for k, v in leaves.items():
            r = restored[group][k]
            if r.dtype != v.dtype or r.shape != v.shape or \
                    r.tobytes() != v.tobytes():
                raise AssertionError(f"[sharded] (c) restored {group}/{k} is "
                                     f"not the saved one bit for bit")
    if not at_save["chacha20"] >= n_leaves or \
            at_restore["chacha20_lines_unseal"] != n_leaves:
        raise AssertionError(f"[sharded] (c) launches: save {at_save}, "
                             f"restore {at_restore}, {n_leaves} leaves")
    if plain.calls:
        raise AssertionError(f"[sharded] (c) {plain.calls} calls of a plain "
                             f"sealing version on the card's path")
    launches = {k: at_save[k] + at_restore[k] for k in at_save}
    log(f"[sharded] (c) {n_leaves} leaves of {TRAIN_CUT_LAYERS} full-width "
        f"layers and their AdamW state, sealed (ColoE) from the 1x1 mesh: "
        f"manifest (every file's SHA-256) equal to an unsharded save's; "
        f"rescaled onto a fresh 1x1 mesh bit for bit; launches at the save "
        f"{_nonzero(at_save)}, at the restore {_nonzero(at_restore)}; no "
        f"plain sealing version called; {wall:.1f} s")
    return {"leaves": n_leaves, "save_launches": at_save,
            "restore_launches": at_restore, "launches": launches,
            "wall_s": wall}


class _Background:
    """``fn(*args)`` in a thread; ``result()`` joins it and re-raises."""

    def __init__(self, fn, *args):
        import threading
        self._out = {}

        def run():
            try:
                self._out["value"] = fn(*args)
            except BaseException as e:      # re-raised in result()
                self._out["error"] = e
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def result(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


def _sharded_launcher(tmp):
    """(d): the training launcher under ``torchrun`` (one rank, NCCL), run
    twice on one checkpoint directory; the second run resumes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ck = os.path.join(tmp, "launcher_ckpt")
    out = []
    for steps in LAUNCH_STEPS:
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
             "--arch", TRAIN_ARCH, "--steps", str(steps),
             "--checkpoint-every", str(LAUNCH_STEPS[0]),
             "--checkpoint-dir", ck, "--batch", "8", "--seq", "64"],
            env=env, capture_output=True, text=True, timeout=300)
        wall = time.time() - t0
        resumed = f"step={LAUNCH_STEPS[0]} event=resumed" in r.stderr
        log(f"[sharded] (d) torchrun launcher --steps {steps}: exit "
            f"{r.returncode} in {wall:.1f} s, resumed {resumed}; "
            f"{r.stdout.strip().splitlines()[-1:]}")
        if r.returncode != 0:
            raise AssertionError(f"[sharded] (d) launcher failed: "
                                 f"{r.stderr[-3000:]}")
        out.append({"steps": steps, "wall_s": wall, "resumed": resumed})
    if out[0]["resumed"] or not out[1]["resumed"]:
        raise AssertionError(f"[sharded] (d) resume: {out}")
    return out


_DRY_RUNNER = """
import json, sys, time
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_distributed
init_distributed("cpu", fake=True, world_size=dryrun.WORLD)
for arch, shape, multi_pod, mb in CELLS:
    t0 = time.time()
    rec = dryrun.run_cell(arch, shape, multi_pod, microbatches=mb)
    rec["wall_s"] = time.time() - t0
    print(json.dumps(rec), flush=True)
"""


def _start_dryrun():
    """(e), started: the dry run's cells in a subprocess."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, "-c", _DRY_RUNNER.replace("CELLS",
                                                   repr(DRY_CELLS))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish_dryrun(proc):
    """(e)'s gates on the records the subprocess printed."""
    from repro_torch.config import SHAPES
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import roofline_row
    o, e = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"[sharded] (e) dry run failed: {e[-3000:]}")
    out = []
    for line in o.strip().splitlines():
        rec = json.loads(line)
        cfg, shape = get_config(rec["arch"]), SHAPES[rec["shape"]]
        n_matmul = cfg.param_count(active_only=True) - \
            cfg.vocab_size * cfg.d_model
        rows = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
        matmul = (6.0 if shape.kind == "train" else 2.0) * n_matmul * rows
        row = roofline_row(rec)
        coll = sum(rec["collective_bytes_per_device"].values())
        counted = rec["flops_per_device"] * rec["devices"]
        log(f"[sharded] (e) dry run {rec['arch']} {rec['shape']} "
            f"{rec['mesh']} ({rec['devices']} fake ranks, "
            f"{rec.get('microbatches', '-')} microbatches): status "
            f"{rec['status']}, {rec['flops_per_device']:.4e} FLOP and "
            f"{rec['bytes_per_device']:.4e} B (unfused) a device, "
            f"collectives {rec['collective_bytes_per_device']}, memory "
            f"{rec['memory']}; FLOPs x devices {counted:.4e} against the "
            f"matmul part of model_flops {matmul:.4e}; "
            f"{rec['wall_s']:.1f} s")
        log(f"[sharded] (e) roofline_row {json.dumps(row)}")
        if rec["status"] != "ok" or not coll > 0 or not counted >= matmul:
            raise AssertionError(f"[sharded] (e) {rec['arch']} "
                                 f"{rec['shape']} {rec['mesh']}: {rec}")
        out.append({"record": rec, "row": row, "matmul_flops": matmul})
    if len(out) != len(DRY_CELLS):
        raise AssertionError(f"[sharded] (e) {len(out)} records: {e[-2000:]}")
    return out


def phase_sharded(torch, dev, args, train13, dry):
    """Phase 15: sharding on DTensor (module docstring, 15); ``dry`` is
    (e)'s subprocess, started before phase 14 so that it runs beside it."""
    import tempfile
    from repro_torch.configs import ARCH_IDS, get_reduced
    from repro_torch.launch.mesh import (init_distributed, make_host_mesh,
                                         shutdown_distributed)
    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"parity": {}}
    tmp = tempfile.mkdtemp(prefix="repro_sharded_")
    try:
        if init_distributed("cuda") != "cuda":
            raise AssertionError("[sharded] no NCCL group on the card")
        import torch.distributed as dist
        log(f"[sharded] process group: {dist.get_backend()}, world "
            f"{dist.get_world_size()}")
        if dist.get_backend() != "nccl":
            raise AssertionError(f"[sharded] backend {dist.get_backend()}")
        try:
            mesh = make_host_mesh(1, 1, device_type="cuda")
            t0 = time.time()
            for arch in ARCH_IDS:
                out["parity"][arch] = _sharded_parity(
                    torch, dev, mesh, get_reduced(arch).with_(
                        dtype="float32"), args.seed, f"(a) {arch} reduced")
            log(f"[sharded] (a) {time.time() - t0:.1f} s")
            out["init"] = _sharded_init(torch, dev, args, mesh)
            out["full"] = _sharded_full(torch, dev, args, mesh,
                                        train13["full"], tmp)
            # (d)'s subprocesses run while (c) seals, writes and hashes
            launcher = _Background(_sharded_launcher, tmp)
            out["checkpoint"] = _sharded_checkpoint(torch, dev, args, mesh,
                                                    tmp)
            out["launcher"] = launcher.result()
        finally:
            shutdown_distributed()
        out["dryrun"] = _finish_dryrun(dry)
    finally:
        if dry.poll() is None:
            dry.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = out["checkpoint"]["launches"]
    out["wall_s"] = time.time() - t_phase
    log(f"[sharded] phase 15: {out['wall_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 16: the port's three examples on the card
# --------------------------------------------------------------------------

EXAMPLE_TRAIN_STEPS = 30
EXAMPLE_MATMUL_REL = 1e-4   # quickstart step 5 against the plain product


def _start_example(name, argv, env):
    """One example started as a subprocess on the card."""
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", name + ".py")] + argv,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _example(name, argv, proc, t0):
    """An example's stdout, once it has exited 0, and its wall s."""
    out, err = proc.communicate(timeout=300)
    wall = time.time() - t0
    log(f"[examples] {name} {' '.join(argv)}: exit {proc.returncode} in "
        f"{wall:.1f} s")
    for line in out.strip().splitlines()[-12:]:
        log(f"[examples]   {line}")
    if proc.returncode != 0:
        raise AssertionError(f"[examples] {name} failed: "
                             f"{(out + err)[-3000:]}")
    return out, wall


def phase_examples(torch, dev, args):
    """Phase 16: ``examples/torch_quickstart.py``, ``torch_sealed_serving.py``
    and ``torch_train_lm.py`` (lm_100m, 30 steps) on the card, each gated
    on its own claim line."""
    import tempfile
    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    tmp = tempfile.mkdtemp(prefix="repro_examples_")
    ckpt = os.path.join(tmp, "train_lm")
    # the three side by side: small loads on one card
    argv = {"torch_quickstart": [], "torch_sealed_serving": [],
            "torch_train_lm": ["--steps", str(EXAMPLE_TRAIN_STEPS),
                               "--ckpt", ckpt]}
    t0 = time.time()
    procs = {name: _start_example(name, a, env) for name, a in argv.items()}
    out = {}
    try:
        text, wall = _example("torch_quickstart", argv["torch_quickstart"],
                              procs["torch_quickstart"], t0)
        lines = text.strip().splitlines()
        step5 = json.loads(next(x for x in lines
                                if x.startswith("step5 "))[6:])
        rel = step5["max_abs_err"] / step5["scale"]
        log(f"[examples] quickstart step 5: {step5['max_abs_err']:.3e} of "
            f"scale {step5['scale']:.3f} ({rel:.2e}; gate "
            f"{EXAMPLE_MATMUL_REL}), sealed_matmul launches "
            f"{step5['sealed_matmul_launches']}")
        if not (lines[-1] == "quickstart OK" and rel <= EXAMPLE_MATMUL_REL
                and step5["sealed_matmul_launches"] >= 1):
            raise AssertionError(f"[examples] quickstart: {lines[-1]!r}, "
                                 f"{step5}")
        out["quickstart"] = dict(step5, rel_err=rel, wall_s=wall)
        text, wall = _example("torch_sealed_serving",
                              argv["torch_sealed_serving"],
                              procs["torch_sealed_serving"], t0)
        if "all modes produce identical generations: True" not in text:
            raise AssertionError(f"[examples] sealed_serving: {text[-2000:]}")
        out["sealed_serving"] = {"wall_s": wall,
                                 "modes": [x for x in text.splitlines()
                                           if " reqs in " in x]}
        text, wall = _example("torch_train_lm", argv["torch_train_lm"],
                              procs["torch_train_lm"], t0)
        with open(os.path.join(ckpt, "metrics.jsonl")) as f:
            recs = [json.loads(x) for x in f]
        losses = [r["loss"] for r in recs if "loss" in r]
        secs = [r["sec"] for r in recs if "sec" in r]
        log(f"[examples] train_lm: {len(losses)} losses, first "
            f"{losses[0]:.4f}, last {losses[-1]:.4f}; median step "
            f"{statistics.median(secs[1:]) * 1e3:.1f} ms (host clock)")
        if not ("trained lm-100m" in text and
                len(losses) == EXAMPLE_TRAIN_STEPS and
                losses[-1] < losses[0]):
            raise AssertionError(f"[examples] train_lm: {losses}")
        out["train_lm"] = {"wall_s": wall, "losses": losses,
                           "median_step_s": statistics.median(secs[1:])}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.time() - t_phase
    log(f"[examples] phase 16: {out['wall_s']:.1f} s")
    return out


if __name__ == "__main__":
    sys.exit(main())
