"""Scheduler state and serve-step transitions on the device. Port of
``SchedState``, ``admit``, ``evict``, ``cow``, ``chunk_step``,
``decode_tick`` and the step builders ``make_decode_step``,
``make_paged_decode_step``, ``make_paged_prefill`` and
``make_sealed_decode_step`` from ``repro/serve/step.py``.

The reference's jitted, donated transitions become functions that update
the device tensors of ``SchedState`` and the pools IN PLACE. A decode tick
needs nothing from the host but one flag, and only its sampled tokens (with
the cache verdicts, when they are checked) go back to it: the engine's one
device-to-host copy per tick. The flag ``greedy`` is the host's knowledge
that every slot in the dispatch samples at temperature 0 (the engine keeps
each slot's settings): the reference decides that on the device under
``lax.cond``; here a greedy dispatch launches the argmax alone.

The builders are plain closures over ``cfg`` (the reference jits them):
the contiguous decode step, plain or over a sealed image (the paper's
decrypt-on-use step, fused or not), and the paged admission prefill and
decode step, whose pools are updated in place and whose caller mirrors the
write-counter bumps, as the reference's host does. The engines above do not
call them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import sealed_store as SS
from repro_torch.models import paged as PG
from repro_torch.models import transformer as T
from repro_torch.serve import sampling as SM


@dataclasses.dataclass
class SchedState:
    """Per-slot scheduler state the decode loop touches, on the device.

    tables (S, MB) int64   block table per slot (0 = scratch block)
    lengths (S,) int64     tokens in the cache per slot
    wc (NB,) int32         per-pool-block write counters (u32 words)
    run (S,) bool          slot is decoding (prefill finished)
    last_tok (S,) int64    token fed at the next decode tick
    counts (S,) int64      tokens generated so far (PRNG stream index)
    key_data (S, 2) int32  per-request PRNG key (u32 words)
    temp (S,) f32, topk (S,) int64, topp (S,) f32   sampling settings
    """
    tables: torch.Tensor
    lengths: torch.Tensor
    wc: torch.Tensor
    run: torch.Tensor
    last_tok: torch.Tensor
    counts: torch.Tensor
    key_data: torch.Tensor
    temp: torch.Tensor
    topk: torch.Tensor
    topp: torch.Tensor


def sched_init(slots: int, max_blocks: int, num_blocks: int,
               device=None) -> SchedState:
    z = lambda: torch.zeros((slots,), dtype=torch.int64, device=device)
    return SchedState(
        tables=torch.zeros((slots, max_blocks), dtype=torch.int64,
                           device=device),
        lengths=z(),
        wc=torch.zeros((num_blocks,), dtype=torch.int32, device=device),
        run=torch.zeros((slots,), dtype=torch.bool, device=device),
        last_tok=z(),
        counts=z(),
        key_data=torch.zeros((slots, 2), dtype=torch.int32, device=device),
        temp=torch.zeros((slots,), dtype=torch.float32, device=device),
        topk=z(),
        topp=torch.ones((slots,), dtype=torch.float32, device=device),
    )


def admit(state: SchedState, slot_ids, tables, n_shared, key_data, temp,
          topk, topp) -> None:
    """Write whole rows for the admitted slots; they enter the chunked
    prefill phase (run=False) with ``lengths`` = shared-prefix tokens, and
    take their requests' PRNG keys and sampling settings."""
    state.tables[slot_ids] = tables
    state.lengths[slot_ids] = n_shared
    state.run[slot_ids] = False
    state.last_tok[slot_ids] = 0
    state.counts[slot_ids] = 0
    state.key_data[slot_ids] = key_data
    state.temp[slot_ids] = temp
    state.topk[slot_ids] = topk
    state.topp[slot_ids] = topp


def evict(state: SchedState, slot_ids) -> None:
    """Zero finished rows so the decode tick's masked lanes read benign
    state."""
    state.tables[slot_ids] = 0
    state.lengths[slot_ids] = 0
    state.run[slot_ids] = False
    state.last_tok[slot_ids] = 0
    state.counts[slot_ids] = 0
    state.temp[slot_ids] = 0.0
    state.topk[slot_ids] = 0
    state.topp[slot_ids] = 1.0


def _sample(logits, state: SchedState, rows, counts, greedy: bool):
    """Tokens for ``logits`` (B, V), row i drawn for slot ``rows[i]`` (all
    slots when None) at its count ``counts[i]``; the argmax alone when the
    host says every row is greedy."""
    if greedy:
        return SM.sample_logits(logits)
    pick = (lambda t: t) if rows is None else (lambda t: t[rows])
    keys = SM.fold_token_keys(pick(state.key_data), counts)
    return SM.sample_logits(logits, keys, pick(state.temp),
                            pick(state.topk), pick(state.topp),
                            greedy=False)


def cow(cfg: ModelConfig, pools, state: SchedState, src, dst, mask,
        cache_seal):
    """Copy-on-write of pool blocks ``src -> dst`` (re-keyed in flight when
    sealed), bumping the destination write counters. Returns ok, a () bool:
    False if a verified source block failed its MAC (always True without
    cache verification)."""
    return PG.copy_blocks(cfg, cache_seal, pools, state.wc, src, dst, mask)


def chunk_step(cfg: ModelConfig, params, pools, state: SchedState, slot_ids,
               tokens, chunk_len, is_final, cache_seal, greedy: bool = True,
               pad_rows: int = 0):
    """One chunked-prefill step for the listed slots: run the chunk, seal
    its K/V into the slots' blocks, and on each row's final chunk sample the
    request's first token (stream index 0). Returns (tok, cok, logits): tok
    is 0 on rows that are not final; cok (S,) bool is the per-slot cache
    verdict, True on slots not in the chunk (and everywhere without
    verification).

    ``pad_rows`` more rows run through the model after the listed ones, as
    the reference's padding rows do (slot id S clamped to the last slot's
    table and length, zero tokens, chunk length 0): an MoE layer's capacity
    counts every token of the dispatch. They write nothing to the pools,
    change no state and return nothing."""
    n = slot_ids.shape[0]
    sl, cl = slot_ids, chunk_len
    if pad_rows:
        last = state.lengths.shape[0] - 1
        sl = torch.cat([slot_ids, slot_ids.new_full((pad_rows,), last)])
        cl = torch.cat([chunk_len, chunk_len.new_zeros((pad_rows,))])
        tokens = torch.cat([tokens, tokens.new_zeros(
            (pad_rows, tokens.shape[1]))])
    tables = state.tables[sl]
    lengths = state.lengths[sl]
    logits, updates, okr = PG.chunk_logits(cfg, params, pools, tables,
                                           lengths, state.wc, tokens, cl,
                                           cache_seal)
    if pad_rows:
        logits, okr, tables, lengths = (logits[:n], okr[:n], tables[:n],
                                        lengths[:n])
        updates = tuple({key: u[:, :n] for key, u in uj.items()}
                        for uj in updates)
    PG.append_tokens(cfg, cache_seal, pools, updates, tables, lengths,
                     chunk_len, state.wc)
    zero = torch.zeros((), dtype=torch.int64, device=tokens.device)
    tok = torch.where(is_final, _sample(logits, state, slot_ids,
                                        torch.zeros_like(chunk_len), greedy),
                      zero)
    state.lengths[slot_ids] = lengths + chunk_len
    state.run[slot_ids] = is_final
    state.counts[slot_ids] = is_final.to(torch.int64)
    state.last_tok[slot_ids] = tok
    cok = torch.ones_like(state.run)
    cok[slot_ids] = okr
    return tok, cok, logits


def decode_tick(cfg: ModelConfig, params, pools, state: SchedState,
                cache_seal, greedy: bool = True):
    """Advance every running slot one token: logits over the paged view,
    sealed tail-block append, each slot sampled at its count. Slots not
    running write
    nothing and keep their state. Returns (tok, cok, logits), all on the
    device; cok (S,) bool is the per-slot cache verdict (only running slots
    can fail)."""
    logits, updates, ok = PG.decode_logits(cfg, params, pools, state.tables,
                                           state.lengths, state.wc,
                                           state.last_tok[:, None],
                                           cache_seal)
    cnt = state.run.to(torch.int64)
    PG.append_tokens(cfg, cache_seal, pools, updates, state.tables,
                     state.lengths, cnt, state.wc)
    tok = torch.where(state.run,
                      _sample(logits, state, None, state.counts, greedy),
                      state.last_tok)
    cok = ok | ~state.run
    state.lengths += cnt
    state.counts += cnt
    state.last_tok.copy_(tok)
    return tok, cok, logits


def _step_inputs(cfg: ModelConfig, batch):
    """The reference's ``batch`` dict as ``transformer.decode_step`` takes
    it: the token tensor (B, 1), or for a frontend-stub config the dict
    itself, whose ``embeds`` (B, 1, D) ``_embed`` reads."""
    return batch if cfg.frontend is not None else batch["tokens"]


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, cache, batch, pos)`` -> (logits (B, V),
    cache, next_token (B,)); the cache is updated in place."""
    def decode_step(params, cache, batch, pos):
        return T.decode_step(cfg, params, cache, _step_inputs(cfg, batch),
                             int(pos))
    return decode_step


def make_paged_decode_step(cfg: ModelConfig, materialize, cache_seal):
    """Continuous-batching decode step over the paged (optionally sealed)
    KV pools: every slot advances one token at its own position, its new
    K/V are appended (sealed) into its tail block, and the next token is
    sampled from each request's own PRNG stream. ``materialize`` maps the
    stored param tree (possibly ``SealedTensor`` leaves) to the serving
    view. Returns (tok, logits, pools); the caller bumps ``wc`` of each
    slot's tail block after the step."""
    def decode_step(tensors, pools, tables, lengths, wc, tokens, key_data,
                    counts, temperature, top_k, top_p):
        params = materialize(tensors)
        logits, updates, _ = PG.decode_logits(cfg, params, pools, tables,
                                              lengths, wc, tokens, cache_seal)
        pools = PG.apply_paged_updates(cfg, cache_seal, pools, updates,
                                       tables, lengths, wc)
        keys = SM.fold_token_keys(key_data, counts)
        tok = SM.sample_logits(logits, keys, temperature, top_k, top_p,
                               greedy=False)
        return tok, logits, pools
    return decode_step


def make_paged_prefill(cfg: ModelConfig, materialize, cache_seal):
    """Ragged admission prefill: run a right-padded (A, S_bucket) batch,
    seal its KV into the admitted slots' pool blocks (their counters bumped
    by the caller beforehand), and sample each request's first token
    (generation index 0). Returns (tok, logits, pools)."""
    def prefill(tensors, pools, tokens, true_len, block_tables, wc,
                key_data, temperature, top_k, top_p):
        params = materialize(tensors)
        logits, cache = PG.prefill_logits(cfg, params, tokens, true_len)
        pools = PG.prefill_write(cfg, cache_seal, pools, cache,
                                 block_tables, wc)
        keys = SM.fold_token_keys(key_data, torch.zeros_like(true_len))
        tok = SM.sample_logits(logits, keys, temperature, top_k, top_p,
                               greedy=False)
        return tok, logits, pools
    return prefill


def make_sealed_decode_step(cfg: ModelConfig, sp: SS.SealedParams,
                            key_bytes: bytes, fused: bool = True):
    """Decode with decryption in the step: it receives the ciphertext
    ``SealedTensor`` leaves. With ``fused`` (the default) the matmul-shaped
    leaves stay sealed into the fused decrypt-in-matmul kernels and only
    the line leaves are decrypted first (``fused_params``); with
    ``fused=False`` every leaf is decrypted first (``unseal_params``: on the
    card a line leaf by one ``lines_unseal`` launch, a tile leaf slice by
    slice, its pad from the ChaCha kernel XORed in), the paper-faithful
    baseline that moves the weights three times."""
    def decode_step(tensors, cache, batch, pos):
        sp2 = SS.SealedParams(tensors, sp.plans, sp.skeleton, sp.seal,
                              sp._engines)
        params = (SS.fused_params if fused else SS.unseal_params)(
            sp2, key_bytes)
        return T.decode_step(cfg, params, cache, _step_inputs(cfg, batch),
                             int(pos))
    return decode_step
