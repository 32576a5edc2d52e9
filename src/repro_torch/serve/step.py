"""Scheduler state and serve-step transitions on the device. Port of
``SchedState``, ``admit``, ``evict``, ``cow``, ``chunk_step`` and
``decode_tick`` from ``repro/serve/step.py``.

The reference's jitted, donated transitions become functions that update
the device tensors of ``SchedState`` and the pools IN PLACE. A decode tick
needs nothing from the host but one flag, and only its sampled tokens (with
the cache verdicts, when they are checked) go back to it: the engine's one
device-to-host copy per tick. The flag ``greedy`` is the host's knowledge
that every slot in the dispatch samples at temperature 0 (the engine keeps
each slot's settings): the reference decides that on the device under
``lax.cond``; here a greedy dispatch launches the argmax alone.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import paged as PG
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
