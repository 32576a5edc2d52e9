"""Serving engines over the sealed weights. Port of
``repro/serve/engine.py`` (``ServeEngine``, ``GroupServeEngine``).

``ServeEngine`` is the continuous batcher over the paged, sealed KV cache.

A fixed set of decode slots with admission and eviction at every step. The
per-slot scheduler state (block tables, lengths, write counters, last
tokens) lives on the device in a ``SchedState`` updated in place
(``serve/step.py``); the host keeps the block allocator, the request
bookkeeping and debug mirrors of the device state (``check_device_mirror``).
Prompts prefill in fixed-size chunks between decode ticks, and a decode
tick copies only its sampled tokens to the host.

With ``seal`` the weights are sealed (``core/sealed_store.py``) and stay
ciphertext up to the fused decrypt-in-matmul kernel, and the token
embedding up to the gather of each dispatch's rows
(``sealed_store.serving_params``); with ``seal_cache``
(default: follows sealed weights) the KV pools hold ciphertext too. Without
``seal`` the engine keeps the matmul weights and the embedding table once in
the compute dtype (``_plain_weights``): the roundings every use makes anyway.

``GroupServeEngine`` is the group-drain baseline: prefill a group of
prompts in one shot (self-attention through the flash kernel, the RG-LRU
and SSD recurrences over the whole prompt), then decode over a contiguous,
plaintext cache until every member finishes. The reference keeps it for
benchmark comparison and serves recurrent/SSD architectures only through
it.

With ``prefix_share`` identical prompt prefixes share cache blocks
copy-on-write (``models.cache.PrefixRegistry``): a block's pad derives from
its pool address and write counter, so several tables read one ciphertext
block as it is, and a slot pays one re-keying copy (``ops.cache_copy``) only
when it must append into a shared tail block. With ``verify`` the sealed
cache carries per-block MACs: every read is checked, a failure fails only
the owning request, which is re-prefilled once (``fault_hooks`` model the
adversary, ``core.security.tamper``); over sealed weights ``verify`` also
seals the weights with per-tile and per-line MACs and sweeps them once per
drain (``_verify_weights``), fail-stop. Requests sample with their own
temperature / top-k / top-p from the reference's PRNG streams
(``serve/sampling.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import u32
from repro_torch.config import ModelConfig, SealConfig
from repro_torch.core import sealed_store as SS
from repro_torch.core.mac import SealedIntegrityError
from repro_torch.device import resolve_device
from repro_torch.models import cache as MC
from repro_torch.models import transformer as T
from repro_torch.runtime.fault import StragglerTimeout
from repro_torch.serve import sampling as SM
from repro_torch.serve import step as ST
from repro_torch.tree import flatten_with_path, leaves, map_leaves, unflatten

# leaves read only through a rounding to the compute dtype: every weight
# contraction (the experts', the router's and the recurrent blocks' too),
# the embedding table's gather, and the recurrent blocks' conv taps and
# gate biases; the RG-LRU's ``lam`` and SSD's ``A_log``, ``D``, ``dt_bias``
# and ``norm_scale`` are read in f32 and stay f32
_ROUNDED_LEAVES = ("w", "wq", "wk", "wv", "wo", "wi", "wg", "router",
                   "w_x", "w_gate", "w_rg", "w_ig", "w_out", "w_in",
                   "conv_w", "conv_b", "b_rg", "b_ig")


def _plain_weights(cfg: ModelConfig, params):
    """``params`` with the leaves in ``_ROUNDED_LEAVES`` stored in the
    compute dtype; norms stay f32. The results are bit for bit those of the
    f32 tree, since each such leaf is rounded to the compute dtype before
    every use."""
    dt = getattr(torch, cfg.dtype)
    flat = flatten_with_path(params)
    return unflatten(params, [t.to(dt) if p[-1] in _ROUNDED_LEAVES else t
                              for p, t in flat])


def _sweep_weights(eng) -> None:
    """One MAC sweep of a verifying engine's sealed weight image, counted as
    a ``mac_check``; a failure raises ``SealedIntegrityError("weights")``."""
    if not (eng.verify and eng.sealed is not None):
        return
    eng.stats["mac_checks"] += 1
    if not bool(SS.verify_params(eng.sealed, eng.key_bytes)):
        eng.stats["mac_failures"] += 1
        raise SealedIntegrityError(
            "weights", "sealed weight image failed its MAC sweep: "
            "fail-stop, the model is not trustworthy")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                # (S,) int32
    max_tokens: int = 32
    eos: int = -1
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_done: float = 0.0
    retries: int = 0                  # integrity-failure re-prefills so far
    error: Optional[str] = None       # "integrity" once the retry budget is
                                      # spent; None on clean completion


def _check_prompt(prompt: np.ndarray, vocab: int) -> None:
    """Token ids must lie in [0, vocab): refused before anything reaches the
    device (the reference instead embeds a NaN row or wraps the id)."""
    if prompt.size and (int(prompt.min()) < 0 or int(prompt.max()) >= vocab):
        raise ValueError(f"prompt token ids must lie in [0, {vocab}), got "
                         f"[{int(prompt.min())}, {int(prompt.max())}]")


class ServeEngine:
    """Continuous batcher over the paged, sealed KV cache.

    Device side: the decode tick, the chunked-prefill step and the
    copy-on-write (``serve/step.py``) over the resident ``SchedState`` and
    pools. Host side: the refcounted block allocator, the prefix registry,
    per-slot request bookkeeping and debug mirrors
    (``_tables``/``_lengths``/``_wc``/``_counts``), never read by the hot
    loop; ``_wc`` is also the trusted copy of the write counters that an
    integrity retry restores the device's from.
    """

    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 4,
                 max_len: int = 256, seal: Optional[SealConfig] = None,
                 key_bytes: bytes = bytes(range(32)), block_size: int = 16,
                 seal_cache: Optional[bool] = None,
                 admit_batch: Optional[int] = None, sample_seed: int = 0,
                 prefix_share: bool = False,
                 chunk_tokens: Optional[int] = None,
                 verify: bool = False, watchdog=None,
                 max_run_steps: Optional[int] = None, fault_hooks=(),
                 device=None):
        if cfg.frontend is not None:      # the reference's assert
            raise AssertionError("serving demo targets token archs")
        bad = [k for k in cfg.pattern if k not in ("attn", "local_attn")]
        if bad:
            raise ValueError(f"continuous batching needs attention-only "
                             f"patterns (got {bad}); use GroupServeEngine "
                             f"for recurrent/SSD archs")
        weights_sealed = seal is not None and seal.mode != "none"
        if seal_cache is None:
            seal_cache = weights_sealed
        if verify and not (weights_sealed or seal_cache):
            raise ValueError("verify=True needs sealed weights and/or a "
                             "sealed cache: there is nothing to MAC")
        if weights_sealed and verify and not seal.verify:
            seal = dataclasses.replace(seal, verify=True)
        self.device = resolve_device(device)
        params = map_leaves(lambda t: t.to(self.device), params)
        self.cfg = cfg
        self.slots = batch_slots
        self.block_size = block_size
        self.max_len = -(-max_len // block_size) * block_size
        self.seal_cache = seal_cache
        self.seal = seal
        self.key_bytes = key_bytes
        self.verify = verify
        self.watchdog = watchdog
        self.max_run_steps = max_run_steps
        self.fault_hooks = tuple(fault_hooks)
        self.sealed = (SS.seal_params(params, seal, key_bytes)
                       if weights_sealed else None)
        # the weight image is immutable while serving: it is swept by its
        # own MAC pass at drain entry, not re-hashed inside every dispatch
        self._wswept = False
        self._plain_params = (None if weights_sealed
                              else _plain_weights(cfg, params))

        self.cache_seal = (SS.cache_seal_config(key_bytes, self.device,
                                                verify=verify)
                           if seal_cache else None)
        if verify and seal_cache:   # the hash keys, once, on the device
            self.cache_seal.mac.hash_keys(
                block_size * MC.kv_words_per_token(cfg))

        s, mb = self.slots, self.max_len // block_size
        self.num_blocks = 1 + s * mb          # block 0 = scratch
        self._pools = MC.paged_pool_init(cfg, self.num_blocks, block_size,
                                         self.device)
        self._state = ST.sched_init(s, mb, self.num_blocks, self.device)
        self._alloc = MC.BlockAllocator(self.num_blocks)
        self.prefix_share = prefix_share
        self._registry = (MC.PrefixRegistry(self._alloc, block_size)
                          if prefix_share else None)
        self.chunk_tokens = int(chunk_tokens or 2 * block_size)
        self._active: List[Optional[Request]] = [None] * s
        self._slot_blocks: List[List[int]] = [[] for _ in range(s)]
        self._pending: List[Optional[np.ndarray]] = [None] * s
        self._tables = np.zeros((s, mb), np.int64)
        self._lengths = np.zeros((s,), np.int64)
        self._wc = np.zeros((self.num_blocks,), np.uint32)
        self._last_tok = np.zeros((s,), np.int64)
        self._counts = np.zeros((s,), np.int64)
        self._temp = np.zeros((s,), np.float32)    # decides greedy dispatches
        self._admit_n = min(admit_batch or max(1, batch_slots // 4),
                            batch_slots)
        self._sample_seed = sample_seed
        self._next_rid = 0
        self.queue: List[Request] = []
        self._done: List[Request] = []

        itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)
                               ).element_size()
        kv_pt = 0 if seal_cache else (
            2 * cfg.n_superblocks() * len(cfg.pattern) * s * self.max_len
            * cfg.num_kv_heads * cfg.head_dim * itemsize)
        w_pt = (self.sealed.serving_plaintext_bytes(
                    s, getattr(torch, cfg.dtype), cfg.tie_embeddings)
                if self.sealed else sum(t.numel() * t.element_size()
                                        for t in leaves(self._plain_params)))
        self.stats = {
            "prefills": 0, "prefill_chunks": 0, "decode_steps": 0,
            "tokens": 0, "cow_copies": 0,
            "mac_checks": 0, "mac_failures": 0, "retries": 0,
            "shared_prefix_blocks": 0, "shared_prefix_tokens": 0,
            "fused_matmul_leaves": (len(self.sealed.fused_paths())
                                    if self.sealed else 0),
            "weights_plaintext_bytes_per_step": w_pt,
            "kv_plaintext_bytes_per_step": kv_pt,
            "plaintext_bytes_per_step": w_pt + kv_pt,
        }

    # -------------------------------------------------- public API

    def params(self):
        """The serving view for one dispatch: line-layout leaves decrypted
        but the token embedding, which stays line-sealed to its gather;
        tile-sealed leaves still sealed (the plaintext params when the
        weights are not sealed)."""
        if self.sealed is None:
            return self._plain_params
        return SS.serving_params(self.sealed, self.key_bytes,
                                 self.cfg.tie_embeddings)

    def submit(self, prompt, max_tokens: int = 32, eos: int = -1,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0) -> Request:
        prompt = np.asarray(prompt, np.int32)
        if not 1 <= len(prompt) < self.max_len:
            raise ValueError(f"prompt length {len(prompt)} vs max_len "
                             f"{self.max_len}")
        _check_prompt(prompt, self.cfg.vocab_size)
        r = Request(self._next_rid, prompt, max_tokens, eos,
                    temperature, top_k, top_p, t_submit=time.time())
        self._next_rid += 1
        self.queue.append(r)
        return r

    @property
    def busy(self) -> bool:
        """True while any request is queued or holds a slot."""
        return bool(self.queue) or any(r is not None for r in self._active)

    @property
    def _free(self) -> List[int]:
        return self._alloc._free

    def step(self) -> List[Request]:
        """Admit what fits, run one prefill chunk for pending prompts,
        advance every decoding slot one token; returns the requests that
        completed during this step. Registered fault hooks fire first: they
        model an adversary changing the sealed memory image between
        dispatches."""
        n0 = len(self._done)
        for hook in self.fault_hooks:
            hook.on_step(self)
        if not self._wswept:
            self._verify_weights()
        self._admit()
        if any(p is not None for p in self._pending):
            self._chunk_tick()
        if any(r is not None and self._pending[i] is None
               for i, r in enumerate(self._active)):
            self._decode_tick()
        return self._done[n0:]

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Drain queue and in-flight work; returns the requests completed
        by this call. ``max_steps`` (default: the engine's
        ``max_run_steps``) bounds the scheduler steps, and an attached
        ``StepWatchdog`` gets each step's wall-clock duration: either one
        raises ``StragglerTimeout`` rather than spin on a stuck drain."""
        limit = max_steps if max_steps is not None else self.max_run_steps
        n0 = len(self._done)
        self._verify_weights()          # the fail-stop sweep at drain entry
        steps = 0
        while self.busy:
            before = (len(self.queue), self.stats["decode_steps"],
                      self.stats["prefills"])
            t0 = time.time()
            self.step()
            after = (len(self.queue), self.stats["decode_steps"],
                     self.stats["prefills"])
            if after == before:
                raise RuntimeError("scheduler made no progress")
            steps += 1
            if self.watchdog is not None:
                self.watchdog.check(time.time() - t0)
            if limit is not None and steps >= limit and self.busy:
                raise StragglerTimeout(
                    f"serve drain exceeded {limit} steps with work still "
                    f"in flight ({len(self.queue)} queued)")
        return self._done[n0:]

    def check_device_mirror(self):
        """The host mirrors must track the device ``SchedState`` exactly."""
        st = self._state
        for dev_t, host in ((st.tables, self._tables),
                            (st.lengths, self._lengths),
                            (st.counts, self._counts)):
            if not np.array_equal(dev_t.cpu().numpy(), host):
                raise AssertionError("device state diverged from its mirror")
        if not np.array_equal(st.wc.cpu().numpy().view(np.uint32), self._wc):
            raise AssertionError("device write counters diverged")

    # -------------------------------------------------- scheduling

    def _mt_eff(self, r: Request) -> int:
        return max(1, min(r.max_tokens, self.max_len - len(r.prompt)))

    def _to_dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def _admit(self):
        bs = self.block_size
        while self.queue:
            free_slots = [i for i, r in enumerate(self._active) if r is None]
            if not free_slots:
                return
            width = min(self._admit_n, len(free_slots))
            batch = []
            cow_pairs: List[tuple] = []
            cow_slots: List[int] = []
            for r in list(self.queue):
                if len(batch) >= width:
                    break
                plen = len(r.prompt)
                if self._registry is not None:
                    full, partial, n_shared = self._registry.match(r.prompt)
                else:
                    full, partial, n_shared = [], None, 0
                # pin matched blocks before eviction can free them
                held = list(full) + ([partial[0]] if partial else [])
                self._alloc.incref(held)
                need = -(-(plen + self._mt_eff(r)) // bs) - len(full)
                if need > self._alloc.free_count and self._registry:
                    self._registry.evict_lru(need)
                priv = self._alloc.alloc(need)
                if priv is None:
                    self._alloc.decref(held)
                    break               # strict FIFO: head of queue blocks
                self.queue.remove(r)
                self._alloc.incref(full)   # the slot's own references
                slot = free_slots[len(batch)]
                table = full + priv
                self._active[slot] = r
                self._slot_blocks[slot] = table
                self._pending[slot] = np.asarray(r.prompt[n_shared:],
                                                 np.int32)
                self._tables[slot] = 0
                self._tables[slot, :len(table)] = table
                self._lengths[slot] = n_shared
                self._counts[slot] = 0
                self._last_tok[slot] = 0
                self._temp[slot] = r.temperature
                if partial is not None:
                    cow_pairs.append((partial[0], priv[0]))
                    cow_slots.append(slot)
                    self.stats["cow_copies"] += 1
                self.stats["shared_prefix_blocks"] += (
                    len(full) + (1 if partial else 0))
                self.stats["shared_prefix_tokens"] += n_shared
                batch.append((slot, n_shared, held, r))
            if not batch:
                return
            slots = [b[0] for b in batch]
            reqs = [b[3] for b in batch]
            keys = torch.stack([SM.request_key_data(self._sample_seed, r.rid)
                                for r in reqs])
            ST.admit(self._state, self._to_dev(np.asarray(slots, np.int64)),
                     self._to_dev(self._tables[slots]),
                     self._to_dev(np.asarray([b[1] for b in batch],
                                             np.int64)),
                     keys.to(self.device),
                     self._to_dev(np.asarray([r.temperature for r in reqs],
                                             np.float32)),
                     self._to_dev(np.asarray([r.top_k for r in reqs],
                                             np.int64)),
                     self._to_dev(np.asarray([r.top_p for r in reqs],
                                             np.float32)))
            if cow_pairs:
                # padded to the admit width, as the reference's dispatch;
                # the copy finishes, in stream order, before the sharers'
                # first chunk writes into their private blocks
                a = self._admit_n
                src = np.zeros((a,), np.int64)
                dst = np.zeros((a,), np.int64)
                msk = np.zeros((a,), bool)
                for i, (s_b, d_b) in enumerate(cow_pairs):
                    src[i], dst[i], msk[i] = s_b, d_b, True
                    self._wc[d_b] += 1
                cok = ST.cow(self.cfg, self._pools, self._state,
                             self._to_dev(src), self._to_dev(dst),
                             self._to_dev(msk), self.cache_seal)
                if self.verify and self.seal_cache:
                    self.stats["mac_checks"] += len(cow_pairs)
                    if not bool(cok):
                        # a shared source block failed its MAC: the copy
                        # would launder tampered words under a fresh tag, so
                        # drop the donor chains and retry the sharers
                        if self._registry is not None:
                            self._registry.purge_blocks(
                                [s_b for s_b, _ in cow_pairs])
                        for _, _, held, _ in batch:
                            self._alloc.decref(held)
                        self._integrity_retry(cow_slots)
                        continue
            for _, _, held, _ in batch:
                self._alloc.decref(held)   # slot refs live in _slot_blocks

    def _fetch(self, tok, cok):
        """The dispatch's tokens, and its cache verdicts when verifying, to
        the host in one copy."""
        if not self.verify:
            return tok.cpu().numpy(), None
        both = torch.cat([tok, cok.to(tok.dtype)]).cpu().numpy()
        return both[:tok.shape[0]], both[tok.shape[0]:].astype(bool)

    def _chunk_tick(self):
        """One chunked-prefill dispatch: up to admit-width pending slots
        each advance ``chunk_tokens`` prompt tokens; rows reaching the end
        of their prompt sample their first token and switch to decode.

        A dense model runs only the pending rows. An MoE model runs the
        reference's whole (admit width, chunk) batch, padding rows
        included, since its expert capacity counts every token of the
        dispatch (``step.chunk_step``'s ``pad_rows``)."""
        a, c, bs = self._admit_n, self.chunk_tokens, self.block_size
        rows = [i for i, p in enumerate(self._pending) if p is not None][:a]
        if not rows:
            return
        toks = np.zeros((len(rows), c), np.int64)
        cl = np.zeros((len(rows),), np.int64)
        fin = np.zeros((len(rows),), bool)
        for i, slot in enumerate(rows):
            pend = self._pending[slot]
            n = min(len(pend), c)
            toks[i, :n] = pend[:n]
            cl[i] = n
            fin[i] = n == len(pend)
        tok, cok, _ = ST.chunk_step(
            self.cfg, self.params(), self._pools, self._state,
            self._to_dev(np.asarray(rows, np.int64)), self._to_dev(toks),
            self._to_dev(cl), self._to_dev(fin), self.cache_seal,
            greedy=bool((self._temp[rows] <= 0).all()),
            pad_rows=a - len(rows) if self.cfg.moe is not None else 0)
        self.stats["prefills"] += 1
        self.stats["prefill_chunks"] += len(rows)
        tok, cok_h = self._fetch(tok, cok)
        self._count_checks(len(rows))
        finished: List[int] = []
        failed: List[int] = []
        for i, slot in enumerate(rows):
            n = int(cl[i])
            r = self._active[slot]
            length = int(self._lengths[slot])
            # mirror the device's bumps whether or not the slot failed: the
            # mirror tracks what the dispatch did, not what is trusted
            for b in range(length // bs, (length + n - 1) // bs + 1):
                self._wc[self._tables[slot, b]] += 1
            self._lengths[slot] += n
            if cok_h is not None and not cok_h[slot]:
                failed.append(slot)
                continue
            if not fin[i]:
                self._pending[slot] = self._pending[slot][n:]
                continue
            self._pending[slot] = None
            if self._registry is not None:
                self._registry.register(r.prompt, self._slot_blocks[slot])
            nt = int(tok[i])
            self._counts[slot] = 1
            self._last_tok[slot] = nt
            r.out.append(nt)
            self.stats["tokens"] += 1
            if len(r.out) >= self._mt_eff(r) or nt == r.eos:
                finished.append(slot)
        if failed:
            self._integrity_retry(failed)
        if finished:
            self._evict_slots(finished)

    def _decode_tick(self):
        tok, cok, _ = ST.decode_tick(
            self.cfg, self.params(), self._pools, self._state,
            self.cache_seal, greedy=bool((self._temp <= 0).all()))
        self.stats["decode_steps"] += 1
        tok, cok_h = self._fetch(tok, cok)     # the ONLY d2h copy per tick
        self._count_checks(sum(1 for i, r in enumerate(self._active)
                               if r is not None and self._pending[i] is None))
        bs = self.block_size
        finished: List[int] = []
        failed: List[int] = []
        for slot, r in enumerate(self._active):
            if r is None or self._pending[slot] is not None:
                continue
            # mirror the tail block's counter bump, for failed slots too
            pb = self._tables[slot, self._lengths[slot] // bs]
            self._wc[pb] += 1
            self._lengths[slot] += 1
            self._counts[slot] += 1
            if cok_h is not None and not cok_h[slot]:
                failed.append(slot)
                continue
            nt = int(tok[slot])
            self._last_tok[slot] = nt
            r.out.append(nt)
            self.stats["tokens"] += 1
            if len(r.out) >= self._mt_eff(r) or nt == r.eos:
                finished.append(slot)
        if failed:
            self._integrity_retry(failed)
        if finished:
            self._evict_slots(finished)

    # -------------------------------------------------- integrity

    def _verify_weights(self):
        """The MAC sweep over the sealed weight image
        (``sealed_store.verify_params``: one kernel launch a leaf, one
        device bool), a dispatch of its own at ``run()`` entry and once
        lazily from ``step()``. A failure is fail-stop: the model is not
        trustworthy and no request can be recovered."""
        self._wswept = True
        _sweep_weights(self)

    def _count_checks(self, n_checked: int) -> None:
        """A verified dispatch checked the cache reads of ``n_checked``
        slots."""
        if self.verify:
            self.stats["mac_checks"] += n_checked

    def _integrity_retry(self, slots: List[int]):
        """Recovery from cache MAC failures, failing ONLY the owning slots:
        their registry chains are purged (a tampered shared block must not
        be served again), their blocks released, the device write counters
        restored from the trusted host mirror (a counter rollback changes
        the device's only), and each victim re-prefilled once from the
        front of the queue under fresh counters; a second failure ends the
        request with ``error="integrity"``. Slots that passed their check
        are untouched and decode exactly as they would have."""
        self.stats["mac_failures"] += len(slots)
        victims = [self._active[s] for s in slots]
        if self._registry is not None:
            self._registry.purge_blocks(
                [b for s in slots for b in self._slot_blocks[s]])
        self._evict_slots(slots, complete=False)
        self._state.wc.copy_(u32.words(self._wc, self.device))
        for r in reversed(victims):
            if r.retries >= 1:
                r.error = "integrity"
                r.done = True
                r.t_done = time.time()
                self._done.append(r)
                continue
            r.retries += 1
            r.out = []
            self.stats["retries"] += 1
            self.queue.insert(0, r)

    def _evict_slots(self, slots: List[int], complete: bool = True):
        """Batched slot teardown: one device evict zeroes the rows; the host
        drops the slots' block references (shared blocks survive while the
        registry or another slot holds them). With ``complete=False`` the
        requests are not marked done: the caller decides their fate."""
        ST.evict(self._state, self._to_dev(np.asarray(slots, np.int64)))
        for slot in slots:
            r = self._active[slot]
            if complete:
                r.done = True
                r.t_done = time.time()
                self._done.append(r)
            self._alloc.decref(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
            self._tables[slot] = 0
            self._lengths[slot] = 0
            self._counts[slot] = 0
            self._last_tok[slot] = 0
            self._temp[slot] = 0.0
            self._active[slot] = None
            self._pending[slot] = None


def right_align(prompts) -> np.ndarray:
    """A group's prompts as one (B, max length) int64 array, each
    right-aligned after token-0 left padding (the group engine's layout)."""
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    return toks


class GroupServeEngine:
    """Group-drain baseline: prefill a fixed group, decode greedily until
    every member finishes; finished slots idle until the group drains.

    Prompts of a group are right-aligned with token-0 left padding at
    positions ``arange(plen)`` and no padding mask, as in the reference.
    Sealed: the weights are sealed once and every dispatch reads them
    through ``serving_params`` (norm leaves and the recurrent blocks' line
    leaves decrypted, the embedding's rows decrypted inside their gather,
    tile leaves inside the fused matmul). The contiguous cache is never
    sealed. The engine serves every token pattern: attention, MoE, RG-LRU
    and SSD, the last two only here, as in the reference.

    ``verify`` over sealed weights seals them with MACs and sweeps the
    image once per drain (``_sweep_weights``, the continuous engine's
    fail-stop sweep, counted in a ``mac_checks`` stat). The reference's
    group engine has no such option; the recurrent models, which only this
    engine serves, are verified through it.
    """

    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 4,
                 max_len: int = 256, seal: Optional[SealConfig] = None,
                 key_bytes: bytes = bytes(range(32)), verify: bool = False,
                 device=None):
        if cfg.frontend is not None:      # the reference's assert
            raise AssertionError("serving demo targets token archs")
        weights_sealed = seal is not None and seal.mode != "none"
        if verify and not weights_sealed:
            raise ValueError("verify=True needs sealed weights: the group "
                             "engine's cache is never sealed")
        if verify and not seal.verify:
            seal = dataclasses.replace(seal, verify=True)
        self.verify = verify
        self.device = resolve_device(device)
        params = map_leaves(lambda t: t.to(self.device), params)
        self.cfg = cfg
        self.slots = batch_slots
        self.max_len = max_len
        self.seal = seal
        self.key_bytes = key_bytes
        self.sealed = (SS.seal_params(params, seal, key_bytes)
                       if weights_sealed else None)
        self._plain_params = (None if weights_sealed
                              else _plain_weights(cfg, params))
        self._next_rid = 0
        self.queue: List[Request] = []
        # the contiguous cache is never sealed: its KV image is plaintext
        itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)
                               ).element_size()
        kv_pt = (2 * cfg.n_superblocks() * len(cfg.pattern) * batch_slots
                 * max_len * cfg.num_kv_heads * cfg.head_dim * itemsize)
        w_pt = (self.sealed.serving_plaintext_bytes(
                    batch_slots, getattr(torch, cfg.dtype), cfg.tie_embeddings)
                if self.sealed else sum(t.numel() * t.element_size()
                                        for t in leaves(self._plain_params)))
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens": 0,
                      "fused_matmul_leaves": (len(self.sealed.fused_paths())
                                              if self.sealed else 0),
                      "weights_plaintext_bytes_per_step": w_pt,
                      "kv_plaintext_bytes_per_step": kv_pt,
                      "plaintext_bytes_per_step": w_pt + kv_pt}
        if verify:
            self.stats.update(mac_checks=0, mac_failures=0)

    def params(self):
        """The serving view for one dispatch (see ``ServeEngine.params``)."""
        if self.sealed is None:
            return self._plain_params
        return SS.serving_params(self.sealed, self.key_bytes,
                                 self.cfg.tie_embeddings)

    def submit(self, prompt, max_tokens: int = 32, eos: int = -1) -> Request:
        """Queue a greedy request (the group engine takes no sampling
        settings, as the reference's)."""
        prompt = np.asarray(prompt, np.int32)
        _check_prompt(prompt, self.cfg.vocab_size)
        r = Request(self._next_rid, prompt, max_tokens, eos,
                    t_submit=time.time())
        self._next_rid += 1
        self.queue.append(r)
        return r

    @property
    def busy(self) -> bool:
        return bool(self.queue)

    def run(self) -> List[Request]:
        """Drain the queue; returns completed requests. A verifying engine
        sweeps the weight image first, fail-stop."""
        if self.queue:
            _sweep_weights(self)
        done: List[Request] = []
        while self.queue:
            group = self.queue[:self.slots]
            self.queue = self.queue[self.slots:]
            done.extend(self._run_group(group))
        return done

    def _run_group(self, group: List[Request]) -> List[Request]:
        toks = right_align([r.prompt for r in group])
        plen = toks.shape[1]
        logits, cache = T.prefill(self.cfg, self.params(),
                                  torch.from_numpy(toks).to(self.device),
                                  self.max_len)
        self.stats["prefills"] += 1
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for i, r in enumerate(group):
            r.out.append(int(nxt[i]))
        pos = plen
        max_new = max(r.max_tokens for r in group)
        for _ in range(1, max_new):
            if pos >= self.max_len:
                break
            tokens = torch.from_numpy(nxt[:, None]).to(self.device)
            _, cache, tok = T.decode_step(self.cfg, self.params(), cache,
                                          tokens, pos)
            self.stats["decode_steps"] += 1
            nxt = tok.cpu().numpy()            # the one d2h copy per step
            pos += 1
            for i, r in enumerate(group):
                if r.done:
                    continue
                nt = int(nxt[i])
                r.out.append(nt)
                self.stats["tokens"] += 1
                if len(r.out) >= r.max_tokens or nt == r.eos:
                    r.done = True
                    r.t_done = time.time()
            if all(r.done for r in group):
                break
        for r in group:
            if not r.done:
                r.done = True
                r.t_done = time.time()
        return group
