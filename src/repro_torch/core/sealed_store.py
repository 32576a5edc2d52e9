"""Sealed parameter store: model weights kept as ciphertext and decrypted on
use. Port of ``repro/core/sealed_store.py``.

``seal_params`` applies the SE plan and the engine per leaf:

* matmul-shaped leaves (attention wq/wk/wv/wo, dense-MLP wi/wg/wo, the LM
  head) take the tile-sealed layout when ``seal.fuse_decrypt`` is on: they
  reach ``kernels.sealed_matmul`` still sealed and are decrypted in
  registers under their SE row masks;
* every other leaf (norms, the embedding) takes the line-packed layout and is
  decrypted before use.

With ``seal.verify`` every leaf also carries Carter–Wegman tags (``macs``:
one a tile, or one a 128-byte line record), and ``verify_params`` recomputes
them all from the at-rest image into one device bool: one kernel launch a
leaf on the card (``kernels.chacha20.tile_tags`` / ``line_tags``).

``fused_params`` is the reference's serving view (line leaves decrypted,
tile leaves passed through sealed); ``serving_params``, what the port's
engines serve from, also leaves the token embedding line-sealed, so that a
dispatch decrypts only the rows it embeds; ``unseal_params`` decrypts
everything; ``sealed_byte_report`` sums the image's bytes. Nonces are
sha256 hashes of the leaf paths, so the port's paths must equal the
reference's (``repro_torch.tree``).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import u32
from repro_torch.config import SealConfig
from repro_torch.core import cipher as C
from repro_torch.core import coloe as CL
from repro_torch.core import engine as E
from repro_torch.core import mac as M
from repro_torch.core import plan as P
from repro_torch.core.sealed_tensor import SealedTensor, SealMeta, torch_dtype
from repro_torch.tree import flatten_with_path, map_leaves, unflatten


# the token embedding's path: ``serving_params`` keeps it line-sealed
EMBED = "embed/w"


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


@dataclasses.dataclass
class SealedParams:
    """tensors: path -> SealedTensor, in flatten order (``plans`` keeps the
    same order); ``skeleton`` is the parameter tree with its leaves dropped."""
    tensors: Dict[str, SealedTensor]
    plans: Dict[str, P.LeafPlan]
    skeleton: Any
    seal: SealConfig
    _engines: Dict[bytes, Any] = dataclasses.field(default_factory=dict,
                                                   repr=False)

    def engine(self, key_bytes: bytes):
        """The engine for ``key_bytes`` on the image's device, built once
        (its key words live on the device, so per-step decrypts copy
        nothing from the host)."""
        eng = self._engines.get(key_bytes)
        if eng is None:
            dev = next(iter(self.tensors.values())).payload.device
            eng = E.make_engine(self.seal.mode, key_bytes, dev)
            self._engines[key_bytes] = eng
        return eng

    def stored_bytes(self) -> int:
        return sum(t.stored_bytes() for t in self.tensors.values())

    def enc_fraction(self) -> float:
        return P.plan_totals(self.plans)["enc_fraction"]

    def fused_paths(self):
        return [p for p, t in self.tensors.items()
                if t.meta.layout == "tiles"]

    def plaintext_bytes_materialized(self) -> int:
        """Plaintext bytes the decrypt-on-use path materializes per step:
        the line-layout leaves only."""
        return sum(t.logical_bytes() for t in self.tensors.values()
                   if t.meta.layout != "tiles")

    def serving_plaintext_bytes(self, rows: int, dtype: torch.dtype,
                                tie_embeddings: bool = False) -> int:
        """Plaintext bytes ``serving_params`` materializes in a dispatch
        that embeds ``rows`` tokens in ``dtype``: the line-layout leaves but
        the embedding, plus the gathered rows (the whole embedding when the
        unembedding shares it)."""
        kept = _sealed_in_view(self, tie_embeddings)
        row = self.tensors[EMBED].meta.shape[-1] * torch.empty(
            (), dtype=dtype).element_size() if kept else 0
        return sum(t.logical_bytes() for p, t in self.tensors.items()
                   if t.meta.layout != "tiles" and p not in kept) + rows * row


def _nonce2(path: str) -> Tuple[int, int]:
    h = hashlib.sha256(path.encode()).digest()
    return (int.from_bytes(h[:4], "little"), int.from_bytes(h[4:8], "little"))


def _nonce3(path: str) -> Tuple[int, int, int]:
    """3-word per-tensor nonce for the tile layout (a domain apart from the
    line layout, whose nonce word 0 is the small line address)."""
    h = hashlib.sha256(b"tiles/" + path.encode()).digest()
    return tuple(int.from_bytes(h[i:i + 4], "little") | 1
                 for i in (8, 12, 16))


def _line_tweak(path: str) -> Tuple[int, int, int]:
    """Per-tensor MAC-pad tweak for line-layout leaves. Word 2 stays 0 while
    every tile nonce word is odd, so line and tile tag domains never
    collide, even across tensors."""
    return _nonce2(path) + (0,)


@dataclasses.dataclass(frozen=True)
class CacheSeal:
    """Sealing context of the paged KV cache: key words plus one 3-word nonce
    per stream (k / v). Layer id and write counter are folded in per block
    by ``kernels.ref.cache_block_otp``. With ``mac`` every pool block
    carries a co-located MAC word per stream (``mac_k``/``mac_v``), written
    at every sealed write and checked at every read (``models/paged.py``)."""
    key_words: torch.Tensor           # (8,) int32 on the pools' device
    nonce_k: Tuple[int, int, int]
    nonce_v: Tuple[int, int, int]
    mac: Optional[M.MacContext] = None

    def mac_nonces(self):
        """The MAC pads' nonces of the k and v streams (the cache nonce is
        each stream's tweak, as in ``MacContext.tags``)."""
        return self.mac.nonce(self.nonce_k), self.mac.nonce(self.nonce_v)


def cache_seal_config(key_bytes: bytes, device=None,
                      verify: bool = False) -> CacheSeal:
    """The cache-block sealing context (same key as the weight store,
    nonce domain "kvcache/"). ``verify`` arms the per-block Carter–Wegman
    MACs (domain "kvcache")."""
    return CacheSeal(u32.words(C.key_to_words(key_bytes[:32]), device),
                     _nonce3("kvcache/k"), _nonce3("kvcache/v"),
                     M.mac_context(key_bytes, "kvcache", device)
                     if verify else None)


def line_flags_from_mask(mask_elems, dtype: torch.dtype,
                         n_lines: int) -> torch.Tensor:
    """Element-level encrypt mask -> per-128 B-line flag (any elem set)."""
    size = torch.empty((), dtype=dtype).element_size()
    epw = 4 // size if size < 4 else 1
    flat = mask_elems.reshape(-1)
    elems_per_line = CL.WORDS_PER_LINE * max(epw, 1)
    pad = n_lines * elems_per_line - flat.shape[0]
    if pad > 0:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    return flat.reshape(n_lines, elems_per_line).any(dim=1).to(torch.int32)


# --------------------------------------------------------------------------
# fused (tile-sealed) eligibility
# --------------------------------------------------------------------------

_FUSED_LEAVES = {("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                 ("attn", "wo"), ("mlp", "wi"), ("mlp", "wg"),
                 ("mlp", "wo"), ("head", "w")}


def _pick_block(dim: int) -> Optional[int]:
    for b in (128, 64, 32, 16, 8):
        if dim % b == 0:
            return b
    return None


def tile_geometry(path: Tuple[str, ...], shape, dtype: torch.dtype,
                  seal: SealConfig):
    """(n_batch, k_ndim, n_out, K, N, bk, bn) if the leaf can take the
    tile-sealed layout, else None."""
    if not seal.fuse_decrypt or seal.mode not in ("counter", "coloe"):
        return None
    parent = path[-2] if len(path) >= 2 else ""
    if (parent, path[-1]) not in _FUSED_LEAVES and \
            (path[0], path[-1]) not in _FUSED_LEAVES:
        return None
    if torch.empty((), dtype=dtype).element_size() != 4:
        return None                       # payload is the u32 bitcast
    cls = P._classify(path, len(shape))
    if cls is None:
        return None
    batch_axes, row_axes = cls
    nb, nk = len(batch_axes), len(row_axes)
    if nb > 1 or batch_axes != tuple(range(nb)) or \
            row_axes != tuple(range(nb, nb + nk)):
        return None
    n_out = len(shape) - nb - nk
    if n_out < 1:
        return None
    k = n = 1
    for d in shape[nb:nb + nk]:
        k *= d
    for d in shape[nb + nk:]:
        n *= d
    bk, bn = _pick_block(k), _pick_block(n)
    if bk is None or bn is None:
        return None
    return nb, nk, n_out, k, n, bk, bn


# --------------------------------------------------------------------------
# seal
# --------------------------------------------------------------------------

def _seal_lines(eng, seal, leaf, plan, path) -> SealedTensor:
    n_words = -(-leaf.numel() * leaf.element_size() // 4)
    n_lines = -(-n_words // CL.WORDS_PER_LINE)
    if plan.mode == "rows":
        mask = P.expand_mask(plan, tuple(leaf.shape))
        flags = line_flags_from_mask(mask, leaf.dtype, n_lines)
    else:
        flags = torch.ones((n_lines,), dtype=torch.int32, device=leaf.device)
    sealed = eng.encrypt(leaf, nonce2=_nonce2(path), enc_flags=flags)
    meta = SealMeta(scheme=sealed.scheme, layout="lines",
                    dtype=_dtype_name(leaf.dtype),
                    nonce=tuple(int(v) for v in sealed.nonce2),
                    shape=tuple(leaf.shape), orig_len=sealed.orig_len)
    macs = eng.line_macs(sealed, _line_tweak(path)) if seal.verify else None
    return SealedTensor(sealed.payload, sealed.counters, None, None, None,
                        meta, macs=macs)


def _seal_tiles(eng, seal, leaf, plan, path, geom) -> SealedTensor:
    nb, nk, n_out, k, n, bk, bn = geom
    nonce3 = _nonce3(path)
    shape = tuple(leaf.shape)
    dev = leaf.device
    if plan.mask is not None:
        mask = plan.mask.reshape(tuple(plan.mask.shape[:nb]) + (k,))
    else:
        mask = torch.ones(shape[:nb] + (k,), dtype=torch.bool, device=dev)
    if nb == 1:
        # one write counter per stack slice: the (key, nonce, counter)
        # triple, hence the OTP, is never reused across layers
        payload = torch.stack([
            eng.encrypt_tiles(leaf[i].reshape(k, n), nonce3, mask[i], i,
                              bk, bn) for i in range(shape[0])]).reshape(shape)
        wc = torch.arange(shape[0], dtype=torch.int32, device=dev)
        key_c = eng.key_words.expand(shape[0], 8).contiguous()
    else:
        payload = eng.encrypt_tiles(leaf.reshape(k, n), nonce3, mask, 0,
                                    bk, bn).reshape(shape)
        wc = torch.zeros((), dtype=torch.int32, device=dev)
        key_c = eng.key_words.clone()
    meta = SealMeta(scheme=eng.name, layout="tiles",
                    dtype=_dtype_name(leaf.dtype), nonce=nonce3, shape=shape,
                    n_batch=nb, k_ndim=nk, n_out=n_out, bk=bk, bn=bn)
    macs = (M.tile_tags(eng.mac_ctx, _tiles2d(payload, meta), mask, wc, bk,
                        bn, tweak=nonce3) if seal.verify else None)
    return SealedTensor(payload, None, mask, key_c, wc, meta, macs=macs)


def _tiles2d(payload, m: SealMeta) -> torch.Tensor:
    """A tile leaf's words as (K, N), or (n, K, N) when stacked (a view)."""
    k = n = 1
    for d in m.shape[m.n_batch:m.n_batch + m.k_ndim]:
        k *= d
    for d in m.shape[m.n_batch + m.k_ndim:]:
        n *= d
    return payload.reshape(tuple(m.shape[:m.n_batch]) + (k, n))


def seal_params(params, seal: SealConfig, key_bytes: bytes) -> SealedParams:
    """Seal every leaf on the device the leaves live on."""
    flat = flatten_with_path(params)
    dev = flat[0][1].device
    plans = P.make_plan(params, seal)
    eng = E.make_engine(seal.mode, key_bytes, dev)
    tensors: Dict[str, SealedTensor] = {}
    for pt, leaf in flat:
        path = "/".join(pt)
        plan = plans[path]
        geom = tile_geometry(pt, tuple(leaf.shape), leaf.dtype, seal) \
            if eng.supports_fused else None
        if geom is not None:
            tensors[path] = _seal_tiles(eng, seal, leaf, plan, path, geom)
        else:
            tensors[path] = _seal_lines(eng, seal, leaf, plan, path)
    sp = SealedParams(tensors, plans, map_leaves(lambda _: None, params),
                      seal)
    sp._engines[key_bytes] = eng
    return sp


# --------------------------------------------------------------------------
# unseal
# --------------------------------------------------------------------------

def _unseal_tensor(eng, st: SealedTensor) -> torch.Tensor:
    m = st.meta
    if m.layout == "tiles":
        nb = m.n_batch
        k = n = 1
        for d in m.shape[nb:nb + m.k_ndim]:
            k *= d
        for d in m.shape[nb + m.k_ndim:]:
            n *= d
        if nb == 1:
            w = torch.stack([
                eng.decrypt_tiles(st.payload[i].reshape(k, n), m.nonce,
                                  st.row_mask[i], i, m.bk, m.bn)
                for i in range(m.shape[0])]).reshape(m.shape)
        else:
            w = eng.decrypt_tiles(st.payload.reshape(k, n), m.nonce,
                                  st.row_mask, 0, m.bk, m.bn).reshape(m.shape)
        return w.to(torch_dtype(m.dtype))
    buf = E.SealedBuffer(m.scheme, st.payload, st.counters, m.orig_len,
                         m.shape, torch_dtype(m.dtype), m.nonce)
    return eng.decrypt(buf)


def unseal_params(sp: SealedParams, key_bytes: bytes):
    """Decrypt every leaf; the tree comes back in the parameters' shape."""
    eng = sp.engine(key_bytes)
    return unflatten(sp.skeleton,
                     [_unseal_tensor(eng, sp.tensors[p]) for p in sp.plans])


def _view(sp: SealedParams, key_bytes: bytes, keep=()):
    """Tile leaves passed through sealed; line leaves decrypted, but those
    in ``keep``, which stay line-sealed and carry the key words."""
    eng = sp.engine(key_bytes)

    def leaf(p):
        st = sp.tensors[p]
        if st.meta.layout == "tiles":
            return st
        if p in keep:
            return SealedTensor(st.payload, st.counters, None, eng.key_words,
                                None, st.meta)
        return _unseal_tensor(eng, st)

    return unflatten(sp.skeleton, [leaf(p) for p in sp.plans])


def verify_params(sp: SealedParams, key_bytes: bytes) -> torch.Tensor:
    """Integrity check of the whole sealed weight image: every stored tag
    recomputed from the at-rest words, reduced to one () bool on the
    image's device (True = intact), with no read back to the host. Leaves
    sealed without MACs are skipped (True when there are none)."""
    eng = sp.engine(key_bytes)
    oks = []
    for path in sp.plans:
        st = sp.tensors[path]
        if st.macs is None:
            continue
        m = st.meta
        if m.layout == "tiles":
            tags = M.tile_tags(eng.mac_ctx, _tiles2d(st.payload, m),
                               st.row_mask, st.wc, m.bk, m.bn, tweak=m.nonce)
        else:
            buf = E.SealedBuffer(m.scheme, st.payload, st.counters,
                                 m.orig_len, m.shape, torch_dtype(m.dtype),
                                 m.nonce)
            tags = eng.line_macs(buf, _line_tweak(path))
        oks.append((tags == st.macs).all())
    if not oks:
        return torch.ones((), dtype=torch.bool,
                          device=eng.mac_ctx.key_words.device)
    return torch.stack(oks).all()


def n_macs(sp: SealedParams) -> int:
    """Number of stored weight tags (for stats and overhead reports)."""
    return sum(t.macs.numel() for t in sp.tensors.values()
               if t.macs is not None)


def sealed_byte_report(sp: SealedParams) -> Dict[str, float]:
    """The image's bytes: plaintext, the encrypted share, stored (with
    counters, flags and masks), the overhead over plaintext, the
    tile-sealed leaves and the plaintext ``fused_params`` materializes a
    step."""
    tot = P.plan_totals(sp.plans)
    return {
        "plaintext_bytes": tot["total_bytes"],
        "enc_fraction": tot["enc_fraction"],
        "stored_bytes": sp.stored_bytes(),
        "overhead": sp.stored_bytes() / max(tot["total_bytes"], 1) - 1.0,
        "fused_leaves": len(sp.fused_paths()),
        "plaintext_bytes_per_step": sp.plaintext_bytes_materialized(),
    }


def fused_params(sp: SealedParams, key_bytes: bytes):
    """The reference's serving view: line-layout leaves decrypted,
    tile-sealed leaves passed through still sealed to their consumption
    site."""
    return _view(sp, key_bytes)


def _sealed_in_view(sp: SealedParams, tie_embeddings: bool):
    """The leaves ``serving_params`` keeps line-sealed: the embedding, whose
    rows the ChaCha gather kernel unseals. Direct's AES lines have no
    gather, so there the embedding is decrypted whole, as the reference's
    ``fused_params`` does for every engine."""
    if tie_embeddings or EMBED not in sp.tensors or \
            not E.ENGINES[sp.seal.mode].supports_fused:
        return ()
    return (EMBED,)


def serving_params(sp: SealedParams, key_bytes: bytes,
                   tie_embeddings: bool = False):
    """The port's serving view: ``fused_params`` with the token embedding
    left line-sealed (``SealedTensor.gather_rows`` decrypts a dispatch's
    rows inside the gather kernel), so no plaintext embedding is written to
    device memory. A model whose unembedding shares the embedding needs
    the whole matrix, so there it is decrypted as before, and so it is under
    the Direct engine (``_sealed_in_view``)."""
    return _view(sp, key_bytes, _sealed_in_view(sp, tie_embeddings))
