"""The yardstick: peaks, bounds and the work each launch and each dispatch
needs. Frozen here, so that no change to the program can move it.

Copied from the program's tree as it stood when this benchmark was made:
``bound_ms``, ``_pad_bound``, ``_view_work``, ``_splice_work`` and
``_sealed_bound`` from ``chip_smoke.py``; ``model_flops`` and
``param_count`` from ``repro_torch/launch/roofline.py`` and
``repro_torch/config.py``, for dense attention layers. The functions after
them compute one dispatch's launches and useful FLOPs from the shapes the
harness knows (slots, rows x chunk, cache lengths) and the configuration's
fused leaves. The work is what the algorithm needs at those shapes, each
input byte counted once and each output byte once, whatever a kernel reads
again.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
PEAK_BF16 = 989e12          # FLOP/s, dense
PEAK_F32 = 67e12            # FLOP/s outside the tensor cores
HBM_BW = 3.35e12            # B/s
# 32-bit integer issue: 132 SMs x 128 lanes x 1.98 GHz; the ALU pipe (XOR,
# rotate) 64 lanes; shared-memory words 32 banks
INT32_OPS_PER_S = 132 * 128 * 1.98e9
ALU_OPS_PER_S = 132 * 64 * 1.98e9
LDS_WORDS_PER_S = 132 * 32 * 1.98e9
CHACHA_OPS = 976            # 20 rounds x 4 quarter-rounds x 12 ops + 16 adds
CHACHA_ALU_OPS = 640        # ... of which 320 XORs and 320 rotations
CHACHA_XOR_OPS = 16         # XOR of one block into 16 words


def bound_ms(nbytes, int_ops=0.0, bf16_flops=0.0, alu_ops=0.0, lookups=0.0,
             f32_flops=0.0) -> Tuple[float, str]:
    """Least time of the work: the larger of bytes over the memory rate and
    each kind of operation over its peak. Returns (ms, bound_by)."""
    t_bytes = nbytes / HBM_BW
    t_ops = max(int_ops / INT32_OPS_PER_S, alu_ops / ALU_OPS_PER_S,
                bf16_flops / PEAK_BF16, lookups / LDS_WORDS_PER_S,
                f32_flops / PEAK_F32)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def pad_bound(nbytes, pads) -> Tuple[float, str]:
    """Bound of a pass that moves ``nbytes`` and makes ``pads`` ChaCha
    blocks, each XORed into 16 words."""
    return bound_ms(nbytes, pads * (CHACHA_OPS + CHACHA_XOR_OPS),
                    alu_ops=pads * (CHACHA_ALU_OPS + CHACHA_XOR_OPS))


def view_work(lengths: Sequence[int], slots: int, mb: int, wpb: int,
              wpt: int) -> Tuple[int, int]:
    """(bytes, pads) a cache-view launch needs: live words read, every word
    written, one pad per live 16-word unit, for k and v."""
    live_units = live_words = 0
    for length in lengths:
        for m in range(mb):
            words = max(0, min(wpb, length * wpt - m * wpb))
            live_words += words
            live_units += -(-words // 16)
    nbytes = 2 * (4 * live_words + 4 * slots * mb * wpb) + 12 * slots * mb
    return nbytes, 2 * live_units


def splice_work(n: int, lengths: Sequence[int], counts: Sequence[int],
                c: int, wpb: int, wpt: int, bs: int) -> Tuple[int, int]:
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
    k = 2 * n
    nbytes = k * (64 * units + 64 * reads + 4 * fresh)
    return nbytes, k * (units + reads)


def sealed_bound(m: int, k: int, n: int, enc_rows: int,
                 x_bytes: int) -> Tuple[float, str]:
    """Least time of one fused matmul: x, the ciphertext and the mask read
    once, the f32 output written once; the ChaCha pads of the encrypted
    rows made once; the products on the bf16 tensor cores."""
    nbytes = x_bytes * m * k + 4 * k * n + k + 4 * m * n + 48
    pads = enc_rows * (n // 16)
    return bound_ms(nbytes, pads * (CHACHA_OPS + CHACHA_XOR_OPS),
                    2.0 * m * k * n, pads * (CHACHA_ALU_OPS + CHACHA_XOR_OPS))


# ---------------------------------------------------------------- model


def dims(c: dict) -> Dict[str, int]:
    d, hq = c["hidden_size"], c["num_attention_heads"]
    return {"n": c["num_hidden_layers"], "d": d, "hq": hq,
            "hkv": c["num_key_value_heads"], "dh": c.get("head_dim") or d // hq,
            "f": c["intermediate_size"], "v": c["vocab_size"]}


def param_count(c: dict) -> int:
    """The program's rough count for a dense attention model: embedding,
    head unless tied, each layer's projections, MLP and two norms."""
    k = dims(c)
    d, q_dim, kv_dim = k["d"], k["hq"] * k["dh"], k["hkv"] * k["dh"]
    total = k["v"] * d
    if not c.get("tie_word_embeddings", False):
        total += k["v"] * d
    layer = d * q_dim + 2 * d * kv_dim + q_dim * d + 3 * d * k["f"] + 2 * d
    return total + k["n"] * layer


def model_flops(c: dict, kind: str, seq_len: int, batch: int) -> float:
    """``launch/roofline.py::model_flops`` for dense attention layers:
    prefill 2 N T plus causal attention (it counts one of the two attention
    products there), decode 2 N B plus both products over the cache."""
    k = dims(c)
    n_matmul = param_count(c) - k["v"] * k["d"]
    hd = k["hq"] * k["dh"]
    if kind == "prefill":
        return (2.0 * n_matmul * seq_len * batch
                + 2.0 * batch * hd * k["n"] * seq_len ** 2 / 2)
    if kind == "decode":
        return 2.0 * n_matmul * batch + 2.0 * batch * hd * k["n"] * seq_len * 2
    raise ValueError(kind)


def layer_matmul_params(c: dict) -> int:
    """Weights one token meets in one layer's contractions."""
    k = dims(c)
    return (k["d"] * (2 * k["hq"] * k["dh"] + 2 * k["hkv"] * k["dh"])
            + 3 * k["d"] * k["f"])


def fused_leaves(c: dict) -> List[Tuple[str, int, int, int, int]]:
    """(leaf, layer, K, N, encrypted rows) of every fused matmul a dispatch
    launches: each layer's seven projections and, untied, the head. The
    encrypted rows follow the configuration's seal: ``smart_ratio`` of the
    rows (rounded up), every row in the first and last layer and the head
    when boundary layers are protected."""
    k = dims(c)
    seal = c["seal"]
    ratio = 0.0 if seal["mode"] == "none" else seal["smart_ratio"]
    edge = seal.get("protect_boundary_layers", True)
    d, q, kv, f, n = k["d"], k["hq"] * k["dh"], k["hkv"] * k["dh"], k["f"], k["n"]
    shapes = [("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d),
              ("wi", d, f), ("wg", d, f), ("wo_mlp", f, d)]
    out = []
    for layer in range(n):
        full = edge and layer in (0, n - 1)
        for name, kk, nn in shapes:
            rows = kk if full or ratio >= 1.0 else math.ceil(ratio * kk)
            out.append((name, layer, kk, nn, rows))
    if not c.get("tie_word_embeddings", False):
        out.append(("head", n, d, k["v"], d if edge or ratio >= 1.0
                    else math.ceil(ratio * d)))
    return out


def matmul_launches(c: dict, shape: dict) -> List[Tuple[int, int, int, int]]:
    """(M, K, N, encrypted rows) of each fused matmul of a dispatch: M is
    the dispatch's rows, every slot at decode and rows x chunk at a chunked
    prefill, whose head takes one row each."""
    if shape["kind"] == "decode":
        m = m_head = shape["slots"]
    else:
        m, m_head = shape["rows"] * shape["chunk"], shape["rows"]
    return [(m_head if name == "head" else m, kk, nn, rows)
            for name, _, kk, nn, rows in fused_leaves(c)]


def kv_words_per_token(c: dict) -> int:
    """u32 words one token's K (or V) takes in the cache, in bf16."""
    k = dims(c)
    return k["hkv"] * k["dh"] * 2 // 4


def view_launches(c: dict, shape: dict, block_size: int
                  ) -> List[Tuple[int, int]]:
    """(bytes, pads) of each cache-view launch of a dispatch: one a layer,
    over every slot at decode and over the chunk's rows at a prefill."""
    wpt = kv_words_per_token(c)
    rows = shape["slots"] if shape["kind"] == "decode" else shape["rows"]
    work = view_work(shape["lengths"], rows, shape["mb"], block_size * wpt,
                     wpt)
    return [work] * dims(c)["n"]


def dispatch_flops(c: dict, shape: dict) -> float:
    """Useful FLOPs of a dispatch: each real token through every layer's
    contractions and both attention products over its live context (the
    new token included), and the unembedding of each sampled token. Idle
    slots, padding and logits that are thrown away count nothing."""
    k = dims(c)
    per_tok = 2.0 * layer_matmul_params(c)
    attn = 4.0 * k["hq"] * k["dh"]          # QK and PV, 2 FLOPs a MAC
    head = 2.0 * k["d"] * k["v"]
    total = 0.0
    if shape["kind"] == "decode":
        for run, length in zip(shape["running"], shape["lengths"]):
            if run:
                total += k["n"] * (per_tok + attn * (length + 1)) + head
        return total
    for cl, length, fin in zip(shape["cl"], shape["lengths"], shape["final"]):
        ctx = cl * length + cl * (cl + 1) / 2
        total += k["n"] * (per_tok * cl + attn * ctx) + (head if fin else 0)
    return total
