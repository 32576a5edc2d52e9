"""The frozen yardstick, pinned to hand counts at one small shape each."""
import math

import pytest

from sealbench import roofline_work as W

# a model small enough to count by hand: 2 layers, d 4, heads 2/1 of 2,
# d_ff 8, vocab 10, its own head, ColoE at SE 0.5 with the boundary rule
HAND = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2,
        "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 2,
        "vocab_size": 10, "tie_word_embeddings": False,
        "seal": {"mode": "coloe", "smart_ratio": 0.5,
                 "protect_boundary_layers": True}}


def test_bound_takes_the_larger_of_bytes_and_each_operation():
    assert W.bound_ms(3.35e9) == (pytest.approx(1.0), "bytes")
    assert W.bound_ms(0, bf16_flops=989e9) == (pytest.approx(1.0),
                                                "operations")
    ms, by = W.pad_bound(0, 1)
    # one pad: 992 operations at 33.45e12/s, 656 on the ALU pipe at
    # 16.73e12/s; the ALU pipe binds
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 656 / (132 * 64 * 1.98e9))


def test_view_work_by_hand():
    # 2 slots x 2 blocks of 4 tokens x 2 words; slot 0 holds 3 tokens
    nbytes, pads = W.view_work([3, 0], 2, 2, 8, 2)
    # 6 live words read, 2 x 2 x 8 words written, for k and v; 12 bytes of
    # table, length and counter a block; one live 16-word unit each
    assert nbytes == 2 * (4 * 6 + 4 * 2 * 2 * 8) + 12 * 2 * 2 == 352
    assert pads == 2


def test_splice_work_by_hand():
    # one token into a 4-token block at offset 3: one 8-word unit (read,
    # since its first 6 words are old), 2 new words, k and v
    nbytes, pads = W.splice_work(1, [3], [1], 1, 8, 2, 4)
    assert nbytes == 2 * (64 + 64 + 4 * 2) == 272
    assert pads == 2 * (1 + 1) == 4


def test_sealed_bound_by_hand():
    ms, by = W.sealed_bound(4, 128, 64, 64, 2)
    nbytes = 2 * 4 * 128 + 4 * 128 * 64 + 128 + 4 * 4 * 64 + 48
    assert nbytes == 34992
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * nbytes / 3.35e12)
    # at a prefill's M the tensor cores bind
    ms, by = W.sealed_bound(4096, 2048, 8192, 1024, 2)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 2 * 4096 * 2048 * 8192 / 989e12)


def test_model_flops_by_hand():
    # embedding 40 + head 40 + 2 x (16 + 16 + 16 + 96 + 8 norms)
    assert W.param_count(HAND) == 384
    # decode: 2 x 344 x 3 + both attention products over a 5-token cache
    assert W.model_flops(HAND, "decode", 5, 3) == 2 * 344 * 3 + 480
    # prefill: 2 x 344 x 15 + one product over the causal half
    assert W.model_flops(HAND, "prefill", 5, 3) == 2 * 344 * 15 + 600


def test_dispatch_flops_by_hand():
    per_tok = 2 * (4 * (2 * 2 * 2 + 2 * 1 * 2) + 3 * 4 * 8)   # 288
    attn, head = 4 * 2 * 2, 2 * 4 * 10
    dec = {"kind": "decode", "running": [True, False], "lengths": [4, 9]}
    assert W.dispatch_flops(HAND, dec) == 2 * (per_tok + attn * 5) + head
    # model_flops's decode at one slot of a 5-token cache, which also
    # counts the norms' 2 x d weights a layer as matmul weights
    assert W.dispatch_flops(HAND, dec) + 2 * 2 * (2 * 4) == \
        W.model_flops(HAND, "decode", 5, 1)
    chunk = {"kind": "chunk", "cl": [3, 2], "lengths": [4, 0],
             "final": [True, False]}
    # row 0 attends over 5, 6, 7 keys, row 1 over 1, 2
    assert W.dispatch_flops(HAND, chunk) == \
        2 * (per_tok * 3 + attn * 18) + head + 2 * (per_tok * 2 + attn * 3)


def test_fused_leaves_and_launches_by_hand():
    c = dict(HAND, num_hidden_layers=3)
    leaves = W.fused_leaves(c)
    assert len(leaves) == 7 * 3 + 1
    rows = {(name, layer): r for name, layer, _, _, r in leaves}
    assert rows[("wq", 0)] == 4 and rows[("wq", 2)] == 4   # boundary layers
    assert rows[("wq", 1)] == 2 and rows[("wo_mlp", 1)] == 4   # ceil(8 / 2)
    assert rows[("head", 3)] == 4
    shape = {"kind": "chunk", "rows": 2, "chunk": 8}
    ms = sorted(m for m, _, _, _ in W.matmul_launches(c, shape))
    assert ms == [2] + [16] * 21
    tied = dict(c, tie_word_embeddings=True)
    assert len(W.matmul_launches(tied, {"kind": "decode", "slots": 5})) == 21


def test_view_launches_one_a_layer():
    shape = {"kind": "decode", "slots": 2, "lengths": [3, 0], "mb": 2}
    got = W.view_launches(dict(HAND, num_key_value_heads=1, head_dim=4),
                          shape, 4)
    assert got == [W.view_work([3, 0], 2, 2, 8, 2)] * 2
    assert W.kv_words_per_token(HAND) == 1


def test_peaks_are_the_data_sheets():
    assert (W.PEAK_BF16, W.PEAK_F32, W.HBM_BW) == (989e12, 67e12, 3.35e12)
    assert math.isclose(W.INT32_OPS_PER_S, 33.45e12, rel_tol=1e-3)
