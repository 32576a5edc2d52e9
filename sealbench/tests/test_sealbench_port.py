"""What the benchmark hands the program: the configuration's constants
folded into the weights, and the shapes read from the engine."""
import pytest
import torch

from sealbench import port
from sealbench.reference import dense_gqa as R

SMALL = {"name": "small", "hidden_size": 16, "intermediate_size": 24,
         "num_hidden_layers": 3, "num_attention_heads": 4,
         "num_key_value_heads": 2, "vocab_size": 37, "rms_norm_eps": 1e-5,
         "rope_theta": 10000.0, "hidden_act": "silu"}
GRANITE = {"embedding_multiplier": 12.0, "attention_multiplier": 0.015625,
           "residual_multiplier": 0.22, "logits_scaling": 8.0}


@pytest.mark.parametrize("tied", [False, True])
def test_folded_weights_compute_the_stated_function(tied):
    """The reference at the program's constants (its epsilon, attention at
    head_dim ** -0.5, no multipliers) on the folded weights gives the
    logits of the reference at the file's constants on the weights as
    drawn."""
    c = dict(SMALL, tie_word_embeddings=tied, **(GRANITE if tied else {}))
    w = {k: v.double() for k, v in R.make_weights(c, 5, "cpu").items()}
    toks = torch.tensor([3, 1, 4, 1, 5, 9, 2, 6])
    at = torch.arange(len(toks))
    want = R.forward(c, w, toks, at)
    f = port.fold_constants(c, w)
    assert f["embed"] == pytest.approx(
        c.get("embedding_multiplier", 1.0) * (port.program_eps() / 1e-5) ** 0.5)
    plain = dict(SMALL, tie_word_embeddings=tied,
                 rms_norm_eps=port.program_eps())
    got = R.forward(plain, w, toks, at)
    assert torch.allclose(got, want, rtol=1e-9, atol=1e-9 * want.abs().max())
    # the fold is not the identity: without it the logits differ
    assert not torch.allclose(
        R.forward(plain, {k: v.double() for k, v in
                          R.make_weights(c, 5, "cpu").items()}, toks, at),
        want, rtol=1e-3)


def test_a_missing_engine_field_fails_the_run():
    class Engine:
        slots, max_len, block_size, chunk_tokens = 2, 64, 16, 32
        _active, _pending = [None, None], [None, None]

    with pytest.raises(RuntimeError, match="_lengths"):
        port.decode_shape(Engine())
    with pytest.raises(RuntimeError, match="_lengths"):
        port.chunk_shape(Engine())
    Engine._lengths, Engine._admit_n = [0, 0], 1
    assert port.decode_shape(Engine())["running"] == [False, False]
    assert port.chunk_shape(Engine())["rows"] == 0
