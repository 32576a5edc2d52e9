"""The plain reference against a two-layer forward computed by hand, in
float64 numpy with explicit loops over positions and heads."""
import numpy as np
import pytest
import torch

from sealbench.reference import dense_gqa as R

SMALL = {"hidden_size": 8, "intermediate_size": 6, "num_hidden_layers": 2,
         "num_attention_heads": 4, "num_key_value_heads": 2,
         "vocab_size": 11, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
         "tie_word_embeddings": False}


def by_hand(c, w, tokens):
    w = {k: v.double().numpy() for k, v in w.items()}
    d, hq, hkv = c["hidden_size"], c["num_attention_heads"], \
        c["num_key_value_heads"]
    dh, half = d // hq, d // hq // 2
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    scale = c.get("attention_multiplier") or dh ** -0.5
    res = c.get("residual_multiplier", 1.0)

    def norm(x, off):
        return x / np.sqrt(np.mean(x * x) + eps) * (1 + off)

    def rope(v, p):
        out = np.empty_like(v)
        for i in range(half):
            a = p / theta ** (i / half)
            out[i] = v[i] * np.cos(a) - v[i + half] * np.sin(a)
            out[i + half] = v[i + half] * np.cos(a) + v[i] * np.sin(a)
        return out

    xs = [w["embed.w"][t] * c.get("embedding_multiplier", 1.0)
          for t in tokens]
    for layer in range(c["num_hidden_layers"]):
        hs = [norm(x, w["norm1.scale"][layer]) for x in xs]
        q = [[rope(h @ w["attn.wq"][layer][:, j], p) for j in range(hq)]
             for p, h in enumerate(hs)]
        k = [[rope(h @ w["attn.wk"][layer][:, j], p) for j in range(hkv)]
             for p, h in enumerate(hs)]
        v = [[h @ w["attn.wv"][layer][:, j] for j in range(hkv)] for h in hs]
        new = []
        for p, x in enumerate(xs):
            o = np.zeros(d)
            for j in range(hq):
                g = j // (hq // hkv)         # the kv head of query head j
                s = np.array([q[p][j] @ k[t][g] * scale
                              for t in range(p + 1)])
                a = np.exp(s - s.max())
                a /= a.sum()
                head = sum(a[t] * v[t][g] for t in range(p + 1))
                o += head @ w["attn.wo"][layer][j]
            new.append(x + res * o)
        xs = new
        out = []
        for x in xs:
            h = norm(x, w["norm2.scale"][layer])
            gate = h @ w["mlp.wg"][layer]
            m = (gate / (1 + np.exp(-gate))) * (h @ w["mlp.wi"][layer])
            out.append(x + res * (m @ w["mlp.wo"][layer]))
        xs = out
    head = w["embed.w"].T if c["tie_word_embeddings"] else w["head.w"]
    return np.stack([norm(x, w["final_norm.scale"]) @ head
                     / c.get("logits_scaling", 1.0) for x in xs])


@pytest.mark.parametrize("tied", [False, True])
def test_reference_matches_the_hand_forward(tied):
    c = dict(SMALL, tie_word_embeddings=tied)
    if tied:     # Granite's constants, as a file would state them
        c.update(embedding_multiplier=1.5, attention_multiplier=0.3,
                 residual_multiplier=0.7, logits_scaling=2.0)
    w = R.make_weights(c, 4, "cpu")
    tokens = [3, 1, 4, 1, 5, 9]
    want = by_hand(c, w, tokens)
    got = R.forward(c, w, torch.tensor(tokens), torch.arange(6))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # rows at chosen positions are the same rows
    part = R.forward(c, w, torch.tensor(tokens), torch.tensor([2, 5]))
    np.testing.assert_allclose(part.numpy(), want[[2, 5]], rtol=2e-5,
                               atol=2e-5)


def test_query_blocks_do_not_change_the_result(monkeypatch):
    c = dict(SMALL)
    w = R.make_weights(c, 5, "cpu")
    tokens = torch.randint(0, 11, (40,), generator=torch.Generator()
                           .manual_seed(0))
    whole = R.forward(c, w, tokens, torch.arange(40))
    monkeypatch.setattr(R, "Q_BLOCK", 7)
    blocked = R.forward(c, w, tokens, torch.arange(40))
    torch.testing.assert_close(blocked, whole, rtol=1e-6, atol=1e-6)


def test_weights_follow_the_seed_and_the_stated_shapes():
    c = dict(SMALL)
    a, b = R.make_weights(c, 2 ** 40 + 3, "cpu"), R.make_weights(
        c, 2 ** 40 + 3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        {k: s for k, s, _ in R.leaves(c)}
    assert all(v.dtype == torch.float32 for v in a.values())
    other = R.make_weights(c, 2 ** 40 + 4, "cpu")
    assert not torch.equal(a["attn.wq"], other["attn.wq"])


def test_fp8_control_rounds_both_operands():
    x = torch.tensor([[1.0, 3.3, -0.017]])
    w = torch.tensor([[0.5], [1.7], [2.9]])
    got = R.fp8_matmul(x, w)
    assert not torch.equal(got, x @ w)
    # e4m3 keeps 3 mantissa bits: within 2 ** -4 of each operand's scale
    assert torch.allclose(got, x @ w, rtol=0.15)
