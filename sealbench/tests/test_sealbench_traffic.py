"""The traffic generator: deterministic by seed, one pool of lengths for
every seed, residual-life first budgets."""
from collections import Counter

from sealbench import spec, traffic


def mix(name="chat"):
    return spec.load_cell({"chat": "internlm2-chat",
                           "code": "granite-code"}[name]).mix


def draw(m, seed, n, first=0):
    t = traffic.Traffic(m, seed, 1000)
    shares = t.residuals(first)
    return [t.next_request(shares[i] if i < first else 1.0)
            for i in range(n)]


def test_same_seed_same_requests():
    m = mix()
    a, b = draw(m, 2 ** 31 + 12345, 40, 8), draw(m, 2 ** 31 + 12345, 40, 8)
    assert [(p.tolist(), o) for p, o in a] == [(p.tolist(), o) for p, o in b]
    c = draw(m, 7, 40, 8)
    assert [(p.tolist(), o) for p, o in a] != [(p.tolist(), o) for p, o in c]


def test_every_seed_draws_the_same_pool_in_its_own_order():
    m = mix("code")
    n = m["pool"]
    sizes = [Counter((len(p), o) for p, o in draw(m, s, n)) for s in (1, 2)]
    assert sizes[0] == sizes[1] == Counter(traffic.length_pool(m))
    assert [len(p) for p, _ in draw(m, 1, n)] != \
        [len(p) for p, _ in draw(m, 2, n)]


def test_pool_spans_the_stated_ranges():
    for name in ("chat", "code"):
        m = mix(name)
        pool = traffic.length_pool(m)
        for i, key in enumerate(("prompt_tokens", "output_tokens")):
            dist, got = m[key], sorted(pair[i] for pair in pool)
            assert dist["min"] <= got[0] and got[-1] == dist["max"]
            # the published median, at stratified quantiles
            assert abs(got[len(got) // 2] - dist["median"]) <= \
                0.02 * dist["median"] + 1
            assert dist["median"] == m["published"][key.split("_")[0]
                                                    + "_median"]
        # every request fits its slot's cache, with no block to spare
        longest = max(p + o for p, o in pool)
        assert longest <= m["max_len"] < longest + m["block_size"]


def test_first_budgets_are_stratified_residual_lives():
    m = mix()
    t = traffic.Traffic(m, 99, 1000)
    shares = t.residuals(32)
    assert sorted(shares) == [(i + 0.5) / 32 for i in range(32)]
    assert shares != traffic.Traffic(m, 100, 1000).residuals(32)
    t = traffic.Traffic(m, 99, 1000)
    start = t._next
    for share in t.residuals(32):
        o = t.pool[t._next][1]
        assert t.next_request(share)[1] == max(1, -(-share * o // 1))
    assert t._next == (start + 32) % m["pool"]
    assert traffic.Traffic(m, 1, 1000).next_request(0.001)[1] == 1


def test_prompt_ids_lie_in_the_vocabulary():
    p, _ = traffic.Traffic(mix(), 3, 50).next_request()
    assert p.dtype.name == "int32" and p.min() >= 0 and p.max() < 50


def test_warmup_rounds_run_every_row_count():
    m = mix()
    rounds = traffic.warmup_prompts(m, 5, 1000)
    assert [len(r) for r in rounds] == list(range(m["admit_batch"], 0, -1))
    assert all(len(p) == m["chunk_tokens"] for r in rounds for p in r)
