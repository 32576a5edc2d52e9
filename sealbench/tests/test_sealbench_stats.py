"""Percentiles and the window's arithmetic, over every sample."""
import types

import pytest

from sealbench import stats


def rec(t_submit, stamps, error=None):
    return types.SimpleNamespace(t_submit=t_submit, stamps=list(stamps),
                                 error=error)


def test_percentile_interpolates_between_ranks():
    xs = list(range(1, 11))                  # 1..10
    assert stats.percentile(xs, 0) == 1
    assert stats.percentile(xs, 100) == 10
    assert stats.percentile(xs, 50) == pytest.approx(5.5)
    assert stats.percentile(xs, 90) == pytest.approx(9.1)
    assert stats.percentile(xs, 95) == pytest.approx(9.55)
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([], 50) is None


def test_window_counts_every_token_and_censors_first_tokens():
    records = [
        rec(0.5, [0.9, 1.2, 1.4, 2.5]),      # in flight at the open
        rec(1.1, [1.6, 1.8]),                # wholly inside
        rec(1.5, []),                        # no token by the close
        rec(1.9, [2.4]),                     # first token after the close
        rec(2.1, [2.2]),                     # submitted after the close
    ]
    n = stats.window_numbers(records, 1.0, 2.0)
    assert n["tokens"] == 2 + 2              # 1.2, 1.4; 1.6, 1.8
    assert n["first"] == 1
    assert n["submitted"] == 3
    # 1.6 - 1.1; censored at the close: 2.0 - 1.5 and 2.0 - 1.9
    assert sorted(n["ttft"]) == pytest.approx(sorted([0.5, 0.5, 0.1]))
    assert sorted(n["itl"]) == pytest.approx([0.2, 0.2])
    e2e = stats.end_to_end(n)
    assert e2e["output_tok_s"] == pytest.approx(4.0)
    assert e2e["ttft_p90_ms"] == pytest.approx(500.0)
    assert e2e["itl_p95_ms"] == pytest.approx(200.0)


def test_window_counts_failed_requests_against_attempted():
    records = [rec(1.1, [1.2], error="integrity"), rec(1.2, [1.3])]
    n = stats.window_numbers(records, 1.0, 2.0)
    assert (n["submitted"], n["failed"]) == (2, 1)


def test_tokens_at_the_open_belong_before_it():
    n = stats.window_numbers([rec(0.0, [1.0, 2.0])], 1.0, 2.0)
    assert n["tokens"] == 1 and n["itl"] == []
