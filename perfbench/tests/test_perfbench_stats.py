"""Percentiles and rates over every request of a window."""

import pytest

from perfbench.stats import percentile, summarize, window_rate


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert percentile(xs, 90) == 90
    assert percentile(xs, 95) == 95
    assert percentile(xs, 100) == 100
    assert percentile([7.0], 90) == 7.0
    assert percentile([], 90) is None
    assert percentile([3, 1, 2], 50) == 2
    with pytest.raises(ValueError):
        percentile(xs, 0)


def test_window_rate():
    assert window_rate([0.5, 1.0, 1.5, 2.0], 1.0, 2.0) == 2.0


def test_summarize_counts_every_request_in_the_window():
    reqs = [
        (0.0, [0.5, 1.5, 2.5]),        # first token before the window
        (1.0, [1.2, 1.4]),             # all inside
        (2.0, [3.5]),                  # after the window
    ]
    s = summarize(reqs, 1.0, 3.0)
    assert s["tokens"] == 4            # 1.5, 2.5, 1.2, 1.4
    assert s["output_tok_s"] == 2.0
    assert s["ttft_samples"] == 1 and s["ttft_p90_ms"] == pytest.approx(200)
    # gaps whose later token is in the window: 1.0 (0.5->1.5), 1.0, 0.2
    assert s["itl_samples"] == 3
    assert s["itl_p95_ms"] == pytest.approx(1000)
