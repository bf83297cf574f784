"""Percentiles and rates over every request of a measured window.

Percentiles are nearest-rank over all samples (no interpolation), so a
p90 over n samples is a value some request actually saw, and at least
``n - ceil(0.9 n)`` samples lie above it.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple

__all__ = ["percentile", "window_rate", "WindowStats", "summarize"]


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank ``q``-th percentile (0 < q <= 100); None when empty."""
    if not 0 < q <= 100:
        raise ValueError(f"percentile q must be in (0, 100], got {q}")
    if not values:
        return None
    ordered = sorted(values)
    rank = math.ceil(q / 100.0 * len(ordered))
    return ordered[max(rank, 1) - 1]


def window_rate(times: Iterable[float], w0: float, w1: float) -> float:
    """Events with a time in ``[w0, w1)`` per second of the window."""
    if w1 <= w0:
        raise ValueError("empty window")
    return sum(1 for t in times if w0 <= t < w1) / (w1 - w0)


class WindowStats:
    """What the clients saw: every request's send time and token times."""

    def __init__(self, w0: float, w1: float) -> None:
        self.w0, self.w1 = w0, w1
        self.ttft: List[float] = []       # seconds, first token in window
        self.itl: List[float] = []        # seconds, later token in window
        self.tokens = 0                   # output tokens emitted in window

    def add(self, sent: float, token_times: Sequence[float]) -> None:
        w0, w1 = self.w0, self.w1
        for k, t in enumerate(token_times):
            if not w0 <= t < w1:
                continue
            self.tokens += 1
            if k == 0:
                self.ttft.append(t - sent)
            else:
                self.itl.append(t - token_times[k - 1])


def summarize(requests: Iterable[Tuple[float, Sequence[float]]],
              w0: float, w1: float) -> dict:
    """The end-to-end serving metrics of one window over ``requests``
    (send time, token times): output tokens per second, TTFT p90 and ITL
    p95 in ms, with their sample counts."""
    st = WindowStats(w0, w1)
    for sent, times in requests:
        st.add(sent, times)
    p90 = percentile(st.ttft, 90)
    p95 = percentile(st.itl, 95)
    return {
        "output_tok_s": st.tokens / (w1 - w0),
        "ttft_p90_ms": None if p90 is None else p90 * 1e3,
        "itl_p95_ms": None if p95 is None else p95 * 1e3,
        "ttft_samples": len(st.ttft),
        "itl_samples": len(st.itl),
        "tokens": st.tokens,
    }
