"""Seeded token sampling for the serving plane.

Greedy decode is a degenerate sampler; real serving needs temperature /
top-k / top-p — but chaos replay (and evict-and-resume) must still be
byte-identical, so randomness cannot come from any engine-global stream
whose consumption order depends on batch composition.  Instead every
draw is keyed by ``(request seed, absolute token index)``: the i-th
token of a request uses ``np.random.default_rng([seed, i])``, so a
request evicted after 3 tokens and resumed in a different batch draws
token 4 from exactly the same stream it would have drawn it from
uninterrupted.

Math is float64 on host (the logits row is tiny) with a stable
descending sort tie-broken by token id, so the sampled stream is
platform-deterministic.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["sample_token", "sampler_method"]

_SEED_MASK = (1 << 63) - 1


def sampler_method(temperature: float, top_k: int, top_p: float) -> str:
    """Which sampler family a request's knobs select (for metrics)."""
    if temperature <= 0.0:
        return "greedy"
    if top_k > 0:
        return "topk"
    if top_p < 1.0:
        return "topp"
    return "temperature"


def sample_token(
    logits: np.ndarray,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int = 0,
    index: int = 0,
) -> Tuple[int, str]:
    """Draw one token from a single logits row; returns (token, method).

    ``temperature <= 0`` is greedy (argmax, first-max tie-break — the
    same token ``jnp.argmax`` picks).  Otherwise logits are scaled by
    ``1/temperature``, the distribution is truncated by ``top_k`` (if
    > 0) then ``top_p`` (if < 1, keeping the probability mass up to and
    including the first candidate that crosses ``p``), renormalized, and
    sampled by inverse CDF with a uniform keyed on (seed, index).
    """
    method = sampler_method(temperature, top_k, top_p)
    row = np.asarray(logits, np.float64).reshape(-1)
    if method == "greedy":
        return int(np.argmax(row)), method

    # stable descending order, ties broken by token id
    order = np.argsort(-row, kind="stable")
    scores = row[order] / float(temperature)
    keep = scores.size
    if top_k > 0:
        keep = min(keep, int(top_k))
    probs = np.exp(scores[:keep] - scores[0])
    probs /= probs.sum()
    if top_p < 1.0:
        cdf = np.cumsum(probs)
        keep = int(np.searchsorted(cdf, float(top_p), side="left")) + 1
        probs = probs[:keep]
        probs /= probs.sum()

    rng = np.random.default_rng([int(seed) & _SEED_MASK, int(index)])
    u = rng.random()
    j = int(np.searchsorted(np.cumsum(probs), u, side="right"))
    j = min(j, probs.size - 1)
    return int(order[j]), method
