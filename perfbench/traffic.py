"""One general generator of closed-loop traffic, driven by a mix file.

A mix (``perfbench/traffic/<name>.json``) gives the clients, the prompt
and output length distributions and a shared prefix.  Every request is
greedy: the comparison that decides ``correct`` judges greedy tokens.  Every seed gets the same sizes in the same order: lengths are the
distribution's quantiles at ``(j + 0.5) / BLOCK`` for each block of
``BLOCK`` requests, shuffled within the block (prompt and output lengths
apart) by a permutation fixed by the block's index alone.  The seed draws
the token ids (and, in ``perfbench.weights``, the weights).  So every
seed does the same work on other numbers, and a window's tail does not
swing with which long prompts a seed happens to put side by side.

Each client's first request takes its output length from the residual
distribution: the tokens a request in progress at a random moment still
has to emit, P(R = r) ∝ P(L ≥ r).  The loop then starts near its steady
state instead of with every client at its first token.
"""

from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist
from typing import List, Mapping, Optional

import numpy as np

__all__ = ["BLOCK", "MIX_KEYS", "RequestSpec", "Traffic", "ceil_div",
           "pool_pages", "quantiles", "residual_pmf"]

_MASK = (1 << 63) - 1

#: requests a block of quantiles: the 97th percentile comes once in each
BLOCK = 16

#: the keys a mix file may have (``why`` and ``sources`` are for readers)
MIX_KEYS = {"why", "sources", "clients", "prompt", "shared_prefix_tokens",
            "output", "warmup_steps", "check_requests"}


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & _MASK, *key])


def quantiles(dist: Mapping, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles ``(j + 0.5) / n`` of ``dist``:
    ``{"dist": "lognormal", "median", "sigma", "min", "max"}`` or
    ``{"dist": "uniform", "min", "max"}`` (integers, both ends in)."""
    lo, hi = int(dist["min"]), int(dist["max"])
    qs = (np.arange(n) + 0.5) / n
    if dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(q)) for q in qs])
        vals = np.rint(float(dist["median"]) * np.exp(float(dist["sigma"]) * z))
    elif dist["dist"] == "uniform":
        vals = lo + np.floor(qs * (hi - lo + 1))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(vals, lo, hi).astype(np.int64)


def residual_pmf(dist: Mapping, n: int = 4096) -> np.ndarray:
    """P(R = r) for r = 0..max of the residual of ``dist`` (index 0 is 0):
    the tokens still to come of a request caught at a random moment."""
    lengths = quantiles(dist, n)
    hi = int(lengths.max())
    counts = np.bincount(lengths, minlength=hi + 1).astype(np.float64)
    at_least = counts[::-1].cumsum()[::-1]        # P(L >= r) · n
    pmf = at_least.copy()
    pmf[0] = 0.0
    return pmf / pmf.sum()


@dataclass
class RequestSpec:
    index: int
    prompt: np.ndarray            # int32 token ids
    max_new_tokens: int


class Traffic:
    """The request stream of one mix and one seed.

    ``next(client)`` returns the client's next request: its first one with
    a residual output length, then the shared stream's next request in
    order.
    """

    def __init__(self, mix: Mapping, seed: int, vocab_size: int) -> None:
        unknown = set(mix) - MIX_KEYS
        if unknown:
            raise ValueError(f"unknown mix keys {sorted(unknown)}")
        self.mix = mix
        self.seed = int(seed)
        self.vocab = int(vocab_size)
        self.clients = int(mix["clients"])
        self.block = BLOCK
        self.prefix_len = int(mix.get("shared_prefix_tokens", 0))
        self.prefix = (_rng(self.seed, 1).integers(
            0, self.vocab, self.prefix_len).astype(np.int32)
            if self.prefix_len else np.zeros((0,), np.int32))
        self._prompt_q = quantiles(mix["prompt"], self.block)
        self._output_q = quantiles(mix["output"], self.block)
        self._blocks: dict = {}
        self._next = 0
        pmf = residual_pmf(mix["output"])
        cdf = np.cumsum(pmf)
        qs = (np.arange(self.clients) + 0.5) / self.clients
        firsts = np.maximum(np.minimum(np.searchsorted(cdf, qs),
                                       len(pmf) - 1), 1)
        self._first: List[Optional[int]] = list(
            _rng(0, 2).permutation(firsts))

    @property
    def max_prompt(self) -> int:
        return int(self._prompt_q.max())

    @property
    def max_output(self) -> int:
        return int(self._output_q.max())

    def _block(self, b: int):
        if b not in self._blocks:
            rng = _rng(0, 3, b)
            self._blocks[b] = (rng.permutation(self._prompt_q),
                               rng.permutation(self._output_q))
        return self._blocks[b]

    def spec(self, i: int, output: Optional[int] = None) -> RequestSpec:
        """Request ``i`` of the stream (its output length overridden by
        ``output``): its prompt is the shared prefix and then its own
        tokens, to the drawn total length."""
        prompts, outputs = self._block(i // self.block)
        total = int(prompts[i % self.block])
        own = _rng(self.seed, 4, i).integers(
            0, self.vocab, max(total - self.prefix_len, 1)).astype(np.int32)
        prompt = np.concatenate([self.prefix, own])[:max(total, 1)]
        return RequestSpec(
            index=i, prompt=prompt,
            max_new_tokens=int(outputs[i % self.block] if output is None
                               else output))

    def next(self, client: int) -> RequestSpec:
        i = self._next
        self._next += 1
        first, self._first[client] = self._first[client], None
        return self.spec(i, output=first)

    def lengths(self, n: int) -> List[tuple]:
        """(prompt, output) lengths of the stream's first ``n`` requests."""
        out = []
        for i in range(n):
            prompts, outputs = self._block(i // self.block)
            out.append((int(prompts[i % self.block]),
                        int(outputs[i % self.block])))
        return out


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def pool_pages(clients: int, longest: int, page: int) -> int:
    """Pages for every client at the longest sequence at once."""
    return clients * ceil_div(longest, page)

