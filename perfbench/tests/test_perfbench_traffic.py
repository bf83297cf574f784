"""The generator: the same seed repeats, another seed draws other tokens
over the same set of sizes."""

import json

import numpy as np
import pytest

from perfbench.tests.perfbench_tiny import ROOT
from perfbench.traffic import (BLOCK, Traffic, pool_pages, quantiles,
                               residual_pmf)

MIXES = sorted(p.stem for p in (ROOT / "perfbench/traffic").glob("*.json"))


def _mix(name):
    return json.loads((ROOT / "perfbench/traffic" / f"{name}.json").read_text())


def _stream(mix, seed, n, vocab=1000):
    t = Traffic(mix, seed, vocab)
    return [t.next(i % t.clients) for i in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_repeats(name):
    a = _stream(_mix(name), 2**33 + 1, 40)
    b = _stream(_mix(name), 2**33 + 1, 40)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert x.max_new_tokens == y.max_new_tokens


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_same_sizes_other_tokens(name):
    mix = _mix(name)
    n = 3 * BLOCK
    ta, tb = Traffic(mix, 11, 1000), Traffic(mix, 12, 1000)
    assert ta.lengths(n) == tb.lengths(n)
    assert ta._first == tb._first
    for i in (0, 5, n - 1):
        a, b = ta.spec(i), tb.spec(i)
        assert len(a.prompt) == len(b.prompt)
        assert not np.array_equal(a.prompt, b.prompt)


@pytest.mark.parametrize("name", MIXES)
def test_each_block_holds_every_quantile(name):
    mix = _mix(name)
    block = BLOCK
    t = Traffic(mix, 3, 1000)
    lens = t.lengths(2 * block)
    for b in range(2):
        part = lens[b * block:(b + 1) * block]
        assert sorted(p for p, _ in part) == sorted(quantiles(mix["prompt"], block))
        assert sorted(o for _, o in part) == sorted(quantiles(mix["output"], block))


@pytest.mark.parametrize("name", MIXES)
def test_lengths_within_the_mix(name):
    mix = _mix(name)
    t = Traffic(mix, 5, 1000)
    share = int(mix.get("shared_prefix_tokens", 0))
    for c in range(3 * t.clients):
        r = t.next(c % t.clients)
        assert mix["prompt"]["min"] <= len(r.prompt) <= mix["prompt"]["max"]
        assert 1 <= r.max_new_tokens <= mix["output"]["max"]
        if share:
            assert np.array_equal(r.prompt[:share], t.prefix)


def test_quantiles_and_clip():
    q = quantiles({"dist": "uniform", "min": 8, "max": 48}, 41)
    assert list(q) == list(range(8, 49))
    q = quantiles({"dist": "lognormal", "median": 100, "sigma": 2.0,
                   "min": 50, "max": 200}, 64)
    assert q.min() == 50 and q.max() == 200 and np.median(q) == 100


def test_residual_is_length_biased():
    pmf = residual_pmf({"dist": "uniform", "min": 10, "max": 10}, 16)
    assert np.allclose(pmf[1:11], 0.1) and pmf[0] == 0
    pmf = residual_pmf({"dist": "uniform", "min": 128, "max": 512})
    assert pmf[1] == pytest.approx(pmf[128]) and pmf[500] < pmf[128]


def test_pool_pages():
    assert pool_pages(32, 4144, 16) == 32 * 259


@pytest.mark.parametrize("name", MIXES)
def test_a_key_the_generator_does_not_read_is_refused(name):
    mix = dict(_mix(name), profile_seconds=6)
    with pytest.raises(ValueError, match="profile_seconds"):
        Traffic(mix, 1, 1000)


@pytest.mark.parametrize("name", MIXES)
def test_every_parameter_names_its_source(name):
    mix = _mix(name)
    for key in ("prompt", "output"):
        assert mix["sources"][key]
