"""Port parity, bitwise: chunked prefill (``prefill_chunk_tokens``) and the
rebatching baseline (``incremental=False``) against the reference engine.

Each case of the reference's ``tests/test_chunked_prefill.py`` runs on both
engines — the reference's over its integer ``ToyLM``, the port's over the
torch twin (``helpers/torch_toy.py``) — with the same seeded workload on a
``SimExecutor`` of the same seed: paged and dense, with prefix sharing on
and off, through mid-chunk batch kills and poisonings, stall-free decode
and the latency histograms.  Integer state and logits make every
comparison exact: token streams, errors, latencies, the decision trace,
prefill counts, ``serving_stats`` and the page and slot ledgers must be
equal, and the port must hold the reference suite's own assertions.
"""

import random

import numpy as np
import pytest
from helpers.invariants import check_serving_invariants
from helpers.serving import ToyLM, make_engine, make_requests
from helpers.torch_serving import (
    assert_engines_match,
    make_port_engine,
    port_requests,
    streams,
)
from helpers.torch_toy import TorchToyLM

import repro.runtime.serve_loop as jax_loop
from repro_torch.core.sim import SimExecutor
from repro_torch.runtime import Request, ServerConfig, ServingEngine

KV_MODES = ("paged", "dense")


def _both(seed, **kw):
    """The reference engine and the port's, same config and seed."""
    return make_engine(seed, **kw)[0], make_port_engine(seed, **kw)[0]


def _serve_workload(seed, kv_mode, chunk, *, sharing=True, n=8):
    ref, port = _both(
        seed, max_batch=3, max_seq=48, step_time_s=0.001, kv_mode=kv_mode,
        prefix_sharing=sharing, prefix_cache_seqs=2 if sharing else 0,
        prefill_chunk_tokens=chunk)
    reqs = make_requests(random.Random(seed), n, deadline_prob=0.0,
                         sample_prob=0.5, share_prob=0.5)
    preqs = port_requests(reqs)
    for engine, rs in ((ref, reqs), (port, preqs)):
        for r in rs:
            engine.submit(r)
        engine.drain(timeout=60)
    ctx = f"kv_mode={kv_mode} chunk={chunk} sharing={sharing}"
    assert_engines_match(ref, port, reqs, preqs, ctx)
    check_serving_invariants(port, preqs, ctx=ctx)
    return port, preqs


# --------------------------------------------- chunked == monolithic


@pytest.mark.parametrize("chunk", (0, 1, 3, 5))
@pytest.mark.parametrize("sharing", (True, False), ids=("share", "noshare"))
@pytest.mark.parametrize("kv_mode", KV_MODES)
def test_chunked_workload_matches_reference(kv_mode, sharing, chunk):
    """Every budget gives the reference's run, and the monolithic run's
    streams (the reference suite's headline property)."""
    port, preqs = _serve_workload(11, kv_mode, chunk, sharing=sharing)
    chunks = port.serving_stats()["prefill_chunks_total"]
    assert (chunks > 0) == (chunk > 0)
    if chunk:
        _, mreqs = _serve_workload(11, kv_mode, 0, sharing=sharing)
        assert [r.tokens for r in preqs] == [r.tokens for r in mreqs]


@pytest.mark.parametrize("kv_mode", KV_MODES)
def test_chunked_run_replays_like_the_reference(kv_mode):
    p1, r1 = _serve_workload(23, kv_mode, 3)
    p2, r2 = _serve_workload(23, kv_mode, 3)
    assert streams(r1) == streams(r2)
    assert p1.trace_text() == p2.trace_text()


# ------------------------------------- mid-chunk eviction / poison


def _long_prompt(n=24, vocab=31):
    return np.asarray([(i * 7 + 3) % vocab for i in range(n)], np.int32)


def _long_pair(request_id=0, tenant="alice"):
    kw = dict(prompt=_long_prompt(), max_new_tokens=4, request_id=request_id,
              tenant=tenant)
    return jax_loop.Request(**kw), Request(**kw)


@pytest.mark.parametrize("kv_mode,fault", [
    ("paged", "kill"), ("dense", "kill"), ("paged", "poison")])
def test_mid_chunk_fault_matches_reference(kv_mode, fault):
    """Paged kill: resumes from the last chunk boundary (24 rows prefilled
    once); dense kill: restarts (8 + 24); poison: restarts clean (8 +
    24) — each on the port exactly as on the reference."""
    ref, port = _both(1, max_batch=1, max_seq=48, step_time_s=0.001,
                      kv_mode=kv_mode, prefill_chunk_tokens=4)
    (rr, pr) = _long_pair()
    for engine, r in ((ref, rr), (port, pr)):
        engine.submit(r)
        engine.step()
        engine.step()
        assert engine.serving_stats()["prefill_chunks_total"] == 2
        if fault == "kill":
            assert engine.kill_batch() == 1
        else:
            assert engine.poison_prefilling() == "req0"
        engine.drain(timeout=60)
    assert_engines_match(ref, port, [rr], [pr], f"{kv_mode} {fault}")
    stats = port.serving_stats()
    resumed = kv_mode == "paged" and fault == "kill"
    assert stats["resumed_total"] == int(resumed)
    assert stats["prefill_tokens_total"]["incremental"] == (
        24 if resumed else 32)
    assert pr.error is None and len(pr.tokens) == 4
    check_serving_invariants(port, [pr], ctx=f"{kv_mode} {fault}")


def test_poison_prefilling_is_noop_when_nothing_mid_prefill():
    port, _ = make_port_engine(1, max_batch=1, max_seq=48, kv_mode="paged",
                               prefill_chunk_tokens=4)
    assert port.poison_prefilling() is None
    assert port.serving_stats()["arena_poison_total"] == 0


# ------------------------------------------------ stall-free decode


@pytest.mark.parametrize("kv_mode", KV_MODES)
def test_decode_advances_every_tick_during_long_prefill(kv_mode):
    ref, port = _both(1, max_batch=2, max_seq=48, step_time_s=0.001,
                      kv_mode=kv_mode, prefill_chunk_tokens=2)
    runs = []
    for engine, module in ((ref, jax_loop), (port, None)):
        R = module.Request if module else Request
        short = R(prompt=np.asarray([3, 1, 4], np.int32), max_new_tokens=16,
                  request_id=0, tenant="alice")
        engine.submit(short)
        engine.step()
        while not short.tokens:
            engine.step()
        long = R(prompt=_long_prompt(), max_new_tokens=4, request_id=1,
                 tenant="bob")
        engine.submit(long)
        chunks_before = engine.serving_stats()["prefill_chunks_total"]
        for _ in range(6):
            have = len(short.tokens)
            engine.step()
            assert len(short.tokens) == have + 1, kv_mode
        assert engine.serving_stats()["prefill_chunks_total"] >= \
            chunks_before + 6
        assert not long.tokens
        engine.drain(timeout=60)
        runs.append([short, long])
    assert_engines_match(ref, port, runs[0], runs[1], kv_mode)
    check_serving_invariants(port, runs[1], ctx=f"stall-free {kv_mode}")


def test_ttft_and_intertoken_histograms_match_reference():
    ref, port = _both(5, max_batch=3, max_seq=48, step_time_s=0.001,
                      kv_mode="paged", prefill_chunk_tokens=3)
    reqs = make_requests(random.Random(5), 6, deadline_prob=0.0)
    preqs = port_requests(reqs)
    hists = []
    for engine, rs in ((ref, reqs), (port, preqs)):
        for r in rs:
            engine.submit(r)
        engine.drain(timeout=60)
        hists.append({
            key: (h.count, round(h.sum, 9))
            for key, h in engine.telemetry.histograms().items()
            if key[0] in ("serving.ttft_seconds",
                          "serving.intertoken_seconds")})
    assert hists[1] == hists[0]
    ttft = sum(n for (name, _), (n, _) in hists[1].items()
               if name == "serving.ttft_seconds")
    inter = sum(n for (name, _), (n, _) in hists[1].items()
                if name == "serving.intertoken_seconds")
    assert ttft == len(preqs)
    assert inter == sum(len(r.tokens) - 1 for r in preqs)


# ------------------------------------------------ config validation


class _Without:
    """Proxy hiding named attributes of a model (validation tests)."""

    def __init__(self, inner, *hidden):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_hidden", frozenset(hidden))

    def __getattr__(self, name):
        if name in self._hidden:
            raise AttributeError(name)
        return getattr(self._inner, name)


@pytest.mark.parametrize("hidden,kv_mode,incremental,match", [
    ((), "auto", False, "incremental"),
    (("paged_prefill_at",), "paged", True, "paged_prefill_at"),
    (("prefill_chunk",), "dense", True, "prefill_chunk"),
])
def test_chunked_config_validation_matches_reference(hidden, kv_mode,
                                                     incremental, match):
    """The reference's own ``ValueError``s, on both engines."""
    kw = dict(max_batch=2, max_seq=32, tokens_per_page=4, kv_mode=kv_mode,
              incremental=incremental, prefill_chunk_tokens=2)
    with pytest.raises(ValueError, match=match) as ref_err:
        jax_loop.ServingEngine(_Without(ToyLM(), *hidden), ToyLM().init(),
                               jax_loop.ServerConfig(**kw))
    with pytest.raises(ValueError, match=match) as port_err:
        ServingEngine(_Without(TorchToyLM(paged=True), *hidden),
                      ServerConfig(**kw), executor=SimExecutor(seed=0))
    assert str(port_err.value) == str(ref_err.value)


# ------------------------------------------ the rebatching baseline


@pytest.mark.parametrize("seed,n,sample_prob,deadline_prob", [
    (0, 10, 0.0, 0.15), (1, 12, 0.4, 0.15), (2, 30, 0.3, 0.6)])
def test_rebatching_matches_reference(seed, n, sample_prob, deadline_prob):
    """``incremental=False``: every admission re-prefills the whole
    zero-padded batch (``prefill_full``), in dense mode under ``auto``."""
    ref, port = _both(seed, incremental=False)
    assert port.kv_mode == ref.kv_mode == "dense"
    reqs = make_requests(random.Random(seed), n, sample_prob=sample_prob,
                         deadline_prob=deadline_prob)
    preqs = port_requests(reqs)
    for engine, rs in ((ref, reqs), (port, preqs)):
        for r in rs:
            engine.submit(r)
        engine.drain(timeout=60)
    assert_engines_match(ref, port, reqs, preqs, f"rebatch seed={seed}")
    stats = port.serving_stats()
    assert stats["prefill_sequences_total"]["full"] > 0
    assert stats["prefill_sequences_total"]["incremental"] == 0
    assert any(" prefill_full " in line for line in port.trace())
    check_serving_invariants(port, preqs, ctx=f"rebatch seed={seed}")


def test_rebatching_refuses_paged_mode_like_the_reference():
    kw = dict(max_batch=2, max_seq=32, kv_mode="paged", incremental=False)
    with pytest.raises(ValueError, match="incremental") as ref_err:
        jax_loop.ServingEngine(ToyLM(), ToyLM().init(),
                               jax_loop.ServerConfig(**kw))
    with pytest.raises(ValueError, match="incremental") as port_err:
        ServingEngine(TorchToyLM(paged=True), ServerConfig(**kw))
    assert str(port_err.value) == str(ref_err.value)
