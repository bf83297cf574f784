"""Port parity, bitwise: the serving chaos suite's single-device cases
(``tests/test_serving_chaos.py``) on the port's engine, against the
reference's.

The same seeded scenario — multi-tenant workload with priorities,
deadlines, quotas, shared prompt headers and sampled requests, a random
chunk budget, batch kills and arena / shared-prefix / mid-prefill
poisonings at virtual times — runs on the reference engine over its
integer ``ToyLM`` with the reference's ``FailureInjector``, and on the
port's engine over the torch twin with the port's copy
(``repro_torch.runtime.fault``).  Every seed must give the same trace,
token streams, errors, latencies and counters, byte for byte, and the
port's engine must hold the reference suite's invariants after every
drain.  The replica chaos plane (``mesh_chaos_run``) is paired in
``tests/test_torch_replica.py``.
"""

import random
from collections import Counter

import numpy as np
import pytest
from helpers.invariants import check_serving_invariants
from helpers.serving import SHARED_HEADERS, make_engine, make_requests
from helpers.torch_serving import (
    assert_engines_match,
    make_port_engine,
    port_requests,
    streams,
)

from repro.core import TenantQuota
from repro.runtime.fault import FailureInjector as JaxInjector
from repro_torch.runtime.fault import FailureInjector

KV_MODES = ("paged", "dense")
#: the reference suite's CI window is seeds 0..59; these cover its first
#: 30 in each kv mode, a case per seed
SEEDS = range(30)

QUOTAS = {
    "alice": TenantQuota(max_tasks_in_flight=2),
    "bob": TenantQuota(max_tasks_in_flight=1),
    "carol": TenantQuota(max_tasks_in_flight=2),
}


def chaos_run(seed, kv_mode, port):
    """``test_serving_chaos.chaos_run`` on one engine; returns (engine,
    requests, counters)."""
    rng = random.Random(seed * 9127 + 5)
    chunk = rng.choice((0, 0, 2, 3))
    make = make_port_engine if port else make_engine
    engine, sim = make(
        seed, max_batch=3, max_seq=48, step_time_s=0.01, quotas=QUOTAS,
        kv_mode=kv_mode, prefix_cache_seqs=2, prefill_chunk_tokens=chunk,
    )
    reqs = make_requests(
        rng, 10, deadline_prob=0.15, sample_prob=0.5, share_prob=0.4,
    )
    if port:
        reqs = port_requests(reqs)
    injector = FailureInjector() if port else JaxInjector()
    for _ in range(rng.randrange(3)):
        injector.kill_batch_at_t.append(round(rng.uniform(0.02, 0.35), 3))
    for _ in range(rng.randrange(3)):
        injector.poison_arena_at_t[round(rng.uniform(0.02, 0.35), 3)] = (
            rng.randrange(3))
    for _ in range(rng.randrange(2)):
        injector.poison_shared_at_t[round(rng.uniform(0.02, 0.35), 3)] = (
            rng.randrange(3))
    for _ in range(rng.randrange(2)):
        injector.poison_prefilling_at_t[round(rng.uniform(0.02, 0.35), 3)] = (
            rng.randrange(3))
    injector.arm_serving(sim, engine)
    for r in reqs:
        engine.submit(r)
    engine.drain(timeout=60)
    stats = engine.serving_stats()
    counters = Counter({
        "batch_kills": stats["batch_kill_total"],
        "poisons": stats["arena_poison_total"],
        "evictions": stats["evicted_total"],
        "resumes": stats["resumed_total"],
        "prefix_hits": stats["prefix_hits_total"],
        "cow_copies": stats["prefix_cow_copies_total"],
        "prefill_chunks": stats["prefill_chunks_total"],
        "expired": sum(stats["expired_total"].values()),
    })
    return engine, reqs, counters


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kv_mode", KV_MODES)
def test_chaos_seed_matches_reference(kv_mode, seed):
    ref, ref_reqs, ref_counts = chaos_run(seed, kv_mode, port=False)
    port, port_reqs, counts = chaos_run(seed, kv_mode, port=True)
    ctx = f"seed={seed} kv_mode={kv_mode}"
    assert_engines_match(ref, port, ref_reqs, port_reqs, ctx)
    assert counts == ref_counts, ctx
    check_serving_invariants(port, port_reqs, ctx=ctx)


@pytest.mark.parametrize("kv_mode", KV_MODES)
def test_chaos_window_exercised_every_fault_path(kv_mode):
    """Over the window the port's engine ran every chaos path the
    reference suite's coverage floor asks for (counted afresh here, so
    the test stands alone)."""
    totals = Counter()
    for seed in SEEDS:
        totals.update(chaos_run(seed, kv_mode, port=True)[2])
    for key in ("batch_kills", "poisons", "evictions", "expired",
                "prefill_chunks"):
        assert totals[key] > 0, (key, totals)
    if kv_mode == "paged":
        assert totals["resumes"] > 0 and totals["prefix_hits"] > 0
        assert totals["cow_copies"] > 0, totals
    else:
        assert totals["resumes"] == 0 and totals["prefix_hits"] == 0


@pytest.mark.parametrize("kv_mode", KV_MODES)
def test_chaos_seeds_replay_byte_identically(kv_mode):
    for seed in (0, 10, 20):
        a = chaos_run(seed, kv_mode, port=True)
        b = chaos_run(seed, kv_mode, port=True)
        assert a[0].trace_text() == b[0].trace_text()
        assert streams(a[1]) == streams(b[1])


# -------------------------------------------------- deterministic cases


@pytest.mark.parametrize("kv_mode", KV_MODES)
def test_batch_kill_mid_flight_matches_reference(kv_mode):
    def run(port, kill):
        make = make_port_engine if port else make_engine
        engine, sim = make(3, max_batch=2, step_time_s=0.01, kv_mode=kv_mode)
        reqs = make_requests(random.Random(3), 4, deadline_prob=0.0,
                             sample_prob=0.5)
        for r in reqs:
            r.max_new_tokens = 8
        if port:
            reqs = port_requests(reqs)
        if kill:
            sim.call_at(0.035, engine.kill_batch)
        for r in reqs:
            engine.submit(r)
        engine.drain(timeout=60)
        return engine, reqs

    (ref, rr), (port, pr) = run(False, True), run(True, True)
    assert_engines_match(ref, port, rr, pr, kv_mode)
    check_serving_invariants(port, pr, ctx=f"kill {kv_mode}")
    clean, cr = run(True, False)
    assert [r.tokens for r in pr] == [r.tokens for r in cr]
    stats = port.serving_stats()
    assert stats["batch_kill_total"] == 1 and stats["evicted_total"] >= 1
    clean_prefills = clean.serving_stats()[
        "prefill_sequences_total"]["incremental"]
    if kv_mode == "paged":
        assert stats["resumed_total"] == stats["evicted_total"]
        assert stats["prefill_sequences_total"]["incremental"] == \
            clean_prefills
    else:
        assert stats["resumed_total"] == 0
        assert stats["prefill_sequences_total"]["incremental"] > \
            clean_prefills


def test_arena_poison_evicts_only_the_victim_like_the_reference():
    def run(port):
        make = make_port_engine if port else make_engine
        engine, sim = make(4, max_batch=2, step_time_s=0.01)
        victim = make_requests(random.Random(1), 1, deadline_prob=0.0)[0]
        victim.request_id, victim.max_new_tokens = 0, 10
        bystander = make_requests(random.Random(2), 1, deadline_prob=0.0)[0]
        bystander.request_id, bystander.max_new_tokens = 1, 10
        reqs = port_requests([victim, bystander]) if port \
            else [victim, bystander]
        for r in reqs:
            engine.submit(r)
        sim.call_at(0.045, lambda: engine.kv.poison_sequence("req0"))
        engine.drain(timeout=60)
        return engine, reqs

    (ref, rr), (port, pr) = run(False), run(True)
    assert_engines_match(ref, port, rr, pr, "poison")
    assert port.prefill_counts() == {0: 2, 1: 1}
    check_serving_invariants(port, pr, ctx="poison")


def test_eviction_does_not_re_expire_an_admitted_deadline():
    def run(port):
        make = make_port_engine if port else make_engine
        engine, sim = make(6, max_batch=1, step_time_s=0.01)
        r = make_requests(random.Random(7), 1, deadline_prob=0.0)[0]
        r.max_new_tokens, r.deadline_s = 12, 0.05
        reqs = port_requests([r]) if port else [r]
        engine.submit(reqs[0])
        sim.call_at(0.08, engine.kill_batch)
        engine.drain(timeout=60)
        return engine, reqs

    (ref, rr), (port, pr) = run(False), run(True)
    assert_engines_match(ref, port, rr, pr, "evict-not-expire")
    assert pr[0].error is None and len(pr[0].tokens) == 12
    assert pr[0].admitted_at == 0.0


def _shared_pair(seed_a, seed_b, port):
    header = list(SHARED_HEADERS[0])
    out = []
    for rid, (seed, tail) in enumerate(((seed_a, [3, 9]),
                                        (seed_b, [14, 2, 6]))):
        r = make_requests(random.Random(seed), 1, deadline_prob=0.0)[0]
        r.prompt = np.asarray(header + tail, np.int32)
        r.request_id, r.max_new_tokens = rid, 8
        out.append(r)
    return port_requests(out) if port else out


@pytest.mark.parametrize("case", ["poison_shared", "kill_shared",
                                  "parked_donor", "poison_live_index"])
def test_sharing_chaos_case_matches_reference(case):
    """The shared-page cases: a poisoned clique evicts and recovers, a
    kill under shared pages resumes both, a parked donor shares across an
    idle gap, and the poison plan's sorted index."""
    def run(port):
        make = make_port_engine if port else make_engine
        if case == "poison_shared":
            engine, _ = make(11, max_batch=3, step_time_s=0.01,
                             prefix_cache_seqs=2)
            reqs = _shared_pair(20, 21, port)
            engine.submit(reqs[0])
            engine.step()
            engine.submit(reqs[1])
            engine.step()
            assert engine.poison_shared(0) == "req0"
        elif case == "kill_shared":
            engine, _ = make(12, max_batch=2, step_time_s=0.01)
            reqs = _shared_pair(30, 31, port)
            engine.submit(reqs[0])
            engine.step()
            engine.submit(reqs[1])
            engine.step()
            engine.step()
            engine.kill_batch()
        elif case == "parked_donor":
            engine, _ = make(13, max_batch=2, step_time_s=0.01,
                             prefix_cache_seqs=1)
            reqs = _shared_pair(40, 41, port)
            engine.submit(reqs[0])
            engine.drain(timeout=60)
            assert engine.kv.live_pages() > 0
            engine.submit(reqs[1])
        else:
            engine, _ = make(5, max_batch=3, step_time_s=0.01)
            reqs = make_requests(random.Random(9), 3, deadline_prob=0.0)
            for r in reqs:
                r.max_new_tokens = 8
            reqs = port_requests(reqs) if port else reqs
            for r in reqs:
                engine.submit(r)
            engine.step()
            assert engine.poison_live(1) == "req1"
        engine.drain(timeout=60)
        return engine, reqs

    (ref, rr), (port, pr) = run(False), run(True)
    assert_engines_match(ref, port, rr, pr, case)
    stats = port.serving_stats()
    if case == "poison_shared":
        assert stats["evicted_total"] == 2
    elif case == "kill_shared":
        assert stats["resumed_total"] == stats["evicted_total"] == 2
    elif case == "parked_donor":
        assert stats["prefix_hits_total"] == 1
        assert port.flush_prefix_cache() == ref.flush_prefix_cache() == 1
    check_serving_invariants(port, pr, ctx=case)


@pytest.mark.parametrize("kv_mode", KV_MODES)
def test_evacuate_matches_reference(kv_mode):
    """``evacuate`` returns every incomplete request in the reference's
    order, drops every resident sequence and leaves the engine inert."""
    def run(port):
        make = make_port_engine if port else make_engine
        engine, _ = make(8, max_batch=2, step_time_s=0.01, kv_mode=kv_mode,
                         prefix_cache_seqs=1)
        reqs = make_requests(random.Random(8), 6, deadline_prob=0.0,
                             share_prob=0.5)
        reqs = port_requests(reqs) if port else reqs
        for r in reqs:
            engine.submit(r)
        for _ in range(4):
            engine.step()
        out = engine.evacuate()
        assert engine.step() == 0 and engine.dead
        return engine, [r.request_id for r in out]

    (ref, ref_out), (port, port_out) = run(False), run(True)
    assert port_out == ref_out and port_out
    assert port.trace_text() == ref.trace_text()
    assert port.kv.pages_allocated == port.kv.pages_freed == \
        ref.kv.pages_freed
    assert port.admission.slot_balance() == {}
