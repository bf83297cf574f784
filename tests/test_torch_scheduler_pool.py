"""Port parity: the serverless scheduler, the warm sandbox pool and the
metrics registry (``repro_torch.core``) against the reference's.

* The chaos suite's scenario (``tests/test_scheduler_chaos.py``): every
  10th seed of its window replays on the port's scheduler under its
  ``SimExecutor``, with torch tensors, the port's ``FailureInjector`` and
  the port's ``checkpoint``.  The decision trace must be byte-identical to
  the reference's, the task histories and counters equal, and the
  reference's drain invariants (``helpers/invariants.py``) must hold on
  both.  Admission traces run on the simulated workers and sleep inside
  user code, so this also holds the Sentry's tracing to interleaving.
* The pool's refill cases of ``tests/test_pool_refill.py`` on both pools.
* ``MetricsRegistry`` text for a pool, an admission controller and a
  drained scheduler, family by family.
"""

import random
from collections import Counter

import jax.numpy as jnp
import pytest
import torch
from helpers.invariants import check_drain_invariants
from helpers.torch_invariants import (
    AuditedPool,
    WatchedScheduler,
    check_port_drain_invariants,
)
from test_scheduler_chaos import (
    AFFINITY,
    CHAOS_SEED_COUNT,
    CHAOS_SEED_START,
    REPLAY_STRIDE,
    TENANTS,
    chaos_run,
)

import repro.core as J
import repro_torch.core as T
from repro_torch.runtime.fault import FailureInjector

PORT_QUOTAS = {
    "alice": T.TenantQuota(max_tasks_in_flight=2, weight=2),
    "bob": T.TenantQuota(max_tasks_in_flight=1),
    "carol": T.TenantQuota(max_tasks_in_flight=2),
}


def port_chaos_run(seed):
    """``chaos_run`` of ``tests/test_scheduler_chaos.py`` on the port, line
    for line: the same draws from the same RNG in the same order."""
    rng = random.Random(seed * 7919 + 13)
    sim = T.SimExecutor(seed=seed)
    pool = AuditedPool()
    affinity = AFFINITY if rng.random() < 0.5 else None
    sched = WatchedScheduler(
        workers=4, executor=sim, quotas=PORT_QUOTAS, pool=pool,
        affinity=affinity,
    )
    sched.enable_heartbeats(timeout_s=0.3, replace_dead=True)

    def slow_ok(x):
        sim.sleep(0.02)
        return (x + 1).sum()

    def cooperative(x):
        for _ in range(4):
            sim.sleep(0.01)
            T.checkpoint()
        return (x * 2).sum()

    def quick(x):
        return (x * 3).sum()

    def flaky(x):
        raise RuntimeError("transient chaos failure")

    bodies = (quick, slow_ok, cooperative, slow_ok, cooperative, flaky)
    x = torch.ones(2)
    ids = []
    for i in range(14):
        ids.append(sched.submit(T.TaskSpec(
            tenant=rng.choice(TENANTS),
            fn=rng.choice(bodies),
            args=(x,),
            priority=rng.choice((1, 5, 10)),
            name=f"chaos{i}",
            deadline_s=0.15 if rng.random() < 0.15 else None,
            run_deadline_s=0.08 if rng.random() < 0.15 else None,
        )))

    injector = FailureInjector()
    if rng.random() < 0.5:
        sick = f"w{rng.randrange(4)}"
        injector.slow_at_t[round(rng.uniform(0.02, 0.2), 3)] = {
            sick: rng.choice((20.0, 50.0)),
        }
    if rng.random() < 0.35:
        when = round(rng.uniform(0.02, 0.25), 3)
        injector.kill_at_t[when] = [f"w{rng.randrange(4)}"]
        sim.call_at(when + 0.01, sched.spawn_worker)
    injector.arm(sim)

    for tid in rng.sample(ids, k=2):
        sim.call_at(round(rng.uniform(0.01, 0.3), 3),
                    lambda t=tid: sched.cancel(t))

    for k in range(1, 60):
        sim.call_at(0.05 * k, sched.check_heartbeats)

    sched.start()
    sched.drain(timeout=60)
    sim.run()
    check_port_drain_invariants(sched, ids, quotas=PORT_QUOTAS,
                                ctx=f"port seed={seed}")

    trace = sched.trace_text()
    histories = tuple(sched.record(i).history() for i in ids)
    counters = Counter(sched.stats())
    counters.update({
        "steals": sched.steal_count,
        "preempts": sched.preempt_count,
        "hb_deaths": sched.heartbeat_death_count,
        "kills": len(sim.killed_workers()),
    })
    sched.shutdown()
    return trace, histories, counters


SEEDS = [s for s in range(CHAOS_SEED_START, CHAOS_SEED_START + CHAOS_SEED_COUNT)
         if s % REPLAY_STRIDE == 0]


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_seed_trace_is_byte_identical_to_reference(seed):
    ref_trace, ref_hist, ref_counters = chaos_run(seed)
    trace, hist, counters = port_chaos_run(seed)
    assert trace == ref_trace, f"trace diverged [seed={seed}]"
    assert [[(s.value if hasattr(s, "value") else s) for s in h]
            for h in hist] == [[(s.value if hasattr(s, "value") else s)
                                for s in h] for h in ref_hist]
    assert counters == ref_counters


def test_chaos_sweep_exercises_the_resilience_paths():
    """Over the replayed seeds the port ran preemptions, heartbeat deaths,
    kills and failures, not a sweep of no-op schedules."""
    totals = Counter()
    for seed in SEEDS:
        totals.update(port_chaos_run(seed)[2])
    for key in ("preempts", "hb_deaths", "kills", "failed", "succeeded"):
        assert totals[key] > 0, totals


def _workload(core, arr, executor):
    """``_differential_workload`` of the chaos suite, on either package."""
    sched = core.ServerlessScheduler(
        workers=4, executor=executor,
        quotas={"u": core.TenantQuota(max_tasks_in_flight=3),
                "v": core.TenantQuota(max_tasks_in_flight=2)},
    )

    def ok(x):
        executor.sleep(0.003)
        return (x * 2).sum()

    def always_fails(x):
        raise RuntimeError("always fails")

    x = arr([1.0, 1.0])
    ids = [sched.submit(core.TaskSpec("u" if i % 2 else "v", ok, (x,)))
           for i in range(10)]
    ids += [sched.submit(core.TaskSpec("u", always_fails, (x,),
                                       max_retries=1)) for _ in range(3)]
    sched.start()
    sched.drain(timeout=60)
    return sched, ids


@pytest.mark.parametrize("seed", [5, 6])
def test_sim_workload_matches_reference(seed):
    ref, ref_ids = _workload(J, jnp.asarray, J.SimExecutor(seed=seed))
    got, ids = _workload(T, torch.tensor, T.SimExecutor(seed=seed))
    check_drain_invariants(ref, ref_ids, ctx="reference")
    check_port_drain_invariants(got, ids, ctx="port")
    assert got.trace_text() == ref.trace_text()
    assert got.admission.stats() == ref.admission.stats()
    assert got.pool.stats.as_dict() == ref.pool.stats.as_dict()
    assert [float(got.record(i).result.value) for i in ids[:10]] == \
        [float(ref.record(i).result.value) for i in ref_ids[:10]]
    ref.shutdown()
    got.shutdown()


# ----------------------------------------------------------------- pool

def _refill_cases(core):
    """``tests/test_pool_refill.py``'s deterministic cases; returns the
    pools' stats and idle counts."""
    out = {}
    pool = core.SandboxPool(refill_watermark=2)
    pool.checkout("alice")
    out["tick"] = (pool.tick(), pool.idle_count("alice"), pool.tick())
    pool = core.SandboxPool(refill_watermark=2)
    pool.set_watermark("alice", 2)
    pool.tick()
    for _ in range(20):
        sb = pool.checkout("alice")
        pool.checkin(sb, discard=True)
        pool.tick()
    out["steady"] = pool.stats.as_dict()
    pool = core.SandboxPool(refill_watermark=1)
    pool.checkout("small")
    pool.set_watermark("big", 3)
    pool.tick()
    out["override"] = (pool.idle_count("small"), pool.idle_count("big"))
    pool = core.SandboxPool(refill_watermark=4, max_total_idle=3)
    pool.set_watermark("a", 4)
    out["cap"] = (pool.tick(), pool.idle_count())
    pool = core.SandboxPool(refill_watermark=1)
    restricted = core.Sandbox(tenant="serving",
                              policy=core.LegacyFilterPolicy())
    pool.seed(restricted)
    pool.checkin(pool.checkout("serving"), discard=True)
    pool.tick()
    fresh = pool.checkout("serving")
    out["template"] = (fresh is not restricted, fresh.policy.name)
    pool = core.SandboxPool(refill_watermark=5, max_idle_per_tenant=2)
    pool.set_watermark("t", 5)
    out["clamp"] = (pool.tick(), pool.tick(), pool.stats.evictions)
    pool = core.SandboxPool()
    stranger = core.Sandbox(tenant="ghost")
    pool.checkin(stranger)
    sb = pool.checkout("alice")
    pool.checkin(sb, discard=True)
    pool.checkin(sb)
    out["orphans"] = pool.stats.as_dict()
    return out


def test_pool_refill_cases_match_reference():
    assert _refill_cases(T) == _refill_cases(J)


# -------------------------------------------------------------- metrics

def _families(text):
    fams = {}
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            name = line.split()[2]
            fams[name] = [line]
        elif line and not line.startswith("#"):
            name = line.split("{")[0].split(" ")[0]
            for fam in fams:
                if name == fam or name.startswith(fam + "_"):
                    fams[fam].append(line)
                    break
    return fams


def _registry(core, arr):
    sim = core.SimExecutor(seed=3)
    sched = core.ServerlessScheduler(workers=2, executor=sim)
    fn = lambda x: (x * 2).sum()                  # noqa: E731
    ids = [sched.submit(core.TaskSpec(t, fn, (arr([1.0, 2.0]),)))
           for t in ("alice", "bob", "alice")]
    sched.start()
    sched.drain(timeout=60)
    assert all(sched.record(i).state.value == "succeeded" for i in ids)
    reg = (core.MetricsRegistry().register_sink(sched.telemetry)
           .register_admission(sched.admission).register_pool(sched.pool)
           .register_scheduler(sched))
    text = reg.render()
    sched.shutdown()
    return text


def test_metrics_text_matches_reference_family_by_family():
    ref = _families(_registry(J, jnp.asarray))
    got = _families(_registry(T, torch.tensor))
    assert sorted(got) == sorted(ref)
    for name in ref:
        if "seconds" in name or "busy" in name or "utilization" in name:
            # wall-clock samples: the same series, other values
            assert [ln.split(" ")[0] for ln in got[name]] == \
                [ln.split(" ")[0] for ln in ref[name]], name
        else:
            assert got[name] == ref[name], name
