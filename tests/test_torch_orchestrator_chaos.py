"""Port parity, bitwise: the orchestration chaos sweep
(``tests/test_orchestrator_chaos.py``) on the port, seed by seed.

``port_chaos_run`` is the reference's ``chaos_run`` line for line on the
port's classes: the same draws from the same RNG in the same order build a
``WorkloadOrchestrator`` over a serving engine (the torch twin of the
integer ``ToyLM``), a duck-typed train stepper and a bag of batch jobs on
one 2-worker pool with heartbeats, a metrics-driven ``ElasticAutoscaler``,
and node kills, heartbeat deaths and ops-driven scale events at seeded
virtual times.  Each seed of the reference's window (``ORCH_CHAOS_SEED_*``,
0..29 by default) must hold the reference's invariants on the port and
give the reference's scheduler trace, per-request results, batch outcomes,
autoscaler decision log and counters byte for byte; every 10th seed
replays on the port byte for byte.
"""

import random
from collections import Counter

import pytest
from helpers.invariants import check_serving_invariants
from helpers.serving import make_requests
from helpers.torch_invariants import (AuditedPool, WatchedScheduler,
                                      check_port_drain_invariants)
from helpers.torch_serving import make_port_engine, port_requests
from test_orchestrator_chaos import (ORCH_CHAOS_SEED_COUNT, PREEMPT_BOUND,
                                     REPLAY_STRIDE, SEEDS, chaos_run)

from repro_torch.core.sim import SimExecutor
from repro_torch.core.tasks import checkpoint
from repro_torch.runtime.elastic import AutoscalerConfig, ElasticAutoscaler
from repro_torch.runtime.fault import FailureInjector
from repro_torch.runtime.orchestrator import (OrchestratorConfig,
                                              WorkloadOrchestrator)


class _Stepper:
    def __init__(self, n, sim):
        self.n = n
        self.sim = sim
        self.steps = 0

    def done(self):
        return self.steps >= self.n

    def step_once(self):
        checkpoint()
        self.sim.sleep(0.01)
        self.steps += 1
        return {"step": float(self.steps)}


def port_chaos_run(seed):
    """``chaos_run`` of the reference suite on the port's classes."""
    rng = random.Random(seed * 9176 + 29)
    sim = SimExecutor(seed=seed)
    pool = AuditedPool()
    sched = WatchedScheduler(workers=2, executor=sim, pool=pool)
    sched.enable_heartbeats(timeout_s=0.3, replace_dead=True)
    sched.start()
    engine, _ = make_port_engine(executor=sim, step_time_s=0.01)
    auto = ElasticAutoscaler(sched, serving=engine, cfg=AutoscalerConfig(
        min_workers=1, max_workers=5, queue_high=3, idle_ticks=3,
        cooldown_ticks=2))
    stepper = _Stepper(rng.randint(2, 5), sim)
    orch = WorkloadOrchestrator(
        sched, serving=engine, stepper=stepper, autoscaler=auto,
        cfg=OrchestratorConfig(max_preemptions_per_job=PREEMPT_BOUND,
                               autoscale_every=2))

    reqs = port_requests(make_requests(rng, rng.randint(5, 10),
                                       deadline_prob=0.0, sample_prob=0.3))
    for r in reqs:
        if rng.random() < 0.5:
            engine.submit(r)
        else:
            sim.call_at(round(rng.uniform(0.05, 0.4), 3),
                        lambda r=r: engine.submit(r))

    def make_body(sleeps):
        def body():
            for _ in range(sleeps):
                checkpoint()
                sim.sleep(0.01)
            return sleeps

        return body

    jobs = []
    for i in range(rng.randint(3, 5)):
        body = make_body(rng.randint(2, 6))
        if rng.random() < 0.6:
            jobs.append(orch.submit_batch(body, name=f"job{i}"))
        else:
            sim.call_at(round(rng.uniform(0.02, 0.35), 3),
                        lambda b=body, i=i: jobs.append(
                            orch.submit_batch(b, name=f"job{i}")))

    injector = FailureInjector()
    if rng.random() < 0.45:
        injector.kill_at_t[round(rng.uniform(0.03, 0.3), 3)] = [
            f"w{rng.randrange(2)}"]
    if rng.random() < 0.35:
        injector.slow_at_t[round(rng.uniform(0.03, 0.3), 3)] = {
            f"w{rng.randrange(2)}": rng.choice((20.0, 50.0))}
    if rng.random() < 0.6:
        injector.scale_up_at_t[round(rng.uniform(0.05, 0.3), 3)] = \
            rng.randint(1, 2)
    if rng.random() < 0.4:
        injector.scale_down_at_t[round(rng.uniform(0.4, 0.7), 3)] = 1
    injector.arm(sim)
    injector.arm_orchestrator(sim, auto)

    for k in range(150):
        sim.call_at(0.02 * k + 0.005, orch.tick)
    for k in range(1, 60):
        sim.call_at(0.05 * k, sched.check_heartbeats)

    sim.run()
    orch.tick()
    sched.drain(timeout=60)
    sim.run()

    ctx = f"port seed={seed}"
    assert not orch.has_work(), f"orchestrator not quiescent [{ctx}]"
    check_port_drain_invariants(sched, [r.task_id for r in sched.records()],
                                ctx=ctx)
    check_serving_invariants(engine, reqs, ctx=ctx)
    assert len(engine.completed) == len(reqs), ctx
    assert stepper.done(), f"train lane starved [{ctx}]"
    assert len(jobs) > 0 and all(j.state == "done" for j in jobs), (
        f"batch starved: {[(j.name, j.state) for j in jobs]} [{ctx}]")
    assert all(j.preemptions <= PREEMPT_BOUND for j in jobs), ctx
    assert not pool.double_checkouts, ctx

    results = tuple(sorted(
        (r.request_id, tuple(r.tokens), r.error) for r in reqs))
    outcomes = tuple((j.name, j.state, j.preemptions, j.resubmits)
                     for j in orch.jobs())
    counters = Counter({
        "preemptions": orch.preemptions_total,
        "resubmits": orch.batch_resubmits_total,
        "scale_ups": auto.scale_ups,
        "scale_downs": auto.scale_downs,
        "hb_deaths": sched.heartbeat_death_count,
        "kills": len(sim.killed_workers()),
        "serving_steps": orch.serving_steps,
    })
    trace = sched.trace_text()
    decisions = tuple(auto.decision_log())
    sched.shutdown()
    return trace, results, outcomes, decisions, counters


_PARTS = ("trace", "results", "job outcomes", "decision log", "counters")


@pytest.mark.parametrize("seed", list(SEEDS))
def test_chaos_seed_matches_reference(seed):
    ref = chaos_run(seed)
    port = port_chaos_run(seed)
    for part, a, b in zip(_PARTS, port, ref):
        assert a == b, f"{part} diverged from the reference [seed={seed}]"


def test_chaos_window_exercised_every_path_and_replays():
    """Over the window the port ran every path the reference suite's
    coverage floor asks for (counted afresh here), and every 10th seed
    replays byte for byte."""
    totals = Counter()
    replayed = 0
    for seed in SEEDS:
        first = port_chaos_run(seed)
        totals.update(first[-1])
        if seed % REPLAY_STRIDE == 0:
            assert port_chaos_run(seed)[:4] == first[:4], seed
            replayed += 1
    if ORCH_CHAOS_SEED_COUNT >= 20:
        for key in ("serving_steps", "preemptions", "scale_ups",
                    "scale_downs", "kills"):
            assert totals[key] > 0, (key, totals)
        assert replayed >= 2
