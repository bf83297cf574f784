"""Port parity, bitwise: the cases of ``tests/test_orchestrator.py`` on the
port's ``WorkloadOrchestrator`` (``repro_torch.runtime.orchestrator``),
against the reference's.

Each case builds the same stack on each package under a ``SimExecutor``
of the same seed: the reference's engine over its integer ``ToyLM`` and
the port's over the torch twin (``helpers/torch_serving.py``), a
``ServerlessScheduler`` per package, the same seeded requests, a
duck-typed train stepper and batch bodies that checkpoint and sleep on the
virtual clock.  After the drain the scheduler's trace text, the
orchestrator's stats, the token streams, the engine traces, the batch
jobs' outcomes and, where the case has one, the ``/metrics`` text must be
equal byte for byte; the reference case's own assertions are then made on
the port.  ``TrainStepper`` driven through the pool is held bit for bit to
the port's own ``Trainer.run`` on the reduced gemma2-9b.
"""

import random

import pytest
import torch
from helpers.invariants import check_serving_invariants
from helpers.serving import make_engine, make_requests
from helpers.torch_invariants import check_port_drain_invariants
from helpers.torch_serving import make_port_engine, port_requests, streams

import repro.core as J
import repro.core.metrics as JM
import repro.runtime.elastic as JE
import repro.runtime.orchestrator as JO
import repro_torch.core as T
import repro_torch.core.metrics as TM
import repro_torch.runtime.elastic as TE
import repro_torch.runtime.orchestrator as TO

#: per package: (core, elastic, orchestrator, metrics, make engine, requests)
SIDES = {
    "ref": (J, JE, JO, JM, make_engine, list),
    "port": (T, TE, TO, TM, make_port_engine, port_requests),
}


class FakeStepper:
    """Duck-typed TrainStepper: cooperative, virtual-time step bodies."""

    def __init__(self, n, sim, checkpoint, step_s=0.01):
        self.n, self.sim, self.step_s = n, sim, step_s
        self.checkpoint = checkpoint
        self.steps = 0

    def done(self):
        return self.steps >= self.n

    def step_once(self):
        self.checkpoint()
        self.sim.sleep(self.step_s)
        self.steps += 1
        return {"step": float(self.steps)}


def _batch_body(sim, checkpoint, sleeps=3, step_s=0.01):
    def body():
        for _ in range(sleeps):
            checkpoint()
            sim.sleep(step_s)
        return sleeps

    return body


def _stack(side, seed=0, workers=2, n_requests=6, cfg=None):
    core, _, orch_mod, _, make, convert = SIDES[side]
    sim = core.SimExecutor(seed=seed)
    engine, _ = make(executor=sim, step_time_s=0.01)
    sched = core.ServerlessScheduler(workers=workers, executor=sim)
    if cfg is not None:
        cfg = orch_mod.OrchestratorConfig(**cfg)
    orch = orch_mod.WorkloadOrchestrator(sched, serving=engine, cfg=cfg)
    rng = random.Random(seed * 7919 + 5)
    reqs = convert(make_requests(rng, n_requests, deadline_prob=0.0))
    for r in reqs:
        engine.submit(r)
    return sim, engine, sched, orch, reqs


def _finish(sim, sched, orch, timeout=120):
    orch.drain(timeout=timeout)
    sched.drain(timeout=30)
    sim.run()


def _jobs(orch):
    return tuple((j.job_id, j.name, j.state, j.preemptions, j.resubmits,
                  tuple(j.task_ids)) for j in orch.jobs())


def _observe(engine, sched, orch, reqs):
    return {
        "trace": sched.trace_text(),
        "stats": orch.orchestrator_stats(),
        "streams": streams(reqs),
        "engine_trace": engine.trace_text(),
        "jobs": _jobs(orch),
        "states": tuple(sched.record(r.task_id).state.value
                        for r in sched.records()),
    }


def _assert_paired(ref, port, ctx):
    for key in ref:
        assert port[key] == ref[key], f"{key} differs [{ctx}]"


def _run_both(scenario, **kw):
    out = {side: scenario(side, **kw) for side in SIDES}
    _assert_paired(out["ref"][0], out["port"][0], scenario.__name__)
    return out["port"]


# ---------------------------------------------------------------- cases


def _mixed(side):
    core = SIDES[side][0]
    sim, engine, sched, orch, reqs = _stack(side, seed=3, workers=2)
    orch.stepper = FakeStepper(4, sim, core.checkpoint)
    jobs = [orch.submit_batch(_batch_body(sim, core.checkpoint),
                              name=f"job{i}") for i in range(3)]
    _finish(sim, sched, orch)
    return _observe(engine, sched, orch, reqs), (engine, sched, orch, reqs,
                                                 jobs)


def test_mixed_workloads_share_one_pool():
    _, (engine, sched, orch, reqs, jobs) = _run_both(_mixed)
    assert len(engine.completed) == len(reqs)
    assert orch.stepper.done() and orch.train_steps == 4
    assert all(j.state == "done" for j in jobs)
    stats = orch.orchestrator_stats()
    assert stats["serving_steps"] >= 2
    assert stats["batch_jobs_done"] == 3
    check_serving_invariants(engine, reqs, ctx="mixed pool")
    check_port_drain_invariants(
        sched, [r.task_id for r in sched.records()], ctx="mixed pool")


def _preempts(side):
    core = SIDES[side][0]
    sim, engine, sched, orch, reqs = _stack(
        side, seed=5, workers=1, n_requests=4,
        cfg=dict(max_preemptions_per_job=2))
    jobs = [orch.submit_batch(_batch_body(sim, core.checkpoint, sleeps=10),
                              name=f"long{i}") for i in range(2)]
    _finish(sim, sched, orch, timeout=240)
    return _observe(engine, sched, orch, reqs), (engine, sched, orch, reqs,
                                                 jobs)


def test_decode_preempts_saturated_batch_pool():
    _, (engine, sched, orch, reqs, jobs) = _run_both(_preempts)
    assert len(engine.completed) == len(reqs)
    assert orch.preemptions_total >= 1
    assert all(j.state == "done" for j in jobs)
    for j in jobs:
        assert len(j.task_ids) == j.resubmits + 1
        states = [sched.record(t).state for t in j.task_ids]
        assert states[-1] is T.TaskState.SUCCEEDED
        assert all(s in (T.TaskState.PREEMPTED, T.TaskState.CANCELLED)
                   for s in states[:-1])
    check_serving_invariants(engine, reqs, ctx="preemption")


def _budget(side):
    core = SIDES[side][0]
    sim, engine, sched, orch, reqs = _stack(
        side, seed=9, workers=1, n_requests=10,
        cfg=dict(max_preemptions_per_job=1))
    jobs = [orch.submit_batch(_batch_body(sim, core.checkpoint, sleeps=6),
                              name=f"b{i}") for i in range(3)]
    _finish(sim, sched, orch, timeout=240)
    return _observe(engine, sched, orch, reqs), (engine, orch, reqs, jobs)


def test_preemption_budget_bounds_batch_starvation():
    _, (engine, orch, reqs, jobs) = _run_both(_budget)
    assert all(j.state == "done" for j in jobs), [j.state for j in jobs]
    assert all(j.preemptions <= 1 for j in jobs)
    assert len(engine.completed) == len(reqs)


@pytest.mark.parametrize("side", list(SIDES))
def test_lane_quotas_installed_on_construction(side):
    core, _, orch_mod, _, _, _ = SIDES[side]
    sim = core.SimExecutor(seed=0)
    sched = core.ServerlessScheduler(workers=1, executor=sim)
    orch = orch_mod.WorkloadOrchestrator(sched)
    c = orch.cfg
    assert sched.quota(c.serving_tenant).weight == c.serving_weight
    assert sched.quota(c.serving_tenant).max_tasks_in_flight == 1
    assert sched.quota(c.train_tenant).max_tasks_in_flight == 1
    assert sched.quota(c.batch_tenant).weight == c.batch_weight
    assert sched.quota(c.batch_tenant).max_tasks_in_flight == \
        c.batch_in_flight
    assert orch.class_queue_depths() == {"serving": 0, "train": 0,
                                         "batch": 0}


def test_config_and_job_records_match_the_reference():
    """``OrchestratorConfig`` and ``BatchJob`` keep the reference's fields
    and defaults."""
    import dataclasses

    assert dataclasses.asdict(TO.OrchestratorConfig()) == \
        dataclasses.asdict(JO.OrchestratorConfig())
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(TO.BatchJob) == fields(JO.BatchJob)
    job = TO.BatchJob(job_id=1, name="j", fn=None, priority=10)
    assert job.task_id is None and job.preemptible(2)


def _failure(side):
    core, _, orch_mod, _, _, _ = SIDES[side]
    sim = core.SimExecutor(seed=1)
    sched = core.ServerlessScheduler(workers=1, executor=sim)
    orch = orch_mod.WorkloadOrchestrator(sched)

    def boom():
        raise ValueError("bad batch")

    def fine():
        return 7

    bad = orch.submit_batch(boom, name="bad")
    good = orch.submit_batch(fine, name="good")
    _finish(sim, sched, orch, timeout=60)
    obs = {"trace": sched.trace_text(), "stats": orch.orchestrator_stats(),
           "jobs": _jobs(orch)}
    return obs, (orch, bad, good)


def test_batch_job_failure_is_terminal():
    _, (orch, bad, good) = _run_both(_failure)
    assert bad.state == "failed" and good.state == "done"
    assert bad.resubmits == 0
    stats = orch.orchestrator_stats()
    assert stats["batch_jobs_failed"] == 1 and stats["batch_jobs_done"] == 1


def _bypass(side):
    sim, engine, sched, orch, reqs = _stack(side, seed=7, workers=2,
                                            n_requests=3)
    _finish(sim, sched, orch)
    obs = _observe(engine, sched, orch, reqs)
    obs["system_tasks"] = sched.telemetry.counter("admission.system_task")
    return obs, (engine, sched, orch, reqs)


def test_system_task_bypasses_admission_tracing():
    """The decode step body reads tensors back to the host mid-step, which
    no abstract trace can follow: ``system_task`` routes it around the
    verifier (counted), or every step would land FAILED."""
    _, (engine, sched, orch, reqs) = _run_both(_bypass)
    assert len(engine.completed) == len(reqs)
    assert orch.serving_step_failures == 0
    assert sched.telemetry.counter("admission.system_task") >= \
        orch.serving_steps > 0


def _metrics(side):
    core, elastic, _, metrics, _, _ = SIDES[side]
    sim, engine, sched, orch, reqs = _stack(side, seed=4, workers=2,
                                            n_requests=3)
    auto = elastic.ElasticAutoscaler(
        sched, serving=engine, cfg=elastic.AutoscalerConfig(max_workers=4))
    orch.autoscaler = auto
    jobs = [orch.submit_batch(_batch_body(sim, core.checkpoint), name="m0")]
    _finish(sim, sched, orch)
    reg = metrics.MetricsRegistry().register_orchestrator(orch) \
        .register_elastic(auto)
    obs = _observe(engine, sched, orch, reqs)
    obs.update(text=reg.render(), decisions=tuple(auto.decision_log()),
               elastic=auto.elastic_stats())
    return obs, (jobs, reg)


def test_metrics_families_render():
    _, (jobs, reg) = _run_both(_metrics)
    assert all(j.state == "done" for j in jobs)
    text = reg.render()
    for name in (
        "seepp_orchestrator_ticks_total",
        "seepp_orchestrator_serving_steps_total",
        "seepp_orchestrator_batch_jobs_done_total",
        "seepp_orchestrator_preemptions_total",
        "seepp_orchestrator_class_queue_depth",
        'workload_class="serving"',
        "seepp_elastic_workers_active",
        "seepp_elastic_decisions_total",
        "seepp_elastic_pool_healthy_devices",
    ):
        assert name in text, name
    dump = reg.dump()
    assert dump["seepp_orchestrator_batch_jobs_done_total"][""] == 1.0
    assert dump["seepp_elastic_decisions_total"][""] >= 1.0


@pytest.fixture
def one_thread():
    """Two CPU training runs are bitwise repeatable only on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_through_pool_matches_direct_run(one_thread):
    """``TrainStepper`` driven by orchestrator step-tasks on a 2-worker pool
    under a ``SimExecutor`` equals the port's ``Trainer.run`` from the same
    seed, bit for bit, on the reduced gemma2-9b (fp32)."""
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig, Loader, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    cfg = get_reduced("gemma2-9b")
    model = build_model(cfg, device="cpu")

    def make_trainer():
        dc = DataConfig(global_batch=4, seq_len=16, vocab_size=cfg.vocab_size)
        tr = Trainer(model, Loader(SyntheticLM(dc), dc),
                     TrainerConfig(total_steps=3, ckpt_every=100,
                                   log_every=1))
        params, opt = tr.init_state(0)
        return tr, params, opt

    tr, params, opt = make_trainer()
    tr.run(params, opt)
    direct = [t.clone() for t in tree_leaves(params)]
    direct_log = [dict(row) for row in tr.metrics_log]
    tr.loader.stop()

    tr2, params2, opt2 = make_trainer()
    assert not all(torch.equal(a, b)
                   for a, b in zip(direct, tree_leaves(params2)))
    stepper = tr2.stepper(params2, opt2)
    sim = T.SimExecutor(seed=2)
    sched = T.ServerlessScheduler(workers=2, executor=sim)
    orch = TO.WorkloadOrchestrator(sched, stepper=stepper)
    _finish(sim, sched, orch)
    tr2.loader.stop()

    assert stepper.done() and orch.train_steps == 3
    pooled = tree_leaves(stepper.params)
    assert all(torch.equal(a, b) for a, b in zip(direct, pooled))
    assert [r["loss"] for r in tr2.metrics_log] == \
        [r["loss"] for r in direct_log]
