"""Port parity: the elastic plane (``repro_torch.runtime.elastic``) against
the reference's, case by case of ``tests/test_elastic.py`` and the elastic
cases of ``tests/test_fault_elastic.py``.

``plan_mesh`` must return the reference's shapes and axis names over a
grid of pool sizes, TP degrees and pod preferences; ``ElasticController``
the same event log (every field of every ``ElasticEvent``) and pool
accounting; ``ElasticAutoscaler`` the same ``decision_log()`` and
``elastic_stats()`` on each package's ``ServerlessScheduler`` under a
``SimExecutor`` of the same seed, with the same duck-typed serving planes.
Each scenario runs on both packages, makes the reference case's own
assertions on each, and returns what is compared.
"""

import dataclasses
import itertools

import pytest

import repro.core as J
import repro.runtime.elastic as JE
import repro_torch.core as T
import repro_torch.runtime.elastic as TE

SIDES = {"ref": (J, JE), "port": (T, TE)}


def _both(scenario, *args):
    ref = scenario(*SIDES["ref"], *args)
    port = scenario(*SIDES["port"], *args)
    assert port == ref, scenario.__name__
    return port


# ------------------------------------------------------------- plan_mesh

PLAN_GRID = list(itertools.product(range(0, 70), (1, 2, 3, 4, 6, 16),
                                   (1, 2, 4, 5)))


@pytest.mark.parametrize("model", [1, 2, 3, 4, 6, 16])
def test_plan_mesh_matches_reference_over_a_grid(model):
    for n, m, pods in PLAN_GRID:
        if m != model:
            continue
        got = TE.plan_mesh(n, model=m, prefer_pods=pods)
        assert got == JE.plan_mesh(n, model=m, prefer_pods=pods), (n, m,
                                                                   pods)


def _plan_cases(core, E):
    shapes = [
        E.plan_mesh(256, model=16), E.plan_mesh(240, model=16),
        E.plan_mesh(17, model=16), E.plan_mesh(16, model=16),
        E.plan_mesh(4, model=4),
        E.plan_mesh(8, model=16), E.plan_mesh(3, model=16),
        E.plan_mesh(1, model=16), E.plan_mesh(2, model=6),
        E.plan_mesh(512, model=16, prefer_pods=2),
        E.plan_mesh(512, model=16, prefer_pods=4),
        E.plan_mesh(48, model=16, prefer_pods=5),
        E.plan_mesh(16, model=16, prefer_pods=2),
    ]
    assert shapes[:5] == [((16, 16), ("data", "model")),
                          ((15, 16), ("data", "model")),
                          ((1, 16), ("data", "model")),
                          ((1, 16), ("data", "model")),
                          ((1, 4), ("data", "model"))]
    assert [s for s, _ in shapes[5:9]] == [(1, 8), (1, 2), (1, 1), (2, 1)]
    assert shapes[9] == ((2, 16, 16), ("pod", "data", "model"))
    assert shapes[10] == ((4, 8, 16), ("pod", "data", "model"))
    assert shapes[11:] == [((3, 16), ("data", "model")),
                           ((1, 16), ("data", "model"))]
    return shapes


def test_plan_mesh_shapes_and_branches():
    """The shapes of the reference's across-counts, degrade-TP and
    prefer-pods cases."""
    _both(_plan_cases)


def _never_overcommits(core, E):
    out = []
    for n in range(1, 70):
        for model in (1, 2, 4, 16):
            shape, axes = E.plan_mesh(n, model=model)
            used = 1
            for s in shape:
                used *= s
            assert used <= n and len(shape) == len(axes), (n, model, shape)
            out.append(shape)
    return out


def test_plan_mesh_never_overcommits():
    _both(_never_overcommits)


# ----------------------------------------------------- ElasticController


def _events(ec):
    return [dataclasses.astuple(e) for e in ec.events], (
        ec.healthy, ec.in_use, ec.spare)


def _roundtrip(core, E):
    ec = E.ElasticController(512, model_axis=16)
    shape, axes, ev = ec.lose(32, step=100, reason="pod slice down")
    assert ev.old_devices == 512 and ev.new_devices == 480
    assert ec.healthy == 480 and shape == (30, 16)
    shape, axes, ev = ec.gain(32, step=200)
    assert ec.healthy == 512 and shape == (32, 16)
    assert [e.reason for e in ec.events] == ["pod slice down", "scale-up"]
    return _events(ec)


def _degrade(core, E):
    ec = E.ElasticController(16, model_axis=16)
    shape, axes, ev = ec.lose(12, step=0, reason="rack down")
    assert ec.healthy == 4 and shape == (1, 4) and ev.new_devices == 4
    return _events(ec)


def _spares(core, E):
    ec = E.ElasticController(8, model_axis=4)
    shape, axes, ev = ec.lose(1, step=10)
    assert shape == (1, 4) and ec.healthy == 7
    assert ev.in_use == 4 and ev.spare == 3
    shape, axes, ev = ec.gain(1, step=20)
    assert shape == (2, 4)
    assert ec.healthy == 8 and ev.in_use == 8 and ev.spare == 0
    return _events(ec)


def _floor(core, E):
    ec = E.ElasticController(4, model_axis=4)
    shape, axes, ev = ec.lose(100, step=1)
    assert ec.healthy == 0 and shape == (1, 1)
    assert ev.spare == 0 or ev.spare == -1
    shape, axes, ev = ec.gain(4, step=2)
    assert ec.healthy == 4 and shape == (1, 4)
    return _events(ec)


def _log(core, E):
    ec = E.ElasticController(32, model_axis=4)
    ec.lose(2, step=1)
    ec.lose(2, step=2)
    ec.gain(4, step=3)
    assert [(e.old_devices, e.new_devices) for e in ec.events] == [
        (32, 30), (30, 28), (28, 32)]
    assert all(e.in_use <= max(e.new_devices, 1) for e in ec.events)
    return _events(ec)


def _fault_elastic_events(core, E):
    """``tests/test_fault_elastic.py``'s two elastic cases."""
    assert E.plan_mesh(256, model=16) == ((16, 16), ("data", "model"))
    assert E.plan_mesh(512, model=16, prefer_pods=2) == \
        ((2, 16, 16), ("pod", "data", "model"))
    assert E.plan_mesh(8, model=16)[0][-1] <= 8
    ec = E.ElasticController(512, model_axis=16)
    shape, axes, ev = ec.lose(32, step=100, reason="pod slice down")
    assert ev.old_devices == 512 and ec.healthy == 480 and shape == (30, 16)
    ec.gain(32, step=200)
    assert ec.healthy == 512
    return _events(ec)


@pytest.mark.parametrize("scenario", [_roundtrip, _degrade, _spares, _floor,
                                      _log, _fault_elastic_events],
                         ids=lambda f: f.__name__.strip("_"))
def test_controller_event_log_matches_reference(scenario):
    _both(scenario)


# ----------------------------------------------------- ElasticAutoscaler


class _FakeServing:
    """Duck-typed serving plane: just the two metric feeds."""

    def __init__(self):
        self.wait = (0.0, 0.0)
        self.depth = 0

    def admit_wait_snapshot(self):
        return self.wait

    def queue_depth(self):
        return self.depth


class _FakeReplicaSet(_FakeServing):
    def __init__(self, n=1):
        super().__init__()
        self._alive = list(range(n))

    def alive(self):
        return list(self._alive)

    def add_replica(self, engine):
        self._alive.append(len(self._alive))

    def retire_replica(self, i=None):
        if len(self._alive) <= 1:
            return None
        return self._alive.pop()


def _sim_sched(core, seed=1, workers=1):
    sim = core.SimExecutor(seed=seed)
    sched = core.ServerlessScheduler(workers=workers, executor=sim)
    sched.start()
    return sim, sched


def _outcome(auto, sched):
    return (tuple(auto.decision_log()), auto.elastic_stats(),
            [dataclasses.astuple(e) for e in auto.controller.events],
            tuple(sched.condemned_workers()))


def _queue_depth(core, E):
    sim, sched = _sim_sched(core)
    auto = E.ElasticAutoscaler(sched, cfg=E.AutoscalerConfig(
        queue_high=3, max_workers=4, cooldown_ticks=1))

    def body():
        sim.sleep(0.05)

    ids = [sched.submit(core.TaskSpec(tenant="t", fn=body, name=f"b{i}"))
           for i in range(8)]
    d = auto.tick()
    assert d.action == "scale_up_worker" and d.reason.startswith("queue_high:")
    assert d.queue_depth == 8 and d.workers == 2
    assert auto.tick().reason == "cooldown"
    d = auto.tick()
    assert d.action == "scale_up_worker" and d.workers == 3
    assert auto.scale_ups == 2 and auto.controller.healthy == 3
    out = _outcome(auto, sched)
    sched.drain(timeout=30)
    assert all(sched.record(i).state.name == "SUCCEEDED" for i in ids)
    return out, sched.trace_text()


def _admit_wait(core, E):
    _, sched = _sim_sched(core)
    fake = _FakeServing()
    auto = E.ElasticAutoscaler(sched, serving=fake, cfg=E.AutoscalerConfig(
        queue_high=100, admit_wait_high_s=0.05, cooldown_ticks=0))
    fake.wait = (4.0, 1.0)
    d = auto.tick()
    assert d.action == "scale_up_worker"
    assert d.reason.startswith("admit_wait_high:")
    assert d.admit_wait_s == pytest.approx(0.25)
    d = auto.tick()
    assert d.action == "hold" and d.admit_wait_s == 0.0
    return _outcome(auto, sched)


def _serving_depth(core, E):
    _, sched = _sim_sched(core)
    rs = _FakeReplicaSet(n=1)
    auto = E.ElasticAutoscaler(
        sched, serving=rs, replica_factory=lambda: object(),
        cfg=E.AutoscalerConfig(queue_high=100, serving_queue_high=2,
                               max_replicas=3, cooldown_ticks=0))
    rs.depth = 5
    assert [auto.tick().action for _ in range(3)] == [
        "scale_up_replica", "scale_up_replica", "hold"]
    assert [d.replicas for d in auto.decisions] == [2, 3, 3]
    assert auto.replica_scale_ups == 2
    return _outcome(auto, sched)


def _idle(core, E):
    sim, sched = _sim_sched(core, workers=3)
    auto = E.ElasticAutoscaler(sched, cfg=E.AutoscalerConfig(
        min_workers=1, idle_ticks=2, cooldown_ticks=1))
    assert auto.tick().reason == "idle_streak"
    d = auto.tick()
    assert d.action == "scale_down_worker"
    assert d.reason == "idle:w2" and d.workers == 2
    assert sched.condemned_workers() == ["w2"]
    assert auto.tick().reason == "cooldown"
    assert auto.tick().reason == "idle_streak"
    d = auto.tick()
    assert d.action == "scale_down_worker" and d.reason == "idle:w1"
    assert auto.controller.healthy == 1
    out = _outcome(auto, sched)
    sched.start()
    sim.run()
    return out


def _retire_replica(core, E):
    _, sched = _sim_sched(core, workers=1)
    rs = _FakeReplicaSet(n=2)
    auto = E.ElasticAutoscaler(
        sched, serving=rs, replica_factory=lambda: object(),
        cfg=E.AutoscalerConfig(min_workers=1, min_replicas=1,
                               idle_ticks=1, cooldown_ticks=0))
    d = auto.tick()
    assert d.action == "scale_down_replica" and d.replicas == 1
    assert auto.tick().action == "hold"
    assert auto.replica_scale_downs == 1
    return _outcome(auto, sched)


def _bounds(core, E):
    _, sched = _sim_sched(core, workers=2)
    auto = E.ElasticAutoscaler(sched, cfg=E.AutoscalerConfig(
        min_workers=2, max_workers=2, idle_ticks=1, cooldown_ticks=0))

    def body():
        pass

    for i in range(10):
        sched.submit(core.TaskSpec(tenant="t", fn=body, name=f"b{i}"))
    assert auto.tick().action == "hold"
    assert auto.scale_ups == 0
    assert auto.force_scale_up(3) == 0
    assert auto.force_scale_down(3) == 0
    return _outcome(auto, sched)


def _force(core, E):
    sim, sched = _sim_sched(core, workers=1)
    auto = E.ElasticAutoscaler(sched, cfg=E.AutoscalerConfig(
        min_workers=1, max_workers=3))
    assert auto.force_scale_up(5, reason="chaos") == 2
    assert [d.action for d in auto.decisions] == \
        ["scale_up_worker", "scale_up_worker"]
    assert all(d.reason.startswith("chaos:") for d in auto.decisions)
    assert auto.force_scale_down(5, reason="chaos") == 2
    assert auto.elastic_stats()["workers_active"] == 1
    assert auto.elastic_stats()["pool_healthy"] == 1
    out = _outcome(auto, sched)
    sched.start()
    sim.run()
    return out


def _stats_keys(core, E):
    _, sched = _sim_sched(core, workers=2)
    auto = E.ElasticAutoscaler(sched, serving=_FakeReplicaSet(n=2))
    stats = auto.elastic_stats()
    assert set(stats) == {
        "workers_active", "replicas_alive", "scale_up_total",
        "scale_down_total", "class_scale_down_total",
        "replica_scale_up_total", "replica_scale_down_total",
        "decisions_total", "pool_healthy", "pool_in_use", "pool_spare",
    }
    assert stats["workers_active"] == 2 and stats["replicas_alive"] == 2
    return list(stats.items())


def _class_idle(core, E):
    sim, sched = _sim_sched(core, workers=3)
    auto = E.ElasticAutoscaler(sched, cfg=E.AutoscalerConfig(
        min_workers=1, idle_ticks=99, class_idle_ticks=2,
        cooldown_ticks=0, queue_high=100))
    lanes = {"serving": 3, "train": 2, "batch": 0}
    auto.bind_class_queues(lambda: dict(lanes))

    def body():
        sim.sleep(0.05)

    for i in range(4):
        sched.submit(core.TaskSpec(tenant="t", fn=body, name=f"b{i}"))
    assert auto.tick().action == "hold"
    lanes["train"] = 0
    assert auto.tick().action == "hold"
    d = auto.tick()
    assert d.action == "scale_down_worker"
    assert d.reason.startswith("class_idle:train:") and d.queue_depth > 0
    assert auto.class_scale_downs == 1
    assert auto.tick().action == "hold"
    assert auto.tick().action == "hold"
    lanes["train"] = 1
    auto.tick()
    lanes["train"] = 0
    assert auto.tick().action == "hold"
    d = auto.tick()
    assert d.action == "scale_down_worker"
    assert d.reason.startswith("class_idle:train:")
    assert auto.class_scale_downs == 2
    out = _outcome(auto, sched)
    sched.start()
    sim.run()
    return out, sched.trace_text()


def _class_idle_off(core, E):
    _, sched = _sim_sched(core, workers=2)
    auto = E.ElasticAutoscaler(sched, cfg=E.AutoscalerConfig(
        min_workers=1, idle_ticks=99, cooldown_ticks=0, queue_high=100))
    lanes = {"train": 1}
    auto.bind_class_queues(lambda: dict(lanes))
    auto.tick()
    lanes["train"] = 0
    for _ in range(5):
        assert auto.tick().action == "hold"
    assert auto.class_scale_downs == 0
    return _outcome(auto, sched)


@pytest.mark.parametrize("scenario", [
    _queue_depth, _admit_wait, _serving_depth, _idle, _retire_replica,
    _bounds, _force, _stats_keys, _class_idle, _class_idle_off,
], ids=lambda f: f.__name__.strip("_"))
def test_autoscaler_case_matches_reference(scenario):
    _both(scenario)


def _seeded(core, E, seed):
    """The reference's seeded end-to-end autoscaler run."""
    sim = core.SimExecutor(seed=seed)
    sched = core.ServerlessScheduler(workers=1, executor=sim)
    sched.start()
    auto = E.ElasticAutoscaler(sched, cfg=E.AutoscalerConfig(
        queue_high=3, max_workers=4, idle_ticks=2, cooldown_ticks=1))

    def body():
        sim.sleep(0.03)

    for i in range(7):
        sched.submit(core.TaskSpec(tenant="t", fn=body, name=f"b{i}"))
    for k in range(1, 25):
        sim.call_at(0.02 * k, auto.tick)
    sched.drain(timeout=60)
    sim.run()
    return tuple(auto.decision_log()), auto.elastic_stats(), \
        sched.trace_text()


@pytest.mark.parametrize("seed", [11, 12])
def test_autoscaler_decision_log_replays_and_matches_reference(seed):
    first = _both(_seeded, seed)
    assert _seeded(T, TE, seed) == first
    assert any(k[1] == "scale_up_worker" for k in first[0])


def test_scale_decision_and_config_match_reference():
    assert dataclasses.asdict(TE.AutoscalerConfig()) == \
        dataclasses.asdict(JE.AutoscalerConfig())
    args = (0.1234567891234, "hold", "steady", 3, 1, 0.12345678, 0.5, 2, 1)
    assert TE.ScaleDecision(*args).key() == JE.ScaleDecision(*args).key()
