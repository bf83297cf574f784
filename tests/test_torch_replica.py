"""Port parity: ``ReplicaSet`` (``repro_torch.runtime.replica``) against the
reference's, on the integer ``ToyLM`` and its torch twin.

The replica cases of ``tests/test_sharded_serving.py`` (sticky routing, the
set against one engine, ``kill_replica``, the silent ``kill_mesh_member``
reaped by the heartbeat, the ``/metrics`` families), ``add_replica`` and
``retire_replica``, and the replica chaos plane of
``tests/test_serving_chaos.py`` (``mesh_chaos_run``, seeds 0..19 of its
window) run on both packages with the same seeded workload and fault plan
on a ``SimExecutor`` of the same seed: every replica's trace, the token
streams, errors and latencies, and ``replica_stats()`` must be equal byte
for byte.  That includes 2-way tensor parallelism, which the reference
runs on every third chaos seed and in its DP x TP case: there each port
replica serves on its own 2-rank sub-mesh of shard workers (host slots
0-1 and 2-3, as the reference's replicas take devices 0-1 and 2-3), with
``tp_shards`` 2 on both sides, and no worker outlives the set's meshes.
The port's sets hold the reference's replica invariants
(``helpers/torch_invariants.py``) after every drain.
"""

import random
from collections import Counter

import pytest
from helpers.invariants import check_replica_invariants
from helpers.serving import make_engine, make_requests
from helpers.torch_invariants import check_port_replica_invariants
from helpers.torch_serving import (close_port_meshes, make_port_engine,
                                   port_requests, streams)
from test_serving_chaos import (MESH_CHAOS_SEED_COUNT, MESH_SEEDS, QUOTAS,
                                REPLAY_STRIDE, mesh_chaos_run)

import repro.core.metrics as JM
import repro.core.sim as JS
import repro.runtime.fault as JF
import repro.runtime.replica as JR
import repro_torch.core.metrics as TM
import repro_torch.core.sim as TS
import repro_torch.runtime.fault as TF
import repro_torch.runtime.replica as TR

#: per package: (sim, fault, replica, metrics, make engine, requests)
SIDES = {
    "ref": (JS, JF, JR, JM, make_engine, list),
    "port": (TS, TF, TR, TM, make_port_engine, port_requests),
}


@pytest.fixture(scope="module", autouse=True)
def _meshes():
    yield
    close_port_meshes()


def _make_set(side, *, dp=2, tp=0, seed=3, heartbeat_timeout_s=0.05):
    sim, _, replica, _, make, _ = SIDES[side]
    ex = sim.SimExecutor(seed=seed)
    engines = []
    for i in range(dp):
        kw = dict(executor=ex, kv_mode="paged", prefix_cache_seqs=2)
        if tp:
            kw.update(mesh_devices=tp, mesh_offset=i * tp)
        engines.append(make(**kw)[0])
    return replica.ReplicaSet(engines,
                              heartbeat_timeout_s=heartbeat_timeout_s), ex


def _set_view(rs, reqs):
    return {
        "streams": streams(reqs),
        "traces": tuple(e.trace_text() for e in rs.replicas),
        "stats": rs.replica_stats(),
    }


def _run_set(side, plan=None, *, dp=2, tp=0, n_requests=12, seed=3,
             workload_seed=11):
    _, fault, _, _, _, convert = SIDES[side]
    rs, ex = _make_set(side, dp=dp, tp=tp, seed=seed)
    reqs = convert(make_requests(random.Random(workload_seed), n_requests,
                                 sample_prob=0.5, share_prob=0.4))
    if plan:
        fault.FailureInjector(**plan).arm_replicas(ex, rs)
    for r in reqs:
        rs.submit(r)
    rs.drain(timeout=180)
    check = (check_port_replica_invariants if side == "port"
             else check_replica_invariants)
    check(rs, reqs, ctx=f"{side} plan={plan} dp={dp} tp={tp}")
    return rs, reqs


def _paired(plan=None, **kw):
    """The reference's and the port's set on the same plan: the port's
    (set, requests) after checking them equal byte for byte."""
    ref_rs, ref_reqs = _run_set("ref", plan, **kw)
    rs, reqs = _run_set("port", plan, **kw)
    ref, port = _set_view(ref_rs, ref_reqs), _set_view(rs, reqs)
    for key in ref:
        assert port[key] == ref[key], f"{key} differs [plan={plan}]"
    return rs, reqs


def _tokens(reqs):
    return {r.request_id: (list(r.tokens), r.error) for r in reqs}


def test_replica_routing_sticky_and_deterministic():
    def homes(side):
        rs, _ = _make_set(side)
        convert = SIDES[side][-1]
        for r in convert(make_requests(random.Random(11), 6)):
            rs.submit(r)
        return rs, {t: rs.route(t) for t in ("alice", "bob", "carol")}

    rs, first = homes("port")
    _, second = homes("port")
    _, ref = homes("ref")
    assert first == second == ref
    assert rs.route("alice") == first["alice"]
    assert len(set(first.values())) > 1


def test_replica_set_matches_single_engine():
    """Two replicas change where requests run, never what they decode:
    the port's set streams as one port engine and as the reference's
    set, byte for byte."""
    eng, _ = make_port_engine(seed=3, kv_mode="paged", prefix_cache_seqs=2)
    reqs = port_requests(make_requests(random.Random(11), 12,
                                       sample_prob=0.5, share_prob=0.4))
    for r in reqs:
        eng.submit(r)
    eng.drain(timeout=120)
    rs, got = _paired()
    assert _tokens(got) == _tokens(reqs)
    stats = rs.replica_stats()
    assert stats["replicas_alive"] == 2
    assert sum(p["completed"] for p in stats["per_replica"]) == 12


def test_replica_set_against_the_references_dp_times_tp():
    """2 replicas x 2-way TP on disjoint sub-meshes, on both sides: traces,
    streams and ``replica_stats()`` byte for byte, and the streams equal
    the plain DP run's."""
    base = _tokens(_run_set("port")[1])
    rs, reqs = _paired(tp=2)
    assert _tokens(reqs) == base
    assert all(p["tp_shards"] == 2 for p in rs.replica_stats()["per_replica"])
    meshes = [e.mesh for e in rs.replicas]
    assert meshes[0] is not meshes[1]
    assert not set(meshes[0].devices) & set(meshes[1].devices)


def test_no_worker_outlives_the_sets_meshes():
    """A DP x TP set under a silent mesh-member kill: closing its meshes
    ends all four workers; a kill strands a replica, it ends no process."""
    rs, _ = _run_set("port", {"kill_mesh_member_at_t": {0.03: [0]}}, tp=2)
    assert rs.replicas[0].dead and rs.heartbeat_reaps == 1
    procs = [p for e in rs.replicas for p in e.mesh.processes]
    assert len(procs) == 4 and all(p.is_alive() for p in procs)
    for e in rs.replicas:
        e.mesh.close()
    assert all(not p.is_alive() and p.exitcode is not None for p in procs)


def test_kill_replica_rehomes_and_completes():
    base = _tokens(_run_set("port")[1])
    rs, reqs = _paired(plan={"kill_replica_at_t": {0.07: [0]}})
    assert rs.replica_kills == 1 and rs.rehomed_total > 0
    assert rs.replicas[0].dead and rs.replicas[0].kv.live_pages() == 0
    for rid, (toks, err) in _tokens(reqs).items():
        if err is None and base[rid][1] is None:
            assert toks == base[rid][0], rid


def test_mesh_member_kill_heartbeat_reap():
    """A silent death strands replica 0 until the heartbeat (virtual
    clock) reaps it; survivors absorb the work, the streams equal the
    undisturbed run's, and a replay is byte-identical."""
    base = _tokens(_run_set("port")[1])
    plan = {"kill_mesh_member_at_t": {0.03: [0]}}
    rs, reqs = _paired(plan=plan)
    assert rs.mesh_member_kills == 1 and rs.heartbeat_reaps == 1
    assert rs.rehomed_total > 0 and rs.replicas[0].dead
    rs2, reqs2 = _run_set("port", plan)
    assert _set_view(rs2, reqs2) == _set_view(rs, reqs)
    for rid, (toks, err) in _tokens(reqs).items():
        if err is None and base[rid][1] is None:
            assert toks == base[rid][0], rid


def test_replica_metrics_families():
    texts = {}
    for side in SIDES:
        rs, _ = _run_set(side, plan={"kill_mesh_member_at_t": {0.03: [0]}})
        reg = SIDES[side][3].MetricsRegistry().register_replicas(rs)
        texts[side] = (reg.render(), reg.dump())
    text, dump = texts["port"]
    assert texts["port"] == texts["ref"]
    for name in ("seepp_serving_replica_alive",
                 "seepp_serving_replica_tp_shards",
                 "seepp_serving_replica_rehomed_total",
                 "seepp_serving_mesh_members_dead",
                 "seepp_serving_mesh_heartbeat_reaps_total"):
        assert name in text, name
    assert dump["seepp_serving_mesh_heartbeat_reaps_total"][""] == 1
    alive = dump["seepp_serving_replica_alive"]
    assert alive['{replica="0"}'] == 0 and alive['{replica="1"}'] == 1


def _grow_and_shrink(side):
    """Two replicas take half a workload; a third joins (autoscaler
    scale-up) and takes new tenants; then replica 0 is retired mid-decode
    (its requests re-home), the least-loaded one after it, and a third
    retirement is refused: one replica is left."""
    _, _, _, _, make, convert = SIDES[side]
    rs, ex = _make_set(side, seed=5)
    reqs = convert(make_requests(random.Random(21), 12, sample_prob=0.5,
                                 share_prob=0.4))
    for r in reqs[:6]:
        rs.submit(r)
    for _ in range(3):
        rs.step()
        ex.sleep(0.01)
    engine, _ = make(executor=ex, kv_mode="paged", prefix_cache_seqs=2)
    idx = rs.add_replica(engine)
    for i, r in enumerate(reqs[6:]):
        r.tenant = f"late{i % 2}"
        rs.submit(r)
    for _ in range(2):
        rs.step()
        ex.sleep(0.01)
    assert rs.retire_replica(0) == 0           # live work: it re-homes
    retired = rs.retire_replica()              # the least loaded
    refused = rs.retire_replica(0)             # already gone
    rs.drain(timeout=120)
    check = (check_port_replica_invariants if side == "port"
             else check_replica_invariants)
    check(rs, reqs, ctx=f"{side} grow and shrink")
    return rs, reqs, (idx, retired, refused)


def test_add_and_retire_replica_match_reference():
    ref_rs, ref_reqs, ref_moves = _grow_and_shrink("ref")
    rs, reqs, moves = _grow_and_shrink("port")
    assert moves == ref_moves and moves[0] == 2 and moves[2] is None
    assert _set_view(rs, reqs) == _set_view(ref_rs, ref_reqs)
    stats = rs.replica_stats()
    assert stats["replicas_added"] == 1 and stats["replicas_retired"] == 2
    assert stats["replicas_alive"] == 1 and rs.retire_replica() is None
    assert rs.rehomed_total > 0


def test_replica_set_refusals_match_reference():
    for side in SIDES:
        sim, _, replica, _, make, _ = SIDES[side]
        with pytest.raises(ValueError, match="at least one replica"):
            replica.ReplicaSet([])
        a, _ = make(executor=sim.SimExecutor(seed=0))
        b, _ = make(executor=sim.SimExecutor(seed=0))
        with pytest.raises(ValueError, match="share one executor"):
            replica.ReplicaSet([a, b])
        rs = replica.ReplicaSet([a])
        with pytest.raises(ValueError, match="share the set's executor"):
            rs.add_replica(b)
        assert rs.retire_replica() is None


# ------------------------------------------------- the replica chaos plane


def port_mesh_chaos_run(seed):
    """``mesh_chaos_run`` of ``tests/test_serving_chaos.py`` on the port:
    the same draws in the same order, each replica on its own 2-rank
    sub-mesh on the seeds where the reference runs 2-way TP."""
    rng = random.Random(seed * 7451 + 13)
    sim = TS.SimExecutor(seed=seed)
    tp = 2 if seed % 3 == 0 else 0
    engines = []
    for i in range(2):
        engine, _ = make_port_engine(
            executor=sim, max_batch=3, max_seq=48, step_time_s=0.01,
            quotas=QUOTAS, kv_mode="paged", prefix_cache_seqs=2,
            mesh_devices=tp, mesh_offset=i * tp)
        engines.append(engine)
    rs = TR.ReplicaSet(engines, heartbeat_timeout_s=0.05)
    reqs = port_requests(make_requests(
        rng, 10, deadline_prob=0.1, sample_prob=0.5, share_prob=0.4))

    injector = TF.FailureInjector()
    kind = rng.randrange(4)
    when = round(rng.uniform(0.02, 0.3), 3)
    if kind == 0:
        injector.kill_replica_at_t[when] = [rng.randrange(2)]
    elif kind == 1:
        injector.kill_mesh_member_at_t[when] = [rng.randrange(2)]
    elif kind == 2:
        victim = rng.randrange(2)
        injector.kill_mesh_member_at_t[when] = [victim]
        injector.kill_replica_at_t[round(rng.uniform(0.02, 0.3), 3)] = (
            [victim])
    if rng.random() < 0.3:
        victim = rng.randrange(2)
        sim.call_at(round(rng.uniform(0.02, 0.3), 3),
                    engines[victim].kill_batch)
    injector.arm_replicas(sim, rs)

    for r in reqs:
        rs.submit(r)
    rs.drain(timeout=60)
    check_port_replica_invariants(rs, reqs, ctx=f"port mesh seed={seed}")

    trace = "\n===\n".join(e.trace_text() for e in rs.replicas)
    results = tuple(
        (r.request_id, tuple(r.tokens), r.error, round(r.latency_s, 9))
        for r in sorted(reqs, key=lambda r: r.request_id)
    )
    st = rs.replica_stats()
    counters = Counter({
        "replica_kills": st["replica_kills"],
        "mesh_kills": st["mesh_member_kills"],
        "reaps": st["heartbeat_reaps"],
        "rehomed": st["rehomed_total"],
        "orphaned": st["orphaned"],
        "tp_runs": int(tp > 0),
        "clean": sum(1 for r in reqs if r.error is None),
        "completed": sum(p["completed"] for p in st["per_replica"]),
    })
    return trace, results, counters


@pytest.mark.parametrize("seed", list(MESH_SEEDS))
def test_mesh_chaos_seed_matches_reference(seed):
    ref = mesh_chaos_run(seed)
    port = port_mesh_chaos_run(seed)
    ctx = f"seed={seed}"
    assert port[0] == ref[0], f"traces differ [{ctx}]"
    assert port[1] == ref[1], f"results differ [{ctx}]"
    assert port[2] == ref[2], f"counters differ [{ctx}]"
    assert port[2]["tp_runs"] == int(seed % 3 == 0), ctx


def test_mesh_chaos_window_exercised_both_fault_planes_and_replays():
    totals = Counter()
    replayed = 0
    for seed in MESH_SEEDS:
        first = port_mesh_chaos_run(seed)
        totals.update(first[2])
        if seed % REPLAY_STRIDE == 0:
            assert port_mesh_chaos_run(seed)[:2] == first[:2], seed
            replayed += 1
    if MESH_CHAOS_SEED_COUNT >= 15:
        for key in ("replica_kills", "mesh_kills", "reaps", "rehomed",
                    "clean"):
            assert totals[key] > 0, (key, totals)
        assert totals["orphaned"] == 0, totals
    assert replayed >= 1 or MESH_CHAOS_SEED_COUNT < REPLAY_STRIDE
