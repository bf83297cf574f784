"""Port parity: ``Server`` with ``Request.postprocess`` (``repro_torch.
runtime``) against the reference's, on the integer ``ToyLM`` twin.

Both servers take the same requests; their post-processors are twins (a
sort, a flip, a host callback the Sentry must deny — ``jax.pure_callback``
against a ``torch.library`` custom op — and one that raises).  Inline and
on the concurrent plane (``workers=2``), the post-processed streams must
be byte-identical, the errors of the same kind with the same message where
no primitive name is in it, and the admission, pool and serving counters
and every non-timing metric sample equal.  With workers, the test waits
for the plane after each step that retires a request, so each cold
admission finishes before the next request of its program retires, on
both sides (the counts are then a property of the workload, not of thread
timing).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.serving import ToyLM
from helpers.torch_serving import assert_stats_match
from helpers.torch_toy import TorchToyLM

from repro.core.sim import SimExecutor as JaxSim
from repro.runtime import Request as JaxRequest
from repro.runtime import Server as JaxServer
from repro.runtime import ServerConfig as JaxServerConfig
from repro_torch.core import (
    AdmissionController,
    ModernEmulationPolicy,
    ServerlessScheduler,
    TaskSpec,
    TenantQuota,
)
from repro_torch.core.sim import SimExecutor
from repro_torch.runtime import Request, Server, ServerConfig, ServingEngine


@torch.library.custom_op("seepp_server::leak", mutates_args=())
def _leak(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@_leak.register_fake
def _(x):
    return torch.empty_like(x)


def _raise(t):
    raise ValueError("bad post-code")


#: name -> (reference post-processor, the port's, numpy equivalent)
POSTS = {
    "sort": (lambda t: jnp.sort(t), lambda t: torch.sort(t).values, np.sort),
    "flip": (lambda t: jnp.flip(t), lambda t: torch.flip(t, (0,)),
             lambda a: a[::-1]),
    "evil": (lambda t: jax.pure_callback(
        lambda v: v, jax.ShapeDtypeStruct(t.shape, t.dtype), t),
        lambda t: _leak(t), None),
    "raise": (_raise, _raise, None),
    None: (None, None, None),
}

#: (prompt length, new tokens, post-processor): at most one request
#: retires per step at max_batch 2, and the sort runs on two shapes
WORKLOAD = [(5, 6, "sort"), (7, 4, "sort"), (4, 7, "flip"), (6, 4, "evil"),
            (9, 6, "sort"), (3, 4, "raise"), (8, 4, "sort"), (5, 7, None)]


def _requests(make, side, posts=True):
    rng = np.random.default_rng(11)
    out = []
    for i, (n, new, post) in enumerate(WORKLOAD):
        fn = POSTS[post if posts else None][side]
        out.append(make(prompt=rng.integers(0, 31, (n,)).astype(np.int32),
                        max_new_tokens=new, request_id=i, postprocess=fn,
                        seed=i, temperature=0.0 if i % 2 else 0.7))
    return out


def _drive(srv, reqs):
    for r in reqs:
        srv.submit(r)
    while srv.engine.has_work():
        retired = srv.step()
        assert retired <= 1
        if retired and srv.scheduler is not None:
            srv.scheduler.drain(timeout=60)
    srv.drain()
    return reqs


def _ref_server(workers):
    model = ToyLM()
    srv = JaxServer(model, model.init(), JaxServerConfig(
        max_batch=2, max_seq=32, tokens_per_page=4, workers=workers),
        executor=JaxSim(seed=0))
    return srv


def _port_server(workers):
    return Server(TorchToyLM(paged=True), ServerConfig(
        max_batch=2, max_seq=32, tokens_per_page=4, workers=workers),
        executor=SimExecutor(seed=0))


def _error_kind(err):
    if err is None:
        return None
    kind, _, msg = err.partition(": ")
    return (kind, msg) if "primitive" not in msg else (kind, "primitive")


def _samples(srv):
    """Every metric sample whose value is not a wall-clock time; series by
    worker are summed (which thread took a task is up to the OS)."""
    out = {}
    for name, series in srv.dump_metrics().items():
        if "seconds" in name or "busy" in name:
            continue
        if any("worker=" in labels for labels in series):
            series = {"": sum(series.values())}
        out[name] = series
    return out


@pytest.fixture(scope="module", params=[0, 2], ids=["inline", "workers2"])
def served(request):
    workers = request.param
    ref_srv, srv = _ref_server(workers), _port_server(workers)
    try:
        ref = _drive(ref_srv, _requests(JaxRequest, 0))
        got = _drive(srv, _requests(Request, 1))
        yield ref_srv, srv, ref, got
    finally:
        ref_srv.close()
        srv.close()


def test_postprocessed_streams_and_errors_match_reference(served):
    _, _, ref, got = served
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    assert [_error_kind(r.error) for r in got] == \
        [_error_kind(r.error) for r in ref]
    kinds = [_error_kind(r.error) for r in got]
    assert kinds[3] == ("postprocess denied", "primitive")
    assert kinds[5][0] == "postprocess failed"
    assert kinds[5][1].endswith("bad post-code")
    assert sum(k is None for k in kinds) == 6


def test_good_outputs_are_the_udf_applied_to_the_plain_streams(served):
    _, _, _, got = served
    plain = _drive(_port_server(0), _requests(Request, 1, posts=False))
    for r, p, (_, _, post) in zip(got, plain, WORKLOAD):
        ref_fn = POSTS[post][2]
        if ref_fn is None:
            continue
        assert r.tokens == ref_fn(np.array(p.tokens)).tolist()


def test_admission_pool_and_serving_counters_match_reference(served):
    ref_srv, srv, _, _ = served
    assert srv.admission.stats() == ref_srv.admission.stats()
    assert srv.admission.stats_by_tenant() == \
        ref_srv.admission.stats_by_tenant()
    assert srv.pool.stats.as_dict() == ref_srv.pool.stats.as_dict()
    assert_stats_match(srv.engine, ref_srv.engine)
    assert srv.engine.admit_wait_snapshot() == \
        ref_srv.engine.admit_wait_snapshot()
    # sort on lengths 4 and 6, flip, the callback and the raise: one miss
    # each, every other sort a hit; on the scheduler the raising program
    # is retried once, and fails its trace again
    st = srv.admission.stats()
    retried = 1 if srv.scheduler is not None else 0
    assert (st["misses"], st["hits"], st["denials"]) == (5 + retried, 2, 1)
    assert srv.engine.kv.pages_allocated == srv.engine.kv.pages_freed
    assert srv.admission.slot_balance() == {}


def test_metric_samples_match_reference(served):
    ref_srv, srv, _, _ = served
    got, want = _samples(srv), _samples(ref_srv)
    # the port's span counts are its own (test_torch_spans.py)
    assert set(got) - set(want) == {"seepp_serving_spans_total"}
    assert {k: got[k] for k in want} == want


def test_port_udfs_receive_the_engine_device_int32_tensor():
    seen = []

    def spy(t):
        seen.append((t.dtype, t.device.type, type(t).__name__))
        return t

    srv = _port_server(0)
    try:
        srv.run([Request(prompt=np.arange(4, dtype=np.int32),
                         max_new_tokens=3, postprocess=spy)])
    finally:
        srv.close()
    # the trace sees a fake tensor, the run the real one
    assert (torch.int32, "cpu", "Tensor") in seen
    assert all(dtype == torch.int32 and dev == "cpu"
               for dtype, dev, _ in seen)


@pytest.mark.parametrize("post", [
    lambda t: t * t.sum().item(), lambda t: torch.nonzero(t)])
def test_data_dependent_postprocessor_fails_its_request_only(post):
    srv = _port_server(0)
    try:
        reqs = [Request(prompt=np.arange(4, dtype=np.int32),
                        max_new_tokens=3, request_id=i,
                        postprocess=post if i == 1 else None)
                for i in range(3)]
        srv.run(reqs)
    finally:
        srv.close()
    assert reqs[1].error.startswith("postprocess failed")
    assert reqs[0].error is None and reqs[2].error is None
    assert len(reqs[0].tokens) == 3 and len(reqs[2].tokens) == 3


def test_concurrent_admissions_hold_only_their_own_nodes():
    """Four workers admit eight programs at once, each tracing on its own
    thread, while this thread serves requests through the port's engine:
    every graph holds exactly its own program's operations, and the
    engine's streams are those of a run alone."""
    programs = [
        lambda t: torch.sort(t).values, lambda t: torch.flip(t, (0,)),
        lambda t: torch.cumsum(t, 0), lambda t: t * 3 + 1,
        lambda t: torch.abs(t - 7), lambda t: torch.clamp(t, 2, 20),
        lambda t: torch.maximum(t, t.flip(0)), lambda t: t.sum().reshape(1),
    ]
    x = torch.arange(16, dtype=torch.int32)
    alone = {i: dict(AdmissionController().admit(
        p, (x,), policy=ModernEmulationPolicy()).histogram)
        for i, p in enumerate(programs)}

    def serve():
        engine = ServingEngine(TorchToyLM(paged=True), ServerConfig(
            max_batch=2, max_seq=32, tokens_per_page=4))
        reqs = [Request(prompt=np.arange(3 + i, dtype=np.int32) % 31,
                        max_new_tokens=6, request_id=i) for i in range(6)]
        for r in reqs:
            engine.submit(r)
        engine.drain()
        return [r.tokens for r in reqs]

    solo = serve()
    ctl = AdmissionController()
    sched = ServerlessScheduler(
        workers=4, admission=ctl,
        quotas={"t": TenantQuota(max_tasks_in_flight=4)}).start()
    start = threading.Barrier(5)
    ids = []
    try:
        def submit_all():
            start.wait()
            for p in programs:
                ids.append(sched.submit(TaskSpec("t", p, (x,))))

        feeder = threading.Thread(target=submit_all)
        feeder.start()
        for _ in range(3):
            threading.Thread(target=start.wait).start()
        start.wait()
        concurrent = serve()
        feeder.join()
        sched.drain(timeout=60)
        for i, p in enumerate(programs):
            rec = sched.record(ids[i])
            assert rec.state.value == "succeeded", rec.error
            assert torch.equal(rec.result.value, p(x))
            ticket = ctl.admit(p, (x,), policy=ModernEmulationPolicy())
            assert ticket.cache_hit
            assert dict(ticket.histogram) == alone[i], i
    finally:
        sched.shutdown()
    assert concurrent == solo
