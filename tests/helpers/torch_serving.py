"""Fixtures for the port's engine parity tests: the reference's
``make_engine`` (``helpers/serving.py``) mirrored for the port's engine
over the torch twin of ``ToyLM``, and the comparisons the parity tests
share.

Both engines take the same seeded workload (``helpers.serving.
make_requests``, converted with :func:`port_request`) on a ``SimExecutor``
of the same seed, so everything they report must be equal byte for byte:
token streams and errors, latencies on the virtual clock, the decision
trace, prefill counts, ``serving_stats`` (every key the reference has;
the port's own ``spans`` is checked by ``test_torch_spans.py``) and the
page and slot ledgers.
"""

import dataclasses

from helpers.torch_toy import TorchToyLM

from repro_torch.core.sim import SimExecutor
from repro_torch.core.tasks import TenantQuota
from repro_torch.launch.mesh import make_serving_mesh, simulate_host_devices
from repro_torch.runtime import Request, ServerConfig, ServingEngine

__all__ = ["assert_engines_match", "assert_stats_match", "close_port_meshes",
           "make_port_engine", "port_mesh", "port_request", "port_requests",
           "streams"]

#: open serving meshes by (size, offset): a test module's engines share
#: their workers, as the reference's engines share the simulated devices
_MESHES = {}


def port_mesh(n: int, offset: int = 0):
    """The open mesh over host slots [offset, offset + n), made at its first
    use (the reference's 4-device split: 4 slots)."""
    mesh = _MESHES.get((n, offset))
    if mesh is None or mesh.closed:
        simulate_host_devices(4)
        mesh = _MESHES[(n, offset)] = make_serving_mesh(n, offset=offset)
    return mesh


def close_port_meshes() -> None:
    """End every mesh ``port_mesh`` made (a module's teardown)."""
    for mesh in _MESHES.values():
        mesh.close()
    _MESHES.clear()


def port_request(r) -> Request:
    """The port's twin of a reference ``Request`` (before it is served)."""
    return Request(prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens,
                   request_id=r.request_id, tenant=r.tenant,
                   priority=r.priority, deadline_s=r.deadline_s,
                   temperature=r.temperature, top_k=r.top_k, top_p=r.top_p,
                   seed=r.seed)


def port_requests(reqs):
    return [port_request(r) for r in reqs]


def make_port_engine(seed=None, *, max_batch=3, max_seq=48, step_time_s=0.01,
                     quotas=None, incremental=True, executor=None,
                     kv_mode="auto", prefix_sharing=True, prefix_cache_seqs=0,
                     prefill_chunk_tokens=0, model=None, mesh_devices=0,
                     mesh_offset=0):
    """``make_engine``'s port twin: the port's ``ServingEngine`` over
    ``TorchToyLM(paged=True)`` (so ``kv_mode="auto"`` resolves as for the
    reference's ``ToyLM``), same config, on a seeded ``SimExecutor``.
    Reference ``TenantQuota`` objects are converted field by field.
    ``mesh_devices`` > 0 serves it on the mesh of that many host slots
    from ``mesh_offset`` (:func:`port_mesh`)."""
    if quotas is not None:
        quotas = {t: TenantQuota(**dataclasses.asdict(q))
                  for t, q in quotas.items()}
    cfg = ServerConfig(
        max_batch=max_batch, max_seq=max_seq, tokens_per_page=4,
        step_time_s=step_time_s, quotas=quotas, incremental=incremental,
        kv_mode=kv_mode, prefix_sharing=prefix_sharing,
        prefix_cache_seqs=prefix_cache_seqs,
        prefill_chunk_tokens=prefill_chunk_tokens,
    )
    executor = executor or SimExecutor(seed=seed or 0)
    mesh = port_mesh(mesh_devices, mesh_offset) if mesh_devices else None
    engine = ServingEngine(model or TorchToyLM(paged=True), cfg,
                           executor=executor, mesh=mesh)
    return engine, executor


def streams(reqs):
    """Per request, sorted by id: (id, tokens, error, latency)."""
    return tuple(
        (r.request_id, tuple(r.tokens), r.error, round(r.latency_s, 9))
        for r in sorted(reqs, key=lambda r: r.request_id)
    )


def assert_stats_match(port, ref, tag=""):
    """The port's ``serving_stats()`` on every key of the reference's,
    each value equal; the port's keys beyond them (``spans``) are left to
    the tests of what they report."""
    got, want = port.serving_stats(), ref.serving_stats()
    assert set(want) <= set(got), f"keys missing: {set(want) - set(got)}{tag}"
    assert {k: got[k] for k in want} == want, tag


def assert_engines_match(ref, port, ref_reqs, port_reqs, ctx=""):
    """Streams, trace, prefill counts, stats and ledgers, byte for byte."""
    tag = f" [{ctx}]" if ctx else ""
    assert streams(port_reqs) == streams(ref_reqs), f"streams differ{tag}"
    assert port.trace_text() == ref.trace_text(), f"traces differ{tag}"
    assert port.prefill_counts() == ref.prefill_counts(), tag
    assert_stats_match(port, ref, tag)
    a, b = port.kv, ref.kv
    assert (a.pages_allocated, a.pages_freed, a.shared_pages_total,
            a.cow_copies_total, a.live_pages()) == (
        b.pages_allocated, b.pages_freed, b.shared_pages_total,
        b.cow_copies_total, b.live_pages()), tag
    assert port.admission.slot_stats() == ref.admission.slot_stats(), tag
    assert port.admission.slot_balance() == ref.admission.slot_balance(), tag
