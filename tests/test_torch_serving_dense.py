"""Port parity, bitwise: the dense ``ServingEngine`` mode against the
reference engine's.

The reference engine serves its integer ``ToyLM`` in ``kv_mode="dense"``;
the port's engine serves the torch twin (``helpers/torch_toy.py``) with
its paged interface hidden (``paged=False``), under ``kv_mode="auto"`` and
``"dense"``.  Both
take the same seeded multi-tenant workload (``helpers.serving.
make_requests``: priorities, deadlines, sampled requests) on a
``SimExecutor`` of the same seed.  Integer state and integer logits make
every comparison exact: token streams, errors, the decision trace, the
prefill counts, ``serving_stats`` and the page and slot ledgers must be
equal, byte for byte.
"""

import random

import pytest
from helpers.serving import make_engine, make_requests
from helpers.torch_serving import (assert_stats_match, make_port_engine,
                                   port_requests)
from helpers.torch_toy import TorchToyLM

from repro.core.tasks import TenantQuota as JaxQuota
from repro_torch.core.sim import SimExecutor as PortSim
from repro_torch.runtime import ServerConfig, ServingEngine

#: (seed, requests, sampled share, deadline share, alice's slot cap or
#: None); the last two queue long enough for admit deadlines to expire
WORKLOADS = [(0, 10, 0.0, 0.15, None), (1, 12, 0.4, 0.15, None),
             (2, 30, 0.3, 0.6, 1), (3, 40, 0.5, 0.5, 2)]


def _serve(seed, n, sample_prob, deadline_prob, cap, kv_mode):
    reqs = make_requests(random.Random(seed), n, sample_prob=sample_prob,
                         deadline_prob=deadline_prob)
    quotas = {"alice": JaxQuota(max_tasks_in_flight=cap)} if cap else None
    ref, _ = make_engine(seed, kv_mode="dense", quotas=quotas)
    port, _ = make_port_engine(seed, kv_mode=kv_mode, quotas=quotas,
                               model=TorchToyLM())
    port_reqs = port_requests(reqs)
    for r in reqs:
        ref.submit(r)
    for r in port_reqs:
        port.submit(r)
    ref.drain()
    port.drain()
    return (ref, reqs), (port, port_reqs)


@pytest.fixture(scope="module", params=[
    (w, mode) for w in WORKLOADS for mode in ("auto", "dense")],
    ids=lambda p: f"seed{p[0][0]}-{p[1]}")
def served(request):
    (seed, n, sample_prob, deadline_prob, cap), mode = request.param
    return _serve(seed, n, sample_prob, deadline_prob, cap, mode)


def test_dense_mode_is_resolved(served):
    (ref, _), (port, _) = served
    assert port.kv_mode == ref.kv_mode == "dense"


def test_token_streams_and_errors_match_reference(served):
    (_, ref_reqs), (_, port_reqs) = served
    assert [(r.request_id, r.tokens, r.error) for r in port_reqs] == \
        [(r.request_id, r.tokens, r.error) for r in ref_reqs]
    assert any(r.tokens for r in port_reqs)


def test_trace_and_prefill_counts_match_reference(served):
    (ref, _), (port, _) = served
    assert port.trace() == ref.trace()
    assert port.prefill_counts() == ref.prefill_counts()
    assert_stats_match(port, ref)


def test_page_and_slot_ledgers_balance_and_match_reference(served):
    (ref, _), (port, _) = served
    a, b = port.kv, ref.kv
    assert (a.pages_allocated, a.pages_freed) == \
        (b.pages_allocated, b.pages_freed)
    assert a.pages_allocated == a.pages_freed > 0
    assert a.live_pages() == 0
    assert port.admission.slot_balance() == {}
    assert port.admission.slot_stats() == ref.admission.slot_stats()


def test_slot_write_leaves_live_slots_untouched():
    """An admission rewrites its own slot of the batch state and no
    other, cast to the state's dtype."""
    port = ServingEngine(TorchToyLM(), ServerConfig(max_batch=3, max_seq=16),
                         executor=PortSim(seed=0))
    assert port._batch_axes == {"h": 0, "pos": 0}
    before = {k: v.clone() for k, v in port._state.items()}
    sub = {"h": port.model.init_decode_state(1, 16)["h"] + 7,
           "pos": port.model.init_decode_state(1, 16)["pos"].long() + 3}
    port._write_slot(sub, 1)
    assert port._state["pos"].dtype == before["pos"].dtype
    assert port._state["h"][1].tolist() == [7] * port.model.d
    assert port._state["pos"].tolist() == [0, 3, 0]
    assert port._state["h"][[0, 2]].eq(before["h"][[0, 2]]).all()
