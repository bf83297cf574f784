"""The serving engine's spans: counted on every path of ``step()``, with
leaves that never nest, on the profiler's timeline only while one runs,
and exported by ``/metrics``.

Tiny CPU engines over the torch twin of ``ToyLM`` in paged mode (prefix
sharing on, so suffix prefills and copy-on-write run), dense mode,
chunked prefill (paged and dense) and the rebatching baseline.
"""

import numpy as np
import pytest
import torch
from helpers.torch_serving import make_port_engine
from helpers.torch_toy import TorchToyLM
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.sim import SimExecutor
from repro_torch.runtime import Request, ServingEngine

PARENTS = {"engine.step", "engine.admit", "engine.prefill"}
LEAVES = {"arena.admit", "arena.write_plan", "arena.vma_sample",
          "arena.reserve", "arena.release", "model.decode", "model.prefill",
          "model.prefill_at", "model.prefill_chunk", "model.write_prefill",
          "model.write_slot", "engine.logits", "sampler"}
#: spans opened once for one request, whose args name it
PER_REQUEST = {"engine.prefill", "arena.admit", "arena.write_plan",
               "arena.release", "model.prefill", "model.prefill_at",
               "model.write_prefill", "model.prefill_chunk",
               "model.write_slot"}

MODES = {
    "paged": dict(kv_mode="paged"),
    "dense": dict(kv_mode="dense", model=TorchToyLM()),
    "chunked-paged": dict(kv_mode="paged", prefill_chunk_tokens=5),
    "chunked-dense": dict(kv_mode="dense", prefill_chunk_tokens=5,
                          model=TorchToyLM()),
    "rebatch": dict(kv_mode="dense", incremental=False, model=TorchToyLM()),
}


def _requests(n=7):
    """A shared 8-token head on every other prompt, so the paged engine
    shares pages and prefills suffixes."""
    rng = np.random.default_rng(5)
    head = rng.integers(0, 31, 8)
    out = []
    for i in range(n):
        tail = rng.integers(0, 31, 2 + i % 4)
        prompt = np.concatenate([head, tail]) if i % 2 else tail
        out.append(Request(prompt=prompt.astype(np.int32),
                           max_new_tokens=3 + i % 3, request_id=i))
    return out


def _serve(mode):
    engine, _ = make_port_engine(0, step_time_s=0.0, max_batch=3,
                                 **MODES[mode])
    for r in _requests():
        engine.submit(r)
    steps = 0
    while engine.has_work():
        engine.step()
        steps += 1
    return engine, steps


@pytest.fixture(scope="module", params=sorted(MODES))
def served(request):
    return request.param, *_serve(request.param)


def test_engine_step_counts_step_calls(served):
    _, engine, steps = served
    assert engine.serving_stats()["spans"]["engine.step"][0] == steps


def test_model_decode_counts_decode_steps(served):
    _, engine, _ = served
    stats = engine.serving_stats()
    assert stats["decode_steps_total"] > 0
    assert stats["spans"]["model.decode"][0] == stats["decode_steps_total"]
    assert stats["spans"]["engine.logits"][0] == stats["decode_steps_total"]
    assert stats["spans"]["sampler"][0] == stats["decode_steps_total"]


def test_engine_prefill_counts_every_prefill(served):
    mode, engine, _ = served
    stats = engine.serving_stats()
    prefills = sum(stats["prefill_sequences_total"].values())
    assert prefills > 0
    assert stats["spans"]["engine.prefill"][0] == prefills
    if mode.startswith("chunked"):
        assert stats["prefill_chunks_total"] == prefills
    if mode == "paged":
        assert stats["prefix_hits_total"] > 0
        assert stats["spans"]["model.prefill_at"][0] == \
            stats["prefix_hits_total"]


def test_leaves_sum_to_at_most_engine_step(served):
    _, engine, _ = served
    spans = engine.serving_stats()["spans"]
    assert set(spans) <= PARENTS | LEAVES
    leaves = sum(sec for name, (_, sec) in spans.items() if name in LEAVES)
    assert 0 < leaves <= spans["engine.step"][1]


def test_spans_are_monotonic_totals(served):
    mode, engine, _ = served
    before = engine.serving_stats()["spans"]
    engine.submit(Request(prompt=np.arange(4, dtype=np.int32),
                          max_new_tokens=2, request_id=99))
    engine.step()
    after = engine.serving_stats()["spans"]
    assert after["engine.step"][0] == before["engine.step"][0] + 1
    for name, (n, sec) in before.items():
        assert after[name][0] >= n and after[name][1] >= sec, name


@pytest.mark.parametrize("mode", sorted(MODES))
def test_profiler_sees_leaves_inside_step_and_never_nested(mode,
                                                           monkeypatch):
    real = torch.autograd.profiler.record_function
    opened = []

    def spy(name, args=None):
        opened.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine, _ = _serve(mode)
    ours = PARENTS | LEAVES
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name in ours]
    steps = [(a, b) for name, a, b in events if name == "engine.step"]
    leaves = [(name, a, b) for name, a, b in events if name in LEAVES]
    assert len(steps) == engine.serving_stats()["spans"]["engine.step"][0]
    assert leaves
    for name, a, b in leaves:
        assert any(s0 <= a and b <= s1 for s0, s1 in steps), name
    leaves.sort(key=lambda x: x[1])
    for (n0, a0, b0), (n1, a1, _) in zip(leaves, leaves[1:]):
        assert b0 <= a1, f"{n1} opened inside {n0}"
    # the same spans the totals counted, with their identifiers; each
    # row's reservation after its draw is added to ``arena.reserve``
    # without a range of its own
    counted = engine.serving_stats()["spans"]
    for name, (n, _) in counted.items():
        ranges = sum(1 for o, _ in opened if o == name)
        assert ranges == n or name == "arena.reserve" and ranges < n, name
    # a rebatch prefills every live slot at once: it is keyed by step
    per_request = PER_REQUEST - ({"engine.prefill", "model.prefill"}
                                 if mode == "rebatch" else set())
    for name, args in opened:
        key = "req=" if name in per_request else "step="
        assert args.startswith(key), (name, args)


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, *args):
            entered.append(args)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    engine, _ = _serve("paged")
    assert engine.serving_stats()["spans"]["engine.step"][0] > 0
    assert entered == []


def test_metrics_render_both_span_families():
    engine, _ = _serve("paged")
    reg = MetricsRegistry().register_serving(engine)
    text = reg.render()
    dump = reg.dump()
    spans = engine.serving_stats()["spans"]
    assert "# TYPE seepp_serving_span_seconds_total counter" in text
    assert "# TYPE seepp_serving_spans_total counter" in text
    counts = dump["seepp_serving_spans_total"]
    secs = dump["seepp_serving_span_seconds_total"]
    assert set(counts) == {f'{{span="{n}"}}' for n in spans}
    assert counts['{span="engine.step"}'] == spans["engine.step"][0]
    assert secs['{span="model.decode"}'] > 0


def test_engines_sharing_a_sink_are_exported_once():
    a, _ = _serve("paged")
    reg = MetricsRegistry().register_serving(a)
    once = reg.dump()["seepp_serving_spans_total"]
    twin = ServingEngine(TorchToyLM(paged=True), a.cfg,
                         executor=SimExecutor(seed=0), telemetry=a.telemetry)
    reg.register_serving(twin)
    assert reg.dump()["seepp_serving_spans_total"] == once
