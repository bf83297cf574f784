"""Port parity: the paged ``ServingEngine`` against the reference engine.

Both engines serve the same four requests on the qwen2.5-32b smoke config
at fp32, with the same converted weights, a ``SimExecutor`` of the same
seed and ``max_batch=2``: one greedy request, one sampled with temperature
and top-k, and two that share a prompt prefix longer than one page.  The
token streams, the decision traces, the prefill counts, the prefix hits and
the page ledgers must be equal.

Tokens are compared exactly.  A greedy token may only differ where the
reference's top-2 logit margin at that step is below ``MARGIN_TOL`` (a
near-tie that fp32 sums in another order can flip); the seeds are fixed so
that no such tie occurs, and any other difference fails.
"""

import numpy as np
import pytest
import torch
from helpers.torch_port import fp32_config, model_pair
from helpers.torch_serving import assert_stats_match

import repro.runtime.serve_loop as jax_loop
import repro_torch.runtime.serve_loop as port_loop
from repro.core.sim import SimExecutor as JaxSim
from repro.runtime import ServerConfig as JaxServerConfig
from repro_torch.core.sim import SimExecutor as PortSim
from repro_torch.models import TransformerLM
from repro_torch.models.common import ArchConfig
from repro_torch.runtime import Request, ServerConfig, ServingEngine

MARGIN_TOL = 1e-4


def _requests(module, vocab):
    rng = np.random.default_rng(21)
    shared = rng.integers(0, vocab, 20).astype(np.int32)   # > 1 page of 16
    specs = [  # prompt, new tokens, temperature, top-k
        (shared.copy(), 10, 0.0, 0),
        (rng.integers(0, vocab, 12).astype(np.int32), 4, 0.8, 5),
        (np.concatenate([shared, rng.integers(0, vocab, 6)]).astype(
            np.int32), 6, 0.0, 0),
        (rng.integers(0, vocab, 9).astype(np.int32), 5, 0.0, 0),
    ]
    return [
        module.Request(prompt=p, max_new_tokens=n, request_id=i,
                       temperature=t, top_k=k, seed=100 + i,
                       tenant="alice" if i % 2 else "bob")
        for i, (p, n, t, k) in enumerate(specs)
    ]


def _run(module, engine, vocab, monkeypatch):
    """Drain the requests; record each sampled step's logits by
    (request seed, token index)."""
    seen = {}
    real = module.sample_token

    def spy(logits, **kw):
        seen[(kw["seed"], kw["index"])] = np.array(logits, np.float64)
        return real(logits, **kw)

    monkeypatch.setattr(module, "sample_token", spy)
    reqs = _requests(module, vocab)
    for r in reqs:
        engine.submit(r)
    engine.drain()
    monkeypatch.setattr(module, "sample_token", real)
    return reqs, seen


@pytest.fixture(scope="module")
def served():
    cfg = fp32_config("qwen2.5-32b")
    jax_model, params, port_model = model_pair(cfg)
    scfg = dict(max_batch=2, max_seq=64, step_time_s=0.01)
    mp = pytest.MonkeyPatch()
    try:
        ref_engine = jax_loop.ServingEngine(
            jax_model, params, jax_loop.ServerConfig(**scfg),
            executor=JaxSim(seed=3))
        ref = _run(jax_loop, ref_engine, cfg.vocab_size, mp)
        port_engine = ServingEngine(port_model, ServerConfig(**scfg),
                                    executor=PortSim(seed=3))
        port = _run(port_loop, port_engine, cfg.vocab_size, mp)
    finally:
        mp.undo()
    return (ref_engine, ref), (port_engine, port)


def test_token_streams_match_reference(served):
    (_, (ref_reqs, ref_logits)), (_, (port_reqs, _)) = served
    assert [a.request_id for a in port_reqs] == [0, 1, 2, 3]
    for a, b in zip(port_reqs, ref_reqs):
        assert a.error is None and b.error is None
        assert len(a.tokens) == len(b.tokens) == a.max_new_tokens
        fork = next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                     if x != y), None)
        if fork is None:
            continue
        # past a fork the streams condition on different tokens: only the
        # fork itself is judged
        top2 = np.sort(ref_logits[(b.seed, fork)])[-2:]
        assert b.temperature <= 0 and top2[1] - top2[0] < MARGIN_TOL, (
            f"request {b.request_id} token {fork}: port {a.tokens[fork]} != "
            f"reference {b.tokens[fork]}, top-2 margin "
            f"{top2[1] - top2[0]:.3g} (tolerance {MARGIN_TOL})")


def test_trace_matches_reference(served):
    (ref_engine, _), (port_engine, _) = served
    assert port_engine.trace() == ref_engine.trace()
    assert any(" prefix_share " in line for line in port_engine.trace())


def test_prefill_counts_and_prefix_hits_match_reference(served):
    (ref_engine, _), (port_engine, _) = served
    assert port_engine.prefill_counts() == ref_engine.prefill_counts()
    a, b = port_engine.serving_stats(), ref_engine.serving_stats()
    assert a["prefix_hits_total"] == b["prefix_hits_total"] == 1
    assert_stats_match(port_engine, ref_engine)


def test_page_ledgers_balance_and_match_reference(served):
    (ref_engine, _), (port_engine, _) = served
    a, b = port_engine.kv, ref_engine.kv
    assert (a.pages_allocated, a.pages_freed, a.shared_pages_total,
            a.cow_copies_total) == (b.pages_allocated, b.pages_freed,
                                    b.shared_pages_total, b.cow_copies_total)
    assert a.pages_allocated == a.pages_freed
    assert a.live_pages() == 0
    assert port_engine.admission.slot_balance() == {}
    assert port_engine.admission.slot_stats() == \
        ref_engine.admission.slot_stats()


# ----------------------------------------------------------- unported


@pytest.fixture(scope="module")
def tiny_model():
    cfg = fp32_config("qwen2.5-32b", num_layers=1)
    return TransformerLM(ArchConfig(**cfg.__dict__), device="cpu")


@pytest.mark.parametrize("option", [
    dict(pool_watermark=1), dict(workers=2), dict(heartbeat_timeout_s=1.0),
])
def test_unported_server_options_raise(option):
    # the Server options are ServerConfig fields since Server is ported,
    # with the reference's defaults
    (name, value), = option.items()
    assert getattr(ServerConfig(**option), name) == value
    assert getattr(ServerConfig(), name) == getattr(JaxServerConfig(), name)


@pytest.mark.parametrize("option,kv_mode", [
    (dict(kv_mode="dense"), "dense"), (dict(incremental=False), "dense"),
    (dict(prefill_chunk_tokens=8), "paged"),
])
def test_engine_options_are_accepted(tiny_model, option, kv_mode):
    """Dense mode, the rebatching baseline and chunked prefill, which the
    first slice refused, build the engine in the reference's mode."""
    assert ServingEngine(tiny_model, ServerConfig(**option)).kv_mode == kv_mode


@pytest.mark.parametrize("hook,idle", [
    ("kill_batch", 0), ("evacuate", []), ("poison_live", None),
    ("poison_shared", None), ("poison_prefilling", None)])
def test_chaos_hooks_on_an_idle_engine(tiny_model, hook, idle):
    """With nothing live each hook changes nothing and answers as the
    reference's does (its effects are pinned against the reference in
    ``test_torch_serving_chaos.py``)."""
    engine = ServingEngine(tiny_model, ServerConfig(max_seq=32))
    assert getattr(engine, hook)() == idle
    assert engine.kv.pages_allocated == 0


def test_unported_mesh_and_postprocess_raise(tiny_model):
    """Both are ported.  ``mesh=`` is accepted and resolves as the
    reference's: this model's one kv head does not divide 2 ranks, so
    ``auto`` serves it dense, traces ``tp_fallback`` and never starts the
    mesh's workers.  ``Request.postprocess``: the retired stream goes
    through it, here reversed."""
    from repro.launch.mesh import make_serving_mesh as jax_mesh
    from repro_torch.launch.mesh import make_serving_mesh

    jax_model, params, _ = model_pair(fp32_config("qwen2.5-32b",
                                                  num_layers=1))
    mesh = make_serving_mesh(["cpu", "cpu"])
    engine = ServingEngine(tiny_model, ServerConfig(), mesh=mesh)
    ref = jax_loop.ServingEngine(jax_model, params, JaxServerConfig(),
                                 mesh=jax_mesh(2))
    assert (engine.kv_mode, engine.mesh, engine.tp_shards) == (
        ref.kv_mode, ref.mesh, ref.tp_shards) == ("dense", None, 1)
    assert [x.split(" ", 1)[1] for x in engine.trace()] == \
        [x.split(" ", 1)[1] for x in ref.trace()] == ["tp_fallback kv_mode=dense"]
    assert not mesh.processes
    streams = []
    for post in (None, lambda t: torch.flip(t, (0,))):
        engine = ServingEngine(tiny_model, ServerConfig(max_seq=32))
        r = Request(prompt=np.ones(3, np.int32), max_new_tokens=4,
                    postprocess=post)
        engine.submit(r)
        engine.drain()
        assert r.error is None
        streams.append(r.tokens)
    assert streams[1] == streams[0][::-1]


def test_unpaged_model_is_refused():
    """gemma2 (softcap, windows) cannot decode from pages: ``paged`` is
    refused with the reference's ValueError, and ``auto`` serves it dense."""
    cfg = fp32_config("gemma2-9b", num_layers=2)
    model = TransformerLM(ArchConfig(**cfg.__dict__), device="cpu")
    assert ServingEngine(model, ServerConfig()).kv_mode == "dense"
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, ServerConfig(kv_mode="paged"))
