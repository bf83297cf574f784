"""Port parity: ``repro_torch.models.RwkvLM`` against the reference RWKV6.

Weights are the reference's ``init(PRNGKey(0))`` on the reduced rwkv6-3b
config at fp32 (3 layers, width 64, 4 heads of size 16), carried over with
``params_from_numpy``.  The reference runs with ``impl="xla"`` (its
chunked scan) and ``impl="pallas"`` (its WKV6 kernel in interpret mode);
the port runs its kernels' plain versions.  Prompt lengths are ones the
reference accepts (at most 64, or a multiple of 64).

Tolerance: ``rtol = atol = 2e-3`` on logits and decode states, the
reference's own for its two RWKV implementations
(``test_kernel_model_integration.py::test_wkv6_kernel_in_model``).  Every
side computes in fp32 and only the order of the sums differs, but this
small random-weight model amplifies rounding: scaling the embedding table
by one ulp (1 + 2**-23) moves its logits by ~4e-5.  The port's logits
differ from the reference's by 4.0e-5 and 7.4e-5 on the two forward
shapes, and are bitwise the same at any intra-op thread count, in a fresh
process and in a pytest-xdist worker after other test files (the last
test pins the thread count's part).  Served token streams are compared exactly; a
greedy token may only differ where the reference's top-2 logit margin is
below ``MARGIN_TOL`` (two logits each within the tolerance, |logit| < 3),
and the seeds are fixed so that none does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_port import fp32_config, to_numpy, to_torch
from helpers.torch_serving import assert_stats_match

import repro.runtime.serve_loop as jax_loop
import repro_torch.runtime.serve_loop as port_loop
from repro.core.sim import SimExecutor as JaxSim
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core.sim import SimExecutor as PortSim
from repro_torch.models import RwkvLM, build_model, params_from_numpy
from repro_torch.models.common import ArchConfig
from repro_torch.runtime import ServerConfig, ServingEngine

TOL = dict(rtol=2e-3, atol=2e-3)
MARGIN_TOL = 2 * (2e-3 + 2e-3 * 3)


def _port_cfg(cfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def pair():
    """(reference xla model, reference pallas model, params, port model)."""
    cfg = fp32_config("rwkv6-3b")
    xla = jax_build_model(cfg, impl="xla")
    pallas = jax_build_model(cfg, impl="pallas")
    params = xla.init(jax.random.PRNGKey(0))
    tcfg = _port_cfg(cfg)
    model = RwkvLM(tcfg, device="cpu")
    model.load_state_dict(params_from_numpy(tcfg, to_numpy(params)))
    return xla, pallas, params, model


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _assert_state_close(port, ref):
    assert set(port) == set(ref)
    for name in ref:
        np.testing.assert_allclose(port[name].numpy(), np.asarray(ref[name]),
                                   err_msg=name, **TOL)
        assert port[name].dtype == torch.from_numpy(
            np.zeros(0, np.asarray(ref[name]).dtype)).dtype, name


# ------------------------------------------------------------- forward


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("shape", [(2, 32), (1, 64)])
def test_forward_logits_match_reference(pair, impl, shape):
    xla, pallas, params, model = pair
    ref_model = xla if impl == "xla" else pallas
    toks = _tokens(model.cfg, shape, seed=shape[1])
    ref, _ = ref_model.forward(params, jnp.asarray(toks))
    out, aux = model.forward(to_torch(toks))
    assert out.shape == (*shape, model.cfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert float(aux) == 0.0


# ------------------------------------------------------------- serving


def test_prefill_and_decode_steps_match_reference(pair):
    """prefill's state and logits, then three decode steps'."""
    xla, _, params, model = pair
    toks = _tokens(model.cfg, (2, 48), seed=1)
    ref_state, ref_logits = xla.prefill(params, jnp.asarray(toks))
    state, logits = model.prefill(to_torch(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    _assert_state_close(state, ref_state)
    for i in range(3):
        nxt = _tokens(model.cfg, (2,), seed=10 + i)
        ref_state, ref_logits = xla.decode_step(params, ref_state,
                                                jnp.asarray(nxt))
        state, logits = model.decode_step(state, to_torch(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   err_msg=f"step {i}", **TOL)
        _assert_state_close(state, ref_state)


@pytest.mark.parametrize("T", [1, 37])
def test_prefill_then_decode_equals_forward_at_any_length(pair, T):
    """Lengths the reference's prefill refuses (its chunk must divide T):
    the port's prefill + decode steps reproduce its own forward."""
    _, _, _, model = pair
    toks = to_torch(_tokens(model.cfg, (2, T + 3), seed=T))
    full, _ = model.forward(toks)
    state, logits = model.prefill(toks[:, :T])
    np.testing.assert_allclose(logits.numpy(), full[:, T - 1].numpy(), **TOL)
    for i in range(3):
        state, logits = model.decode_step(state, toks[:, T + i])
        np.testing.assert_allclose(logits.numpy(), full[:, T + i].numpy(),
                                   **TOL)
    assert state["pos"].tolist() == [T + 3, T + 3]


def _requests(module, vocab):
    rng = np.random.default_rng(12)
    specs = [(9, 6, 0.0, 0), (20, 4, 0.8, 5), (33, 5, 0.0, 0),
             (64, 3, 0.0, 0)]                # prompt, new, temperature, top-k
    return [
        module.Request(prompt=rng.integers(0, vocab, n).astype(np.int32),
                       max_new_tokens=new, request_id=i, temperature=t,
                       top_k=k, seed=200 + i,
                       tenant="alice" if i % 2 else "bob")
        for i, (n, new, t, k) in enumerate(specs)
    ]


def _serve(module, engine, vocab, mp):
    seen = {}
    real = module.sample_token

    def spy(logits, **kw):
        seen[(kw["seed"], kw["index"])] = np.array(logits, np.float64)
        return real(logits, **kw)

    mp.setattr(module, "sample_token", spy)
    reqs = _requests(module, vocab)
    for r in reqs:
        engine.submit(r)
    engine.drain()
    mp.setattr(module, "sample_token", real)
    return reqs, seen


@pytest.fixture(scope="module")
def served(pair):
    xla, _, params, model = pair
    vocab = model.cfg.vocab_size
    scfg = dict(max_batch=2, max_seq=96, step_time_s=0.01)
    mp = pytest.MonkeyPatch()
    try:
        ref_engine = jax_loop.ServingEngine(
            xla, params, jax_loop.ServerConfig(**scfg),
            executor=JaxSim(seed=4))
        ref = _serve(jax_loop, ref_engine, vocab, mp)
        port_engine = ServingEngine(model, ServerConfig(**scfg),
                                    executor=PortSim(seed=4))
        port = _serve(port_loop, port_engine, vocab, mp)
    finally:
        mp.undo()
    return (ref_engine, ref), (port_engine, port)


def test_served_streams_match_reference(served):
    (ref_engine, (ref_reqs, ref_logits)), (port_engine, (port_reqs, _)) = \
        served
    assert port_engine.kv_mode == ref_engine.kv_mode == "dense"
    for a, b in zip(port_reqs, ref_reqs):
        assert a.error is None and b.error is None
        assert len(a.tokens) == len(b.tokens) == a.max_new_tokens
        fork = next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                     if x != y), None)
        if fork is None:
            continue
        top2 = np.sort(ref_logits[(b.seed, fork)])[-2:]
        assert b.temperature <= 0 and top2[1] - top2[0] < MARGIN_TOL, (
            f"request {b.request_id} token {fork}: port {a.tokens[fork]} != "
            f"reference {b.tokens[fork]}, top-2 margin "
            f"{top2[1] - top2[0]:.3g} (tolerance {MARGIN_TOL})")


def test_served_trace_and_ledgers_match_reference(served):
    (ref_engine, _), (port_engine, _) = served
    assert port_engine.trace() == ref_engine.trace()
    assert port_engine.prefill_counts() == ref_engine.prefill_counts()
    assert_stats_match(port_engine, ref_engine)
    a = port_engine.kv
    assert a.pages_allocated == a.pages_freed == ref_engine.kv.pages_freed
    assert port_engine.admission.slot_balance() == {}


def test_engine_resolves_dense_and_refuses_paged(pair):
    model = pair[3]
    assert ServingEngine(model, ServerConfig()).kv_mode == "dense"
    assert ServingEngine(model, ServerConfig(kv_mode="dense")).kv_mode == \
        "dense"
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, ServerConfig(kv_mode="paged"))


# ------------------------------------------------------- construction


def test_params_from_numpy_keeps_the_fp32_leaves():
    """In a bf16 model, ``w0`` and ``u`` stay float32, as the reference
    initialises them; every other leaf is bf16."""
    cfg = dataclasses.replace(fp32_config("rwkv6-3b"), dtype="bfloat16")
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    tcfg = _port_cfg(cfg)
    sd = params_from_numpy(tcfg, to_numpy(params))
    fp32 = {n for n, t in sd.items() if t.dtype == torch.float32}
    assert fp32 == {"layers.w0", "layers.u"}
    assert all(t.dtype == torch.bfloat16 for n, t in sd.items()
               if n not in fp32)
    np.testing.assert_array_equal(
        sd["layers.u"].numpy(), np.asarray(params["layers"]["u"]))
    model = RwkvLM(tcfg, device="cpu")
    model.load_state_dict(sd)
    assert model.layers.u.dtype == torch.float32
    assert torch.equal(model.layers.u, sd["layers.u"])


def test_init_uses_the_reference_distributions():
    cfg = dataclasses.replace(fp32_config("rwkv6-3b"), d_model=128,
                              d_ff=448, vocab_size=512, dtype="bfloat16")
    model = RwkvLM(_port_cfg(cfg), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    D, F = cfg.d_model, cfg.d_ff
    L = model.layers
    for t, std in ((model.embed, D ** -0.5), (L.wr, D ** -0.5),
                   (L.wcv, F ** -0.5), (L.tm_w2, 0.1), (L.u, 0.1)):
        assert abs(float(t.float().std()) - std) < 0.1 * std
    assert L.u.dtype == L.w0.dtype == torch.float32
    assert L.wr.dtype == torch.bfloat16
    assert torch.equal(L.w0, torch.full_like(L.w0, -2.0))
    assert torch.equal(L.ln1, torch.ones_like(L.ln1))
    assert float(L.mu_rkvwg.abs().max()) == 0.0
    assert float(L.lnx_bias.abs().max()) == 0.0


def test_build_model_maps_ssm_to_rwkv():
    cfg = dataclasses.replace(get_config("rwkv6-3b"), num_layers=1,
                              d_model=128, d_ff=256, vocab_size=64)
    model = build_model(cfg, device="cpu")
    assert isinstance(model, RwkvLM)
    assert model.layers.wr.shape == (1, 128, 128)
    assert model.H == 2 and model.hd == 64


def test_forward_logits_do_not_depend_on_the_thread_count(pair):
    """The port's fp32 logits are bitwise the same at 1 and at 2 intra-op
    threads (the test helper's setting), so no process-to-process drift
    can come from torch's CPU threading here."""
    _, _, _, model = pair
    toks = to_torch(_tokens(model.cfg, (2, 32), seed=32))
    threads = torch.get_num_threads()
    outs = []
    try:
        for n in (1, 2):
            torch.set_num_threads(n)
            outs.append(model.forward(toks)[0])
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(outs[0], outs[1])
