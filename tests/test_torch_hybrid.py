"""Port parity: ``repro_torch.models.HybridLM`` against the reference's
Hymba-style hybrid.

Weights are the reference's ``init(PRNGKey(0))`` on the reduced hymba-1.5b
config at fp32 (3 layers, width 64, 4 q / 2 kv heads of 16, SSM width 128,
state 4), carried over with ``params_from_numpy``; the windowed variant
has 4 layers, so layer 1 runs the sliding window of 8 (the reduced
config's 3 layers are all global: first, middle and last).  The reference
runs with ``impl="xla"`` (blockwise attention) and ``impl="pallas"`` (its
flash kernel in interpret mode); the port runs K2's plain version.  Prompt
lengths are ones the reference's ``ssm_scan`` accepts (at most 64, or a
multiple of 64), except where a test says otherwise.

Tolerance: ``rtol = atol = 2e-3``, the reference's own in
``tests/test_models_smoke.py``; both sides compute in fp32 and differ by
about 1e-5.  Served token streams are compared exactly; a greedy token may
only differ where the reference's top-2 logit margin is below
``MARGIN_TOL``, and the seeds are fixed so that none does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_port import fp32_config, model_pair, to_numpy, to_torch
from helpers.torch_serving import assert_stats_match

import repro.runtime.serve_loop as jax_loop
import repro_torch.runtime.serve_loop as port_loop
from repro.core.sim import SimExecutor as JaxSim
from repro.models import build_model as jax_build_model
from repro.models.hybrid import ssm_scan as jax_ssm_scan
from repro_torch.configs import get_config
from repro_torch.core.sim import SimExecutor as PortSim
from repro_torch.models import HybridLM, build_model, params_from_numpy
from repro_torch.models.common import ArchConfig
from repro_torch.models.hybrid import hymba_windows, ssm_scan
from repro_torch.runtime import ServerConfig, ServingEngine

TOL = dict(rtol=2e-3, atol=2e-3)
MARGIN_TOL = 2 * (2e-3 + 2e-3 * 3)


@pytest.fixture(scope="module")
def pair():
    """(reference xla model, reference pallas model, params, port model)
    on the reduced config."""
    cfg = fp32_config("hymba-1.5b")
    xla, params, model = model_pair(cfg)
    return xla, jax_build_model(cfg, impl="pallas"), params, model


@pytest.fixture(scope="module")
def windowed():
    """(reference model, params, port model) with 4 layers: windows
    [0, 8, 0, 0]."""
    return model_pair(fp32_config("hymba-1.5b", num_layers=4))


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


def test_windowed_forward_matches_reference(windowed):
    jm, params, model = windowed
    assert hymba_windows(model.cfg).tolist() == [0, 8, 0, 0]
    toks = _tokens(model.cfg, (2, 40), seed=3)          # past the window
    ref, _ = jm.forward(params, jnp.asarray(toks))
    out, _ = model.forward(to_torch(toks))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_full_config_windows():
    """hymba-1.5b: window 1024 on 29 of 32 layers, global on 0, 16, 31."""
    w = hymba_windows(get_config("hymba-1.5b"))
    assert np.flatnonzero(w == 0).tolist() == [0, 16, 31]
    assert (w[w > 0] == 1024).all() and len(w) == 32


# ------------------------------------------------------------- serving


@pytest.mark.parametrize("which", ["reduced", "windowed"])
def test_prefill_and_decode_steps_match_reference(pair, windowed, which):
    """prefill's state and logits into a longer cache, then three decode
    steps' (the windowed model decodes past its window)."""
    jm, params, model = (pair[0], pair[2], pair[3]) if which == "reduced" \
        else windowed
    toks = _tokens(model.cfg, (2, 48), seed=1)
    ref_state, ref_logits = jm.prefill(params, jnp.asarray(toks), max_seq=56)
    state, logits = model.prefill(to_torch(toks), max_seq=56)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    _assert_state_close(state, ref_state)
    for i in range(3):
        nxt = _tokens(model.cfg, (2,), seed=10 + i)
        ref_state, ref_logits = jm.decode_step(params, ref_state,
                                               jnp.asarray(nxt))
        state, logits = model.decode_step(state, to_torch(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   err_msg=f"step {i}", **TOL)
        _assert_state_close(state, ref_state)


@pytest.mark.parametrize("which", ["reduced", "windowed"])
def test_decode_is_consistent_with_forward(pair, windowed, which):
    """The reference's smoke check: prefill(prompt[:-1]) and a decode step
    of prompt[-1] give forward's last logits."""
    model = pair[3] if which == "reduced" else windowed[2]
    toks = to_torch(_tokens(model.cfg, (2, 32), seed=5))
    full, _ = model.forward(toks)
    state, _ = model.prefill(toks[:, :-1], max_seq=32)
    _, logits = model.decode_step(state, toks[:, -1])
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), **TOL)


def test_prefill_then_decode_equals_forward_at_a_ragged_length(windowed):
    """A prompt of 100 tokens, which the reference's scan refuses (64 does
    not divide it): the port's prefill and decode steps reproduce its own
    forward."""
    _, _, model = windowed
    toks = to_torch(_tokens(model.cfg, (2, 103), seed=100))
    full, _ = model.forward(toks)
    state, logits = model.prefill(toks[:, :100], max_seq=103)
    np.testing.assert_allclose(logits.numpy(), full[:, 99].numpy(), **TOL)
    for i in range(3):
        state, logits = model.decode_step(state, toks[:, 100 + i])
        np.testing.assert_allclose(logits.numpy(), full[:, 100 + i].numpy(),
                                   **TOL)


# ------------------------------------------------------------ ssm_scan


def _scan_inputs(T, B=2, di=24, N=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, di)))).astype(np.float32)
    Bp = rng.standard_normal((B, T, N)).astype(np.float32)
    Cp = rng.standard_normal((B, T, N)).astype(np.float32)
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (di, 1))
    h0 = (0.1 * rng.standard_normal((B, di, N))).astype(np.float32)
    return x, dt, Bp, Cp, A, h0


def _scan_fp64(x, dt, Bp, Cp, A, h0):
    """The recurrence token by token in float64."""
    x, dt, Bp, Cp, A, h = (np.asarray(v, np.float64)
                           for v in (x, dt, Bp, Cp, A, h0))
    ys = []
    for t in range(x.shape[1]):
        h = h * np.exp(dt[:, t, :, None] * A) \
            + (dt[:, t] * x[:, t])[..., None] * Bp[:, t, None, :]
        ys.append(np.einsum("bdn,bn->bd", h, Cp[:, t]))
    return h, np.stack(ys, axis=1)


@pytest.mark.parametrize("T", [17, 64, 128])
def test_ssm_scan_matches_reference(T):
    args = _scan_inputs(T, seed=T)
    ref_h, ref_y = jax_ssm_scan(*map(jnp.asarray, args))
    h, y = ssm_scan(*map(to_torch, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **TOL)
    assert y.dtype == torch.float32 and h.dtype == torch.float32


def test_ssm_scan_takes_a_ragged_length_the_reference_refuses():
    """T = 100: the reference asserts that its chunk of 64 divides T; the
    port returns the token loop's result, pinned to a float64 run."""
    args = _scan_inputs(100, seed=7)
    with pytest.raises(AssertionError):
        jax_ssm_scan(*map(jnp.asarray, args))
    h, y = ssm_scan(*map(to_torch, args))
    want_h, want_y = _scan_fp64(*args)
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(h.numpy(), want_h, **TOL)


def test_ssm_scan_casts_its_output_to_the_input_dtype():
    x, dt, Bp, Cp, A, h0 = map(to_torch, _scan_inputs(20, seed=2))
    h, y = ssm_scan(x.bfloat16(), dt, Bp.bfloat16(), Cp.bfloat16(), A, h0)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32


# ------------------------------------------------------------- engine


def _requests(module, vocab):
    rng = np.random.default_rng(21)
    specs = [(9, 6, 0.0, 0), (20, 4, 0.8, 5), (33, 5, 0.0, 0),
             (64, 3, 0.0, 0), (128, 3, 0.0, 0)]   # prompt, new, temp, top-k
    return [
        module.Request(prompt=rng.integers(0, vocab, n).astype(np.int32),
                       max_new_tokens=new, request_id=i, temperature=t,
                       top_k=k, seed=300 + i)
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
def served(windowed):
    jm, params, model = windowed
    vocab = model.cfg.vocab_size
    scfg = dict(max_batch=2, max_seq=160, step_time_s=0.01)
    mp = pytest.MonkeyPatch()
    try:
        ref_engine = jax_loop.ServingEngine(
            jm, params, jax_loop.ServerConfig(**scfg),
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
    assert port_engine.admission.slot_balance() == {}


def test_engine_resolves_dense_with_generic_batch_axes(pair):
    """No change to the engine: its batch axes, found on the meta device,
    are axis 1 of the caches and SSM states and axis 0 of ``pos``."""
    model = pair[3]
    engine = ServingEngine(model, ServerConfig(max_seq=32))
    assert engine.kv_mode == "dense"
    assert engine._batch_axes == {"cache_k": 1, "cache_v": 1, "ssm_h": 1,
                                  "pos": 0}
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, ServerConfig(kv_mode="paged"))


# ------------------------------------------------------- construction


def test_params_from_numpy_keeps_the_fp32_leaves():
    """In a bf16 model, the SSM's ``dt_bias``, ``A_log`` and ``D_skip``
    stay float32, as the reference initialises them; every leaf has the
    reference tree's dtype and shape."""
    cfg = dataclasses.replace(fp32_config("hymba-1.5b"), dtype="bfloat16")
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    tcfg = ArchConfig(**dataclasses.asdict(cfg))
    sd = params_from_numpy(tcfg, to_numpy(params))
    leaves = {".".join(str(k.key) for k in path): leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(sd) == set(leaves)
    for name, leaf in leaves.items():
        assert tuple(sd[name].shape) == leaf.shape, name
        assert str(sd[name].dtype)[6:] == str(leaf.dtype), name
    assert {n for n, t in sd.items() if t.dtype == torch.float32} == {
        "layers.ssm.dt_bias", "layers.ssm.A_log", "layers.ssm.D_skip"}
    model = HybridLM(tcfg, device="cpu")
    model.load_state_dict(sd)
    assert model.layers.ssm.A_log.dtype == torch.float32
    np.testing.assert_array_equal(model.layers.ssm.A_log.numpy(),
                                  np.asarray(params["layers"]["ssm"]["A_log"]))


def test_init_uses_the_reference_distributions():
    cfg = dataclasses.replace(fp32_config("hymba-1.5b"), d_model=128,
                              d_ff=512, ssm_d_inner=256, vocab_size=512,
                              dtype="bfloat16")
    model = HybridLM(ArchConfig(**dataclasses.asdict(cfg)), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    D, F, di = cfg.d_model, cfg.d_ff, cfg.ssm_d_inner
    L, S = model.layers, model.layers.ssm
    for t, std in ((model.embed, D ** -0.5), (L.attn.wq, D ** -0.5),
                   (L.attn.wo, D ** -0.5), (S.w_in, D ** -0.5),
                   (S.w_dt, di ** -0.5), (S.w_B, di ** -0.5),
                   (S.w_out, di ** -0.5), (L.mlp.wg, D ** -0.5),
                   (L.mlp.wd, F ** -0.5)):
        assert abs(float(t.float().std()) - std) < 0.1 * std
    for t in (L.ln1, L.ln2, L.attn_norm, L.ssm_norm, model.final_norm,
              S.D_skip):
        assert torch.equal(t, torch.ones_like(t))
    assert float(S.dt_bias.abs().max()) == 0.0
    want = torch.log(torch.arange(1, cfg.ssm_state_size + 1).float())
    assert torch.equal(S.A_log, want.expand_as(S.A_log))
    assert S.A_log.dtype == S.dt_bias.dtype == S.D_skip.dtype == torch.float32
    assert S.w_in.dtype == torch.bfloat16


def test_build_model_maps_hybrid():
    cfg = dataclasses.replace(get_config("hymba-1.5b"), num_layers=2,
                              d_model=128, d_ff=256, ssm_d_inner=256,
                              vocab_size=64)
    model = build_model(cfg, device="cpu")
    assert isinstance(model, HybridLM)
    assert model.layers.ssm.w_in.shape == (2, 128, 512)
    assert model.di == 256 and model.N == 16
