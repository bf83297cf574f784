"""Port parity: the dense-cache path of ``TransformerLM`` against the
reference, and the port's dense engine mode serving it.

Weights are the reference's ``init(PRNGKey(0))`` carried over with
``params_from_numpy``; inputs are numpy arrays from a seed; both sides run
at fp32 on the CPU.  Tolerance: ``rtol = atol = 1e-4`` on logits and cache
rows, as in ``test_torch_model.py`` (fp32 sums in another order across a
few layers); ``decode_attn`` and ``update_cache`` alone are held to
``1e-5`` (one layer, one contraction).  Covered on the reduced qwen2.5,
gemma2 (sliding windows, both softcaps, sandwich norms, embedding scale),
gemma3 (qk-norm, per-layer RoPE bases) and starcoder2 configs:
``update_cache``/``decode_attn``, ``init_decode_state``, ``decode_step``
continuing ``prefill`` like ``forward``, ``prefill_chunk`` composing to
the monolithic prefill (and refusing gemma's windows and softcap, as the
reference does), a lane past ``max_seq`` leaving the cache unchanged, K2's
plain version at head dim 256 against the reference's Pallas kernel, and
the engine's dense mode against the reference engine's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_port import fp32_config, model_pair, to_torch
from helpers.torch_serving import assert_stats_match

import repro.runtime.serve_loop as jax_loop
import repro_torch.runtime.serve_loop as port_loop
from repro.core.sim import SimExecutor as JaxSim
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models.attention import decode_attn as jax_decode_attn
from repro.models.attention import update_cache as jax_update_cache
from repro_torch.core.sim import SimExecutor as PortSim
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa_bind
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.attention import decode_attn, update_cache
from repro_torch.runtime import ServerConfig, ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["qwen2.5-32b", "gemma2-9b", "gemma3-12b", "starcoder2-7b"]
CHUNKABLE = ["qwen2.5-32b", "starcoder2-7b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return model_pair(fp32_config(request.param))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(out, ref, **tol):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               **(tol or TOL))


# ------------------------------------------------ update_cache / decode_attn


@pytest.mark.parametrize("arch", ARCHS)
def test_update_cache_and_decode_attn_match_reference(arch):
    """One layer's cache write and attention, at the config's window and
    softcap, with lanes at different positions."""
    jm, _, tm = model_pair(fp32_config(arch))
    cfg = tm.cfg
    B, S, K, hd, H = 3, 24, cfg.num_kv_heads, cfg.hd, cfg.num_heads
    rng = np.random.default_rng(ARCHS.index(arch))
    ck = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    cv = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    kn = rng.standard_normal((B, K, hd)).astype(np.float32)
    vn = rng.standard_normal((B, K, hd)).astype(np.float32)
    q = rng.standard_normal((B, H, hd)).astype(np.float32) * 3
    pos = np.asarray([0, 13, 23], np.int32)
    window = int(max(tm.windows))
    rk, rv = jax_update_cache(jnp.asarray(ck), jnp.asarray(cv),
                              jnp.asarray(kn), jnp.asarray(vn),
                              jnp.asarray(pos))
    tk, tv = to_torch(ck), to_torch(cv)
    update_cache(tk, tv, to_torch(kn), to_torch(vn), to_torch(pos))
    assert np.array_equal(tk.numpy(), np.asarray(rk))
    assert np.array_equal(tv.numpy(), np.asarray(rv))
    ref = jax_decode_attn(jnp.asarray(q), rk, rv, jnp.asarray(pos), cfg,
                          window=jnp.asarray(window))
    out = decode_attn(to_torch(q), tk, tv, to_torch(pos), cfg, window=window)
    assert out.dtype == torch.float32 and out.shape == (B, H * hd)
    _close(out, ref, rtol=1e-5, atol=1e-5)


def test_update_cache_lane_past_max_seq_leaves_the_cache_unchanged():
    """A free lane of the dense batch may count past ``max_seq``: the
    reference drops its write; the port writes nothing either (no
    device-side assert on CUDA, no host sync)."""
    rng = np.random.default_rng(4)
    B, S, K, hd = 4, 8, 2, 4
    ck = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    kn = rng.standard_normal((B, K, hd)).astype(np.float32)
    pos = np.asarray([8, 3, 40, 7], np.int32)
    rk, _ = jax_update_cache(jnp.asarray(ck), jnp.asarray(ck),
                             jnp.asarray(kn), jnp.asarray(kn),
                             jnp.asarray(pos))
    tk, tv = to_torch(ck), to_torch(ck)
    update_cache(tk, tv, to_torch(kn), to_torch(kn), to_torch(pos))
    assert np.array_equal(tk.numpy(), np.asarray(rk))
    assert np.array_equal(tk[[0, 2]].numpy(), ck[[0, 2]])
    assert np.array_equal(tk[1, 3].numpy(), kn[1])


# ------------------------------------------------------ decode state


def test_init_decode_state_matches_reference(pair):
    jm, _, tm = pair
    ref = jm.init_decode_state(3, 20)
    out = tm.init_decode_state(3, 20)
    assert sorted(out) == sorted(ref)
    for key in ref:
        assert tuple(out[key].shape) == ref[key].shape
        assert str(out[key].dtype).split(".")[-1] == str(ref[key].dtype)
        assert not out[key].any()
    meta = tm.init_decode_state(2, 20, device="meta")
    assert all(t.device.type == "meta" for t in meta.values())


def test_decode_step_continues_prefill_like_forward(pair):
    """Prefill 9 tokens, then 5 decode steps (past gemma's 8-token window):
    each step's logits equal the reference's decode step and the port's own
    ``forward`` at that position; the caches equal the reference's."""
    jm, params, tm = pair
    toks = _tokens(tm.cfg, (2, 14), seed=5)
    ref_state, _ = jm.prefill(params, jnp.asarray(toks[:, :9]), max_seq=16)
    state, _ = tm.prefill(to_torch(toks[:, :9]), max_seq=16)
    full, _ = tm.forward(to_torch(toks))
    for t in range(9, 14):
        ref_state, ref_logits = jm.decode_step(params, ref_state,
                                               jnp.asarray(toks[:, t]))
        state, logits = tm.decode_step(state, to_torch(toks[:, t]))
        _close(logits, ref_logits)
        _close(logits, full[:, t])
    for key in ("cache_k", "cache_v"):
        _close(state[key], ref_state[key])
    assert state["pos"].tolist() == np.asarray(ref_state["pos"]).tolist()


@pytest.mark.parametrize("arch", CHUNKABLE)
def test_prefill_chunk_composes_to_prefill_like_reference(arch):
    """Chunks of 5, 4 and 3 tokens from a fresh state: each chunk's
    logits and state equal the reference's ``prefill_chunk``, and the last
    ones equal the monolithic ``prefill``."""
    jm, params, tm = model_pair(fp32_config(arch))
    toks = _tokens(tm.cfg, (1, 12), seed=6)
    ref_state = jm.init_decode_state(1, 20)
    state = tm.init_decode_state(1, 20)
    at = 0
    for n in (5, 4, 3):
        chunk = toks[:, at:at + n]
        ref_state, ref_logits = jm.prefill_chunk(
            params, jnp.asarray(chunk), ref_state, jnp.asarray(at, jnp.int32))
        state, logits = tm.prefill_chunk(to_torch(chunk), state, at)
        _close(logits, ref_logits)
        at += n
    for key in ("cache_k", "cache_v"):
        _close(state[key], ref_state[key])
    assert state["pos"].tolist() == np.asarray(ref_state["pos"]).tolist() \
        == [12]
    mono_state, mono_logits = tm.prefill(to_torch(toks), max_seq=20)
    _close(logits, mono_logits)
    for key in ("cache_k", "cache_v"):
        _close(state[key], mono_state[key])


def test_prefill_chunk_write_clamps_like_dynamic_update_slice():
    """A chunk that would run past ``max_seq`` lands at ``max_seq - S``,
    as ``dynamic_update_slice_in_dim`` clamps its start."""
    jm, params, tm = model_pair(fp32_config("qwen2.5-32b"))
    toks = _tokens(tm.cfg, (1, 4), seed=7)
    ref_state, ref_logits = jm.prefill_chunk(
        params, jnp.asarray(toks), jm.init_decode_state(1, 10),
        jnp.asarray(8, jnp.int32))
    state, logits = tm.prefill_chunk(to_torch(toks),
                                     tm.init_decode_state(1, 10), 8)
    _close(logits, ref_logits)
    for key in ("cache_k", "cache_v"):
        _close(state[key], ref_state[key])
        assert state[key][:, :, 6:].any() and not state[key][:, :, :6].any()


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-12b"])
def test_prefill_chunk_refuses_windows_and_softcap(arch):
    jm, params, tm = model_pair(fp32_config(arch))
    toks = _tokens(tm.cfg, (1, 3))
    with pytest.raises(NotImplementedError) as ref_err:
        jm.prefill_chunk(params, jnp.asarray(toks), jm.init_decode_state(1, 8),
                         jnp.asarray(0, jnp.int32))
    with pytest.raises(NotImplementedError) as port_err:
        tm.prefill_chunk(to_torch(toks), tm.init_decode_state(1, 8), 0)
    assert str(port_err.value) == str(ref_err.value)


# ------------------------------------------------------------ K2 at hd 256


@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 50.0), (64, 30.0)])
def test_flash_plain_hd256_matches_reference_kernel(window, cap):
    """K2's plain version at gemma's head dim, with its window and softcap,
    against the reference's Pallas kernel in interpret mode."""
    rng = np.random.default_rng(256 + window)
    B, S, K, G, hd = 1, 128, 2, 2, 256
    q = rng.standard_normal((B, S, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    kw = dict(window=window, scale=hd ** -0.5, logit_cap=cap, causal=True)
    ref = jax_flash(q, k, v, interpret=True, **kw)
    out = fa_ops.flash_attention(to_torch(q), to_torch(k), to_torch(v), **kw)
    _close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_binding_takes_head_dim_256(dtype, monkeypatch):
    """The binding passes head dim 256 on to the kernel (it refused it
    before: gemma2/3 could not prefill on the card); past 256, the largest
    instance, it refuses."""
    def loader(*_a, **_k):
        raise RuntimeError("kernel loader called")

    monkeypatch.setattr(_build, "kernel", loader)
    monkeypatch.setattr(fa_bind, "KERNEL_DEVICE", "cpu")
    q = torch.zeros((1, 8, 4, 256), dtype=dtype)
    k = torch.zeros((1, 8, 2, 256), dtype=dtype)
    with pytest.raises(RuntimeError, match="kernel loader called"):
        fa_bind.flash_attention_cuda(q, k, k, 64, scale=0.0625,
                                     logit_cap=50.0)
    wide_q = torch.zeros((1, 8, 4, 320), dtype=dtype)
    wide_k = torch.zeros((1, 8, 2, 320), dtype=dtype)
    with pytest.raises(ValueError, match="head dim"):
        fa_bind.flash_attention_cuda(wide_q, wide_k, wide_k, 0, scale=0.1)


# ---------------------------------------------------- the dense engine mode


def _requests(module, vocab):
    rng = np.random.default_rng(31)
    specs = [(13, 6, 0.0, 0), (9, 5, 0.8, 5), (20, 4, 0.0, 0), (5, 7, 0.0, 0)]
    return [
        module.Request(prompt=rng.integers(0, vocab, n).astype(np.int32),
                       max_new_tokens=m, request_id=i, temperature=t,
                       top_k=k, seed=200 + i,
                       tenant="alice" if i % 2 else "bob")
        for i, (n, m, t, k) in enumerate(specs)
    ]


@pytest.mark.parametrize("arch,scfg", [
    ("gemma2-9b", {}),
    ("gemma3-12b", {}),
    ("qwen2.5-32b", {"kv_mode": "dense"}),
    ("qwen2.5-32b", {"kv_mode": "dense", "prefill_chunk_tokens": 7}),
    ("qwen2.5-32b", {"incremental": False}),
])
def test_dense_engine_matches_reference(arch, scfg):
    """The engine in dense mode (``auto`` for gemma2/3, whose windows and
    softcap rule out paged decode; forced, chunked and rebatching for
    qwen) against the reference engine on the same weights: every
    sampled step's logits allclose, the token streams, the trace, the
    prefill counts and the ledgers equal."""
    jm, params, tm = model_pair(fp32_config(arch))
    kw = dict(max_batch=2, max_seq=40, step_time_s=0.01, **scfg)
    logits = []
    engines, reqs = [], []
    for module, engine in (
            (jax_loop, jax_loop.ServingEngine(
                jm, params, jax_loop.ServerConfig(**kw),
                executor=JaxSim(seed=4))),
            (port_loop, ServingEngine(tm, ServerConfig(**kw),
                                      executor=PortSim(seed=4)))):
        seen = {}
        real = module.sample_token

        def spy(lg, _seen=seen, _real=real, **k):
            _seen[(k["seed"], k["index"])] = np.array(lg, np.float64)
            return _real(lg, **k)

        rs = _requests(module, tm.cfg.vocab_size)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(module, "sample_token", spy)
            for r in rs:
                engine.submit(r)
            engine.drain()
        logits.append(seen)
        engines.append(engine)
        reqs.append(rs)
    ref, port = engines
    assert port.kv_mode == ref.kv_mode == "dense"
    assert sorted(logits[1]) == sorted(logits[0])
    for key, ref_row in logits[0].items():
        np.testing.assert_allclose(logits[1][key], ref_row, **TOL)
    for a, b in zip(reqs[1], reqs[0]):
        assert a.error is None and a.tokens == b.tokens, a.request_id
    assert port.trace() == ref.trace()
    assert port.prefill_counts() == ref.prefill_counts()
    assert_stats_match(port, ref)
    assert port.admission.slot_balance() == {}
