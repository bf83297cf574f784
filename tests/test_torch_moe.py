"""Port parity: the MoE family (``repro_torch.models.moe`` and the MoE
branches of ``TransformerLM``) against the reference.

Weights are the reference's ``init(PRNGKey(0))`` carried over with
``params_from_numpy``; inputs are numpy arrays from a seed; both sides run
at fp32 on the CPU on the reduced ``qwen3-moe-smoke`` (softmax over the
top-2 of 8 experts, paged) and ``llama4-scout-smoke`` (sigmoid top-1 of 4
experts, a shared expert, windows of 16 on 3 layers of 4: dense).
Tolerance: ``rtol = atol = 1e-4``, as in ``test_torch_model.py`` (fp32
sums in another order over a few layers).

Routing is discontinuous: two router logits within fp32 reassociation
noise can pick other experts, and the outputs then differ by O(1).  The
block-level tests therefore hold the routing decisions (top-k indices,
kept copies, slots) equal to the reference's, and report the
k-th/(k+1)-th logit margin where they differ; the model-level tests put
the smallest margin the port routed at into their failure messages.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_port import fp32_config, model_pair, to_numpy, to_torch
from helpers.torch_serving import assert_engines_match

import repro.runtime.serve_loop as jax_loop
import repro_torch.models.moe as moe
import repro_torch.runtime.serve_loop as port_loop
from repro.configs import get_reduced as jax_get_reduced
from repro.core.sim import SimExecutor as JaxSim
from repro.models import build_model as jax_build_model
from repro.models.moe import init_moe_params
from repro.models.moe import moe_block as jax_moe_block
from repro_torch.configs import get_config
from repro_torch.core.sim import SimExecutor as PortSim
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.common import ArchConfig
from repro_torch.runtime import ServerConfig, ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
QWEN, LLAMA = "qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"
ARCHS = [QWEN, LLAMA]
PAGE = 4


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(out, ref, msg=""):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), err_msg=msg,
                               **TOL)


def _port_cfg(cfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(cfg))


def _margin(logits: np.ndarray, k: int) -> float:
    """The smallest k-th/(k+1)-th router logit gap over the rows."""
    top = -np.sort(-logits, axis=-1)
    return float((top[:, k - 1] - top[:, k]).min())


# ------------------------------------------------------------- moe_block


def _reference_routing(x2d, router, cfg, lossless):
    """The reference's routing decisions (``moe.py:83-105``) on ``x2d``
    (T, D): top-k indices, kept copies and slots, from ``jax.lax.top_k``
    on its fp32 logits."""
    T, k, E = x2d.shape[0], cfg.experts_per_token, cfg.num_experts
    logits = jnp.asarray(x2d, jnp.float32) @ jnp.asarray(router, jnp.float32)
    _, top_idx = jax.lax.top_k(logits, k)
    e_flat = np.asarray(top_idx).reshape(T * k)
    onehot = np.eye(E, dtype=np.int64)[e_flat]
    pos = (np.cumsum(onehot, axis=0) - onehot)[np.arange(T * k), e_flat]
    capacity = T * k if lossless else max(
        1, int(np.ceil(T * k / E * cfg.capacity_factor)))
    capacity = min(capacity, T * k)
    keep = pos < capacity
    slot = np.where(keep, e_flat * capacity + pos, E * capacity)
    return np.asarray(logits), np.asarray(top_idx), keep, slot


def _block_case(arch, case):
    """(reference cfg, params (numpy), x (B, S, D)) for a block case."""
    cfg = fp32_config(arch)
    params = {n: np.array(v) for n, v in init_moe_params(
        jax.random.PRNGKey(7), cfg, jnp.float32).items()}
    rng = np.random.default_rng(17)
    B, S = (2, 24) if case != "lossless" else (4, 1)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if case == "dropping":
        # a shared direction in every token skews the routing towards a
        # few experts, past their capacity
        x += 2.0 * rng.standard_normal(cfg.d_model).astype(np.float32)
    if case == "tied":
        # experts 2e and 2e + 1 have equal router columns: exact ties
        params["router"][:, 1::2] = params["router"][:, 0::2]
    return cfg, params, x


@pytest.mark.parametrize("case", ["dropping", "lossless", "tied"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, case):
    """``moe_block`` and its aux loss against the reference's one-device
    block, with the routing decisions equal: capacity-bounded (the
    reference drops copies here, and so does the port), lossless (a decode
    step's 4 lanes), and exactly tied router logits (both pick the lower
    expert index first)."""
    cfg, params, x = _block_case(arch, case)
    lossless = case == "lossless"
    ref, ref_aux = jax_moe_block(jnp.asarray(x),
                                 jax.tree_util.tree_map(jnp.asarray, params),
                                 cfg, lossless=lossless)
    tp = {n: to_torch(v) for n, v in params.items()}
    tcfg = _port_cfg(cfg)
    out, aux = moe.moe_block(to_torch(x), tp, tcfg, lossless=lossless)

    x2d = x.reshape(-1, cfg.d_model)
    logits, top_idx, keep, slot = _reference_routing(
        x2d, params["router"], cfg, lossless)
    r = moe.route(to_torch(x2d), tp["router"], tcfg, lossless=lossless)
    k = cfg.experts_per_token
    differ = np.flatnonzero((r.top_idx.numpy() != top_idx).any(axis=1))
    assert differ.size == 0, (
        f"routing differs on tokens {differ.tolist()}: k-th/(k+1)-th "
        f"margin there {_margin(logits[differ], k):.3g}")
    assert np.array_equal(r.keep.numpy(), keep)
    assert np.array_equal(r.slot.numpy(), slot)
    dropped = int((~keep).sum())
    if case == "dropping":
        assert dropped > 0, "the reference dropped no copy"
    if lossless:
        assert dropped == 0
    if case == "tied":
        assert np.array_equal(logits[:, 0::2], logits[:, 1::2])
        assert np.array_equal(r.logits[:, 0::2].numpy(),
                              r.logits[:, 1::2].numpy())
        # the lower of two tied experts comes first, in both
        for row in top_idx:
            for i, e in enumerate(row):
                if e % 2:
                    assert e - 1 in row[:i], row
    _close(out, ref)
    np.testing.assert_allclose(float(aux), float(ref_aux), **TOL)


def test_top_k_breaks_ties_to_the_lower_index():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0],
                           [2.0, 2.0, 2.0, 2.0, 2.0]])
    vals, idx = moe._top_k(logits, 3)
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(logits.numpy()), 3)
    assert idx.tolist() == np.asarray(ref_idx).tolist()
    assert vals.tolist() == np.asarray(ref_vals).tolist()


# ------------------------------------------------- the model's functions


@contextlib.contextmanager
def _routing_margin(monkeypatch):
    """Records the smallest k-th/(k+1)-th router logit margin of every
    ``moe.route`` call inside the block: ``[margin]``."""
    seen = [float("inf")]
    real = moe.route

    def spy(x, router_w, cfg, **kw):
        r = real(x, router_w, cfg, **kw)
        if cfg.experts_per_token < cfg.num_experts:
            seen[0] = min(seen[0], _margin(r.logits.numpy(),
                                           cfg.experts_per_token))
        return r

    monkeypatch.setattr(moe, "route", spy)
    yield seen
    monkeypatch.setattr(moe, "route", real)


@pytest.fixture(scope="module", params=ARCHS, ids=["qwen3", "llama4"])
def pair(request):
    return model_pair(fp32_config(request.param))


def test_forward_logits_and_aux_match_reference(pair, monkeypatch):
    jm, params, tm = pair
    toks = _tokens(tm.cfg, (2, 21))                  # past llama4's window
    ref, ref_aux = jm.forward(params, jnp.asarray(toks))
    with _routing_margin(monkeypatch) as margin:
        out, aux = tm.forward(to_torch(toks))
    msg = f"smallest router margin {margin[0]:.3g}"
    _close(out, ref, msg)
    np.testing.assert_allclose(float(aux), float(ref_aux), err_msg=msg,
                               **TOL)
    assert float(aux) > 0


def test_prefill_then_decode_steps_match_reference(pair, monkeypatch):
    """Prefill 11 tokens of 2 rows (capacity over the 22 rows), then 6
    lossless decode steps past llama4's window: logits and caches."""
    jm, params, tm = pair
    toks = _tokens(tm.cfg, (2, 17), seed=1)
    with _routing_margin(monkeypatch) as margin:
        ref_state, ref_logits = jm.prefill(params, jnp.asarray(toks[:, :11]),
                                           max_seq=20)
        state, logits = tm.prefill(to_torch(toks[:, :11]), max_seq=20)
        msg = f"smallest router margin {margin[0]:.3g}"
        _close(logits, ref_logits, msg)
        for t in range(11, 17):
            ref_state, ref_logits = jm.decode_step(params, ref_state,
                                                   jnp.asarray(toks[:, t]))
            state, logits = tm.decode_step(state, to_torch(toks[:, t]))
            _close(logits, ref_logits, msg)
    for key in ("cache_k", "cache_v"):
        _close(state[key], ref_state[key])
    assert state["pos"].tolist() == np.asarray(ref_state["pos"]).tolist()


def test_prefill_chunk_matches_reference(pair):
    """qwen3: chunks of 5, 4 and 3 tokens (capacity over each chunk), each
    chunk's logits and the final cache as the reference's; llama4's
    windows are refused with the reference's message."""
    jm, params, tm = pair
    toks = _tokens(tm.cfg, (1, 12), seed=6)
    ref_state = jm.init_decode_state(1, 20)
    state = tm.init_decode_state(1, 20)
    if tm.cfg.local_window:
        with pytest.raises(NotImplementedError) as ref_err:
            jm.prefill_chunk(params, jnp.asarray(toks), ref_state,
                             jnp.asarray(0, jnp.int32))
        with pytest.raises(NotImplementedError) as port_err:
            tm.prefill_chunk(to_torch(toks), state, 0)
        assert str(port_err.value) == str(ref_err.value)
        return
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
    assert state["pos"].tolist() == [12]


@pytest.fixture(scope="module")
def paged_qwen():
    """qwen3-moe-smoke with two prompts prefilled into permuted pages of
    both pools: 5 tokens in pages [3, 7], 9 tokens in pages [0, 11, 5]."""
    jm, params, tm = model_pair(fp32_config(QWEN))
    jpool = jm.init_paged_state(24, PAGE)
    tpool = tm.init_paged_state(24, PAGE)
    logits = []
    for sid, (n, pages) in enumerate([(5, [3, 7]), (9, [0, 11, 5])]):
        toks = _tokens(tm.cfg, (1, n), seed=10 + sid)
        page_ids = np.asarray([pages[i // PAGE] for i in range(n)], np.int32)
        offsets = np.asarray([i % PAGE for i in range(n)], np.int32)
        jrows, jlog = jm.paged_prefill(params, jnp.asarray(toks))
        trows, tlog = tm.paged_prefill(to_torch(toks))
        logits.append((tlog, jlog))
        jpool = jm.paged_write_prefill(jpool, jrows, jnp.asarray(page_ids),
                                       jnp.asarray(offsets))
        tpool = tm.paged_write_prefill(tpool, trows, page_ids, offsets)
    return (jm, params, tm), jpool, tpool, logits


def _clone(pool):
    return {k: v.clone() for k, v in pool.items()}


def test_paged_prefill_matches_reference(paged_qwen):
    _, jpool, tpool, logits = paged_qwen
    for key in ("k_pages", "v_pages"):
        _close(tpool[key], jpool[key])
    for tlog, jlog in logits:
        _close(tlog, jlog)


def test_paged_decode_step_matches_reference(paged_qwen):
    """Ragged positions and a dead lane; the lanes route losslessly."""
    (jm, params, tm), jpool, tpool, _ = paged_qwen
    tpool = _clone(tpool)
    table = np.full((3, 4), -1, np.int32)
    table[0, :2] = [3, 7]
    table[1, :3] = [0, 11, 5]
    pos = np.asarray([5, 9, 0], np.int32)
    toks = _tokens(tm.cfg, (3,), seed=4)
    jpool, jlog = jm.paged_decode_step(params, jpool, jnp.asarray(toks),
                                       jnp.asarray(table), jnp.asarray(pos))
    tpool, tlog = tm.paged_decode_step(tpool, to_torch(toks),
                                       to_torch(table), to_torch(pos))
    _close(tlog, jlog)
    for key in ("k_pages", "v_pages"):
        _close(tpool[key], jpool[key])


def test_paged_prefill_at_matches_reference(paged_qwen):
    """A 7-token suffix after 6 resident prefix rows (capacity over the
    suffix)."""
    (jm, params, tm), jpool, tpool, _ = paged_qwen
    suffix = _tokens(tm.cfg, (1, 7), seed=8)
    table = np.asarray([[0, 11, 5, -1]], np.int32)
    jrows, jlog = jm.paged_prefill_at(params, jnp.asarray(suffix), jpool,
                                      jnp.asarray(table), 6)
    trows, tlog = tm.paged_prefill_at(to_torch(suffix), tpool,
                                      to_torch(table), 6)
    _close(tlog, jlog)
    for key in ("k", "v"):
        _close(trows[key], jrows[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_consistency_without_drops(arch):
    """``test_models_smoke.py::test_smoke_decode_consistency`` for the
    port: at capacity factor 64 no copy drops, so prefill + one decode
    step equals ``forward``'s last position (its tolerance, 2e-3), and the
    decode step equals the reference's."""
    cfg = fp32_config(arch, capacity_factor=64.0)
    jm, params, tm = model_pair(cfg)
    toks = _tokens(cfg, (2, 20), seed=3)
    full, _ = tm.forward(to_torch(toks))
    state, _ = tm.prefill(to_torch(toks[:, :-1]), max_seq=22)
    state, step = tm.decode_step(state, to_torch(toks[:, -1]))
    np.testing.assert_allclose(step.numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)
    ref_state, _ = jm.prefill(params, jnp.asarray(toks[:, :-1]), max_seq=22)
    _, ref_step = jm.decode_step(params, ref_state, jnp.asarray(toks[:, -1]))
    _close(step, ref_step)


# ------------------------------------------------------- construction


def test_convert_keeps_the_router_fp32_at_bf16():
    """A bf16 MoE config: ``layers.moe.router`` stays float32, every other
    leaf is bf16, and every shape is the reference ``init``'s."""
    for arch in ARCHS:
        cfg = jax_get_reduced(arch)
        assert cfg.dtype == "bfloat16"
        params = to_numpy(jax_build_model(cfg).init(jax.random.PRNGKey(0)))
        sd = params_from_numpy(_port_cfg(cfg), params)
        flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
        ref_shapes = {".".join(p.key for p in path): leaf.shape
                      for path, leaf in flat.items()}
        assert {n: tuple(t.shape) for n, t in sd.items()} == ref_shapes
        for name, t in sd.items():
            want = torch.float32 if name == "layers.moe.router" \
                else torch.bfloat16
            assert t.dtype == want, name
        model = build_model(_port_cfg(cfg), device="cpu")
        model.load_state_dict(sd)
        assert model.layers.moe.router.dtype == torch.float32
        assert not hasattr(model.layers, "mlp")


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_and_init_at_the_reference_distributions(arch):
    """``build_model`` builds the MoE configs (the full ones on the meta
    device: shapes only), and ``init`` draws N(0, 1) / sqrt(fan_in),
    fan_in = shape[-2], as ``init_moe_params``."""
    full = build_model(get_config(arch), device="meta")
    assert full.layers.moe.wg.shape == (
        full.cfg.num_layers, full.cfg.num_experts, full.cfg.d_model,
        full.cfg.expert_d_ff)
    cfg = dataclasses.replace(get_config(arch), num_layers=1, d_model=64,
                              expert_d_ff=96, vocab_size=512,
                              dtype="float32")
    tm = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    for name, t in tm.layers.moe.named_parameters():
        std = t.shape[-2] ** -0.5
        assert abs(float(t.std()) - std) < 0.1 * std, name
    assert tm.layers.moe.router.dtype == torch.float32


# ----------------------------------------------------------- the engine


def _requests(module, vocab):
    """Two requests share a 20-token prefix (past a 16-token page and
    llama4's window); greedy and temperature 0.8 / top-k 5."""
    rng = np.random.default_rng(41)
    shared = rng.integers(0, vocab, 20).astype(np.int32)
    specs = [
        (shared.copy(), 8, 0.0, 0),
        (rng.integers(0, vocab, 12).astype(np.int32), 5, 0.8, 5),
        (np.concatenate([shared, rng.integers(0, vocab, 6)]).astype(
            np.int32), 6, 0.0, 0),
        (rng.integers(0, vocab, 27).astype(np.int32), 5, 0.0, 0),
    ]
    return [
        module.Request(prompt=p, max_new_tokens=n, request_id=i,
                       temperature=t, top_k=k, seed=300 + i,
                       tenant="alice" if i % 2 else "bob")
        for i, (p, n, t, k) in enumerate(specs)
    ]


@pytest.mark.parametrize("arch,scfg,mode", [
    (QWEN, {}, "paged"),
    (QWEN, {"prefill_chunk_tokens": 7}, "paged"),
    (LLAMA, {}, "dense"),
], ids=["qwen3-paged", "qwen3-paged-chunked", "llama4-dense"])
def test_engine_matches_reference(arch, scfg, mode, monkeypatch):
    """The engine on the MoE configs at their own capacity factor (copies
    drop in prefill as the reference drops them) against the reference
    engine on the same weights: ``kv_mode="auto"`` resolves alike, every
    sampled step's logits allclose, and the token streams, trace, prefill
    counts, stats and page and slot ledgers equal."""
    jm, params, tm = model_pair(fp32_config(arch))
    kw = dict(max_batch=2, max_seq=48, step_time_s=0.01, **scfg)
    logits, engines, reqs = [], [], []
    for module, engine in (
            (jax_loop, jax_loop.ServingEngine(
                jm, params, jax_loop.ServerConfig(**kw),
                executor=JaxSim(seed=5))),
            (port_loop, ServingEngine(tm, ServerConfig(**kw),
                                      executor=PortSim(seed=5)))):
        seen = {}
        real = module.sample_token

        def spy(lg, _seen=seen, _real=real, **k):
            _seen[(k["seed"], k["index"])] = np.array(lg, np.float64)
            return _real(lg, **k)

        rs = _requests(module, tm.cfg.vocab_size)
        with monkeypatch.context() as mp:
            mp.setattr(module, "sample_token", spy)
            with _routing_margin(mp) as margin:
                for r in rs:
                    engine.submit(r)
                engine.drain()
        logits.append(seen)
        engines.append(engine)
        reqs.append(rs)
    ref, port = engines
    assert port.kv_mode == ref.kv_mode == mode
    assert sorted(logits[1]) == sorted(logits[0])
    msg = f"smallest router margin of the port's run {margin[0]:.3g}"
    for key, ref_row in logits[0].items():
        np.testing.assert_allclose(logits[1][key], ref_row, err_msg=msg,
                                   **TOL)
    assert all(r.error is None for r in reqs[1])
    assert_engines_match(ref, port, reqs[0], reqs[1], ctx=arch)
    if mode == "paged":
        assert port.serving_stats()["prefix_hits_total"] >= 1
    if scfg:
        assert any(" prefill_chunk " in ln for ln in port.trace())
