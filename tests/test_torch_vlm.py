"""Port parity: the VLM family (``TransformerLM`` with a patch-embedding
prefix) against the reference's transformer.

Weights are the reference's ``init(PRNGKey(0))`` on the reduced
llava-next-34b config at fp32 (3 layers, width 64, 8 q / 2 kv heads of 8,
4 patches, untied unembedding), carried over with ``params_from_numpy``;
patch embeddings are seeded numpy arrays.  As in the reference, the
prefix enters through ``forward`` and the dense ``prefill`` only: the
engine serves text, in paged mode.

Tolerance: ``rtol = atol = 2e-3``, the reference's own in
``tests/test_models_smoke.py``; both sides compute in fp32.  Served token
streams are compared exactly; a greedy token may only differ where the
reference's top-2 logit margin is below ``MARGIN_TOL``, and the seeds are
fixed so that none does.
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
from repro_torch.core.sim import SimExecutor as PortSim
from repro_torch.models import TransformerLM
from repro_torch.runtime import ServerConfig, ServingEngine

TOL = dict(rtol=2e-3, atol=2e-3)
MARGIN_TOL = 2 * (2e-3 + 2e-3 * 3)


@pytest.fixture(scope="module")
def pair():
    return model_pair(fp32_config("llava-next-34b"))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _patches(cfg, B, seed=0, n=None):
    return np.random.default_rng(seed).standard_normal(
        (B, n or cfg.num_patches, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------- forward


@pytest.mark.parametrize("with_patches", [True, False])
def test_forward_logits_match_reference(pair, with_patches):
    jm, params, model = pair
    assert isinstance(model, TransformerLM) and model.cfg.family == "vlm"
    toks = _tokens(model.cfg, (2, 20), seed=1)
    pe = _patches(model.cfg, 2, seed=1) if with_patches else None
    ref, _ = jm.forward(params, jnp.asarray(toks), patch_embeds=(
        None if pe is None else jnp.asarray(pe)))
    out, aux = model.forward(to_torch(toks), patch_embeds=(
        None if pe is None else to_torch(pe)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert float(aux) == 0.0


def test_patches_replace_the_prefix_rows(pair):
    """The prefix's tokens do not matter; the rest do."""
    _, _, model = pair
    toks = to_torch(_tokens(model.cfg, (1, 12), seed=2))
    pe = to_torch(_patches(model.cfg, 1, seed=2))
    other = toks.clone()
    other[:, :4] = (other[:, :4] + 1) % model.cfg.vocab_size
    a, _ = model.forward(toks, patch_embeds=pe)
    b, _ = model.forward(other, patch_embeds=pe)
    assert torch.equal(a, b)
    other[:, 4] = (other[:, 4] + 1) % model.cfg.vocab_size
    c, _ = model.forward(other, patch_embeds=pe)
    assert not torch.equal(a[:, 4:], c[:, 4:])


@pytest.mark.parametrize("arch,over", [
    ("llava-next-34b", {"embed_scale": True}),
    ("llama4-scout-17b-a16e", {})])
def test_embed_inputs_match_reference(arch, over):
    """The prefix is placed after gemma's embedding scale and cast to the
    model's dtype (bf16 here), for the VLM and for llama4's early fusion."""
    cfg = dataclasses.replace(fp32_config(arch, **over), dtype="bfloat16")
    jm, params, model = model_pair(cfg)
    toks = _tokens(cfg, (2, 9), seed=3)
    pe = _patches(cfg, 2, seed=3)
    ref = jm._embed_inputs(params, jnp.asarray(toks), jnp.asarray(pe))
    out = model._embed_inputs(to_torch(toks), to_torch(pe))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_llama4_forward_with_patches_matches_reference():
    jm, params, model = model_pair(fp32_config("llama4-scout-17b-a16e"))
    toks = _tokens(model.cfg, (1, 24), seed=4)
    pe = _patches(model.cfg, 1, seed=4)
    ref, _ = jm.forward(params, jnp.asarray(toks),
                        patch_embeds=jnp.asarray(pe))
    out, _ = model.forward(to_torch(toks), patch_embeds=to_torch(pe))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# ------------------------------------------------------------ prefill


def test_prefill_with_patches_and_decode_match_reference(pair):
    """The dense prefill over a 4-patch prefix into a longer cache, then
    three decode steps, against the reference's."""
    jm, params, model = pair
    toks = _tokens(model.cfg, (2, 14), seed=5)
    pe = _patches(model.cfg, 2, seed=5)
    ref_state, ref_logits = jm.prefill(params, jnp.asarray(toks), max_seq=20,
                                       patch_embeds=jnp.asarray(pe))
    state, logits = model.prefill(to_torch(toks), max_seq=20,
                                  patch_embeds=to_torch(pe))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    for i in range(4):
        for name in ("cache_k", "cache_v", "pos"):
            np.testing.assert_allclose(
                state[name].numpy(), np.asarray(ref_state[name]),
                err_msg=f"{name} after {i} steps", **TOL)
        if i == 3:
            break
        nxt = _tokens(model.cfg, (2,), seed=20 + i)
        ref_state, ref_logits = jm.decode_step(params, ref_state,
                                               jnp.asarray(nxt))
        state, logits = model.decode_step(state, to_torch(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   err_msg=f"step {i}", **TOL)


def test_decode_is_consistent_with_forward(pair):
    """The reference's smoke check, with the prefix: prefill(prompt[:-1])
    and a decode step of prompt[-1] give forward's last logits."""
    _, _, model = pair
    toks = to_torch(_tokens(model.cfg, (2, 16), seed=6))
    pe = to_torch(_patches(model.cfg, 2, seed=6))
    full, _ = model.forward(toks, patch_embeds=pe)
    state, _ = model.prefill(toks[:, :-1], max_seq=16, patch_embeds=pe)
    _, logits = model.decode_step(state, toks[:, -1])
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), **TOL)


# ------------------------------------------------------------- engine


def _requests(module, vocab):
    rng = np.random.default_rng(31)
    specs = [(6, 6, 0.0, 0), (30, 4, 0.8, 5), (17, 5, 0.0, 0),
             (45, 3, 0.0, 0)]                # prompt, new, temperature, top-k
    return [
        module.Request(prompt=rng.integers(0, vocab, n).astype(np.int32),
                       max_new_tokens=new, request_id=i, temperature=t,
                       top_k=k, seed=400 + i)
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
    jm, params, model = pair
    vocab = model.cfg.vocab_size
    scfg = dict(max_batch=2, max_seq=64, step_time_s=0.01)
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


def test_served_text_streams_match_reference(served):
    (ref_engine, (ref_reqs, ref_logits)), (port_engine, (port_reqs, _)) = \
        served
    assert port_engine.kv_mode == ref_engine.kv_mode == "paged"
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
    assert_stats_match(port_engine, ref_engine)
    a = port_engine.kv
    assert a.pages_allocated == a.pages_freed == ref_engine.kv.pages_freed
    assert port_engine.admission.slot_balance() == {}


def test_converted_tree_matches_reference_leaves(pair):
    """The untied VLM's tree, leaf by leaf: names and shapes."""
    _, params, model = pair
    want = {".".join(str(k.key) for k in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(to_numpy(params))[0]}
    got = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert got == want and "unembed" in got
