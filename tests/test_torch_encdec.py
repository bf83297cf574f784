"""Port parity: ``repro_torch.models.EncDecLM`` and ``blockwise_attn``
against the reference's whisper-style encoder-decoder.

Weights are the reference's ``init(PRNGKey(0))`` on the reduced
whisper-tiny config at fp32 (2 + 2 layers, width 64, 4 heads of 16),
carried over with ``params_from_numpy``, with ``encoder_len`` 600: the
attention chunk ``min(512, Sk)`` does not divide 600, so 424 sentinel rows
pad the encoder's keys, as 36 pad the full config's 1500 frames.  Frames
are seeded numpy arrays.

Tolerance: ``rtol = atol = 2e-3``, the reference's own in
``tests/test_models_smoke.py``; both sides compute in fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_port import fp32_config, model_pair, to_numpy, to_torch

import repro.runtime.serve_loop as jax_loop
from repro.models import build_model as jax_build_model
from repro.models.attention import blockwise_attn as jax_blockwise_attn
from repro.models.encdec import sinusoids as jax_sinusoids
from repro_torch.configs import get_config
from repro_torch.models import EncDecLM, build_model, params_from_numpy
from repro_torch.models.attention import blockwise_attn
from repro_torch.models.common import ArchConfig
from repro_torch.models.encdec import sinusoids
from repro_torch.runtime import Request, ServerConfig, ServingEngine

TOL = dict(rtol=2e-3, atol=2e-3)
T_ENC = 600


@pytest.fixture(scope="module")
def pair():
    return model_pair(fp32_config("whisper-tiny", encoder_len=T_ENC))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _frames(cfg, B, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------ blockwise_attn


@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (False, 0, 0.0), (True, 5, 0.0), (True, 0, 30.0),
    (False, 6, 20.0)])
def test_blockwise_attn_matches_reference(causal, window, cap):
    """Sk = 20 over chunks of 8 (4 sentinel rows), 2 kv heads of 3 q."""
    rng = np.random.default_rng(window + int(cap))
    q = rng.standard_normal((2, 12, 2, 3, 16)).astype(np.float32)
    k = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    qpos = np.arange(8, 20, dtype=np.int32)
    kpos = np.arange(20, dtype=np.int32)
    kw = dict(scale=0.25, logit_cap=cap, causal=causal, chunk=8)
    ref = jax_blockwise_attn(*map(jnp.asarray, (q, k, v)),
                             q_positions=jnp.asarray(qpos),
                             k_positions=jnp.asarray(kpos),
                             window=jnp.asarray(window, jnp.int32), **kw)
    out = blockwise_attn(*map(to_torch, (q, k, v)),
                         q_positions=to_torch(qpos),
                         k_positions=to_torch(kpos), window=window, **kw)
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_sinusoids_match_reference():
    np.testing.assert_array_equal(sinusoids(1500, 384),
                                  jax_sinusoids(1500, 384))


# -------------------------------------------------------- model-level


def test_encode_matches_reference(pair):
    jm, params, model = pair
    frames = _frames(model.cfg, 2, seed=1)
    ref = jm.encode(params, jnp.asarray(frames))
    out = model.encode(to_torch(frames))
    assert out.shape == (2, T_ENC, model.cfg.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_forward_logits_match_reference(pair):
    jm, params, model = pair
    toks = _tokens(model.cfg, (2, 24), seed=2)
    frames = _frames(model.cfg, 2, seed=2)
    ref, _ = jm.forward(params, jnp.asarray(toks), frames=jnp.asarray(frames))
    out, aux = model.forward(to_torch(toks), frames=to_torch(frames))
    assert out.shape == (2, 24, model.cfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert float(aux) == 0.0
    # the reference's launcher passes the stub through ``patch_embeds``
    alias, _ = model.forward(to_torch(toks), patch_embeds=to_torch(frames))
    assert torch.equal(alias, out)


def test_prefill_and_decode_steps_match_reference(pair):
    """prefill's state (self and cross K/V) and logits into a longer
    cache, then three decode steps'."""
    jm, params, model = pair
    toks = _tokens(model.cfg, (2, 10), seed=3)
    frames = _frames(model.cfg, 2, seed=3)
    ref_state, ref_logits = jm.prefill(params, jnp.asarray(toks), max_seq=16,
                                       frames=jnp.asarray(frames))
    state, logits = model.prefill(to_torch(toks), max_seq=16,
                                  frames=to_torch(frames))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    assert set(state) == set(ref_state)
    for i in range(4):
        for name in ref_state:
            np.testing.assert_allclose(
                state[name].numpy(), np.asarray(ref_state[name]),
                err_msg=f"{name} after {i} steps", **TOL)
        if i == 3:
            break
        nxt = _tokens(model.cfg, (2,), seed=10 + i)
        ref_state, ref_logits = jm.decode_step(params, ref_state,
                                               jnp.asarray(nxt))
        state, logits = model.decode_step(state, to_torch(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   err_msg=f"step {i}", **TOL)


def test_decode_is_consistent_with_forward(pair):
    """The reference's smoke check: prefill(prompt[:-1]) and a decode step
    of prompt[-1] give forward's last logits."""
    _, _, model = pair
    toks = to_torch(_tokens(model.cfg, (2, 12), seed=4))
    frames = to_torch(_frames(model.cfg, 2, seed=4))
    full, _ = model.forward(toks, frames=frames)
    state, _ = model.prefill(toks[:, :-1], max_seq=12, frames=frames)
    _, logits = model.decode_step(state, toks[:, -1])
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), **TOL)


def test_decode_takes_slot_zeros_position_for_every_slot(pair):
    """The reference's quirk, copied: every lane adds ``pos_embed[pos[0]]``
    whatever its own position."""
    jm, params, model = pair
    toks = _tokens(model.cfg, (2, 6), seed=6)
    frames = _frames(model.cfg, 2, seed=6)
    ref_state, _ = jm.prefill(params, jnp.asarray(toks), max_seq=12,
                              frames=jnp.asarray(frames))
    state, _ = model.prefill(to_torch(toks), max_seq=12,
                             frames=to_torch(frames))
    skew = np.asarray([6, 3], np.int32)
    ref_state = dict(ref_state, pos=jnp.asarray(skew))
    state = dict(state, pos=to_torch(skew))
    nxt = _tokens(model.cfg, (2,), seed=7)
    _, ref_logits = jm.decode_step(params, ref_state, jnp.asarray(nxt))
    _, logits = model.decode_step(state, to_torch(nxt))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)


def test_prefill_without_frames_names_the_missing_input(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="frames"):
        model.prefill(to_torch(_tokens(model.cfg, (1, 4))))


# ------------------------------------------------------------- engine


def test_engine_fails_on_its_first_prefill_as_the_reference_does(pair):
    """The engine passes no frames: the reference's prefill fails with an
    AttributeError, the port's with a ValueError naming them."""
    jm, params, model = pair
    prompt = _tokens(model.cfg, (5,), seed=8)
    ref_engine = jax_loop.ServingEngine(jm, params,
                                        jax_loop.ServerConfig(max_seq=16))
    assert ref_engine.kv_mode == "dense"
    ref_engine.submit(jax_loop.Request(prompt=prompt, max_new_tokens=2))
    with pytest.raises(AttributeError):
        ref_engine.step()
    engine = ServingEngine(model, ServerConfig(max_seq=16))
    assert engine.kv_mode == "dense"
    engine.submit(Request(prompt=prompt, max_new_tokens=2))
    with pytest.raises(ValueError, match="frames"):
        engine.step()


# ------------------------------------------------------- construction


def test_params_from_numpy_converts_the_enc_dec_tree():
    """Every leaf of the reference's tree (encoder and decoder stacks, both
    final norms, the learned positions) lands with its shape, in bf16."""
    cfg = dataclasses.replace(fp32_config("whisper-tiny"), dtype="bfloat16")
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    tcfg = ArchConfig(**dataclasses.asdict(cfg))
    sd = params_from_numpy(tcfg, to_numpy(params))
    leaves = {".".join(str(k.key) for k in path): leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(sd) == set(leaves)
    assert {"pos_embed", "enc_final_ln.scale", "dec_final_ln.bias",
            "enc_layers.attn.wq", "dec_layers.cross_attn.bv"} <= set(sd)
    for name, leaf in leaves.items():
        assert tuple(sd[name].shape) == leaf.shape, name
        assert str(sd[name].dtype)[6:] == str(leaf.dtype), name
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(sd)
    assert model.pos_embed.shape == (32768 + 8, cfg.d_model)


def test_init_uses_the_reference_distributions():
    cfg = dataclasses.replace(fp32_config("whisper-tiny"), d_model=128,
                              num_heads=4, num_kv_heads=4, d_ff=512,
                              vocab_size=512, dtype="bfloat16")
    model = EncDecLM(ArchConfig(**dataclasses.asdict(cfg)), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    D, F = cfg.d_model, cfg.d_ff
    E, Dl = model.enc_layers, model.dec_layers
    for t, std in ((model.embed, D ** -0.5), (model.pos_embed, 0.01),
                   (E.attn.wq, D ** -0.5), (E.attn.wo, D ** -0.5),
                   (Dl.cross_attn.wk, D ** -0.5), (E.mlp.w1, D ** -0.5),
                   (Dl.mlp.w2, F ** -0.5)):
        assert abs(float(t.float().std()) - std) < 0.1 * std
    for t in (E.ln1.scale, Dl.ln_x.scale, model.enc_final_ln.scale,
              model.dec_final_ln.scale):
        assert torch.equal(t, torch.ones_like(t))
    for t in (E.attn.bq, Dl.self_attn.bv, Dl.cross_attn.bo, E.mlp.b1,
              Dl.ln2.bias, model.dec_final_ln.bias):
        assert float(t.float().abs().max()) == 0.0
    assert model.embed.dtype == torch.bfloat16


def test_build_model_gives_audio_its_target_positions():
    cfg = get_config("whisper-tiny")
    model = build_model(cfg, device="meta")
    assert isinstance(model, EncDecLM)
    assert model.max_target_positions == 32768 + 8
    assert build_model(cfg, device="meta",
                       max_target_positions=448).pos_embed.shape == (448, 384)
