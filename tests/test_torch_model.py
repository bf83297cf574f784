"""Port parity: ``repro_torch.models`` against the reference transformer.

Weights are the reference's ``init(PRNGKey(0))`` carried over with
``params_from_numpy``; both models run at fp32 on the CPU, the port through
its kernels' plain versions.  Tolerance: ``rtol = atol = 1e-4`` on logits
and K/V rows — both sides compute in fp32, and the port's full-softmax
prefill attention sums in another order than the reference's blockwise
XLA attention over a few layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_port import fp32_config, model_pair, to_numpy, to_torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.attention import attention_block as jax_attention_block
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import TransformerLM, build_model
from repro_torch.models.attention import attention_block

TOL = dict(rtol=1e-4, atol=1e-4)

#: (arch, overrides): the qwen2.5-32b smoke config (K = 1), a K = 2
#: variant of it, and starcoder2-7b's plain GELU-tanh MLP
DENSE = [
    ("qwen2.5-32b", {}),
    ("qwen2.5-32b", {"num_heads": 4, "num_kv_heads": 2}),
    ("starcoder2-7b", {}),
]
PAGE = 4


@pytest.fixture(scope="module", params=DENSE, ids=["qwen", "qwen-k2",
                                                   "starcoder2"])
def pair(request):
    arch, over = request.param
    return model_pair(fp32_config(arch, **over))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------------------------------------- forward


def test_forward_logits_match_reference(pair):
    jm, params, tm = pair
    toks = _tokens(tm.cfg, (2, 13))
    ref, _ = jm.forward(params, jnp.asarray(toks))
    out, aux = tm.forward(to_torch(toks))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert float(aux) == 0.0


def test_prefill_state_and_logits_match_reference(pair):
    jm, params, tm = pair
    toks = _tokens(tm.cfg, (1, 11), seed=1)
    ref_state, ref_logits = jm.prefill(params, jnp.asarray(toks), max_seq=16)
    state, logits = tm.prefill(to_torch(toks), max_seq=16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    for key in ("cache_k", "cache_v"):
        np.testing.assert_allclose(state[key].numpy(),
                                   np.asarray(ref_state[key]), **TOL)
    assert state["pos"].tolist() == np.asarray(ref_state["pos"]).tolist()


def test_gemma2_forward_window_softcap_post_norms():
    """Windows, attention and final softcaps, sandwich norms and embed
    scaling through the plain flash path (gemma2 is not paged-capable)."""
    jm, params, tm = model_pair(fp32_config("gemma2-9b"))
    toks = _tokens(tm.cfg, (1, 20), seed=2)        # > the 8-token window
    ref, _ = jm.forward(params, jnp.asarray(toks))
    out, _ = tm.forward(to_torch(toks))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not tm.supports_paged_decode


def test_attention_block_matches_reference_flash_kernel():
    """The module holding K2 against the reference's attention block on
    its Pallas flash kernel (interpret mode)."""
    cfg = fp32_config("qwen2.5-32b", num_heads=4, num_kv_heads=2)
    jm, params, tm = model_pair(cfg)
    p_jax = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["attn"])
    p_port = {k: to_torch(v) for k, v in to_numpy(p_jax).items()}
    x = np.random.default_rng(3).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    ref, (rk, rv) = jax_attention_block(
        jnp.asarray(x), p_jax, cfg, window=0, rope_base=cfg.rope_base,
        impl="pallas", return_kv=True)
    out, (k, v) = attention_block(to_torch(x), p_port, tm.cfg, window=0,
                                  rope_base=cfg.rope_base, return_kv=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(rk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), **TOL)


# --------------------------------------------------------------- paged


@pytest.fixture(scope="module")
def scenario(pair):
    """Two prompts prefilled into permuted pages of both pools, once per
    config: sequence 0 holds 5 tokens in pages [3, 7], sequence 1 holds 9
    tokens in pages [0, 11, 5].  Tests clone the port's pool before they
    write to it."""
    jm, params, tm = pair
    cfg = tm.cfg
    jpool = jm.init_paged_state(24, PAGE)
    tpool = tm.init_paged_state(24, PAGE)
    logits = []
    for sid, (n, pages) in enumerate([(5, [3, 7]), (9, [0, 11, 5])]):
        toks = _tokens(cfg, (1, n), seed=10 + sid)
        page_ids = np.asarray([pages[i // PAGE] for i in range(n)], np.int32)
        offsets = np.asarray([i % PAGE for i in range(n)], np.int32)
        jrows, jlog = jm.paged_prefill(params, jnp.asarray(toks))
        trows, tlog = tm.paged_prefill(to_torch(toks))
        logits.append((tlog, jlog))
        jpool = jm.paged_write_prefill(jpool, jrows, jnp.asarray(page_ids),
                                       jnp.asarray(offsets))
        tpool = tm.paged_write_prefill(tpool, trows, page_ids, offsets)
    return jpool, tpool, logits


def _clone(pool):
    return {k: v.clone() for k, v in pool.items()}


def _assert_pools_close(tpool, jpool):
    for key in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tpool[key].numpy(),
                                   np.asarray(jpool[key]), **TOL)


def test_paged_write_prefill_matches_reference(scenario):
    jpool, tpool, logits = scenario
    _assert_pools_close(tpool, jpool)
    for tlog, jlog in logits:
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


def test_paged_decode_step_matches_reference(pair, scenario):
    """Ragged positions, a dead row (all -1) and a lane whose write page
    is not mapped yet: those two write nowhere, as the reference's dropped
    out-of-bounds scatter does; the table is padded with -1 past the
    power-of-two bucket the engine would pick."""
    jm, params, tm = pair
    jpool, tpool, _ = scenario
    tpool = _clone(tpool)
    table = np.full((4, 8), -1, np.int32)
    table[0, :2] = [3, 7]
    table[1, :3] = [0, 11, 5]
    table[3, :1] = [9]                     # pos 4 -> logical page 1: unmapped
    pos = np.asarray([5, 9, 0, 4], np.int32)
    toks = _tokens(tm.cfg, (4,), seed=4)
    jpool, jlog = jm.paged_decode_step(params, jpool, jnp.asarray(toks),
                                       jnp.asarray(table), jnp.asarray(pos))
    tpool, tlog = tm.paged_decode_step(tpool, to_torch(toks),
                                       to_torch(table), to_torch(pos))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _assert_pools_close(tpool, jpool)


def test_paged_decode_is_width_invariant(pair, scenario):
    """A live row's logits are bitwise equal at table widths W and 2W."""
    _, tpool0, _ = scenario
    tm = pair[2]
    out = []
    for width in (4, 8):
        table = np.full((2, width), -1, np.int32)
        table[0, :2] = [3, 7]
        table[1, :3] = [0, 11, 5]
        pos = np.asarray([5, 9], np.int32)
        _, logits = tm.paged_decode_step(_clone(tpool0), to_torch(_tokens(
            tm.cfg, (2,), seed=5)), to_torch(table), to_torch(pos))
        out.append(logits)
    assert torch.equal(out[0], out[1])


def test_paged_decode_with_no_live_lane_leaves_pool_unchanged(pair, scenario):
    """Every lane dead (empty rows, or a write page past the table): the pool
    comes back bitwise equal, page 0's first row included."""
    _, tpool0, _ = scenario
    tm = pair[2]
    table = np.full((3, 4), -1, np.int32)
    table[2, :1] = [9]                     # pos 20 -> logical page 5: past W
    pool, _ = tm.paged_decode_step(_clone(tpool0), to_torch(_tokens(
        tm.cfg, (3,), seed=8)), to_torch(table),
        to_torch(np.asarray([0, 3, 20], np.int32)))
    for key in ("k_pages", "v_pages"):
        assert torch.equal(pool[key], tpool0[key])


def test_paged_decode_continues_prefill_like_forward(pair):
    """Prefill rows into pages, then one decode step, equals the full
    forward's last-position logits over prompt + token (self-consistency
    of the port's paged path, independent of the reference)."""
    _, _, tm = pair
    toks = _tokens(tm.cfg, (1, 7), seed=6)
    pool = tm.init_paged_state(8, PAGE)
    rows, _ = tm.paged_prefill(to_torch(toks))
    tm.paged_write_prefill(pool, rows, [2] * 4 + [5] * 3, [0, 1, 2, 3, 0, 1, 2])
    nxt = _tokens(tm.cfg, (1,), seed=7)
    table = torch.tensor([[2, 5]], dtype=torch.int32)
    _, logits = tm.paged_decode_step(pool, to_torch(nxt), table,
                                     torch.tensor([7], dtype=torch.int32))
    full, _ = tm.forward(to_torch(np.concatenate([toks, nxt[None]], axis=1)))
    torch.testing.assert_close(logits[0], full[0, -1], **TOL)


def test_paged_prefill_at_matches_reference(pair, scenario):
    """Suffix prefill attending through resident prefix rows."""
    jm, params, tm = pair
    jpool, tpool, _ = scenario
    # sequence 1's first 6 tokens are resident; prefill 4 more after them
    suffix = _tokens(tm.cfg, (1, 4), seed=8)
    table = np.asarray([[0, 11, 5, -1]], np.int32)
    jrows, jlog = jm.paged_prefill_at(params, jnp.asarray(suffix), jpool,
                                      jnp.asarray(table), 6)
    trows, tlog = tm.paged_prefill_at(to_torch(suffix), tpool,
                                      to_torch(table), 6)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(trows[key].numpy(),
                                   np.asarray(jrows[key]), **TOL)


def test_paged_copy_page_matches_reference(pair, scenario):
    jm, params, tm = pair
    jpool, tpool, _ = scenario
    tpool = _clone(tpool)
    jpool = jm.paged_copy_page(jpool, 11, 20)
    same = tm.paged_copy_page(tpool, 11, 20)
    assert same is tpool                     # in place
    _assert_pools_close(tpool, jpool)
    assert torch.equal(tpool["k_pages"][:, 20], tpool["k_pages"][:, 11])


# ------------------------------------------------------- construction


def test_init_uses_the_reference_distributions():
    cfg = dataclasses.replace(fp32_config("qwen2.5-32b"), d_model=64,
                              d_ff=256, vocab_size=512)
    from repro_torch.models.common import ArchConfig

    tm = TransformerLM(ArchConfig(**dataclasses.asdict(cfg)), device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    D, F = cfg.d_model, cfg.d_ff
    assert abs(float(tm.embed.std()) - D ** -0.5) < 0.1 * D ** -0.5
    assert abs(float(tm.layers.mlp.wd.std()) - F ** -0.5) < 0.1 * F ** -0.5
    assert abs(float(tm.layers.attn.wq.std()) - D ** -0.5) < 0.1 * D ** -0.5
    assert float(tm.layers.attn.bq.abs().max()) == 0.0
    assert torch.equal(tm.layers.ln1, torch.ones_like(tm.layers.ln1))
    assert torch.equal(tm.final_norm, torch.ones_like(tm.final_norm))


def test_unported_families_and_absent_cuda_raise():
    """Every family the reference builds is ported now: only a family the
    reference does not know raises, with its ``ValueError``; CUDA asked
    for and absent raises and never falls back to the CPU."""
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(get_config("qwen2.5-32b"),
                                        family="diffusion"), device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(dataclasses.replace(
                get_config("qwen2.5-32b"), num_layers=1), device="cuda")


def _leaf_name(path) -> str:
    return ".".join(str(k.key) for k in path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_model_builds_every_arch_like_the_reference(arch):
    """The published config of each of the ten archs builds on the meta
    device with the reference's parameter tree: the same leaves (names,
    shapes, dtypes, from ``jax.eval_shape`` of its ``init``) and so the
    same parameter count."""
    ref = jax.eval_shape(jax_build_model(jax_get_config(arch)).init,
                         jax.random.PRNGKey(0))
    want = {_leaf_name(path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
    model = build_model(get_config(arch), device="meta")
    got = {name: (tuple(t.shape), str(t.dtype)[6:])
           for name, t in model.state_dict().items()}
    assert got == want
    assert sum(t.numel() for t in model.parameters()) == sum(
        int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(ref))
