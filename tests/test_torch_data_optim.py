"""The port's data pipeline, schedule and AdamW against the reference's.

Batches are numpy arrays and must be byte-equal to the reference's for the
same (seed, step, host); the tokenizer is a copy.  ``lr_at`` and
``clip_by_global_norm`` compute in fp32 as the reference does: they are
held to rtol 1e-6 (the two libraries' ``cos``, ``pow`` and reductions may
round differently in the last place).  The weight-decay mask equals the
reference's leaf by leaf on every arch's reduced config.  One
``adamw_update`` step matches the reference's in fp32 within rtol 1e-6 /
atol 1e-7 (moments, the new parameters and the norm), and in bf16 the new
parameters within one bf16 ulp of the reference's.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as J
import repro.optim as JO
import repro_torch.data as T
import repro_torch.optim as TO
from repro.configs import get_reduced as ref_get_reduced
from repro.models import build_model as ref_build_model
from repro.optim.adamw import _decay_mask as ref_decay_mask
from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.core import (LegacyFilterPolicy, ModernEmulationPolicy,
                              Sandbox, SandboxViolation)
from repro_torch.core.gofer import Gofer
from repro_torch.models import build_model
from repro_torch.models.common import param_tree
from repro_torch.optim.adamw import _decay_mask
from repro_torch.tree import keystr, tree_flatten_with_path, tree_leaves

FP32 = dict(rtol=1e-6, atol=1e-7)


@torch.library.custom_op("seepp_data_optim::leak", mutates_args=())
def _leak(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@_leak.register_fake
def _(x):
    return torch.empty_like(x)


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("kw", [
    dict(global_batch=4, seq_len=16, vocab_size=100),
    dict(global_batch=8, seq_len=33, vocab_size=256000, seed=3),
    dict(global_batch=8, seq_len=16, vocab_size=1000, num_hosts=2,
         host_index=1),
])
def test_synthetic_batches_equal_the_references(kw):
    ours, theirs = T.SyntheticLM(T.DataConfig(**kw)), \
        J.SyntheticLM(J.DataConfig(**kw))
    for step in (0, 1, 7, 1000):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_file_backed_batches_equal_the_references(tmp_path):
    from repro.core.gofer import Gofer as RefGofer

    tok = T.ByteTokenizer()
    corpus = tok.encode("the quick brown fox " * 200, bos=False)
    Gofer.for_root("data", tmp_path, write=True).write_bytes(
        "data", "corpus.bin", corpus.astype(np.uint16).tobytes())
    kw = dict(global_batch=4, seq_len=32, vocab_size=tok.vocab_size, seed=2)
    ours = T.FileBackedLM(T.DataConfig(**kw), Gofer.for_root("data", tmp_path),
                          "data", "corpus.bin")
    theirs = J.FileBackedLM(J.DataConfig(**kw),
                            RefGofer.for_root("data", tmp_path),
                            "data", "corpus.bin")
    for step in (0, 5):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    assert (a["targets"][:, :-1] == a["tokens"][:, 1:]).all()


def test_loader_keeps_its_order():
    cfg = T.DataConfig(global_batch=2, seq_len=8, vocab_size=50)
    loader = T.Loader(T.SyntheticLM(cfg), cfg, start_step=3)
    it = iter(loader)
    batches = [next(it) for _ in range(4)]
    loader.stop()
    ref = J.SyntheticLM(J.DataConfig(global_batch=2, seq_len=8, vocab_size=50))
    for i, got in enumerate(batches):
        np.testing.assert_array_equal(got["tokens"],
                                      ref.batch_at(3 + i)["tokens"])


def _mask_evens(batch):
    lm = batch["loss_mask"] * (batch["targets"] % 2).to(torch.float32)
    return dict(batch, loss_mask=lm)


def test_sandboxed_transform_is_admitted_and_applied():
    cfg = T.DataConfig(global_batch=2, seq_len=8, vocab_size=50)
    box = Sandbox(policy=ModernEmulationPolicy())
    loader = T.Loader(T.SyntheticLM(cfg), cfg).with_transform(_mask_evens,
                                                              box)
    it = iter(loader)
    batch = next(it)
    loader.stop()
    assert isinstance(batch["loss_mask"], np.ndarray)
    assert (batch["loss_mask"] == (batch["targets"] % 2)).all()
    assert [e.kind for e in box.audit].count("verify") == 1
    assert "run" in [e.kind for e in box.audit]


@pytest.mark.parametrize("fn,policy", [
    (lambda b: dict(b, tokens=_leak(b["tokens"])), ModernEmulationPolicy()),
    (lambda b: dict(b, loss_mask=torch.erf(b["loss_mask"])),
     LegacyFilterPolicy()),
])
def test_transform_admission_denied(fn, policy):
    cfg = T.DataConfig(global_batch=2, seq_len=8, vocab_size=50)
    with pytest.raises(SandboxViolation):
        T.Loader(T.SyntheticLM(cfg), cfg).with_transform(
            fn, Sandbox(policy=policy))


def test_byte_tokenizer_roundtrip():
    tok, ref = T.ByteTokenizer(), J.ByteTokenizer()
    text = "SEE++ sandbox: gVisor→GPU 🤖"
    ids = tok.encode(text, bos=True, eos=True)
    np.testing.assert_array_equal(ids, ref.encode(text, bos=True, eos=True))
    assert ids[0] == tok.bos_id and ids[-1] == tok.eos_id
    assert tok.decode(ids) == text
    batch = tok.pad_batch([ids, ids[:5]], 12)
    np.testing.assert_array_equal(batch, ref.pad_batch([ids, ids[:5]], 12))
    assert (batch[1, 5:] == tok.pad_id).all()


# -------------------------------------------------------------- schedule


@pytest.mark.parametrize("kind", ["cosine", "constant", "rsqrt"])
def test_lr_at_matches_the_reference(kind):
    kw = dict(peak_lr=3e-3, warmup_steps=10, decay_steps=60, min_ratio=0.1,
              kind=kind)
    ours, theirs = TO.ScheduleConfig(**kw), JO.ScheduleConfig(**kw)
    got = np.array([float(TO.lr_at(s, ours)) for s in range(80)])
    want = np.array([float(JO.lr_at(s, theirs)) for s in range(80)])
    np.testing.assert_allclose(got, want, **FP32)
    t = TO.lr_at(torch.tensor(12, dtype=torch.int32), ours)
    assert t.dtype == torch.float32 and t.shape == ()


# ----------------------------------------------------------------- AdamW


def _grads(rng, shapes, dtype=np.float32):
    return {k: (rng.standard_normal(s) * 3).astype(dtype)
            for k, s in shapes.items()}


def test_clip_by_global_norm_matches_the_reference(rng):
    g = _grads(rng, {"a": (4, 7), "b": (3,), "c": (2, 2, 5)})
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    clipped, gnorm = TO.clip_by_global_norm(tg, 1.0)
    ref_clipped, ref_gnorm = JO.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(gnorm), float(ref_gnorm), **FP32)
    for k in g:
        np.testing.assert_allclose(clipped[k].numpy(),
                                   np.asarray(ref_clipped[k]), **FP32)
    small = {"a": torch.full((4,), 0.1)}
    unclipped, _ = TO.clip_by_global_norm(small, 1.0)
    assert torch.equal(unclipped["a"], small["a"])


def _mask_pairs(arch):
    """(path → decays) of the port's and of the reference's mask for the
    arch's reduced config (the reference's from ``eval_shape``, the port's
    on the meta device: the mask reads only paths and ranks)."""
    ref_model = ref_build_model(ref_get_reduced(arch))
    shapes = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    ref = jax.tree_util.tree_flatten_with_path(
        ref_decay_mask(shapes, JO.AdamWConfig().no_decay))[0]
    want = {jax.tree_util.keystr(p): bool(m) for p, m in ref}
    params = param_tree(build_model(get_reduced(arch), device="meta"))
    got = {keystr(p): bool(m) for p, m in tree_flatten_with_path(
        _decay_mask(params, TO.AdamWConfig().no_decay))}
    return got, want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decay_mask_matches_the_reference_leaf_by_leaf(arch):
    got, want = _mask_pairs(arch)
    assert list(got) == list(want)
    assert got == want


def test_decay_mask_pins_the_references_choices():
    """Stacked layers make per-layer vectors 2-D and ``"/u"`` never
    matches a keystr: RWKV's ``u``, ``w0``, ``mu_x``, ``mu_rkvwg`` and the
    hybrid's ``A_log`` and ``D_skip`` decay, every norm and ``dt_bias``
    does not."""
    rwkv, _ = _mask_pairs("rwkv6-3b")
    for leaf in ("u", "w0", "mu_x", "mu_rkvwg", "wr"):
        assert rwkv[f"['layers']['{leaf}']"], leaf
    for leaf in ("ln1", "ln2", "lnx_scale", "lnx_bias"):
        assert not rwkv[f"['layers']['{leaf}']"], leaf
    hybrid, _ = _mask_pairs("hymba-1.5b")
    assert hybrid["['layers']['ssm']['A_log']"]
    assert hybrid["['layers']['ssm']['D_skip']"]
    assert not hybrid["['layers']['ssm']['dt_bias']"]
    assert not hybrid["['layers']['attn_norm']"]
    gemma, _ = _mask_pairs("gemma2-9b")
    assert not gemma["['final_norm']"] and gemma["['embed']"]


def _adamw_inputs(rng, dtype):
    shapes = {"layers": {"ln1": (3, 8), "w": (3, 8, 16)}, "embed": (32, 8),
              "bias": (16,)}
    params = {"layers": _grads(rng, shapes["layers"]),
              "embed": _grads(rng, {"e": shapes["embed"]})["e"],
              "bias": _grads(rng, {"b": shapes["bias"]})["b"]}
    grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.5
                                    ).astype(np.float32), params)
    jparams = jax.tree.map(lambda p: jnp.asarray(p, dtype), params)
    jgrads = jax.tree.map(lambda g: jnp.asarray(g, dtype), grads)
    return jparams, jgrads


def _to_torch_tree(tree):
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(conv, tree)


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(rng, dtype, inplace):
    jparams, jgrads = _adamw_inputs(rng, getattr(jnp, dtype))
    cfg = JO.AdamWConfig(weight_decay=0.1, clip_norm=1.0)
    jstate = JO.adamw_init(jparams)
    # two steps: the second runs on non-zero moments and step 2
    for _ in range(2):
        jparams, jstate, jgnorm = JO.adamw_update(jgrads, jstate, jparams,
                                                  3e-3, cfg)
    params, grads = _to_torch_tree(_adamw_inputs(
        np.random.default_rng(0), getattr(jnp, dtype))[0]), \
        _to_torch_tree(jgrads)
    tcfg = TO.AdamWConfig(weight_decay=0.1, clip_norm=1.0)
    state = TO.adamw_init(params)
    for _ in range(2):
        new, state, gnorm = TO.adamw_update(grads, state, params,
                                            3e-3, tcfg, inplace=inplace)
        if inplace:     # the same tensors, overwritten
            assert all(a is b for a, b in zip(tree_leaves(new),
                                              tree_leaves(params)))
        params = new
    assert int(state["step"]) == 2 and state["step"].dtype == torch.int32
    np.testing.assert_allclose(float(gnorm), float(jgnorm), **FP32)
    for (path, p), (_, m), (_, v) in zip(
            tree_flatten_with_path(params),
            tree_flatten_with_path(state["mu"]),
            tree_flatten_with_path(state["nu"])):
        ref_p = np.asarray(_lookup(jparams, path)).astype(np.float32)
        np.testing.assert_allclose(m.numpy(),
                                   np.asarray(_lookup(jstate["mu"], path)),
                                   **FP32)
        np.testing.assert_allclose(v.numpy(),
                                   np.asarray(_lookup(jstate["nu"], path)),
                                   **FP32)
        got = p.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, ref_p, **FP32)
        else:   # one bf16 ulp: 2**-7 of the value's binade
            ulp = 2.0 ** (np.floor(np.log2(np.abs(ref_p) + 1e-30)) - 7)
            assert (np.abs(got - ref_p) <= ulp).all(), path


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_adamw_decays_only_masked_leaves():
    params = {"layers": {"ln1": torch.ones(2, 4), "mlp": {"wd": torch.ones(4, 4)}}}
    state = TO.adamw_init(params)
    zero = {"layers": {"ln1": torch.zeros(2, 4),
                       "mlp": {"wd": torch.zeros(4, 4)}}}
    new, _, _ = TO.adamw_update(zero, state, params, 0.1,
                                TO.AdamWConfig(weight_decay=1.0))
    assert torch.equal(new["layers"]["ln1"], params["layers"]["ln1"])
    assert (new["layers"]["mlp"]["wd"] < 1.0).all()


def test_adamw_converges_on_a_quadratic():
    params = {"x": torch.tensor([5.0, -3.0])}
    state = TO.adamw_init(params)
    cfg = TO.AdamWConfig(weight_decay=0.0)
    for _ in range(300):
        params, state, _ = TO.adamw_update({"x": 2 * params["x"]}, state,
                                           params, 0.05, cfg)
    assert float(params["x"].abs().max()) < 1e-2
