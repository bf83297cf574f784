"""The reference's remat policies in the port (``build_model(cfg,
remat=...)``, ``models.common.remat_call``) and the chunk checkpoints of
its two scans (``models.rwkv.wkv6_scan``, ``models.hybrid.ssm_scan``).

(a) Each family's ``loss`` and every gradient under ``"full"``, ``"dots"``
    and ``"none"`` against ``jax.value_and_grad`` of the reference's
    ``loss`` built with the same ``remat`` (fp32, the tolerances of
    tests/test_torch_train_loss.py); the port's ``"dots"`` and ``"none"``
    gradients bit-equal to its ``"full"`` ones.  The hybrid and RWKV6 run
    at T = 128, two chunks of their scans.
(b) The products one layer's backward reruns, counted by a dispatch mode:
    ``"full"`` reruns every product of the forward, ``"dots"`` only those
    with a batch dimension (``bmm``), ``"none"`` none; the hybrid's
    ``"dots"`` runs as its ``"none"``.
(c) The products ``"dots"`` keeps in one layer against the residuals
    ``saved_residuals`` lists for the reference's layer under
    ``dots_with_no_batch_dims_saveable``.
(d) The scans: gradients against the reference's at T = 128, exact at a
    ragged T = 100 against the whole loop unchunked, and the bytes a
    backward keeps at T = 1024 under a quarter of one state a token.
(e) On two gloo ranks, a ``TransformerLM`` step (and a hybrid one, whose
    SSM branch gathers an activation over ``model``) under each policy
    against one device, with no gathered leaf of a layer alive when the
    backward starts.
"""

import functools
import gc
import weakref
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_dist import run_ranks
from helpers.torch_port import fp32_config, to_numpy
from helpers.torch_remat import remat_step_ranks
from helpers.torch_train import GRAD_REL, LOSS_RTOL
from jax._src.ad_checkpoint import saved_residuals
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.models.common as common
from repro.checkpoint.ckpt import tree_to_records as ref_records
from repro.models import build_model as jax_build_model
from repro.models.hybrid import ssm_scan as jax_ssm_scan
from repro.models.rwkv import wkv6_scan as jax_wkv6_scan
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.common import (ArchConfig, param_tree, remat_call,
                                       unstack_layers)
from repro_torch.models.hybrid import _ssm_chunk, ssm_scan
from repro_torch.models.rwkv import _wkv6_chunk, wkv6_scan
from repro_torch.runtime.train_loop import backward
from repro_torch.tree import tree_flatten_with_path, tree_unflatten_like

POLICIES = ["full", "dots", "none"]
#: dense (gemma2: windows, softcaps, post-norms), MoE, the VLM prefix, the
#: hybrid, RWKV6 and whisper
ARCHS = ["gemma2-9b", "qwen3-moe-235b-a22b", "llava-next-34b",
         "hymba-1.5b", "rwkv6-3b", "whisper-tiny"]
#: tokens a batch holds: two chunks of the scans for the recurrent families
SEQ = {"ssm": 128, "hybrid": 128}


def _batch(cfg, B=2, seed=0):
    """Seeded tokens, targets and a ragged loss mask (+ patch embeddings
    for the VLM, frames for whisper)."""
    S = SEQ.get(cfg.family, 16)
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return b


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """(reference config, the reference's init(PRNGKey(0)) as numpy)."""
    cfg = fp32_config(arch)
    return cfg, to_numpy(jax_build_model(cfg).init(jax.random.PRNGKey(0)))


def _port(arch, policy):
    cfg, params = _weights(arch)
    tcfg = ArchConfig(**cfg.__dict__)
    model = build_model(tcfg, device="cpu", remat=policy)
    model.load_state_dict(params_from_numpy(tcfg, params))
    return model


@functools.lru_cache(maxsize=None)
def _port_run(arch, policy):
    """The port's (loss, metrics, [(path, gradient)]) under ``policy``."""
    cfg, _ = _weights(arch)
    model = _port(arch, policy)
    tree = param_tree(model)
    flat = tree_flatten_with_path(tree)
    leaves = [t.clone().requires_grad_(True) for _, t in flat]
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss, metrics = model.loss(tree_unflatten_like(tree, leaves), batch)
    grads = backward(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            [("/".join(map(str, p)), g) for (p, _), g in zip(flat, grads)])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_the_reference(arch, policy):
    cfg, params = _weights(arch)
    ref = jax_build_model(cfg, remat=policy)
    (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(
        ref.loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in _batch(cfg).items()})
    loss, metrics, grads = _port_run(arch, policy)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    for key in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(metrics[key].item(),
                                   float(ref_metrics[key]), rtol=LOSS_RTOL,
                                   atol=1e-7)
    want = dict(ref_records(ref_grads))
    assert len(want) == len(grads)
    for key, g in grads:
        w = np.asarray(want[key])
        assert g.shape == w.shape, key
        scale = float(np.abs(w).max())
        assert scale > 0, f"{key}: the reference's gradient is zero"
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_REL * scale + 1e-7, (key, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_and_none_equal_full_bit_for_bit(arch):
    loss, _, grads = _port_run(arch, "full")
    for policy in ("dots", "none"):
        other, _, got = _port_run(arch, policy)
        assert torch.equal(other, loss), policy
        for (key, g), (_, h) in zip(grads, got):
            assert torch.equal(g, h), (policy, key)


@pytest.mark.parametrize("family_arch", ["gemma2-9b", "qwen3-moe-235b-a22b",
                                         "llava-next-34b", "hymba-1.5b",
                                         "rwkv6-3b", "whisper-tiny"])
def test_build_model_takes_the_three_policies_and_refuses_others(
        family_arch):
    cfg, _ = _weights(family_arch)
    tcfg = ArchConfig(**cfg.__dict__)
    for policy in POLICIES:
        build_model(tcfg, device="cpu", remat=policy)
    with pytest.raises(ValueError, match="remat"):
        build_model(tcfg, device="cpu", remat="offload")


def test_unflatten_keeps_no_cycle_holding_its_leaves():
    """``tree_unflatten_like`` (which turns a step's gradient list into its
    tree) leaves no reference cycle behind: with the cyclic garbage
    collector off, the leaves die with the last reference to them.  A
    self-calling closure there kept each step's gradients alive until a
    collection, which under ``remat="none"`` on the card added a step's
    gradients (5 GB for gemma2-9b x 8) to the memory of every next step."""
    was = gc.isenabled()
    gc.disable()
    try:
        leaves = [torch.zeros(8), torch.ones(4)]
        refs = [weakref.ref(t.untyped_storage()) for t in leaves]
        tree = tree_unflatten_like({"a": {"b": 0, "c": None}, "d": [1]},
                                   leaves)
        assert torch.equal(tree["d"][0], torch.ones(4))
        del leaves, tree
        assert all(r() is None for r in refs)
    finally:
        if was:
            gc.enable()


# ------------------------------------------------- (b) recompute counts

PRODUCTS = {"aten.mm.default": "mm", "aten.addmm.default": "mm",
            "aten.bmm.default": "bmm", "aten.baddbmm.default": "bmm"}


class _Products(TorchDispatchMode):
    """Counts the products dispatched on this thread: mm/addmm as ``mm``,
    bmm/baddbmm as ``bmm``."""

    def __init__(self):
        super().__init__()
        self.n = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kind = PRODUCTS.get(str(func))
        if kind:
            self.n[kind] += 1
        return func(*args, **(kwargs or {}))


def _layer_counts(arch, policy, S=16):
    """Products of one layer's forward and of its backward under
    ``policy`` (a 1-layer model's layer 0 through ``remat_call``)."""
    cfg, _ = _weights(arch)
    model = _port(arch, policy)
    p = unstack_layers(param_tree(model)["layers"], cfg.num_layers)[0]
    p = {k: ({n: t.clone().requires_grad_(True) for n, t in v.items()}
             if isinstance(v, dict) else v.clone().requires_grad_(True))
         for k, v in p.items()}
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)).requires_grad_(True)
    extra = (0, torch.arange(S)) if cfg.family != "ssm" else ()
    with _Products() as fwd:
        out = remat_call(model._train_layer, h, p, *extra,
                         policy=model.remat if cfg.family == "hybrid"
                         else policy)
        out = out[0] if isinstance(out, tuple) else out
    leaves = [h] + [t for v in p.values() for t in
                    (v.values() if isinstance(v, dict) else [v])]
    with _Products() as bwd:
        torch.autograd.grad(out.square().sum(), leaves, allow_unused=True)
    return fwd.n, bwd.n


def test_backward_reruns_what_each_policy_recomputes():
    """gemma2's layer: ``"full"`` reruns its forward's products, ``"dots"``
    its batched ones alone (attention's einsums), ``"none"`` nothing."""
    fwd, none = _layer_counts("gemma2-9b", "none")
    _, full = _layer_counts("gemma2-9b", "full")
    _, dots = _layer_counts("gemma2-9b", "dots")
    assert fwd["mm"] > 0 and fwd["bmm"] > 0
    assert full["mm"] == none["mm"] + fwd["mm"]
    assert full["bmm"] == none["bmm"] + fwd["bmm"]
    assert dots["mm"] == none["mm"]
    assert dots["bmm"] == none["bmm"] + fwd["bmm"]


def test_moe_dots_recomputes_the_expert_products():
    """qwen3-moe's layer under ``"dots"``: the router's and projections'
    ``mm`` are kept, the per-expert ``torch.bmm`` (a batch dimension, as
    the reference's ``einsum`` over experts) rerun."""
    fwd, none = _layer_counts("qwen3-moe-235b-a22b", "none")
    _, dots = _layer_counts("qwen3-moe-235b-a22b", "dots")
    assert dots["mm"] == none["mm"]
    assert dots["bmm"] == none["bmm"] + fwd["bmm"] > none["bmm"]


def test_hybrid_dots_runs_as_none():
    """The reference checkpoints a hybrid layer under ``"full"`` alone.
    ``"full"``'s recompute stops once every tensor the backward saves is
    back: where no norm follows the layer's last product (the MLP's down
    projection), its inputs are saved before it runs, so it is not rerun."""
    assert _port("hymba-1.5b", "dots").remat == "none"
    fwd, none = _layer_counts("hymba-1.5b", "none", S=64)
    _, dots = _layer_counts("hymba-1.5b", "dots", S=64)
    _, full = _layer_counts("hymba-1.5b", "full", S=64)
    assert dots == none
    assert full["mm"] == none["mm"] + fwd["mm"] - 1
    assert full["bmm"] == none["bmm"] + fwd["bmm"]


# ------------------------------------------------- (c) saved products

#: archs whose layers end in a product no post-norm reads
LAST_PRODUCT_UNREAD = {"qwen2.5-32b", "llava-next-34b"}


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen2.5-32b",
                                  "qwen3-moe-235b-a22b", "llava-next-34b"])
def test_dots_saves_the_products_the_reference_saves(arch, monkeypatch):
    """Elements of the products ``"dots"`` keeps in one layer against the
    reference's residuals under ``dots_with_no_batch_dims_saveable`` that
    are no argument, literal or constant: the outputs of its products
    (described, under jax 0.9, as the outputs at the products' source
    lines, or of the activation applied to the gate's product, of the same
    size).  One difference, in the sum: where no post-norm reads the
    layer's last product (the MLP's down projection; the MoE's is a
    batched product and is recomputed on both sides), the port's selective
    checkpoint keeps its (B, S, D) output too, which the reference's
    partial evaluation drops because its backward does not read it."""
    cfg, params = _weights(arch)
    ref = jax_build_model(cfg, remat="dots")
    B, S = 2, 16
    rng = np.random.default_rng(5)
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    p0 = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]),
                                params["layers"])
    layer = jax.checkpoint(
        ref._layer,
        policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)

    def f(x, p, positions):
        out, aux = layer(x, p, jnp.asarray(ref.windows[0]),
                         jnp.asarray(ref.rope_bases[0]), positions)
        return out.sum() + aux

    want = sum(aval.size for aval, why in saved_residuals(
        f, jnp.asarray(h), p0, jnp.arange(S)) if why.startswith("output of"))
    if arch in LAST_PRODUCT_UNREAD:
        want += B * S * cfg.d_model

    saved = []
    real = common._dots_policy

    def spy(ctx, op, *args, **kwargs):
        policy = real(ctx, op, *args, **kwargs)
        if policy == common.CheckpointPolicy.MUST_SAVE:
            saved.append(args[-2].shape[0] * args[-1].shape[1])
        return policy

    monkeypatch.setattr(common, "_dots_policy", spy)
    model = _port(arch, "dots")
    p = unstack_layers(param_tree(model)["layers"], cfg.num_layers)[0]
    x = torch.from_numpy(h).requires_grad_(True)
    remat_call(model._train_layer, x, p, 0, torch.arange(S), policy="dots")
    assert saved and sum(saved) == want


# ------------------------------------------------- (d) the scans


def _ssm_inputs(T, B=2, di=24, N=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, di)))).astype(np.float32)
    Bp = rng.standard_normal((B, T, N)).astype(np.float32)
    Cp = rng.standard_normal((B, T, N)).astype(np.float32)
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (di, 1))
    h0 = (0.1 * rng.standard_normal((B, di, N))).astype(np.float32)
    return x, dt, Bp, Cp, A, h0


def _wkv_inputs(T, B=2, H=2, hd=8, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, hd)) * 0.5 - 1.0)
               ).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


SCANS = {
    # name: (port scan, reference scan, inputs, the whole loop unchunked)
    "ssm": (ssm_scan, jax_ssm_scan, _ssm_inputs,
            lambda x, dt, B, C, A, h0: _ssm_whole(x, dt, B, C, A, h0)),
    "wkv6": (wkv6_scan, jax_wkv6_scan, _wkv_inputs,
             lambda r, k, v, w, u, s: _wkv6_chunk(s, r, k, v, w, u)),
}


def _ssm_whole(x, dt, Bp, Cp, A, h0):
    h, y = _ssm_chunk(h0, *(t.transpose(0, 1) for t in (x, dt, Bp, Cp)), A)
    return h, y


def _objective(seed, final, ys):
    """A seeded weighting of the scan's two results."""
    rng = np.random.default_rng(seed)
    return (final * torch.from_numpy(rng.standard_normal(
        final.shape).astype(np.float32))).sum() + \
        (ys * torch.from_numpy(rng.standard_normal(
            ys.shape).astype(np.float32))).sum()


def _grads(fn, inputs, seed=11):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    final, ys = fn(*ts)
    gs = torch.autograd.grad(_objective(seed, final, ys), ts)
    return final.detach(), ys.detach(), gs


@pytest.mark.parametrize("name", list(SCANS))
def test_scan_gradients_match_the_reference(name):
    port, ref, inputs, _ = SCANS[name]
    args = inputs(128, seed=1)
    rng = np.random.default_rng(11)
    _, ref_ys = ref(*map(jnp.asarray, args))
    w_final = rng.standard_normal(args[-1].shape).astype(np.float32)
    w_ys = rng.standard_normal(ref_ys.shape).astype(np.float32)

    def objective(*a):
        final, ys = ref(*a)
        return jnp.sum(final * w_final) + jnp.sum(ys * w_ys)

    want = jax.grad(objective, argnums=tuple(range(6)))(
        *map(jnp.asarray, args))
    _, _, got = _grads(port, args)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_REL * scale + 1e-7, (name, i, err, scale)


@pytest.mark.parametrize("name", list(SCANS))
def test_scan_gradients_stay_exact_at_a_ragged_length(name):
    """T = 100: a chunk of 64 and a ragged one of 36, each checkpointed,
    against the whole loop run as one chunk with no checkpoint: results
    bit-equal, gradients within fp32 rounding of the sums' order."""
    port, _, inputs, whole = SCANS[name]
    args = inputs(100, seed=2)
    final, ys, got = _grads(port, args)
    w_final, w_ys, want = _grads(whole, args)
    assert torch.equal(final, w_final) and torch.equal(ys, w_ys)
    for i, (g, w) in enumerate(zip(got, want)):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-6 * scale, (name, i)


@pytest.mark.parametrize("name", list(SCANS))
def test_scan_keeps_a_state_per_chunk_not_per_token(name):
    """T = 1024 under grad: the bytes of every tensor saved for the
    backward (summed through ``saved_tensors_hooks``) stay under a quarter
    of one state a token (the per-token loop kept about one a token: its
    ``addcmul`` / product operand)."""
    port, _, _, _ = SCANS[name]
    if name == "ssm":
        args = _ssm_inputs(1024, B=1, di=64, N=16, seed=4)
        state = args[-1].nbytes
    else:
        args = _wkv_inputs(1024, B=1, H=2, hd=32, seed=4)
        state = args[-1].nbytes
    kept = []

    def pack(t):
        kept.append(t.numel() * t.element_size())
        return t

    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        port(*ts)
    assert 0 < sum(kept) < 0.25 * 1024 * state, (sum(kept), state)


# ------------------------------------------------- (e) on a mesh

MESH_SEQ = 16
#: gemma2's layer on (2, 1) (its leaves gathered over ``data``) and (1, 2)
#: (its 4 heads split over ``model``); the hybrid's on (1, 2), where its
#: SSM branch gathers ``xc`` over ``model``
MESH_CASES = {(2, 1): ["gemma2-9b"], (1, 2): ["gemma2-9b", "hymba-1.5b"]}


def _mesh_case(arch):
    cfg, params = _weights(arch)
    return (arch, ArchConfig(**cfg.__dict__), params, MESH_SEQ)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Each case's step on one device under ``full`` and on two gloo ranks
    under each policy, by mesh shape."""
    archs = sorted({a for v in MESH_CASES.values() for a in v})
    one = remat_step_ranks(0, 1, None, None, [_mesh_case(a) for a in archs],
                           ["full"])
    runs = {}
    for shape, names in MESH_CASES.items():
        runs[shape] = run_ranks(
            remat_step_ranks, 2, tmp_path_factory.mktemp("remat"), *shape,
            [_mesh_case(a) for a in names], POLICIES, timeout=300)
    return one, runs


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("shape,arch", [(s, a) for s, v in MESH_CASES.items()
                                        for a in v])
def test_mesh_step_equals_one_device_under_each_policy(mesh_runs, shape,
                                                       arch, policy):
    one, runs = mesh_runs
    want = one[arch]["full"]
    for rank in runs[shape]:
        got = rank[arch][policy]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert set(got["grads"]) == set(want["grads"])
        for key, g in got["grads"].items():
            w = want["grads"][key]
            scale = float(np.abs(w).max())
            err = float(np.abs(g - w).max())
            assert err <= GRAD_REL * scale + 1e-12, (key, err, scale)


@pytest.mark.parametrize("policy", POLICIES)
def test_no_gathered_leaf_outlives_its_layer(mesh_runs, policy):
    """On (2, 1) each layer's leaves are gathered over ``data`` inside the
    layer: when the backward starts none of them is alive (``"none"``
    keeps a saved one as its shard), and the backward gathers each saved
    leaf again."""
    _, runs = mesh_runs
    for rank in runs[(2, 1)]:
        got = rank["gemma2-9b"][policy]
        assert got["gathered"] > 0
        assert got["alive"] == 0
        assert got["regathered"] > 0
