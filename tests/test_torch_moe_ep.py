"""The port's expert-parallel MoE block against the reference's
``shard_map`` branch under the same mesh.

Both run ``moe_block`` on the same seeded input, router and experts, fp32
on the CPU, under a (data, model) mesh: the reference on the conftest's
simulated host devices, the port on as many gloo ranks
(``helpers.torch_dist.run_ranks``), each holding its rows of the batch and
its experts.  The reference's mesh is a ``jax.sharding.Mesh`` of Auto axes:
its own ``make_host_mesh`` builds Explicit axes under jax 0.9, which
``with_sharding_constraint`` refuses.  The objective is ``sum(out * w) +
aux``; a port rank's gradient is that of its data shard's part (its rows'
term and the aux, which the block averages over the shards), so the
router's and the experts' gradients summed over the data ranks are the
reference's.

Tolerances: the output and the aux within 1e-5, every gradient within
1e-4 of its largest entry.  Both sides compute in fp32 over the same
tokens per shard (the capacity is the shard's); sums over the shards'
tokens run in another order.

Cases: both routers (qwen3-moe's softmax top-2 over 8 experts, llama4's
sigmoid top-1 over 4 with a shared expert), the sequence split over
``model`` and its fallback (S % model != 0), experts split over ``model``
and their fallback (E % model != 0), on 2 x 2 and 1 x 2 meshes.  The
mesh's capacity per shard makes the block's output differ from the
one-device block's; the port's must differ where the reference's does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import torch_mesh
from helpers.torch_dist import run_ranks

from repro.configs import get_reduced as jax_get_reduced
from repro.models.common import mesh_context as jax_mesh_context
from repro.models.moe import moe_block as jax_moe_block
from repro_torch.models.common import ArchConfig
from repro_torch.models.moe import moe_block

OUT_TOL = 1e-5
GRAD_REL = 1e-4

#: (id, arch, config overrides, (data, model), (B, S))
CASES = [
    ("qwen3-2x2", "qwen3-moe-235b-a22b", {}, (2, 2), (4, 8)),
    ("llama4-2x2", "llama4-scout-17b-a16e", {}, (2, 2), (4, 8)),
    ("qwen3-2x2-seq-fallback", "qwen3-moe-235b-a22b", {}, (2, 2), (4, 7)),
    ("qwen3-1x2", "qwen3-moe-235b-a22b", {}, (1, 2), (2, 8)),
    ("qwen3-1x2-expert-fallback", "qwen3-moe-235b-a22b",
     {"num_experts": 5}, (1, 2), (2, 8)),
]


def _inputs(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = {"router": f32(D, E), "wg": f32(E, D, F) / 8, "wu": f32(E, D, F) / 8,
         "wd": f32(E, F, D) / 8}
    if cfg.num_shared_experts:
        Fs = F * cfg.num_shared_experts
        p.update(swg=f32(D, Fs) / 8, swu=f32(D, Fs) / 8, swd=f32(Fs, D) / 8)
    return f32(B, S, D), p, f32(B, S, D)


def _reference(cfg, x, p, w, shape):
    n = shape[0] * shape[1]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             ("data", "model"))
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def f(x, p):
        out, aux = jax_moe_block(x, p, cfg)
        return jnp.sum(out * jnp.asarray(w)) + aux, (out, aux)

    with mesh, jax_mesh_context(mesh):
        (_, (out, aux)), grads = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jp)
    single, _ = jax.jit(lambda x, p: jax_moe_block(x, p, cfg))(
        jnp.asarray(x), jp)
    return (np.asarray(out), float(aux),
            {"x": np.asarray(grads[0]),
             **{k: np.asarray(v) for k, v in grads[1].items()}},
            np.asarray(single))


def _close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= GRAD_REL * scale + 1e-7, (what, err, scale)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_expert_parallel_block_matches_shard_map(case, tmp_path):
    _, arch, over, shape, (B, S) = case
    jcfg = dataclasses.replace(jax_get_reduced(arch), dtype="float32", **over)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    x, p, w = _inputs(cfg, B, S)
    ref_out, ref_aux, ref_grads, ref_single = _reference(jcfg, x, p, w,
                                                         shape)
    ranks = run_ranks(torch_mesh.moe_ep_ranks, shape[0] * shape[1],
                      tmp_path, shape[0], shape[1], cfg, x, p, w)

    router = np.zeros_like(ref_grads["router"])
    experts = {k: np.zeros_like(ref_grads[k]) for k in ("wg", "wu", "wd")}
    shared = {k: np.zeros_like(ref_grads[k]) for k in p if k.startswith("s")}
    for r in ranks:
        lo, rows = r["rows"]
        e_lo, e_n = r["experts"]
        g = r["grads"]
        np.testing.assert_allclose(r["out"], ref_out[lo:lo + rows],
                                   rtol=OUT_TOL, atol=OUT_TOL)
        np.testing.assert_allclose(r["aux"], ref_aux, rtol=OUT_TOL)
        _close(g["x"], ref_grads["x"][lo:lo + rows], "x")
        if r["coords"]["model"] == 0:
            router += g["router"]
            for k in shared:
                shared[k] += g[k]
        if e_n < cfg.num_experts or r["coords"]["model"] == 0:
            for k in experts:
                experts[k][e_lo:e_lo + e_n] += g[k]
    _close(router, ref_grads["router"], "router")
    for k, v in {**experts, **shared}.items():
        _close(v, ref_grads[k], k)

    # capacity per shard: the mesh changes the block's output exactly
    # where it changes the reference's
    with torch.no_grad():
        single, _ = moe_block(torch.from_numpy(x),
                              {k: torch.from_numpy(v) for k, v in p.items()},
                              cfg)
    ref_moved = not np.allclose(ref_out, ref_single, rtol=OUT_TOL,
                                atol=OUT_TOL)
    port_out = np.concatenate([r["out"] for r in ranks
                               if r["coords"]["model"] == 0])
    port_moved = not np.allclose(port_out, single.numpy(), rtol=OUT_TOL,
                                 atol=OUT_TOL)
    assert port_moved == ref_moved
    if case[0] == "qwen3-2x2":
        assert ref_moved


def test_recompute_on_another_thread_sees_the_mesh(tmp_path):
    """A CUDA backward runs on the autograd engine's thread, where the
    layer's activation-checkpoint recompute must still run the expert-
    parallel branch: the gradient taken on another thread equals the one
    taken on this one."""
    cfg = ArchConfig(**dataclasses.asdict(dataclasses.replace(
        jax_get_reduced("qwen3-moe-235b-a22b"), dtype="float32")))
    x, p, _ = _inputs(cfg, 2, 8)
    for same, other in run_ranks(torch_mesh.remat_thread_ranks, 2, tmp_path,
                                 cfg, x, p):
        np.testing.assert_array_equal(other, same)
