"""The port's training layout on a mesh against the reference's GSPMD
layout on the same mesh.

On a mesh, ``launch.steps.make_train_step`` gathers each layer's weights
over ``data`` inside its checkpointed layer and reduce-scatters their
gradients as the backward leaves it (FSDP), and ``TransformerLM`` splits
its work over ``model`` as the reference's ``constrain`` sites lay it out:
the residual stream by sequence, attention by q heads where they divide
the axis (gemma2's 4 heads) and by query rows where they do not
(qwen2.5's 5: only K/V are gathered), the MLP by ``d_ff``, the logits by
the rank's own tokens.  The reference runs its ``Trainer`` on a
``jax.sharding.Mesh`` of Auto axes over the conftest's simulated host
devices (as in ``test_torch_mesh_train.py``); the port runs as many gloo
ranks (``helpers.torch_dist.run_ranks``).  Both start from the
reference's ``init(PRNGKey(0))`` weights and read the same ``SyntheticLM``
batches with a seeded ragged ``loss_mask`` (and, for llava, seeded
``patch_embeds``).  Cases: gemma2 on 2 x 2, 1 x 4 (one q head a rank, half
a kv group) and with ``accum_steps=2``; qwen2.5 on 2 x 2 and on 1 x 3,
where neither its heads nor the 16 tokens divide the axis (the sequence is
padded at its end with masked tokens); qwen3-moe on 2 x 2; llava with its
patch prefix on 2 x 2.

Limits are ``test_torch_mesh_train.py``'s: losses within rtol 1e-4,
gradient norms within 1e-3, learning rates within 1e-6, each leaf's change
over the run within 5e-3 of its size (relative L2).  One step's
gradient, whole: every leaf the rules replicate over ``model`` (each rank
computes its tokens' or heads' part, which the layout sums over
``model``) within 1e-4 of the one-device gradient (relative to the
leaf's largest entry), the MoE's within 1e-4 of the reference's on its
mesh (capacity per shard); and a 1 x 4 rank's FLOPs (``CostMode``) below
half of the one-device step's.
"""

import dataclasses

import jax
import numpy as np
import pytest
from helpers import torch_mesh
from helpers.torch_dist import run_ranks
from helpers.torch_port import fp32_config, model_pair

import repro.data as JD
import repro.optim as JO
import repro.runtime as JR
from repro.checkpoint.ckpt import tree_to_records as ref_records
from repro.models.common import mesh_context as jax_mesh_context
from repro_torch.models import build_model
from repro_torch.models.common import ArchConfig, param_tree
from repro_torch.parallel.sharding import AbstractMesh, param_shardings
from repro_torch.tree import tree_flatten_with_path

LOSS_RTOL, GNORM_RTOL, LR_RTOL, UPDATE_REL = 1e-4, 1e-3, 1e-6, 5e-3
GRAD_REL = 1e-4
WORK_SHARE = 0.5
SEQ = 16

#: (id, arch, (data, model), accum_steps, patch_embeds)
CASES = [
    ("gemma2-2x2", "gemma2-9b", (2, 2), 1, False),
    ("gemma2-1x4", "gemma2-9b", (1, 4), 1, False),
    ("gemma2-accum2-2x2", "gemma2-9b", (2, 2), 2, False),
    ("qwen2.5-2x2", "qwen2.5-32b", (2, 2), 1, False),
    ("qwen2.5-1x3", "qwen2.5-32b", (1, 3), 1, False),
    ("qwen3-moe-2x2", "qwen3-moe-235b-a22b", (2, 2), 1, False),
    ("llava-2x2", "llava-next-34b", (2, 2), 1, True),
]
#: cases stepped once for their gradients (accum 1); the MoE's against
#: the reference's mesh gradient, the others against one device
STEPPED = ["gemma2-1x4", "qwen2.5-2x2", "qwen2.5-1x3", "qwen3-moe-2x2",
           "llava-2x2"]
MOE = {"qwen3-moe-2x2"}
#: no dimension of the reduced qwen2.5 divides 3: on 1 x 3 the rules
#: replicate every leaf, and the layout still splits the work
ALL_REPLICATED = {"qwen2.5-1x3"}
BY_ID = {c[0]: c for c in CASES}


def _loader(pkg, cfg, patches):
    dc = pkg.DataConfig(global_batch=4, seq_len=SEQ,
                        vocab_size=cfg.vocab_size)
    return pkg.Loader(torch_mesh.MaskedLM(pkg.SyntheticLM(dc),
                                          torch_mesh.patches_of(cfg, patches)),
                      dc)


def _nested(records):
    out = {}
    for key, v in records.items():
        *path, leaf = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _jax_mesh(shape):
    n = shape[0] * shape[1]
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             ("data", "model"))


def _reference_grads(jax_model, params, cfg, shape, patches):
    """The reference's gradient of its loss on the step-0 batch, on its
    mesh, by path."""
    dc = JD.DataConfig(global_batch=4, seq_len=SEQ,
                       vocab_size=cfg.vocab_size)
    batch = torch_mesh.MaskedLM(JD.SyntheticLM(dc), torch_mesh.patches_of(
        cfg, patches)).batch_at(0)
    batch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    mesh = _jax_mesh(shape)
    with mesh, jax_mesh_context(mesh):
        grads = jax.jit(jax.grad(lambda p: jax_model.loss(p, batch)[0]))(
            params)
    return {k: np.asarray(v) for k, v in dict(ref_records(grads)).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: the reference's mesh run and the starting weights; per
    mesh shape, one spawn of the port's ranks for its cases; the
    one-device (or, for the MoE, the reference's mesh) gradients and
    FLOPs of the stepped cases."""
    refs, starts, cfgs, want = {}, {}, {}, {}
    by_shape = {}
    for name, arch, shape, accum, patches in CASES:
        jcfg = fp32_config(arch)
        jax_model, params, _ = model_pair(jcfg)
        starts[name] = dict(ref_records(params))
        loader = _loader(JD, jcfg, patches)
        tr = JR.Trainer(jax_model, loader,
                        torch_mesh.trainer_cfg(JR, JO, accum), donate=False)
        mesh = _jax_mesh(shape)
        with mesh, jax_mesh_context(mesh):
            p, _ = tr.run(params, JO.adamw_init(params))
        loader.stop()
        refs[name] = (tr.metrics_log, dict(ref_records(p)))
        cfg = ArchConfig(**dataclasses.asdict(jcfg))
        cfgs[name] = cfg
        weights = _nested({k: np.asarray(v) for k, v in starts[name].items()})
        train, step = by_shape.setdefault(shape, ([], []))
        train.append((name, cfg, weights, accum, SEQ, patches))
        if name in STEPPED:
            step.append((name, cfg, weights, SEQ, patches))
            if name in MOE:
                want[name] = {"grads": _reference_grads(
                    jax_model, params, jcfg, shape, patches)}
            else:
                want[name] = torch_mesh.one_step(None, cfg, weights, SEQ,
                                                 patches)
    ranks = {}
    for shape, (train, step) in by_shape.items():
        got = run_ranks(torch_mesh.layout_ranks, shape[0] * shape[1],
                        tmp_path_factory.mktemp("layout"), *shape, train,
                        step, timeout=300)
        for name, *_ in train:
            ranks[name] = [(g[0][name], g[1].get(name)) for g in got]
    return refs, ranks, starts, cfgs, want


def _model_replicated(cfg, shape, paths):
    """The leaves the training rules replicate over ``model`` on a mesh of
    ``shape``."""
    mesh = AbstractMesh(shape, ("data", "model"))
    sh = param_shardings(param_tree(build_model(cfg, device="meta")), mesh,
                         heads_divisible=cfg.num_heads % shape[1] == 0)
    out = set()
    for p, s in tree_flatten_with_path(sh):
        names = {a for e in s.spec if e is not None
                 for a in (e if isinstance(e, tuple) else (e,))}
        if "model" not in names:
            out.add("/".join(map(str, p)))
    assert out <= set(paths)
    return out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_layout_trains_as_the_reference_on_its_mesh(runs, name):
    refs, ranks, starts, _, _ = runs
    ref_log, ref_p = refs[name]
    for trained, _ in ranks[name]:
        log = trained["log"]
        assert [r["step"] for r in log] == [r["step"] for r in ref_log]
        for g, w in zip(log, ref_log):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(g["gnorm"], w["gnorm"],
                                       rtol=GNORM_RTOL)
            np.testing.assert_allclose(g["lr"], w["lr"], rtol=LR_RTOL)
        assert set(trained["params"]) == set(ref_p)
        for key, t in trained["params"].items():
            ref = np.asarray(ref_p[key]).astype(np.float64)
            moved = np.linalg.norm(ref - np.asarray(starts[name][key]))
            err = np.linalg.norm(t.astype(np.float64) - ref)
            assert err <= UPDATE_REL * moved + 1e-12, (key, err, moved)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_layout_ranks_hold_only_their_shards(runs, name):
    _, ranks, starts, _, _ = runs
    whole = sum(np.asarray(v).size for v in starts[name].values())
    for trained, _ in ranks[name]:
        assert trained["shapes_ok"]
        assert trained["resident"] == trained["moments"] == trained["want"]
        if name in ALL_REPLICATED:
            assert trained["want"] == whole
        else:
            assert trained["want"] < whole


def _close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= GRAD_REL * scale + 1e-12, (what, err, scale)


@pytest.mark.parametrize("name", STEPPED)
def test_model_replicated_gradients_equal_one_devices(runs, name):
    """The leaves replicated over ``model`` (``wk``/``wv``, the norms, the
    biases, the router, and ``wq``/``wo`` where the heads do not divide):
    each rank's gradient is its part, and the sum over ``model`` must give
    the whole gradient (a cut would keep 1/M of it)."""
    _, ranks, _, cfgs, want = runs
    shape = BY_ID[name][2]
    ref = want[name]["grads"]
    replicated = _model_replicated(cfgs[name], shape, ref)
    assert any(k.endswith("attn/wk") for k in replicated)
    if BY_ID[name][1] == "qwen2.5-32b":
        assert {"layers/attn/wq", "layers/attn/wo"} <= replicated
    for _, stepped in ranks[name]:
        for key in sorted(replicated):
            _close(stepped["grads"][key], ref[key], key)


@pytest.mark.parametrize("name", [n for n in STEPPED
                                  if n not in ALL_REPLICATED])
def test_model_split_gradients_equal_one_devices(runs, name):
    _, ranks, _, cfgs, want = runs
    ref = want[name]["grads"]
    split = set(ref) - _model_replicated(cfgs[name], BY_ID[name][2], ref)
    assert split
    for _, stepped in ranks[name]:
        assert set(stepped["grads"]) == set(ref)
        for key in sorted(split):
            _close(stepped["grads"][key], ref[key], key)


def test_a_rank_does_under_half_of_one_devices_work(runs):
    """gemma2 on 1 x 4: each rank computes one q head, a quarter of
    ``d_ff`` and its quarter of the tokens' logits; a dense rank that
    repeated the step would count at least the one-device FLOPs."""
    _, ranks, _, _, want = runs
    single = want["gemma2-1x4"]["flops"]
    assert single > 0
    for _, stepped in ranks["gemma2-1x4"]:
        assert 0 < stepped["flops"] < WORK_SHARE * single, (
            stepped["flops"], single)
