"""The training-layout tests' oracle and runs (tests/test_torch_mesh_layout.py,
tests/test_torch_mesh_layout_families.py).

The reference runs its ``Trainer`` on a ``jax.sharding.Mesh`` of Auto
axes over the conftest's simulated host devices; the port runs as many
gloo ranks (``helpers.torch_dist.run_ranks`` of
``helpers.torch_mesh.layout_ranks``).  Both start from the reference's
``init(PRNGKey(0))`` weights and read the same ``SyntheticLM`` batches
with a seeded ragged ``loss_mask`` (and each family's modality input:
llava's ``patch_embeds``, whisper's ``frames``).
"""

import dataclasses

import jax
import numpy as np
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

__all__ = ["jax_mesh", "layout_runs", "model_replicated", "nested"]


def nested(records):
    """Records ``{"a/b": v}`` as the nested dict ``{"a": {"b": v}}``."""
    out = {}
    for key, v in records.items():
        *path, leaf = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def jax_mesh(shape):
    """A ``(data, model)`` mesh of Auto axes over the first devices."""
    n = shape[0] * shape[1]
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             ("data", "model"))


def _data(cfg, seq, patches):
    dc = JD.DataConfig(global_batch=4, seq_len=seq,
                       vocab_size=cfg.vocab_size)
    return dc, torch_mesh.masked_lm(JD.SyntheticLM(dc), cfg, patches)


def _reference_grads(jax_model, params, cfg, shape, seq, patches):
    """The reference's gradient of its loss on the step-0 batch, on its
    mesh, by path."""
    _, data = _data(cfg, seq, patches)
    batch = {k: jax.numpy.asarray(v) for k, v in data.batch_at(0).items()}
    mesh = jax_mesh(shape)
    with mesh, jax_mesh_context(mesh):
        grads = jax.jit(jax.grad(lambda p: jax_model.loss(p, batch)[0]))(
            params)
    return {k: np.asarray(v) for k, v in dict(ref_records(grads)).items()}


def layout_runs(tmp_path_factory, cases, stepped, *, seq, mesh_grads=(),
                peak_lr=3e-3, step_only=()):
    """Per case ``(name, arch, (data, model), accum_steps, patches)``: the
    reference's 3-step run on its mesh at ``peak_lr`` (its metrics log and
    final weights by path), the port's ranks (one spawn per mesh shape:
    each rank's trained results and, for the ``stepped`` cases, one step's
    gradients and FLOPs), the starting weights and the port's config; for
    the stepped cases the gradient to hold them to: one device's, or for
    ``mesh_grads`` (the MoE: capacity per shard) the reference's on its
    mesh.  The ``step_only`` cases are only stepped: no reference run, no
    training (their entries in refs and in the ranks' trained results are
    None).  Returns (refs, ranks, starts, cfgs, want)."""
    refs, starts, cfgs, want = {}, {}, {}, {}
    by_shape = {}
    for name, arch, shape, accum, patches in cases:
        jcfg = fp32_config(arch)
        jax_model, params, _ = model_pair(jcfg)
        starts[name] = dict(ref_records(params))
        cfg = ArchConfig(**dataclasses.asdict(jcfg))
        cfgs[name] = cfg
        weights = nested({k: np.asarray(v) for k, v in starts[name].items()})
        train, step = by_shape.setdefault(shape, ([], []))
        refs[name] = None
        if name not in step_only:
            dc, data = _data(jcfg, seq, patches)
            loader = JD.Loader(data, dc)
            tr = JR.Trainer(jax_model, loader,
                            torch_mesh.trainer_cfg(JR, JO, accum,
                                                   peak_lr=peak_lr),
                            donate=False)
            mesh = jax_mesh(shape)
            with mesh, jax_mesh_context(mesh):
                p, _ = tr.run(params, JO.adamw_init(params))
            loader.stop()
            refs[name] = (tr.metrics_log, dict(ref_records(p)))
            train.append((name, cfg, weights, accum, seq, patches, peak_lr))
        if name in stepped:
            step.append((name, cfg, weights, seq, patches))
            if name in mesh_grads:
                want[name] = {"grads": _reference_grads(
                    jax_model, params, jcfg, shape, seq, patches)}
            else:
                want[name] = torch_mesh.one_step(None, cfg, weights, seq,
                                                 patches)
    ranks = {}
    for shape, (train, step) in by_shape.items():
        got = run_ranks(torch_mesh.layout_ranks, shape[0] * shape[1],
                        tmp_path_factory.mktemp("layout"), *shape, train,
                        step, timeout=300)
        for name in {c[0] for c in train + step}:
            ranks[name] = [(g[0].get(name), g[1].get(name)) for g in got]
    return refs, ranks, starts, cfgs, want


def model_replicated(cfg, shape, paths):
    """The leaves the training rules replicate over ``model`` on a mesh of
    ``shape`` (all of them among ``paths``)."""
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
