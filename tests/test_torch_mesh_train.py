"""The port's ``Trainer(mesh=)`` against the reference's ``Trainer`` on the
same mesh.

The reference runs ``Trainer.run`` under ``mesh_context`` on a 2 x 2
``jax.sharding.Mesh`` of Auto axes over the conftest's simulated host
devices (its own ``make_host_mesh`` builds Explicit axes under jax 0.9,
which ``with_sharding_constraint`` refuses); there only the MoE block's
``shard_map`` changes values.  The port runs 4 gloo ranks
(``helpers.torch_dist.run_ranks``), each holding its shards of the
parameters and AdamW moments and training on its rows.  Both start from
the reference's ``init(PRNGKey(0))`` weights and read the same
``SyntheticLM`` batches with a seeded ragged ``loss_mask``, so the data
shards' mask counts differ and a mean of per-shard means would be wrong.

Limits are ``tests/test_torch_train.py``'s: losses within rtol 1e-4,
gradient norms within rtol 1e-3, learning rates within 1e-6, and each
leaf's change over the run within 5e-3 of its size (relative L2).  The
dense configs are held to the port's one-device trainer at the same
limits (the mesh changes no value there); the MoE configs (capacity per
shard) only to the reference's mesh run.  Each rank holds exactly the
elements the rules' shard shapes give, of parameters and moments, and
``init_state`` on the mesh keeps only those and frees the module's.
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
import repro_torch.data as PD
import repro_torch.optim as PO
import repro_torch.runtime as PR
from repro.checkpoint.ckpt import tree_to_records as ref_records
from repro.models.common import mesh_context as jax_mesh_context
from repro_torch.models.common import ArchConfig, param_tree
from repro_torch.tree import tree_flatten_with_path

LOSS_RTOL, GNORM_RTOL, LR_RTOL, UPDATE_REL = 1e-4, 1e-3, 1e-6, 5e-3
SHAPE = (2, 2)
SEQ = 16

#: (id, arch, accum_steps)
CASES = [("gemma2", "gemma2-9b", 1), ("gemma2-accum2", "gemma2-9b", 2),
         ("qwen3-moe", "qwen3-moe-235b-a22b", 1),
         ("llama4-scout", "llama4-scout-17b-a16e", 1)]
DENSE = {"gemma2", "gemma2-accum2"}


def _loader(pkg, cfg):
    dc = pkg.DataConfig(global_batch=4, seq_len=SEQ,
                        vocab_size=cfg.vocab_size)
    return pkg.Loader(torch_mesh.MaskedLM(pkg.SyntheticLM(dc)), dc)


def _nested(records):
    out = {}
    for key, v in records.items():
        *path, leaf = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: the reference's mesh run, the port's 4 ranks (one spawn
    for every case), the port's one-device run of the dense cases, and
    the starting weights."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(SHAPE),
                             ("data", "model"))
    refs, cases, single, starts = {}, [], {}, {}
    for name, arch, accum in CASES:
        jcfg = fp32_config(arch)
        jax_model, params, model = model_pair(jcfg)
        starts[name] = dict(ref_records(params))
        loader = _loader(JD, jcfg)
        tr = JR.Trainer(jax_model, loader,
                        torch_mesh.trainer_cfg(JR, JO, accum), donate=False)
        with mesh, jax_mesh_context(mesh):
            p, _ = tr.run(params, JO.adamw_init(params))
        loader.stop()
        refs[name] = (tr.metrics_log, dict(ref_records(p)))
        cfg = ArchConfig(**dataclasses.asdict(jcfg))
        weights = _nested({k: np.asarray(v) for k, v in starts[name].items()})
        cases.append((name, cfg, weights, accum, SEQ))
        if name in DENSE:
            loader = _loader(PD, cfg)
            tr = PR.Trainer(model, loader,
                            torch_mesh.trainer_cfg(PR, PO, accum))
            pp = param_tree(model)
            pp, _ = tr.run(pp, PO.adamw_init(pp))
            loader.stop()
            single[name] = (tr.metrics_log, {
                "/".join(map(str, k)): t.numpy()
                for k, t in tree_flatten_with_path(pp)})
    ranks = run_ranks(torch_mesh.mesh_train_ranks, 4,
                      tmp_path_factory.mktemp("mesh"), *SHAPE, cases,
                      timeout=240)
    return refs, ranks, single, starts


def _assert_curves_match(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["gnorm"], w["gnorm"], rtol=GNORM_RTOL)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=LR_RTOL)


def _assert_params_match(got, want, start):
    assert set(got) == set(want)
    for key, t in got.items():
        ref = np.asarray(want[key]).astype(np.float64)
        moved = np.linalg.norm(ref - np.asarray(start[key]))
        err = np.linalg.norm(t.astype(np.float64) - ref)
        assert err <= UPDATE_REL * moved + 1e-12, (key, err, moved)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_mesh_trainer_matches_the_reference_on_its_mesh(runs, name):
    refs, ranks, _, starts = runs
    ref_log, ref_p = refs[name]
    for r in ranks:
        _assert_curves_match(r[name]["log"], ref_log)
        _assert_params_match(r[name]["params"], ref_p, starts[name])


@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_mesh_trainer_matches_the_one_device_trainer(runs, name):
    _, ranks, single, starts = runs
    log, params = single[name]
    _assert_curves_match(ranks[0][name]["log"], log)
    _assert_params_match(ranks[0][name]["params"], params, starts[name])


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_each_rank_holds_only_its_shards(runs, name):
    _, ranks, _, starts = runs
    whole = sum(np.asarray(v).size for v in starts[name].values())
    for r in ranks:
        got = r[name]
        assert got["shapes_ok"]
        assert got["resident"] == got["moments"] == got["want"]
        assert got["init_elems"] == got["want"] and got["freed"]
        assert got["want"] < whole
    # every element is held by some rank (the layout covers the leaves)
    assert sum(r[name]["want"] for r in ranks) >= whole


def test_references_host_mesh_is_refused_where_its_axes_are_explicit():
    """Pinned behaviour of the reference: ``make_host_mesh`` builds its
    mesh with ``jax.make_mesh``, whose axes are Explicit under jax 0.9, and
    ``with_sharding_constraint`` (the models' ``constrain``) refuses them;
    with Auto axes (the jax its shims were probed on) the loss runs.  So
    the oracle mesh above is a ``jax.sharding.Mesh``."""
    from repro.launch.mesh import make_host_mesh as jax_make_host_mesh
    from repro.models import build_model as jax_build_model

    cfg = fp32_config("gemma2-9b")
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = {k: jax.numpy.zeros((4, 8), jax.numpy.int32)
             for k in ("tokens", "targets")}
    mesh = jax_make_host_mesh(model=2)
    run = lambda: jax.jit(model.loss)(params, batch)
    with mesh, jax_mesh_context(mesh):
        explicit = getattr(getattr(jax.sharding, "AxisType", None),
                           "Explicit", None)
        if explicit is not None and all(
                t == explicit for t in getattr(mesh, "axis_types", ())):
            with pytest.raises(ValueError, match="only refer to Auto axes"):
                run()
        else:
            assert np.isfinite(float(run()[0]))
