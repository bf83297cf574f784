"""The port's partition rules against the reference's, leaf by leaf.

For every arch at its published config, on the abstract production meshes
(one pod, 16 x 16, and two, 2 x 16 x 16: names and sizes, no devices),
the fitted spec of each parameter (train and serve modes, q-heads
dividing the model axis or not), each AdamW moment, each input of every
train and prefill shape, and each decode-state leaf (both cache layouts)
equals the reference's ``NamedSharding.spec``.  The port's trees are its
own: the parameters of ``build_model(..., device="meta")``, the decode
state of ``init_decode_state(..., device="meta")``, the batches of
``launch.steps.make_batch_stub``; the reference's come from
``jax.eval_shape``.  Then the reference's legality checks
(``tests/test_sharding_rules.py``) on the port's shardings: every shard
shape divides, and the parameters and decode state are sharded at all.
"""

import jax
import numpy as np
import pytest
import torch

from repro.compat import abstract_mesh
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import cells_for as ref_cells_for
from repro.configs import get_config as jax_get_config
from repro.launch.steps import make_batch_stub as ref_batch_stub
from repro.models import build_model as jax_build_model
from repro.optim import adamw_init as jax_adamw_init
from repro.parallel import sharding as RS
from repro_torch.configs import ARCH_IDS, SHAPES, cells_for, get_config
from repro_torch.launch.steps import make_batch_stub
from repro_torch.models import build_model
from repro_torch.models.common import param_tree
from repro_torch.parallel import sharding as PS
from repro_torch.tree import tree_flatten_with_path

#: (sizes, names) of the one-pod and the two-pod production meshes
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _meshes():
    return [(abstract_mesh(s, n), PS.AbstractMesh(s, n)) for s, n in MESHES]


def _norm(spec):
    """A spec as a plain tuple of None / name / tuple of names."""
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def _ref_specs(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="/"): _norm(s.spec)
            for p, s in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_specs(tree):
    return {"/".join(map(str, p)): _norm(s.spec)
            for p, s in tree_flatten_with_path(tree)}


@pytest.fixture(scope="module")
def shapes():
    """Per arch: (reference param shapes, port param meta tree)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            ref = jax.eval_shape(jax_build_model(jax_get_config(arch)).init,
                                 jax.random.PRNGKey(0))
            port = param_tree(build_model(get_config(arch), device="meta"))
            cache[arch] = (ref, port)
        return cache[arch]

    return get


def _opt_tree(params):
    step = torch.empty((), dtype=torch.int32, device="meta")
    return {"mu": params, "nu": params, "step": step}


def test_shapes_are_the_references():
    assert SHAPES.keys() == REF_SHAPES.keys()
    for name, spec in SHAPES.items():
        ref = REF_SHAPES[name]
        assert (spec.name, spec.kind, spec.seq_len, spec.global_batch) == (
            ref.name, ref.kind, ref.seq_len, ref.global_batch)
    for arch in ARCH_IDS:
        assert cells_for(arch) == ref_cells_for(arch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_shardings_equal_the_references(arch, shapes):
    ref_p, port_p = shapes(arch)
    ref_o = jax.eval_shape(jax_adamw_init, ref_p)
    for ref_mesh, mesh in _meshes():
        for mode in ("train", "serve"):
            for hd in (True, False):
                want = _ref_specs(RS.param_shardings(
                    ref_p, ref_mesh, mode=mode, heads_divisible=hd))
                got = _port_specs(PS.param_shardings(
                    port_p, mesh, mode=mode, heads_divisible=hd))
                assert got == want, (mode, hd)
        for hd in (True, False):
            want = _ref_specs(RS.opt_state_shardings(ref_o, ref_mesh,
                                                     heads_divisible=hd))
            got = _port_specs(PS.opt_state_shardings(
                _opt_tree(port_p), mesh, heads_divisible=hd))
            assert got == want, hd


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_shardings_equal_the_references(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for ref_mesh, mesh in _meshes():
        n = mesh.shape.get("pod", 1) * mesh.shape["data"]
        for name, shape in SHAPES.items():
            if shape.kind == "decode":
                continue
            kw = dict(batch=shape.global_batch, seq=shape.seq_len,
                      kind=shape.kind)
            stub, ref_stub = make_batch_stub(cfg, **kw), ref_batch_stub(
                jcfg, **kw)
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                    for k, v in stub.items()} == {
                k: (tuple(v.shape), str(v.dtype))
                for k, v in ref_stub.items()}
            div = shape.global_batch % n == 0
            want = {k: _norm(s.spec) for k, s in RS.batch_shardings(
                ref_stub, ref_mesh, batch_divisible=div).items()}
            got = {k: _norm(s.spec) for k, s in PS.batch_shardings(
                stub, mesh, batch_divisible=div).items()}
            assert got == want, name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_shardings_equal_the_references(arch):
    jax_model = jax_build_model(jax_get_config(arch))
    ref_s = jax.eval_shape(lambda: jax_model.init_decode_state(128, 32768))
    port_s = build_model(get_config(arch), device="meta").init_decode_state(
        128, 32768, device="meta")
    for ref_mesh, mesh in _meshes():
        for layout in ("seq", "heads"):
            for div in (True, False):
                want = _ref_specs(RS.decode_state_shardings(
                    ref_s, ref_mesh, layout=layout, batch_divisible=div))
                got = _port_specs(PS.decode_state_shardings(
                    port_s, mesh, layout=layout, batch_divisible=div))
                assert got == want, (layout, div)


# ------------------------------------------------- the reference's checks


def _mesh():
    return PS.AbstractMesh((16, 16), ("data", "model"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_shardings_legal(arch, shapes):
    _, port_p = shapes(arch)
    mesh = _mesh()
    p_shard = PS.param_shardings(port_p, mesh)
    n_sharded = 0
    for (_, leaf), (_, sh) in zip(tree_flatten_with_path(port_p),
                                  tree_flatten_with_path(p_shard)):
        sh.shard_shape(tuple(leaf.shape))          # raises if illegal
        if any(e is not None for e in sh.spec):
            n_sharded += 1
    assert n_sharded > 3, f"{arch}: params basically unsharded"
    o_tree = _opt_tree(port_p)
    for (_, leaf), (_, sh) in zip(
            tree_flatten_with_path(o_tree),
            tree_flatten_with_path(PS.opt_state_shardings(o_tree, mesh))):
        sh.shard_shape(tuple(leaf.shape))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_shardings_legal(arch):
    mesh = _mesh()
    s_shapes = build_model(get_config(arch), device="meta").init_decode_state(
        128, 32768, device="meta")
    cache_sharded = 0
    for (_, leaf), (_, sh) in zip(
            tree_flatten_with_path(s_shapes),
            tree_flatten_with_path(PS.decode_state_shardings(s_shapes,
                                                             mesh))):
        sh.shard_shape(tuple(leaf.shape))
        if any(e is not None for e in sh.spec):
            cache_sharded += 1
    assert cache_sharded >= 1, f"{arch}: decode state unsharded"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_shardings_legal(arch):
    mesh = _mesh()
    cfg = get_config(arch)
    for shape in SHAPES.values():
        if shape.kind == "decode":
            continue
        stub = make_batch_stub(cfg, batch=shape.global_batch,
                               seq=shape.seq_len, kind=shape.kind)
        for key, sh in PS.batch_shardings(stub, mesh).items():
            sh.shard_shape(tuple(stub[key].shape))


# ------------------------------------------------------ layout helpers


def test_fit_spec_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = PS.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    # 36 heads do not divide 16: replicated; ("pod", "data") keeps the
    # prefix that divides
    assert PS.fit_spec(mesh, PS.P("data", "model", None), (64, 36, 8)) == \
        PS.P("data", None, None)
    assert PS.fit_spec(mesh, PS.P(("pod", "data"),), (8,)) == PS.P("pod")
    sh = PS.named(mesh, PS.P(("pod", "data"), "model"), (64, 32))
    assert sh.placements == (Shard(0), Shard(0), Shard(1))
    assert PS.NamedSharding(mesh, PS.P(None, "model")).placements == (
        Replicate(), Replicate(), Shard(1))
    assert sh.shard_shape((64, 32)) == (2, 2)
    assert sh.global_shape((2, 2)) == (64, 32)
    with pytest.raises(ValueError):
        PS.NamedSharding(mesh, PS.P("model")).shard_shape((20,))
    with pytest.raises(ValueError):
        PS.NamedSharding(mesh, PS.P(("data", "pod"))).placements
    assert PS.named(mesh, PS.P("data", "nope", ("pod", "x"))).spec == \
        PS.P("data", None, ("pod",))
    assert np.prod([mesh.shape[a] for a in mesh.axis_names]) == mesh.size


def test_serving_steps_call_the_model():
    """``make_prefill_fn`` / ``make_decode_fn`` are the model's prefill and
    decode step on a batch dict, as the reference's (the port's model
    holds its weights, so neither takes a parameter tree)."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.launch.steps import make_decode_fn, make_prefill_fn

    cfg = dataclasses.replace(get_reduced("gemma2-9b"), dtype="float32")
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    state, logits = make_prefill_fn(model, max_seq=16)({"tokens": tokens})
    want_state, want = model.prefill(tokens, max_seq=16)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    got = make_decode_fn(model)(state, nxt)[1]
    torch.testing.assert_close(got, model.decode_step(want_state, nxt)[1],
                               rtol=0, atol=0)
