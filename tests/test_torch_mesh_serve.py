"""The port's serving layout on a mesh against the reference's meshed
prefill and decode on the same mesh.

``launch.steps.make_prefill_fn`` / ``make_decode_fn`` with ``shardings=``
serve ``TransformerLM`` as the reference's serving cell lays it out
(``repro/launch/dryrun.py``'s ``build_cell``): the weights rest as
``param_shardings`` gives them (training or serving rules) and each layer's
are gathered where it runs; the prefill splits its work over ``model``
(the sequence between sublayers, q heads or query rows, ``d_ff``, experts
with each shard's capacity); the decode cache is the rank's shard of
``decode_state_shardings``, its rows (``seq``) or kv heads (``heads``)
split over ``model`` where the axis divides them, and a decode step takes
the softmax over the split rows with their global max and sum.

The reference jits its own ``make_prefill_fn`` and ``make_decode_fn``
with its ``build_cell``'s in- and out-shardings on a
``jax.sharding.Mesh`` of Auto axes over the conftest's simulated host
devices (its ``make_production_mesh`` makes Explicit axes under jax 0.9,
which its ``with_sharding_constraint`` refuses); the port runs as many
gloo ranks (``helpers.torch_dist.run_ranks``).  Both start from the
reference's ``init(PRNGKey(0))`` weights, fp32, on 4 lanes of a seeded
prompt of S tokens into a cache of ``max_seq`` > S rows; lane 3 is then
set to ``max_seq - 3``, so it runs past the cache's end, and 8 greedy
decode steps follow, each fed the reference's greedy tokens, crossing the
boundary of the ranks' windows at ``max_seq / model``.

Cases: gemma2 on 2 x 2 (softcap, sliding windows, q and kv heads divide
the axis), qwen2.5 on 1 x 3 (biases; neither its 5 heads, its 13 tokens
nor its 26 rows divide 3: the query-rows split on a padded sequence, the
cache whole), qwen3-moe on 2 x 2 (each shard's capacity in the prefill, a
lossless decode, the experts split) and llava with its patch prefix on
2 x 2; each in ``seq`` and ``heads``, under the training and the serving
rules.  Limits: the logits within 1e-4 of the reference's, each rank's
cache shard within 1e-5 (times the cache's largest entry where it passes
1: gemma2's scaled embeddings put K/V near 8, where fp32 sums taken in
another order read 1.1e-5 apart), the greedy tokens equal where the
reference's top two differ by more than 1e-3.  Each rank holds exactly
the elements the rules' shard shapes give and, where the rules or the
layout split them, less than the whole weights and cache.  A 1 x 4 rank's ``CostMode``
FLOPs for a gemma2 decode step are under half of one device's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import torch_mesh_serve
from helpers.torch_dist import run_ranks
from helpers.torch_port import fp32_config, model_pair, to_numpy

from repro.launch.steps import make_decode_fn as ref_decode_fn
from repro.launch.steps import make_prefill_fn as ref_prefill_fn
from repro.models import build_model as jax_build_model
from repro.models.common import mesh_context as jax_mesh_context
from repro.parallel.sharding import P as JP
from repro.parallel.sharding import batch_shardings as ref_batch_shardings
from repro.parallel.sharding import \
    decode_state_shardings as ref_state_shardings
from repro.parallel.sharding import named as ref_named
from repro.parallel.sharding import param_shardings as ref_param_shardings
from repro_torch.launch.hlo_cost import analyze_graph
from repro_torch.models.common import ArchConfig

LOGIT_ATOL, CACHE_ATOL, CLEAR_MARGIN = 1e-4, 1e-5, 1e-3
WORK_SHARE = 0.5
B, STEPS = 4, 8
LANE = 3

#: (id, arch, (data, model), prompt tokens S, max_seq, patch_embeds)
CASES = [
    ("gemma2-2x2", "gemma2-9b", (2, 2), 10, 24, False),
    ("qwen2.5-1x3", "qwen2.5-32b", (1, 3), 13, 26, False),
    ("qwen3-moe-2x2", "qwen3-moe-235b-a22b", (2, 2), 10, 24, False),
    ("llava-2x2", "llava-next-34b", (2, 2), 10, 24, True),
]
LAYOUTS = ("seq", "heads")
RULES = ("train", "serve")
BY_ID = {c[0]: c for c in CASES}
RUNS = [(c, lay, rules) for c in BY_ID for lay in LAYOUTS for rules in RULES]
#: no dimension of the reduced qwen2.5 divides 3: every rule replicates
ALL_REPLICATED = {"qwen2.5-1x3"}
#: the 1 x 4 cell whose decode step's FLOPs are counted
FLOP_CASE = ("gemma2-1x4", "gemma2-9b", (1, 4), 10, 24, False)


def _jax_mesh(shape):
    n = shape[0] * shape[1]
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             ("data", "model"))


def _batch(cfg, S, patches):
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    if patches:
        batch["patch_embeds"] = (rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32) * 0.5)
    return batch


def _nested(params):
    return jax.tree_util.tree_map(np.asarray, to_numpy(params))


def _reference(cfg, params, shape, layout, rules, batch, max_seq):
    """The reference's meshed prefill, lane 3 moved, then ``STEPS`` greedy
    decode steps: the logits, the greedy tokens fed, the caches after the
    prefill and after the steps (whole, numpy)."""
    model = jax_build_model(cfg, impl="xla", decode_layout=layout)
    mesh = _jax_mesh(shape)
    hd = cfg.num_heads % shape[1] == 0
    p_sh = ref_param_shardings(params, mesh, mode=rules, heads_divisible=hd)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    b_sh = ref_batch_shardings(jbatch, mesh, batch_divisible=True)
    prefill = ref_prefill_fn(model, max_seq=max_seq)
    rows = ref_named(mesh, JP(("pod", "data"), None))
    with mesh, jax_mesh_context(mesh):
        s_shape = jax.eval_shape(prefill, params, jbatch)[0]
        s_sh = ref_state_shardings(s_shape, mesh, layout=layout,
                                   batch_divisible=True)
        state, logits = jax.jit(prefill, in_shardings=(p_sh, b_sh),
                                out_shardings=(s_sh, rows))(params, jbatch)
        caches = [[np.asarray(state[k]) for k in ("cache_k", "cache_v")]]
        state = dict(state)
        state["pos"] = jax.device_put(
            state["pos"].at[LANE].set(max_seq - 3), s_sh["pos"])
        decode = jax.jit(ref_decode_fn(model),
                         in_shardings=(p_sh, s_sh, ref_named(
                             mesh, JP(("pod", "data")))),
                         out_shardings=(s_sh, rows))
        out, tokens = [np.asarray(logits)], []
        for _ in range(STEPS):
            tok = np.argmax(out[-1], axis=-1).astype(np.int32)
            tokens.append(tok)
            state, logits = decode(params, state, jnp.asarray(tok))
            out.append(np.asarray(logits))
        caches.append([np.asarray(state[k]) for k in ("cache_k", "cache_v")])
    return {"logits": out, "tokens": np.stack(tokens), "caches": caches}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per (case, layout, rules): the reference's run and the port's ranks'
    (one spawn of ranks per mesh shape); the 1 x 4 rank's and one
    device's FLOPs for a decode step."""
    refs, by_shape, cfgs = {}, {}, {}
    for name, arch, shape, S, max_seq, patches in CASES:
        jcfg = fp32_config(arch)
        _, params, _ = model_pair(jcfg)
        cfg = ArchConfig(**dataclasses.asdict(jcfg))
        cfgs[name] = cfg
        weights = _nested(params)
        batch = _batch(jcfg, S, patches)
        for layout in LAYOUTS:
            for rules in RULES:
                ref = _reference(jcfg, params, shape, layout, rules, batch,
                                 max_seq)
                refs[name, layout, rules] = ref
                by_shape.setdefault(shape, []).append(
                    (f"{name}/{layout}/{rules}", cfg, weights, rules, layout,
                     batch, max_seq, {LANE: max_seq - 3}, ref["tokens"],
                     False))
    name, arch, shape, S, max_seq, patches = FLOP_CASE
    jcfg = fp32_config(arch)
    _, params, single = model_pair(jcfg)
    batch = _batch(jcfg, S, patches)
    tokens = np.zeros((1, B), np.int32)
    by_shape.setdefault(shape, []).append(
        (name, ArchConfig(**dataclasses.asdict(jcfg)), _nested(params),
         "train", "seq", batch, max_seq, {}, tokens, True))
    state, _ = single.prefill(torch.from_numpy(batch["tokens"]),
                              max_seq=max_seq)
    one, _ = analyze_graph(single.decode_step,
                           (state, torch.from_numpy(tokens[0])))
    ranks = {}
    for shape, cases in by_shape.items():
        got = run_ranks(torch_mesh_serve.serve_ranks, shape[0] * shape[1],
                        tmp_path_factory.mktemp("serve"), *shape, cases,
                        timeout=300)
        for case in cases:
            ranks[case[0]] = [g[case[0]] for g in got]
    return refs, ranks, cfgs, one.flops


def _window(run, rank, shape, max_seq, K):
    """The slices of the whole cache that ``rank``'s shard holds."""
    m = rank % shape[1]
    lo, hi = run["lanes"]
    rows, heads = run["cache_shape"][2], run["cache_shape"][3]
    r0 = m * rows if rows < max_seq else 0
    j0 = m * heads if heads < K else 0
    return (slice(None), slice(lo, hi), slice(r0, r0 + rows),
            slice(j0, j0 + heads))


@pytest.mark.parametrize("name,layout,rules", RUNS)
def test_serving_layout_matches_the_references_mesh(runs, name, layout,
                                                    rules):
    refs, ranks, cfgs, _ = runs
    ref = refs[name, layout, rules]
    _, _, shape, S, max_seq, _ = BY_ID[name]
    for rank, run in enumerate(ranks[f"{name}/{layout}/{rules}"]):
        lo, hi = run["lanes"]
        got = [run["prefill_logits"]] + run["decode_logits"]
        assert len(got) == len(ref["logits"]) == STEPS + 1
        for step, (g, w) in enumerate(zip(got, ref["logits"])):
            w = w[lo:hi]
            err = float(np.abs(g - w).max())
            assert err <= LOGIT_ATOL, (rank, step, err)
            top2 = np.sort(w, axis=-1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > CLEAR_MARGIN
            assert clear.any()
            np.testing.assert_array_equal(np.argmax(g, -1)[clear],
                                          np.argmax(w, -1)[clear])
        win = _window(run, rank, shape, max_seq, cfgs[name].num_kv_heads)
        for got_c, want_c in zip((run["prefill_cache"], run["decode_cache"]),
                                 ref["caches"]):
            for g, w in zip(got_c, want_c):
                assert g.shape == w[win].shape
                err = float(np.abs(g - w[win]).max())
                scale = max(1.0, float(np.abs(w).max()))
                assert err <= CACHE_ATOL * scale, (rank, err, scale)


@pytest.mark.parametrize("name,layout,rules", RUNS)
def test_serving_ranks_hold_only_their_shards(runs, name, layout, rules):
    """The rules' shards of the weights, nothing more, and the cache the
    layout gives: split where the axis divides its rows (``seq``) or kv
    heads (``heads``)."""
    _, ranks, cfgs, _ = runs
    cfg = cfgs[name]
    _, _, shape, S, max_seq, _ = BY_ID[name]
    M = shape[1]
    split = (max_seq % M == 0 if layout == "seq"
             else cfg.num_kv_heads % M == 0)
    for run in ranks[f"{name}/{layout}/{rules}"]:
        assert run["resident"] == run["want"]
        if name in ALL_REPLICATED:
            assert run["want"] == run["whole"]
        else:
            assert run["want"] < run["whole"]
        lo, hi = run["lanes"]
        assert tuple(run["decode_cache"][0].shape) == run["cache_shape"]
        whole = (cfg.num_layers, hi - lo, max_seq, cfg.num_kv_heads, cfg.hd)
        smaller = np.prod(run["cache_shape"]) < np.prod(whole)
        assert smaller == split


def test_a_decode_rank_does_under_half_of_one_devices_work(runs):
    """gemma2 on 1 x 4 in ``seq``: each rank projects one q head, attends
    over its quarter of the cache's rows, computes a quarter of ``d_ff``
    and scores a quarter of the vocabulary; a rank that repeated the step
    would count at least the one-device FLOPs."""
    _, ranks, _, single = runs
    assert single > 0
    for run in ranks[FLOP_CASE[0]]:
        assert 0 < run["flops"] < WORK_SHARE * single, (run["flops"], single)
