"""The serving layout on a mesh of ``RwkvLM``, the hybrid and whisper
against the reference's meshed prefill and decode on the same mesh, and
K2's query offset, which the query-rows prefill now runs.

``launch.steps.make_prefill_fn`` / ``make_decode_fn`` with ``shardings=``
serve every family as the reference's serving cell lays it out
(``repro/launch/dryrun.py``'s ``build_cell``): the weights rest as
``param_shardings`` gives them and each layer's are gathered where it
runs; the prefill splits its work over ``model`` as a training step's
forward does (RWKV6's time mix on the rank's rows, through K3's entry
point; the hybrid's attention by q heads or by query rows, through K2's,
its SSM scan by ``d_inner``; whisper's encoder and decoder over their own
lengths), each recurrence over the prompt's tokens alone, not its
padding; the decode state is the rank's shard of
``decode_state_shardings``: the cache's rows (``seq``) or kv heads
(``heads``), whisper's cross K/V by heads, RWKV6's ``wkv`` by its value
columns and the hybrid's ``ssm_h`` by ``d_inner``, each split over
``model`` where the axis divides it.

The reference jits its own ``make_prefill_fn`` and ``make_decode_fn``
with its ``build_cell``'s in- and out-shardings on a
``jax.sharding.Mesh`` of Auto axes over the conftest's simulated host
devices, as ``test_torch_mesh_serve.py`` does; the port runs as many gloo
ranks (``helpers.torch_dist.run_ranks``).  Both start from the
reference's ``init(PRNGKey(0))`` weights, fp32, on 4 lanes of a seeded
prompt of S tokens (whisper's with seeded frames) into ``max_seq`` rows;
lane 3 is then set to ``max_seq - 3``, so it runs past the cache's end,
and 8 greedy decode steps follow, each fed the reference's greedy tokens,
crossing the boundary of the ranks' windows.  The reference runs once per
case and cache layout (RWKV6, which has no cache, once per case: its two
layouts are one program), under the training rules: the rules change
where its weights rest, not the function, and the port's runs under both
rules are held to it.

Cases, on 2 x 2 and on 1 x 3, each in ``seq`` and ``heads`` under the
training and the serving rules: RWKV6 (11 and 13 tokens: its scan takes
any length under 64; on 2 x 2 each rank keeps 8 of the 16 value columns
and the prefill's state reaches them by an all-to-all; on 1 x 3 neither
the 4 rows, 64 channels nor 16 columns divide 3: every rank runs the time
mix on all rows and keeps the state whole); hymba (on 2 x 2 its 4 q and 2
kv heads and its ``d_inner`` of 128 divide; on 1 x 3 none does, so
attention splits by query rows, K2 at the rank's offset, and the SSM state
stays whole); whisper (on 2 x 2 its 4 heads split the cross K/V; on 1 x 3
its 16 frames and 13 tokens are padded to 18 and 15, attention by query
rows).  ``max_seq`` is 24, which 2 and 3 divide, so ``seq`` splits the
cache's rows on both meshes.

Limits are ``test_torch_mesh_serve.py``'s: the logits within 1e-4 of the
reference's, each rank's state shard within 1e-5 times the leaf's largest
entry where it passes 1, the greedy tokens equal where the reference's top
two differ by more than 1e-3.  Each rank holds exactly the elements the
rules' shard shapes give and state shards of the shapes the layout gives,
smaller than the whole where the axis divides.  A 1 x 4 rank's
``CostMode`` FLOPs for a decode step stay under the share of one device's
that :data:`WORK_SHARE` reckons.
"""

import contextlib
import dataclasses
import types
from concurrent.futures import ThreadPoolExecutor

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
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa_bind
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.launch.hlo_cost import analyze_graph
from repro_torch.models.common import ArchConfig

LOGIT_ATOL, STATE_ATOL, CLEAR_MARGIN = 1e-4, 1e-5, 1e-3
B, STEPS, LANE, MAX_SEQ = 4, 8, 3, 24

#: (id, arch, (data, model), prompt tokens S)
CASES = [
    ("rwkv6-2x2", "rwkv6-3b", (2, 2), 11),
    ("rwkv6-1x3", "rwkv6-3b", (1, 3), 13),
    ("hymba-2x2", "hymba-1.5b", (2, 2), 11),
    ("hymba-1x3", "hymba-1.5b", (1, 3), 13),
    ("whisper-2x2", "whisper-tiny", (2, 2), 11),
    ("whisper-1x3", "whisper-tiny", (1, 3), 13),
]
LAYOUTS = ("seq", "heads")
RULES = ("train", "serve")
BY_ID = {c[0]: c for c in CASES}
RUNS = [(c, lay, rules) for c in BY_ID for lay in LAYOUTS for rules in RULES]
#: no dimension of these reduced configs divides 3: every rule replicates
ALL_REPLICATED = {"rwkv6-1x3", "hymba-1x3", "whisper-1x3"}
#: per family, the share of one device's decode-step FLOPs under which a
#: 1 x 4 rank's must stay (seq layout, 4 lanes, 24 rows).  Reckoned from
#: the split, per token and layer in matmul FLOPs of the reduced configs
#: (D 64), with the logits' table split four ways:
#: * RWKV6: the token-shift LoRA, r, k, the decay LoRA and the channel
#:   mix's gate stay whole on every rank (about 0.58 of the layer), v, the
#:   gate, ``wo`` and ``d_ff`` (0.42) split four ways: 0.58 + 0.42 / 4 of
#:   the layers, 1/4 of the logits, about 0.60 with the elementwise work;
#: * hymba: k and v whole (0.05 of the layer), q, ``wo``, the attention,
#:   the SSM's ``d_inner`` and ``d_ff`` split four ways: about 0.29;
#: * whisper: self-attention's k and v whole (0.18 of the layer), the rest
#:   split four ways: about 0.36.
#: The limits add 0.1 for the norms, residuals and softmaxes every rank
#: repeats; a rank that repeated the step would count at least 1.
WORK_SHARE = {"rwkv6-3b": 0.7, "hymba-1.5b": 0.4, "whisper-tiny": 0.46}
FLOP_MESH = (1, 4)


def _jax_mesh(shape):
    n = shape[0] * shape[1]
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             ("data", "model"))


def _batch(cfg, S):
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = (rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model)).astype(np.float32) * 0.5)
    return batch


def _nested(params):
    return jax.tree_util.tree_map(np.asarray, to_numpy(params))


def _state(state):
    return {k: np.asarray(v) for k, v in state.items() if k != "pos"}


def _reference(cfg, params, shape, layout, batch):
    """The reference's meshed prefill, lane 3 moved, then ``STEPS`` greedy
    decode steps: the logits, the greedy tokens fed, the decode state after
    the prefill and after the steps (whole, numpy)."""
    model = jax_build_model(cfg, impl="xla", decode_layout=layout)
    mesh = _jax_mesh(shape)
    hd = cfg.num_heads % shape[1] == 0
    p_sh = ref_param_shardings(params, mesh, mode="train", heads_divisible=hd)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    b_sh = ref_batch_shardings(jbatch, mesh, batch_divisible=True)
    prefill = ref_prefill_fn(model, max_seq=MAX_SEQ)
    rows = ref_named(mesh, JP(("pod", "data"), None))
    with mesh, jax_mesh_context(mesh):
        s_shape = jax.eval_shape(prefill, params, jbatch)[0]
        s_sh = ref_state_shardings(s_shape, mesh, layout=layout,
                                   batch_divisible=True)
        state, logits = jax.jit(prefill, in_shardings=(p_sh, b_sh),
                                out_shardings=(s_sh, rows))(params, jbatch)
        states = [_state(state)]
        state = dict(state)
        state["pos"] = jax.device_put(
            state["pos"].at[LANE].set(MAX_SEQ - 3), s_sh["pos"])
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
        states.append(_state(state))
    return {"logits": out, "tokens": np.stack(tokens), "states": states}


def _spawn(pool, tmp_path_factory, shape, cases):
    """The ranks of a (data, model) mesh running ``cases``, started in a
    thread of ``pool``."""
    return pool.submit(run_ranks, torch_mesh_serve.serve_ranks,
                       shape[0] * shape[1], tmp_path_factory.mktemp("serve"),
                       *shape, cases, timeout=300)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per (case, layout): the reference's run; per (case, layout, rules)
    the port's ranks' (one spawn of ranks per mesh shape); per family the
    1 x 4 ranks' and one device's FLOPs for a decode step.  The 1 x 4
    ranks, which need no reference tokens, run while the reference does,
    and the other meshes' ranks run side by side: each rank is a
    single-threaded process."""
    refs, by_shape, cfgs, single, flop_cases = {}, {}, {}, {}, []
    pairs = {}
    for name, arch, shape, S in CASES:
        jcfg = fp32_config(arch)
        cfg = ArchConfig(**dataclasses.asdict(jcfg))
        cfgs[name] = cfg
        if arch not in pairs:
            _, params, model = pairs[arch] = model_pair(jcfg)
            batch = _batch(jcfg, S)
            inputs = {k: torch.from_numpy(v) for k, v in batch.items()
                      if k != "tokens"}
            state, _ = model.prefill(torch.from_numpy(batch["tokens"]),
                                     max_seq=MAX_SEQ, **inputs)
            tokens = np.zeros((1, B), np.int32)
            one, _ = analyze_graph(model.decode_step,
                                   (state, torch.from_numpy(tokens[0])))
            single[arch] = one.flops
            flop_cases.append((f"{arch}/flops", cfg, _nested(params),
                               "train", "seq", batch, MAX_SEQ, {}, tokens,
                               True))
    with ThreadPoolExecutor(3) as pool:
        spawns = {FLOP_MESH: (_spawn(pool, tmp_path_factory, FLOP_MESH,
                                     flop_cases), flop_cases)}
        for name, arch, shape, S in CASES:
            jcfg = fp32_config(arch)
            _, params, _ = pairs[arch]
            weights = _nested(params)
            batch = _batch(jcfg, S)
            for layout in LAYOUTS:
                if arch == "rwkv6-3b" and layout == "heads":
                    # RWKV6 has no cache: its program and its state's
                    # shardings are the same in both layouts
                    ref = refs[name, "seq"]
                else:
                    ref = _reference(jcfg, params, shape, layout, batch)
                refs[name, layout] = ref
                for rules in RULES:
                    by_shape.setdefault(shape, []).append(
                        (f"{name}/{layout}/{rules}", cfgs[name], weights,
                         rules, layout, batch, MAX_SEQ, {LANE: MAX_SEQ - 3},
                         ref["tokens"], False))
        for shape, cases in by_shape.items():
            spawns[shape] = (_spawn(pool, tmp_path_factory, shape, cases),
                             cases)
        ranks = {}
        for future, cases in spawns.values():
            got = future.result()
            for case in cases:
                ranks[case[0]] = [g[case[0]] for g in got]
    return refs, ranks, cfgs, single


def _window(run, rank, key, shape):
    """The slices of the whole leaf ``key`` that ``rank``'s shard holds:
    its lanes, and along a dimension that the layout splits, the rank's
    chunk over ``model``."""
    m = rank % shape[1]
    lo, hi = run["lanes"]
    out = [slice(None), slice(lo, hi)]
    for part, whole in zip(run["state_shapes"][key][2:],
                           run["whole_shapes"][key][2:]):
        r0 = m * part if part < whole else 0
        out.append(slice(r0, r0 + part))
    return tuple(out)


def _splits(cfg, key: str, layout: str, M: int) -> bool:
    """Whether the layout splits the decode-state leaf ``key`` over a
    ``model`` axis of M (the reference's ``decode_state_shardings``)."""
    if key.startswith("cache"):
        n = MAX_SEQ if layout == "seq" else cfg.num_kv_heads
    elif key in ("xk", "xv"):
        n = cfg.num_heads
    elif key == "wkv":
        n = cfg.rwkv_head_size
    elif key == "ssm_h":
        n = cfg.ssm_d_inner or 2 * cfg.d_model
    else:                                    # tm_prev / cm_prev: rows only
        return False
    return n % M == 0


@pytest.mark.parametrize("name,layout,rules", RUNS)
def test_family_serving_layout_matches_the_references_mesh(runs, name,
                                                           layout, rules):
    refs, ranks, _, _ = runs
    ref = refs[name, layout]
    _, _, shape, S = BY_ID[name]
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
        for when, want_state in zip(("prefill", "decode"), ref["states"]):
            got_state = run[f"{when}_state"]
            assert set(got_state) == set(want_state)
            for key, g in got_state.items():
                w = want_state[key]
                win = _window(run, rank, key, shape)
                assert g.shape == w[win].shape, (key, g.shape)
                err = float(np.abs(g - w[win]).max())
                scale = max(1.0, float(np.abs(w).max()))
                assert err <= STATE_ATOL * scale, (rank, when, key, err)


@pytest.mark.parametrize("name,layout,rules", RUNS)
def test_family_serving_ranks_hold_only_their_shards(runs, name, layout,
                                                     rules):
    """The rules' shards of the weights, nothing more, and each leaf of
    the decode state in the shape the layout gives it: split where the
    axis divides it, whole where it does not."""
    _, ranks, cfgs, _ = runs
    cfg = cfgs[name]
    _, _, shape, _ = BY_ID[name]
    for run in ranks[f"{name}/{layout}/{rules}"]:
        assert run["resident"] == run["want"]
        if name in ALL_REPLICATED:
            assert run["want"] == run["whole"]
        else:
            assert run["want"] < run["whole"]
        for key, g in run["decode_state"].items():
            assert tuple(g.shape) == run["state_shapes"][key], key
            lo, hi = run["lanes"]
            whole = (run["whole_shapes"][key][0], hi - lo,
                     *run["whole_shapes"][key][2:])
            smaller = np.prod(g.shape) < np.prod(whole)
            assert smaller == _splits(cfg, key, layout, shape[1]), key


@pytest.mark.parametrize("arch", sorted(WORK_SHARE))
def test_a_decode_rank_does_its_share_of_one_devices_work(runs, arch):
    """A 1 x 4 rank in ``seq`` under the reckoned share of one device's
    decode-step FLOPs (:data:`WORK_SHARE`)."""
    _, ranks, _, single = runs
    assert single[arch] > 0
    for run in ranks[f"{arch}/flops"]:
        share = run["flops"] / single[arch]
        assert 0 < share < WORK_SHARE[arch], (arch, share)


def test_query_rows_prefill_runs_k2_at_the_ranks_offset(runs):
    """hymba on 1 x 3: its 4 q heads do not divide 3, so each layer's
    attention takes the query-rows branch, which calls K2's entry point
    (its plain version on the CPU) with the rank's first position,
    ``rank · ceil(13 / 3)``, one call a layer."""
    _, ranks, cfgs, _ = runs
    cfg = cfgs["hymba-1x3"]
    for layout in LAYOUTS:
        for rank, run in enumerate(ranks[f"hymba-1x3/{layout}/train"]):
            assert run["k2_offsets"] == [rank * 5] * cfg.num_layers


@pytest.mark.parametrize("hd,window,cap", [(16, 0, 0.0), (64, 7, 0.0),
                                           (128, 0, 30.0), (256, 5, 50.0)])
def test_flash_reference_at_an_offset_is_the_full_calls_rows(hd, window,
                                                            cap):
    """``flash_attention_ref`` with ``q_offset`` (and ``ops.flash_attention``
    on CPU tensors) gives the rows ``[q_offset, q_offset + Sq)`` of the
    call over the whole sequence, the windows and softcap included."""
    g = torch.Generator().manual_seed(hd + window)
    S, K, G, off, Sq = 23, 2, 3, 9, 11
    q = torch.randn((1, S, K, G, hd), generator=g)
    k = torch.randn((1, S, K, hd), generator=g)
    v = torch.randn((1, S, K, hd), generator=g)
    kw = dict(scale=hd ** -0.5, logit_cap=cap, causal=True)
    full = flash_attention_ref(q.reshape(1, S, K * G, hd), k, v, window, **kw)
    part = flash_attention_ref(q[:, off:off + Sq].reshape(1, Sq, K * G, hd),
                               k, v, window, q_offset=off, **kw)
    torch.testing.assert_close(part, full[:, off:off + Sq], rtol=0, atol=0)
    ops = fa_ops.flash_attention(q[:, off:off + Sq], k, v, window=window,
                                 q_offset=off, **kw)
    torch.testing.assert_close(ops.reshape(1, Sq, K * G, hd), part,
                               rtol=0, atol=0)


def test_flash_binding_passes_the_offset(monkeypatch):
    """The binding hands ``q_offset`` to the kernel's entry point in its
    place (after ``causal``) and refuses a negative one."""
    calls = []

    def fake_kernel(name, argtypes):
        def fn(*args):
            calls.append(args)
            return 0
        return fn

    monkeypatch.setattr(_build, "kernel", fake_kernel)
    monkeypatch.setattr(fa_bind, "KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    q = torch.zeros((1, 5, 4, 64))
    k = torch.zeros((1, 12, 2, 64))
    fa_bind.flash_attention_cuda(q, k, k, 8, scale=0.125, q_offset=7)
    ((args),) = calls
    assert len(args) == len(fa_bind._ARGS)
    assert (args[5], args[6], args[13], args[14]) == (5, 12, 1, 7)
    with pytest.raises(ValueError, match="offset >= 0"):
        fa_bind.flash_attention_cuda(q, k, k, 8, scale=0.125, q_offset=-1)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-tiny"])
def test_tables_split_by_their_columns_serve_as_one_device(arch, tmp_path):
    """A vocabulary of 255, which 2 does not divide: on 1 x 2 under the
    serving rules the embedding table (and whisper's ``pos_embed``) rest
    split by their columns, and the ranks look rows up and score on them
    so; the logits of the prefill and of each decode step equal one
    device's."""
    jcfg = fp32_config(arch, vocab_size=255)
    _, params, model = model_pair(jcfg)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    batch = _batch(jcfg, 11)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (STEPS, B)).astype(np.int32)
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()
              if k != "tokens"}
    state, logits = model.prefill(torch.from_numpy(batch["tokens"]),
                                  max_seq=MAX_SEQ, **inputs)
    want = [logits.numpy()]
    for row in tokens:
        state, logits = model.decode_step(state, torch.from_numpy(row))
        want.append(logits.numpy())
    case = ("split", cfg, _nested(params), "serve", "seq", batch, MAX_SEQ,
            {}, tokens, False)
    for run in (r["split"] for r in run_ranks(
            torch_mesh_serve.serve_ranks, 2, tmp_path, 1, 2, [case],
            timeout=300)):
        assert run["resident"] == run["want"] < run["whole"]
        got = [run["prefill_logits"]] + run["decode_logits"]
        for step, (g, w) in enumerate(zip(got, want)):
            assert float(np.abs(g - w).max()) <= LOGIT_ATOL, step
