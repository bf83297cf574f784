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

import numpy as np
import pytest
from helpers.mesh_layout import layout_runs, model_replicated

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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: the reference's mesh run and the starting weights; per
    mesh shape, one spawn of the port's ranks for its cases; the
    one-device (or, for the MoE, the reference's mesh) gradients and
    FLOPs of the stepped cases."""
    return layout_runs(tmp_path_factory, CASES, STEPPED, seq=SEQ,
                       mesh_grads=MOE)


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
    replicated = model_replicated(cfgs[name], shape, ref)
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
    split = set(ref) - model_replicated(cfgs[name], BY_ID[name][2], ref)
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
