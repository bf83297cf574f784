"""Rank functions for the port's serving-mesh tests
(tests/test_torch_mesh_serve.py, tests/test_torch_mesh_serve_families.py),
run by ``helpers.torch_dist.run_ranks``:
torch only, never jax.  Each builds a ``(data, model)`` ``TrainMesh`` over
the ranks' gloo group on the CPU, serves a model of any family in the
reference's serving layout and returns numpy arrays.
"""

import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.launch.hlo_cost import analyze_graph
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_decode_fn, make_prefill_fn
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.common import param_tree
from repro_torch.parallel.sharding import (
    BATCH_AXES,
    decode_state_shardings,
    param_shardings,
    shard_tree,
)
from repro_torch.tree import tree_flatten_with_path, tree_map

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from chip_smoke import k2_offsets  # noqa: E402

__all__ = ["lane_rows", "serve_case", "serve_ranks"]


def lane_rows(mesh, B: int) -> tuple:
    """The lanes ``[lo, hi)`` this rank holds of a batch of ``B``: its rows
    over the batch axes where they divide, else all of them."""
    axes = [a for a in BATCH_AXES if a in mesh.shape]
    n = int(np.prod([mesh.shape[a] for a in axes]))
    if B % n:
        return 0, B
    index = 0
    for a in axes:
        index = index * mesh.shape[a] + mesh.coords[a]
    return index * (B // n), (index + 1) * (B // n)


def serve_case(mesh, cfg, weights, rules, layout, batch, max_seq, lane_pos,
               tokens, flops=False):
    """Prefill ``batch`` (numpy, global) on ``mesh`` with the parameters
    resting under ``rules`` (``train`` or ``serve``) and the cache laid out
    by ``layout``; set each lane's position of ``lane_pos`` ({lane: pos});
    then one decode step per row of ``tokens`` (steps, B).  Returns this
    rank's lanes, logits, decode-state shards (every leaf but ``pos``,
    after the prefill and after the steps; the cache's also as
    ``prefill_cache`` / ``decode_cache``) and the shard shapes the layout
    gives them, its resident parameter elements against the rules' and the
    whole, and, with ``flops``, the ``CostMode`` FLOPs of one more decode
    step, and the query offsets of the prefill's calls of K2's entry
    point."""
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_numpy(cfg, weights))
    full = param_tree(model)
    M = mesh.shape["model"]
    sh = param_shardings(full, mesh, mode=rules,
                         heads_divisible=cfg.num_heads % M == 0)
    params = tree_map(torch.clone, shard_tree(full, sh))
    for t in model.parameters():             # nothing whole stays behind
        t.data = torch.empty(0)
    prefill = make_prefill_fn(model, max_seq=max_seq, shardings=sh,
                              layout=layout)
    decode = make_decode_fn(model, shardings=sh, layout=layout,
                            max_seq=max_seq)
    offsets = []
    with k2_offsets(offsets):
        state, logits = prefill(params, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    lo, hi = lane_rows(mesh, batch["tokens"].shape[0])
    for lane, p in lane_pos.items():
        if lo <= lane < hi:
            state["pos"][lane - lo] = p
    keys = [k for k in state if k != "pos"]
    out = {"lanes": (lo, hi), "prefill_logits": logits.numpy().copy(),
           "k2_offsets": offsets,
           "prefill_state": {k: state[k].numpy().copy() for k in keys}}
    steps = []
    for row in tokens:
        state, logits = decode(params, state,
                               torch.from_numpy(row[lo:hi].copy()))
        steps.append(logits.numpy().copy())
    out["decode_logits"] = steps
    out["decode_state"] = {k: state[k].numpy().copy() for k in keys}
    whole_state = model.init_decode_state(hi - lo, max_seq, device="meta")
    ssh = decode_state_shardings(whole_state, mesh, layout=layout,
                                 batch_divisible=False)
    out["state_shapes"] = {k: ssh[k].shard_shape(tuple(whole_state[k].shape))
                           for k in keys}
    out["whole_shapes"] = {k: tuple(whole_state[k].shape) for k in keys}
    if "cache_k" in keys:
        out["cache_shape"] = out["state_shapes"]["cache_k"]
        for when in ("prefill", "decode"):
            out[f"{when}_cache"] = [out[f"{when}_state"][k]
                                    for k in ("cache_k", "cache_v")]
    flat = list(zip(tree_flatten_with_path(params),
                    tree_flatten_with_path(sh), tree_flatten_with_path(full)))
    out["resident"] = sum(t.numel() for (_, t), _, _ in flat)
    out["want"] = sum(int(np.prod(s.shard_shape(tuple(w.shape))))
                      for _, (_, s), (_, w) in flat)
    out["whole"] = sum(w.numel() for _, _, (_, w) in flat)
    if flops:
        state = tree_map(torch.clone, state)
        cost, _ = analyze_graph(decode, (params, state, torch.from_numpy(
            tokens[-1][lo:hi].copy())))
        out["flops"] = cost.flops
    return out


def serve_ranks(rank, n, data, model, cases):
    """Each case ``(name, cfg, weights, rules, layout, batch, max_seq,
    lane_pos, tokens, flops)`` on one (data, model) mesh: by name,
    :func:`serve_case`'s results."""
    torch.set_num_threads(1)
    mesh = make_host_mesh(data, model, device="cpu")
    return {name: serve_case(mesh, *args) for name, *args in cases}
