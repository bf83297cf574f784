"""Rank function for tests/test_torch_remat.py, run by
``helpers.torch_dist.run_ranks`` (or called directly for one device):
torch only, never jax.  One ``make_train_step`` step of a port model built
with each remat policy, and what the step keeps of its gathered leaves."""

import gc
import weakref

import torch

from helpers.torch_mesh import _on_mesh, _whole, masked_lm
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import steps
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.common import param_tree
from repro_torch.optim import adamw_init
from repro_torch.parallel.sharding import TrainLayout, param_shardings, \
    shard_tree
from repro_torch.tree import tree_flatten_with_path, tree_map

__all__ = ["remat_step_ranks"]


def remat_step_ranks(rank, n, data, model, cases, policies):
    """On a (data, model) mesh (one device where ``data`` is None), for
    each case ``(name, cfg, weights, seq)`` and policy: the step's loss,
    its gradient whole by path, the layer leaves gathered in the forward,
    how many of them are alive when the backward starts, and the gathers
    the backward makes."""
    mesh = _on_mesh(data, model) if data else None
    return {name: {policy: _step(mesh, cfg, weights, seq, policy)
                   for policy in policies}
            for name, cfg, weights, seq in cases}


def _step(mesh, cfg, weights, seq, policy):
    m = build_model(cfg, device="cpu", remat=policy)
    m.load_state_dict(params_from_numpy(cfg, weights))
    params, sh = param_tree(m), None
    if mesh is not None:
        sh = param_shardings(params, mesh, heads_divisible=cfg.num_heads
                             % mesh.shape["model"] == 0)
        params = tree_map(torch.clone, shard_tree(params, sh))
    dc = DataConfig(global_batch=4, seq_len=seq, vocab_size=cfg.vocab_size)
    batch = {k: torch.as_tensor(v) for k, v in
             masked_lm(SyntheticLM(dc), cfg).batch_at(0).items()}

    seen = {"gathered": [], "alive": 0, "regathered": 0, "backward": False}
    real_leaf, real_backward, real_update = (TrainLayout.leaf, steps.backward,
                                             steps.adamw_update)

    def leaf(self, path, t, split, layer=False):
        out = real_leaf(self, path, t, split, layer)
        gathered = out.untyped_storage()._cdata != \
            t.untyped_storage()._cdata
        if layer and gathered and not seen["backward"]:
            seen["gathered"].append(weakref.ref(out.untyped_storage()))
        return out

    def backward(loss, leaves):
        gc.collect()
        seen["alive"] = sum(r() is not None for r in seen["gathered"])
        seen["backward"] = True
        return real_backward(loss, leaves)

    def update(grads, *a, **kw):
        seen["grads"] = grads
        return real_update(grads, *a, **kw)

    if mesh is not None:
        real_gather = mesh.all_gather

        def gather(*a, **kw):
            seen["regathered"] += seen["backward"]
            return real_gather(*a, **kw)

        mesh.all_gather = gather
    TrainLayout.leaf, steps.backward, steps.adamw_update = leaf, backward, \
        update
    try:
        _, _, metrics = steps.make_train_step(m, shardings=sh)(
            params, adamw_init(params), batch)
    finally:
        TrainLayout.leaf, steps.backward, steps.adamw_update = \
            real_leaf, real_backward, real_update
        if mesh is not None:
            mesh.all_gather = real_gather
    grads = seen["grads"]
    whole = _whole(grads, sh) if sh is not None else {
        "/".join(map(str, p)): t.numpy().copy()
        for p, t in tree_flatten_with_path(grads)}
    return {"loss": float(metrics["loss"]), "grads": whole,
            "gathered": len(seen["gathered"]), "alive": seen["alive"],
            "regathered": seen["regathered"]}
