"""Rank functions for the port's training-mesh tests
(tests/test_torch_moe_ep.py, test_torch_mesh_train.py,
test_torch_mesh_ckpt.py), run by ``helpers.torch_dist.run_ranks``: torch
only, never jax.  Each builds a ``(data, model)`` ``TrainMesh`` over the
ranks' gloo group on the CPU and returns numpy arrays.
"""

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.gofer import Gofer
from repro_torch.data import DataConfig, Loader, SyntheticLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.common import mesh_context, param_tree
from repro_torch.models.moe import moe_block
from repro_torch.optim import adamw_init
from repro_torch.parallel.sharding import gather_leaf, shard_tree
from repro_torch.runtime import Trainer
from repro_torch.tree import tree_flatten_with_path, tree_map

__all__ = ["MaskedLM", "moe_ep_ranks", "mesh_train_ranks", "ckpt_ranks",
           "trainer_cfg"]

STEPS = 3


class MaskedLM:
    """A package's ``SyntheticLM`` with a seeded ragged loss mask (a row's
    share of live tokens differs from row to row, so the data shards'
    mask counts differ)."""

    def __init__(self, base):
        self.base = base

    def batch_at(self, step):
        b = self.base.batch_at(step)
        rng = np.random.default_rng(1000 + step)
        B, S = b["tokens"].shape
        keep = rng.random((B, 1)) * 0.8 + 0.1
        b["loss_mask"] = (rng.random((B, S)) < keep).astype(np.float32)
        return b


def trainer_cfg(pkg, opt, accum, steps=STEPS, ckpt_every=10 ** 9):
    return pkg.TrainerConfig(
        total_steps=steps, accum_steps=accum, log_every=1,
        ckpt_every=ckpt_every,
        schedule=opt.ScheduleConfig(peak_lr=3e-3, warmup_steps=2,
                                    decay_steps=5))


def _whole(tree, shardings):
    """Every leaf gathered whole, by its path: numpy arrays."""
    return {"/".join(map(str, p)): gather_leaf(
                "/".join(map(str, p)), t, s, whole=True).numpy().copy()
            for (p, t), (_, s) in zip(tree_flatten_with_path(tree),
                                      tree_flatten_with_path(shardings))}


def _on_mesh(data, model):
    torch.set_num_threads(1)
    return make_host_mesh(data, model, device="cpu")


def _ported(cfg, weights):
    m = build_model(cfg, device="cpu")
    m.load_state_dict(params_from_numpy(cfg, weights))
    return m


# ------------------------------------------------------------ MoE block

def moe_ep_ranks(rank, n, data, model, cfg, x, p, w):
    """``moe_block`` on a (data, model) mesh: this rank's rows of ``x``
    and its experts; the objective sum(out * w) + aux.  Returns its
    output rows, the aux, the gradients of its rows of x, of the router
    and of its experts."""
    mesh = _on_mesh(data, model)
    rows = x.shape[0] // data
    lo = mesh.coords["data"] * rows
    M = mesh.shape["model"]
    E = cfg.num_experts
    e_loc = E // M if E % M == 0 else E
    e_lo = mesh.coords["model"] * e_loc if E % M == 0 else 0
    xr = torch.from_numpy(x[lo:lo + rows]).requires_grad_(True)
    leaves = {k: torch.from_numpy(v[e_lo:e_lo + e_loc] if k in
                                  ("wg", "wu", "wd") else v)
              .requires_grad_(True) for k, v in p.items()}
    with mesh_context(mesh):
        out, aux = moe_block(xr, leaves, cfg)
        obj = torch.sum(out * torch.from_numpy(w[lo:lo + rows])) + aux
    grads = torch.autograd.grad(obj, [xr] + list(leaves.values()))
    return {"out": out.detach().numpy(), "aux": float(aux.detach()),
            "coords": dict(mesh.coords), "rows": (lo, rows),
            "experts": (e_lo, e_loc),
            "grads": {k: g.numpy() for k, g in
                      zip(["x"] + list(leaves), grads)}}


def remat_thread_ranks(rank, n, cfg, x, p):
    """The EP block under ``remat_call`` on a 1 x n mesh, its backward run
    on this thread and on another one (as the autograd engine runs a CUDA
    backward): the two gradients of x."""
    import threading

    from repro_torch.models.common import remat_call

    mesh = _on_mesh(1, n)
    e = cfg.num_experts // n
    leaves = {k: torch.from_numpy(v[rank * e:(rank + 1) * e] if k in
                                  ("wg", "wu", "wd") else v)
              for k, v in p.items()}
    grads = []
    for threaded in (False, True):
        xr = torch.from_numpy(x).requires_grad_(True)
        with mesh_context(mesh):
            out = remat_call(lambda t: moe_block(t, leaves, cfg)[0], xr)
        run = lambda: grads.append(torch.autograd.grad(out.sum(), [xr])[0])
        if threaded:
            worker = threading.Thread(target=run)
            worker.start()
            worker.join(timeout=60)
        else:
            run()
    return [g.numpy() for g in grads]


# --------------------------------------------------------------- trainer

def _mesh_trainer(mesh, cfg, weights, accum, steps, seq, ckpt=None,
                  ckpt_every=10 ** 9, start=0):
    import repro_torch.optim as PO
    import repro_torch.runtime as PR

    model = _ported(cfg, weights)
    dc = DataConfig(global_batch=4, seq_len=seq, vocab_size=cfg.vocab_size)
    loader = Loader(MaskedLM(SyntheticLM(dc)), dc, start_step=start)
    tr = Trainer(model, loader, trainer_cfg(PR, PO, accum, steps, ckpt_every),
                 ckpt=ckpt, mesh=mesh)
    return tr, loader


def mesh_train_ranks(rank, n, data, model, cases):
    """Each case ``(name, cfg, weights, accum, seq)`` on one (data, model)
    mesh: by name, :func:`_train_case`'s results."""
    mesh = _on_mesh(data, model)
    return {name: _train_case(mesh, *args) for name, *args in cases}


def _train_case(mesh, cfg, weights, accum, seq):
    """``STEPS`` steps of ``Trainer(mesh=)`` from ``weights``: the metrics
    log, the whole parameters after (gathered), this rank's resident
    elements of parameters and moments and the shard shapes the rules
    give, and the elements ``init_state`` keeps."""
    tr, loader = _mesh_trainer(mesh, cfg, weights, accum, STEPS, seq)
    sh = tr.shardings
    start = param_tree(tr.model)
    params = tree_map(torch.clone, shard_tree(start, sh["params"]))
    opt = adamw_init(params)
    params, opt = tr.run(params, opt)
    loader.stop()
    resident = sum(t.numel() for _, t in tree_flatten_with_path(params))
    moments = sum(t.numel() for _, t in tree_flatten_with_path(opt["mu"]))
    want = sum(int(np.prod(s.shard_shape(tuple(t.shape))))
               for (_, t), (_, s) in zip(tree_flatten_with_path(start),
                                         tree_flatten_with_path(
                                             sh["params"])))
    shapes_ok = all(
        tuple(t.shape) == s.shard_shape(tuple(w.shape))
        for (_, t), (_, s), (_, w) in zip(
            tree_flatten_with_path(params),
            tree_flatten_with_path(sh["params"]),
            tree_flatten_with_path(start)))
    whole = _whole(params, sh["params"])
    fresh, _ = tr.init_state(0)
    init_elems = sum(t.numel() for _, t in tree_flatten_with_path(fresh))
    freed = all(t.is_meta for t in tr.model.parameters())
    return {"log": tr.metrics_log, "params": whole, "resident": resident,
            "moments": moments, "want": want, "shapes_ok": shapes_ok,
            "init_elems": init_elems, "freed": freed}


# ----------------------------------------------------------- checkpoints

def ckpt_ranks(rank, n, data, model, cfg, weights, seq, root, steps, start,
               save_every):
    """On a (data, model) mesh: restore the newest checkpoint under
    ``root`` if ``start`` (else start from ``weights``), train to
    ``steps`` (the trainer saves at the end), and return the metrics log
    and the final whole parameters and optimizer state."""
    mesh = _on_mesh(data, model)
    ckpt = CheckpointManager(Gofer.for_root("ckpt", root, write=True),
                             keep=10)
    tr, loader = _mesh_trainer(mesh, cfg, weights, 1, steps, seq, ckpt=ckpt,
                               ckpt_every=save_every, start=start)
    params = tree_map(torch.clone,
                      shard_tree(param_tree(tr.model),
                                 tr.shardings["params"]))
    opt = adamw_init(params)
    if start:
        step, tree, _ = ckpt.restore_latest({"params": params, "opt": opt},
                                            shardings=tr.shardings)
        assert step == start, (step, start)
        params, opt = tree["params"], tree["opt"]
    params, opt = tr.run(params, opt, start_step=start)
    loader.stop()
    return {"log": tr.metrics_log,
            "params": _whole(params, tr.shardings["params"]),
            "opt": _whole(opt, tr.shardings["opt"])}

