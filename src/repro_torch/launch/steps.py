"""Step functions shared by the trainer, the server and the dry run.

The counterpart of ``repro/launch/steps.py``.  :func:`make_train_step` is
the one definition of a training step: ``Trainer`` runs it, one device or
a training mesh.  The serving functions take no parameter tree: a port
model holds its weights (``make_prefill_fn(model)(batch)``,
``make_decode_fn(model)(state, tokens)``).  :func:`make_batch_stub` gives
``meta`` tensors, the counterpart of ``jax.ShapeDtypeStruct``: shapes and
dtypes, no allocation.

**On a training mesh** (``shardings``: the parameters' ``NamedSharding``
tree on a ``launch.mesh.TrainMesh``) every rank runs the step (SPMD) on
its shards of the parameters and moments and on the whole global batch,
as the loader yields it:

1. every leaf is all-gathered, expert leaves over all axes but ``model``
   (``parallel.sharding.gather_tree``);
2. with ``accum_steps`` n, microbatch i is rows ``[i·B/n, (i+1)·B/n)`` of
   the global batch, and of it the rank takes its rows over the batch
   axes (``batch_rows``), as the reference's scan splits each microbatch
   over ``data``;
3. the loss is the global mean: the rank's share is the sum of its rows'
   masked losses over the whole microbatch's mask count (an all-reduce),
   so the shares add up to the one-device loss however the masks differ
   between the ranks; the MoE aux term is averaged inside the block and
   alike on every rank;
4. the gradients, summed over the microbatches, are reduced over the
   batch axes and cut to the rank's shards (``reduce_tree``), and AdamW
   updates only those, clipping by the norm of the whole gradient
   (``sharded_global_norm``).

The MoE block runs expert-parallel inside the step (``mesh_context``).
Where the reference's values differ on a mesh (MoE capacity per shard),
this one's do too.

**What the mesh splits.** Only the stored state: parameters and moments
rest split by the rules, so a rank holds about 1/n of them between steps.
Within a step a rank holds every leaf whole (experts: their ``model``
shard) and the whole gradient tree until step 4, and every ``model`` rank
of a dense model computes the same forward and backward.  So a rank's
peak holds the full parameters plus the full gradients: the step does not
scale to a model whose weights and gradients outgrow one card, such as
the production ``train_4k`` cell of the larger archs on 16 x 16.  Gathering
each layer inside its ``remat_call`` and freeing it after use would lift
that.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..models.common import mesh_context
from ..optim import (
    AdamWConfig,
    ScheduleConfig,
    adamw_update,
    lr_at,
    sharded_global_norm,
)
from ..parallel.sharding import BATCH_AXES, batch_rows, gather_tree, reduce_tree
from ..tree import tree_leaves, tree_unflatten_like

__all__ = ["backward", "make_train_step", "make_prefill_fn", "make_decode_fn",
           "make_batch_stub"]


def backward(loss: torch.Tensor, leaves) -> list:
    """d loss / d leaves; a leaf the loss does not reach gets zeros, as
    ``jax.grad`` gives it."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, grads)]


def make_train_step(
    model,
    schedule: ScheduleConfig = ScheduleConfig(),
    opt_cfg: AdamWConfig = AdamWConfig(),
    *,
    accum_steps: int = 1,
    shardings=None,
    donate: bool = False,
) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``donate`` updates the given tensors in place (the
    reference donates them to its jitted step).  The step calls this
    module's :func:`backward` and ``adamw_update`` by name at each call,
    so a harness may wrap them to time or inspect a step."""
    leaves_of = tree_leaves(shardings) if shardings is not None else []
    mesh = leaves_of[0].mesh if leaves_of else None

    def single(params, batch):
        """(loss, metrics, grads) of one microbatch on this rank."""
        denom = None
        if mesh is not None:
            batch = batch_rows(batch, mesh)
            mask = batch.get("loss_mask")
            if mask is None:
                mask = torch.ones(batch["targets"].shape,
                                  dtype=torch.float32, device=mesh.device)
            axes = [a for a in BATCH_AXES if a in mesh.shape]
            denom = torch.clamp(mesh.all_reduce(torch.sum(mask), axes),
                                min=1.0)
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        with torch.enable_grad(), mesh_context(mesh):
            loss, metrics = model.loss(tree_unflatten_like(params, leaves),
                                       batch)
            if denom is not None:
                # this rank's share of the global mean: its rows' masked
                # losses over the whole batch's count; the rest of the
                # loss (the aux term) is alike on every rank
                share = metrics["ce"] * (metrics["tokens"] / denom)
                loss = share + (loss - metrics["ce"])
            grads = backward(loss, leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        loss = loss.detach()
        if denom is not None:
            ce = mesh.all_reduce(share.detach(), axes)
            loss = ce + (loss - share.detach())
            metrics.update(ce=ce, tokens=denom)
        return loss, metrics, grads

    def step(params, opt_state, batch):
        full = params if mesh is None else gather_tree(params, shardings)
        n = accum_steps
        if n > 1:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree_leaves(full)]
            loss_sum = 0.0
            for i in range(n):
                mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, metrics, grads = single(full, mb)
                for a, g in zip(acc, grads):
                    a.add_(g)
                del grads
                loss_sum = loss_sum + loss
            grads = [a / n for a in acc]
            loss = loss_sum / n
        else:
            loss, metrics, grads = single(full, batch)
        grads = tree_unflatten_like(params, grads)
        del full
        gnorm = None
        if mesh is not None:
            grads = reduce_tree(grads, shardings)
            gnorm = sharded_global_norm(grads, shardings)

        lr = lr_at(opt_state["step"], schedule)
        params, opt_state, gnorm = adamw_update(
            grads, opt_state, params, lr, opt_cfg, inplace=donate,
            gnorm=gnorm)
        metrics = dict(metrics)
        metrics.update(loss=loss, gnorm=gnorm, lr=lr)
        return params, opt_state, metrics

    return step


def make_prefill_fn(model, *, max_seq: Optional[int] = None) -> Callable:
    """``prefill(batch) -> (decode state, last logits)``: the prompt and,
    by family, the encoder frames or the patch embeddings."""
    cfg = model.cfg

    def prefill(batch):
        kw = {}
        if cfg.family == "audio":
            kw["frames"] = batch["frames"]
        elif cfg.num_patches:
            kw["patch_embeds"] = batch["patch_embeds"]
        return model.prefill(batch["tokens"], max_seq=max_seq, **kw)

    return prefill


def make_decode_fn(model) -> Callable:
    def decode(state, tokens):
        return model.decode_step(state, tokens)

    return decode


def make_batch_stub(cfg, *, batch: int, seq: int, kind: str
                    ) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input (no allocation), with the
    reference's shapes and dtypes."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    stub: Dict[str, Any] = {"tokens": meta((batch, seq), torch.int32)}
    if kind == "train":
        stub["targets"] = meta((batch, seq), torch.int32)
        stub["loss_mask"] = meta((batch, seq), torch.float32)
    if cfg.family == "audio":
        stub["frames"] = meta((batch, cfg.encoder_len, cfg.d_model),
                              torch.bfloat16)
    elif cfg.num_patches:
        stub["patch_embeds"] = meta((batch, cfg.num_patches, cfg.d_model),
                                    torch.bfloat16)
    return stub
