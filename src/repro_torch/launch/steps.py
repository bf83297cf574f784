"""Step functions shared by the trainer, the server and the dry run.

The counterpart of ``repro/launch/steps.py``.  :func:`make_train_step` is
the one definition of a training step: ``Trainer`` runs it, one device or
a training mesh.  On one device the serving functions take no parameter
tree: a port model holds its weights (``make_prefill_fn(model)(batch)``,
``make_decode_fn(model)(state, tokens)``); on a mesh they take this
rank's shards.  :func:`make_batch_stub` gives
``meta`` tensors, the counterpart of ``jax.ShapeDtypeStruct``: shapes and
dtypes, no allocation.

**On a training mesh** (``shardings``: the parameters' ``NamedSharding``
tree on a ``launch.mesh.TrainMesh``) every rank runs the step (SPMD) on
its shards of the parameters and moments, as the reference's GSPMD step
lays it out:

1. with ``accum_steps`` n, microbatch i is rows ``[i·B/n, (i+1)·B/n)`` of
   the global batch, and of it the rank takes its rows over the batch
   axes (``batch_rows``), as the reference's scan splits each microbatch
   over ``data``; where the mesh has a ``model`` axis, over which every
   family splits its work, also its chunk of the sequence,
   as ``batch_specs`` splits tokens and targets ``P(("pod", "data"),
   "model")`` (padded at the end with masked tokens where the axis does
   not divide the sequence);
2. the model reads its parameters through a ``TrainLayout``
   (``parallel.sharding``): each leaf is all-gathered over the batch axes
   where it is read, a layer's inside its ``remat_call``, so a rank holds
   about one layer's gathered weights at a time and the backward's
   recompute gathers them again (FSDP); the backward of each gather
   reduce-scatters the leaf's gradient, and a leaf's gradient is
   all-reduced over the axes it is not split on that the ranks computed
   different parts over;
3. the loss is the global mean: the rank's share is the sum of its
   tokens' masked losses over the whole microbatch's mask count (an
   all-reduce over the batch axes, and ``model`` where the sequence is
   split), so the shares add up to the one-device loss however the masks
   differ between the ranks; the MoE aux term is averaged inside the
   block and alike on every rank;
4. the gradients come out of the backward summed and cut to the rank's
   shards (with ``accum_steps`` > 1, each microbatch's, summed over the
   ranks in the gradient's dtype, then added up in fp32), and AdamW
   updates only those, clipping by the norm of the whole gradient
   (``sharded_global_norm``).

**What the mesh splits.** The stored state, parameters and moments, split
by the rules; within a step, the weights, gathered over ``data`` one
layer at a time and freed after use; and the work over ``model``, as the
reference's ``constrain`` sites lay it out.  In every family the
residual stream is sequence-parallel and the logits are the rank's own
tokens against the whole vocabulary (the table gathered over ``model``
where it is read).  ``TransformerLM`` splits attention by q heads where
they divide the axis and by query rows where they do not (only K/V are
gathered), the MLP's hidden by ``d_ff`` and the experts by the MoE
block's expert parallelism.  ``RwkvLM`` runs its time mix (the WKV
recurrence) on the rank's rows of the whole sequence, the batch split
over ``("data", "model")`` (all the rows where ``model`` does not divide
them), and splits its channel mix by ``d_ff``.  The hybrid splits its
attention as ``TransformerLM`` does, its SSM branch by ``d_inner`` (whole
on every rank where ``model`` does not divide it) and its MLP by
``d_ff``.  Whisper's encoder and decoder are sequence-parallel over
their own lengths (the encoder's frames padded as the tokens are), with
attention split by heads where they divide the axis and by query rows
where they do not, and the MLP by ``d_ff``.

**Serving on a mesh** (``make_prefill_fn`` / ``make_decode_fn`` with
``shardings=``; every family) the weights rest in their shards, training
or serving rules, and each layer's are gathered where it reads them, a
``model`` split kept where the work is split by it (a ``ServeLayout``).
The prefill splits the work over ``model`` as a training step's forward
does (RWKV's recurrence and the hybrid's SSM scan over the prompt's
tokens alone, not the padding); the decode state is the rank's shard of
``decode_state_shardings(layout=)``: the cache's rows (``seq``) or kv
heads (``heads``), whisper's cross K/V by heads, RWKV's ``wkv`` by its
value columns and the hybrid's ``ssm_h`` by ``d_inner``, each split over
``model`` where the axis divides it.  A decode step repeats the lanes on
every ``model`` rank and splits the attention over the cache's window
(a softmax over ``model``) or heads, the recurrent state's update over
its window, and ``d_ff``, experts and the vocabulary.
"""

from __future__ import annotations

import math
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
from ..parallel.sharding import BATCH_AXES, ServeLayout, TrainLayout, \
    batch_rows
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
        """(loss, metrics, grads) of one microbatch on this rank; on a
        mesh the gradients of this rank's shards, summed over the
        ranks."""
        denom = layout = None
        if mesh is not None:
            layout = TrainLayout(mesh, shardings,
                                 seq_len=batch["tokens"].shape[1])
            batch = batch_rows(batch, mesh, seq_axis="model"
                               if layout.split_model else None)
            mask = batch.get("loss_mask")
            if mask is None:
                mask = torch.ones(batch["targets"].shape,
                                  dtype=torch.float32, device=mesh.device)
            axes = [a for a in BATCH_AXES if a in mesh.shape]
            if layout.split_model:
                axes.append("model")
            denom = torch.clamp(mesh.all_reduce(torch.sum(mask), axes),
                                min=1.0)
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        tree = tree_unflatten_like(params, leaves)
        with torch.enable_grad(), mesh_context(mesh, layout):
            loss, metrics = model.loss(
                tree if layout is None else layout.tree(tree), batch)
            if denom is not None:
                # this rank's share of the global mean: its tokens' masked
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
        n = accum_steps
        if n > 1:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree_leaves(params)]
            loss_sum = 0.0
            for i in range(n):
                mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, metrics, grads = single(params, mb)
                for a, g in zip(acc, grads):
                    a.add_(g)
                del grads
                loss_sum = loss_sum + loss
            grads = [a / n for a in acc]
            loss = loss_sum / n
        else:
            loss, metrics, grads = single(params, batch)
        grads = tree_unflatten_like(params, grads)
        gnorm = None
        if mesh is not None:
            gnorm = sharded_global_norm(grads, shardings)

        lr = lr_at(opt_state["step"], schedule)
        params, opt_state, gnorm = adamw_update(
            grads, opt_state, params, lr, opt_cfg, inplace=donate,
            gnorm=gnorm)
        metrics = dict(metrics)
        metrics.update(loss=loss, gnorm=gnorm, lr=lr)
        return params, opt_state, metrics

    return step


def _state_shape(model, max_seq: Optional[int]):
    """``model``'s decode state of one lane and ``max_seq`` rows on
    ``meta`` (shapes alone), or None; made where a serving function is
    made, so that a step's count of memory leaves it out."""
    if max_seq is None:
        return None
    return model.init_decode_state(1, max_seq, device="meta")


def _serving_layout(model, shardings, layout: str, max_seq: int,
                    state_shape, *, seq_len: int = 0,
                    decoding: bool = False):
    """The mesh of ``shardings`` and the ``ServeLayout`` of a serving step
    on it, its decode-state windows those of ``state_shape`` (the
    model's state, :func:`_state_shape`)."""
    cfg = model.cfg
    mesh = tree_leaves(shardings)[0].mesh
    return mesh, ServeLayout(
        mesh, shardings,
        state_shape=state_shape or _state_shape(model, max_seq),
        max_seq=max_seq, seq_len=seq_len, cache_layout=layout,
        decoding=decoding,
        heads_divisible=cfg.num_heads % mesh.shape.get("model", 1) == 0)


def make_prefill_fn(model, *, max_seq: Optional[int] = None, shardings=None,
                    layout: str = "seq") -> Callable:
    """``prefill(batch) -> (decode state, last logits)``: the prompt and,
    by family, the encoder frames or the patch embeddings.

    With ``shardings`` (the parameters' on a ``TrainMesh``; any family):
    ``prefill(params, batch)`` on this rank's shards
    ``params`` and the global ``batch``, of which it takes its rows over
    ``("pod", "data")`` where they divide (else all of them), as the
    reference's ``batch_shardings``; it returns this rank's shards of the
    decode state (the cache laid out by ``layout``, ``seq`` or ``heads``:
    ``decode_state_shardings``) and its rows' last logits."""
    cfg = model.cfg

    def inputs(batch):
        kw = {}
        if cfg.family == "audio":
            kw["frames"] = batch["frames"]
        elif cfg.num_patches:
            kw["patch_embeds"] = batch["patch_embeds"]
        return kw

    if shardings is None:
        def prefill(batch):
            return model.prefill(batch["tokens"], max_seq=max_seq,
                                 **inputs(batch))

        return prefill

    state_shape = _state_shape(model, max_seq)

    def prefill_on_mesh(params, batch):
        S = batch["tokens"].shape[1]
        mesh, lay = _serving_layout(model, shardings, layout, max_seq or S,
                                    state_shape, seq_len=S)
        n = math.prod(mesh.shape.get(a, 1) for a in BATCH_AXES)
        if batch["tokens"].shape[0] % n == 0:
            batch = batch_rows(batch, mesh)
        with mesh_context(mesh, lay):
            return model.prefill(batch["tokens"], params=lay.tree(params),
                                 **inputs(batch))

    return prefill_on_mesh


def make_decode_fn(model, *, shardings=None, layout: str = "seq",
                   max_seq: Optional[int] = None) -> Callable:
    """``decode(state, tokens) -> (state, logits)``.  With ``shardings``
    (as :func:`make_prefill_fn`'s): ``decode(params, state, tokens)`` on
    this rank's shards of the parameters and of the decode state of
    ``max_seq`` rows (laid out by ``layout``) and its lanes' ``tokens``."""
    if shardings is None:
        def decode(state, tokens):
            return model.decode_step(state, tokens)

        return decode
    if max_seq is None:
        raise ValueError("a decode step on a mesh needs the cache's max_seq")

    state_shape = _state_shape(model, max_seq)

    def decode_on_mesh(params, state, tokens):
        mesh, lay = _serving_layout(model, shardings, layout, max_seq,
                                    state_shape, decoding=True)
        with mesh_context(mesh, lay):
            return model.decode_step(state, tokens, params=lay.tree(params))

    return decode_on_mesh


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
