"""Mixture-of-Experts block with expert-parallel all-to-all dispatch, in
PyTorch.

The counterpart of ``repro/models/moe.py``.  The token path follows the
reference's ``_dispatch_compute_combine`` step by step, split into four
functions that :func:`moe_block` calls in turn:

1. :func:`route`: fp32 router logits, top-k by value with ties to the
   lower expert index (as ``jax.lax.top_k``), softmax over the top-k
   (``softmax_topk``, qwen3) or the sigmoid of the top-1 (``sigmoid_top1``,
   llama4), and each copy's slot in its expert's queue: the exclusive
   cumsum of the one-hot in token-major copy order, as in the reference
   (read off a stable sort by expert).  Past the capacity a copy is dropped
   (earlier tokens win) and sent to a dump row;
2. :func:`dispatch`: copies written into an ``(E, C, D)`` buffer;
3. :func:`expert_ffn`: the expert FFN as three batched products;
4. :func:`combine`: each copy gathered back (dropped ones from an appended
   zero row), weighted and summed over its token's k copies.

A shared expert (llama4) runs densely on every token and is added after.
The load-balance auxiliary loss is the Switch form ``E · Σ_e f_e · p_e``.
Nothing here is a TPU kernel in the reference (it is XLA), so the products
are ``torch.bmm``.  Decode reads every expert's weights, as the
reference's layout does; serving TP replicates the experts on every rank.
A serving mesh (``parallel.sharding.ServeLayout``) never gathers the
experts whole: its prefill runs the branch below, with each shard's
capacity, and a decode step routes the lanes losslessly and runs each
rank's experts (:func:`_expert_decode`).

**On a training mesh** (a ``TrainLayout`` bound with ``mesh_context``,
more than one rank) the block takes the reference's ``shard_map`` branch
(``repro/models/moe.py:146-229``).  ``x`` arrives as the residual stream
lies between sublayers: this rank's rows (split over ``pod`` and
``data``, ``parallel.sharding.batch_rows``) and its chunk of the sequence
over ``model`` (padded to a multiple of the axis).  Then, as the
reference:

1. where ``S % model == 0`` each rank routes its own tokens; else the
   chunks are gathered, the padding cut, and every ``model`` rank routes
   all of its rows, keeping its chunk of the output;
2. the capacity is counted from the tokens the rank routes;
3. ``all_to_all`` over ``model`` sends each expert's buffer to the rank
   that holds it (split 0 / concat 1), and back after the FFN (split 1 /
   concat 0), where ``E % model == 0``; else every rank holds every
   expert and nothing is exchanged;
4. the aux loss is averaged over the token axes.

The expert weights arrive as this rank's ``E / model`` experts, whole in
``F``: the layout all-gathers their ``F`` shards over ``data`` where the
layer reads them (its backward is the reduce-scatter;
``F % data != 0``, the reference's other fallback, leaves them replicated
over ``data``).  The backward passes are ``shard_map``'s transpose
(``parallel.collectives``); the gradients of the router and of experts
every rank holds whole are each rank's tokens' part, which the layout
sums over ``model``.  Without the sequence split the gathered input's
gradient is reduce-scattered, and the aux, alike on the ``model`` ranks,
has its gradient divided by ``model``.  The returned aux is the mean over
the token axes, alike on every rank.  A shared expert runs as the dense
MLP does on the mesh (``common.split_mlp``: the hidden split over
``model``).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from ..parallel.collectives import (
    all_to_all,
    gather_sum_grads,
    mean_over,
    scale_grad,
)
from .common import (
    ArchConfig,
    _act,
    current_layout,
    current_mesh,
    gated_mlp,
    split_mlp,
)

__all__ = ["FP32_PARAMS", "moe_params_shape", "moe_block", "route",
           "dispatch", "expert_ffn", "combine"]

#: state-dict leaves kept in float32 whatever ``cfg.dtype`` (the router, as
#: the reference initialises it)
FP32_PARAMS = ("layers.moe.router",)


def moe_params_shape(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """One layer's MoE leaves: router (D, E), experts (E, D, F) / (E, F, D)
    and, with a shared expert, swg/swu (D, Fs) and swd (Fs, D)."""
    D, E, F = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    shapes = {"router": (D, E), "wg": (E, D, F), "wu": (E, D, F),
              "wd": (E, F, D)}
    if cfg.num_shared_experts:
        Fs = cfg.expert_d_ff * cfg.num_shared_experts
        shapes.update({"swg": (D, Fs), "swu": (D, Fs), "swd": (Fs, D)})
    return shapes


class Routing(NamedTuple):
    """One call's routing: ``logits`` (T, E) fp32, ``top_idx`` (T, k),
    ``weights`` (T·k,) in x's dtype, ``slot`` (T·k,) into the flat
    ``(E·C + 1)`` buffer (``E·C`` is the dump row), ``keep`` (T·k,) bool,
    ``counts`` (E,) the copies routed to each expert, and the capacity C."""

    logits: torch.Tensor
    top_idx: torch.Tensor
    weights: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    counts: torch.Tensor
    capacity: int


def _top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest by value, ties to the lower index.
    A stable descending sort keeps equal values in index order;
    ``torch.topk`` promises no order among them."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: ArchConfig, *,
          lossless: bool = False) -> Routing:
    """Top-k routing and slot assignment of ``x`` (T, D)."""
    T = x.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_token
    logits = x.float() @ router_w.float()                       # (T, E)
    top_vals, top_idx = _top_k(logits, k)
    if cfg.router_score == "sigmoid_top1":
        weights = torch.sigmoid(top_vals)
    else:
        weights = torch.softmax(top_vals, dim=-1)    # renormalised over top-k
    e_flat = top_idx.reshape(T * k)
    # slot assignment: each copy's place in its expert's queue, copies in
    # token-major order.  That is the reference's exclusive cumsum of the
    # (T·k, E) one-hot, read here off a stable sort of the copies by
    # expert: a copy's place is its rank in the sort less its expert's
    # first rank (a scan down the one-hot's T·k rows is slow on the card)
    by_expert, order = torch.sort(e_flat, stable=True)
    experts = torch.arange(E, device=x.device)
    first = torch.searchsorted(by_expert, experts)
    pos = torch.empty_like(e_flat)
    pos[order] = torch.arange(T * k, device=x.device) - first[by_expert]
    counts = torch.searchsorted(by_expert, experts, right=True) - first
    if lossless:
        capacity = T * k       # decode: a dropped token is a wrong answer
    else:
        capacity = max(1, int(math.ceil(T * k / E * cfg.capacity_factor)))
    capacity = min(capacity, T * k)
    keep = pos < capacity
    slot = torch.where(keep, e_flat * capacity + pos, E * capacity)
    return Routing(logits, top_idx, weights.reshape(T * k).to(x.dtype), slot,
                   keep, counts, capacity)


def dispatch(x: torch.Tensor, r: Routing, num_experts: int) -> torch.Tensor:
    """Copies of ``x`` (T, D) into the (E, C, D) expert buffer.  Kept slots
    are unique, so a plain index write is exact; the dump row, which takes
    every dropped copy, is cut off unread."""
    T, D = x.shape
    k = r.slot.shape[0] // T
    buf = x.new_zeros((num_experts * r.capacity + 1, D))
    buf[r.slot] = x.repeat_interleave(k, dim=0)
    return buf[:-1].reshape(num_experts, r.capacity, D)


def expert_ffn(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor, activation: str) -> torch.Tensor:
    """act(buf·wg) * (buf·wu) · wd, batched over the experts."""
    h = _act(activation)(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    return torch.bmm(h, wd)


def combine(y: torch.Tensor, r: Routing, T: int) -> torch.Tensor:
    """Each copy's expert output (a zero row for a dropped one) times its
    router weight, summed over the token's k copies: (T, D)."""
    D = y.shape[-1]
    y_flat = torch.cat([y.reshape(-1, D), y.new_zeros((1, D))])
    w = r.weights * r.keep.to(r.weights.dtype)
    return (y_flat[r.slot] * w[:, None]).reshape(T, -1, D).sum(dim=1)


def _aux_loss(r: Routing) -> torch.Tensor:
    """Switch-style load balance: E · Σ_e f_e · p_e, fp32; f_e is the
    share of tokens that picked expert e."""
    probs = torch.softmax(r.logits, dim=-1)                     # (T, E)
    T, E = probs.shape
    f_e = r.counts.float() / T
    p_e = probs.mean(dim=0)
    return E * torch.sum(f_e * p_e)


def _routed(xt: torch.Tensor, router: torch.Tensor, wg: torch.Tensor,
            wu: torch.Tensor, wd: torch.Tensor, cfg: ArchConfig, *,
            lossless: bool, exchange=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts on ``xt`` (T, D) → (out (T, D), aux); with
    ``exchange`` (mesh, axis), each expert's buffer goes to the rank of
    the axis that holds it and back."""
    r = route(xt, router, cfg, lossless=lossless)
    buf = dispatch(xt, r, cfg.num_experts)
    if exchange is not None:
        buf = all_to_all(buf, *exchange, 0, 1)         # (E/M, C·M, D)
    y = expert_ffn(buf, wg, wu, wd, cfg.activation)
    if exchange is not None:
        y = all_to_all(y, *exchange, 1, 0)             # (E, C, D)
    return combine(y, r, xt.shape[0]), _aux_loss(r)


def _expert_parallel(x: torch.Tensor, p: Dict[str, torch.Tensor],
                     cfg: ArchConfig, mesh, seq_len: int, *, lossless: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``shard_map`` branch on this rank's chunk ``x`` (B,
    c, D) of its rows, of a sequence of ``seq_len`` tokens."""
    B, c, D = x.shape
    E = cfg.num_experts
    b_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    M = mesh.shape.get("model", 1)
    seq_split = seq_len % M == 0
    token_axes = b_axes + (("model",) if M > 1 and seq_split else ())
    model_axis = "model" if M > 1 and E % M == 0 else None
    local_e = E // M if model_axis else E
    if p["wg"].shape[0] != local_e:
        raise ValueError(f"expert weights hold {p['wg'].shape[0]} experts; "
                         f"this rank of a {mesh.shape} mesh holds {local_e}")
    if not seq_split:
        x = gather_sum_grads(x, mesh, "model", 1)[:, :seq_len]
    bl, sl, _ = x.shape
    out, aux = _routed(
        x.reshape(bl * sl, D), p["router"], p["wg"], p["wu"], p["wd"], cfg,
        lossless=lossless, exchange=(mesh, model_axis) if model_axis else None)
    out = out.reshape(bl, sl, D)
    aux = mean_over(aux, mesh, token_axes)
    if not seq_split:
        start = mesh.coords["model"] * c
        out = torch.nn.functional.pad(out, (0, 0, 0, c * M - sl))
        out, aux = out[:, start:start + c], scale_grad(aux, M)
    return out, aux


def _expert_decode(x: torch.Tensor, p: Dict[str, torch.Tensor],
                   cfg: ArchConfig, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decode step's block on a serving mesh: ``x`` (B, D), the lanes
    every ``model`` rank holds, routed losslessly (the reference's ``S =
    1``: the tokens split over the batch axes alone).  Where the experts
    split over ``model``, each rank runs its experts on the copies sent
    to them and the outputs are all-gathered over ``model``: the values of
    the reference's all-to-all of the ranks' (equal) buffers, without its
    ``model``-fold repeat of each expert's rows."""
    E = cfg.num_experts
    M = mesh.shape.get("model", 1)
    r = route(x, p["router"], cfg, lossless=True)
    buf = dispatch(x, r, E)
    if M > 1 and E % M == 0:
        e0 = mesh.coords["model"] * (E // M)
        y = expert_ffn(buf[e0:e0 + E // M], p["wg"], p["wu"], p["wd"],
                       cfg.activation)
        y = mesh.all_gather(y, "model", 0)
    else:
        y = expert_ffn(buf, p["wg"], p["wu"], p["wd"], cfg.activation)
    return combine(y, r, x.shape[0]), _aux_loss(r)


def moe_block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ArchConfig,
              *, lossless: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., D) → (out (..., D), aux loss scalar fp32).

    The leading dims flatten to the T tokens that share one capacity: the
    B·S rows of a prefill, the B lanes of a decode step.  ``lossless``
    (decode) gives every copy a slot.  On a training mesh of more than one
    rank, or a serving mesh's prefill, ``x`` is (B, c, D), this rank's
    rows and its chunk of the sequence, and the block is expert-parallel
    (the module docstring); a serving mesh's decode step takes
    :func:`_expert_decode`.
    """
    mesh, layout = current_mesh(), current_layout()
    split = layout is not None and layout.split_model
    if layout is not None and layout.decoding:
        out, aux = _expert_decode(x, p, cfg, mesh)
    elif mesh is not None and mesh.size > 1:
        if mesh.shape.get("model", 1) > 1 and not split:
            raise ValueError("an MoE block on a mesh with a model axis "
                             "takes the sequence split over it (a "
                             "TrainLayout bound)")
        seq_len = layout.seq_len if split else x.shape[1]
        out, aux = _expert_parallel(x, p, cfg, mesh, seq_len,
                                    lossless=lossless)
    else:
        shape, D = x.shape, x.shape[-1]
        out, aux = _routed(x.reshape(-1, D), p["router"], p["wg"], p["wu"],
                           p["wd"], cfg, lossless=lossless)
        out = out.reshape(shape)
    if cfg.num_shared_experts:
        if split:
            out = out + split_mlp(x, p["swu"], p["swg"], p["swd"],
                                  cfg.activation, layout,
                                  cfg.expert_d_ff * cfg.num_shared_experts)
        else:
            out = out + gated_mlp(x, p["swu"], p["swg"], p["swd"],
                                  cfg.activation)
    return out, aux
