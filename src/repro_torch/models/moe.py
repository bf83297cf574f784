"""Mixture-of-Experts block, one device, in PyTorch.

The counterpart of ``repro/models/moe.py`` on one device (its ``mesh is
None`` branch): the expert-parallel ``shard_map`` branch waits for
training on a mesh (ROADMAP.md queue 1, item 9c; serving TP replicates the
experts on every rank).  The token path follows the
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
reference's layout does.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from .common import ArchConfig, _act, gated_mlp

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


def moe_block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ArchConfig,
              *, lossless: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., D) → (out (..., D), aux loss scalar fp32).

    The leading dims flatten to the T tokens that share one capacity: the
    B·S rows of a prefill, the B lanes of a decode step.  ``lossless``
    (decode) gives every copy a slot.
    """
    shape, D = x.shape, x.shape[-1]
    xt = x.reshape(-1, D)
    r = route(xt, p["router"], cfg, lossless=lossless)
    buf = dispatch(xt, r, cfg.num_experts)
    y = expert_ffn(buf, p["wg"], p["wu"], p["wd"], cfg.activation)
    out = combine(y, r, xt.shape[0]).reshape(shape)
    if cfg.num_shared_experts:
        out = out + gated_mlp(x, p["swu"], p["swg"], p["swd"], cfg.activation)
    return out, _aux_loss(r)
