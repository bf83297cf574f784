"""AdamW with decoupled weight decay and global-norm gradient clipping.

The counterpart of ``repro/optim/adamw.py`` over nested dicts of tensors.
Moments are fp32 regardless of parameter dtype (bf16 params update through
an fp32 delta — the standard mixed-precision recipe without a separate
master copy).  The arithmetic is the reference's, term for term; the
gradient norm sums the leaves in the reference's leaf order (dict keys
sorted).

The weight-decay mask is the reference's, leaf by leaf: a leaf decays
unless its ``jax.tree_util.keystr`` path (``"['layers']['ln1']"``) holds
one of ``no_decay``'s tokens, and only if it has two or more dims.  Since
the layers are stacked, a per-layer vector is 2-D, and ``"/u"`` can never
match a keystr, so RWKV's ``u``, ``w0``, ``mu_x`` and ``mu_rkvwg`` and the
hybrid's ``A_log`` and ``D_skip`` decay, as they do in the reference.

``adamw_update(..., inplace=True)`` writes the new parameters and moments
into the given tensors (the trainer's counterpart of the reference's
buffer donation), a chunk of each leaf at a time, so the update's fp32
temporaries stay small beside a full-width embedding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import (
    keystr,
    tree_flatten_with_path,
    tree_leaves,
    tree_map,
    tree_unflatten_like,
)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm"]

#: elements of a leaf updated at once
_CHUNK = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    #: leaves whose path contains any of these substrings skip weight decay
    no_decay: Tuple[str, ...] = ("norm", "bias", "ln", "b_", "/u", "scale")


def adamw_init(params) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _global_norm(grads) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads))
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


def _decay_mask(params, no_decay: Tuple[str, ...]):
    def visit(path, leaf):
        name = keystr(path).lower()
        return not any(tok in name for tok in no_decay) and leaf.dim() >= 2

    flat = tree_flatten_with_path(params)
    return tree_unflatten_like(params, [visit(p, leaf) for p, leaf in flat])


@torch.no_grad()
def adamw_update(
    grads, opt_state, params, lr, cfg: AdamWConfig = AdamWConfig(), *,
    inplace: bool = False,
):
    """Returns (new_params, new_opt_state, gnorm); with ``inplace`` the new
    parameters and moments are the given tensors, overwritten."""
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = opt_state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t

    def upd(g, m, v, p, wd_on):
        if inplace:
            out_p, out_m, out_v = p, m, v
        else:
            out_p, out_m, out_v = (torch.empty_like(x) for x in (p, m, v))
        flat = [x.reshape(-1) for x in (g, m, v, p)]
        outs = [x.view(-1) for x in (out_p, out_m, out_v)]
        for s in range(0, p.numel(), _CHUNK):
            gc, mc, vc, pc = (x[s:s + _CHUNK] for x in flat)
            # the clip rounds to the gradient's dtype, as the reference's
            g32 = (gc.float() * scale).to(g.dtype).float()
            mc = cfg.b1 * mc + (1 - cfg.b1) * g32
            vc = cfg.b2 * vc + (1 - cfg.b2) * torch.square(g32)
            mhat = mc / bc1
            vhat = vc / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps)
            p32 = pc.float()
            if wd_on:
                delta = delta + cfg.weight_decay * p32
            outs[0][s:s + _CHUNK] = (p32 - lr * delta).to(p.dtype)
            outs[1][s:s + _CHUNK] = mc
            outs[2][s:s + _CHUNK] = vc
        return out_p, out_m, out_v

    flat_p = tree_leaves(params)
    flat_g = tree_leaves(grads)
    flat_m = tree_leaves(opt_state["mu"])
    flat_v = tree_leaves(opt_state["nu"])
    flat_mask = tree_leaves(_decay_mask(params, cfg.no_decay))
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("grads, moments and params differ in structure")
    out = [upd(g, m, v, p, wd) for g, m, v, p, wd in
           zip(flat_g, flat_m, flat_v, flat_p, flat_mask)]
    new_params = tree_unflatten_like(params, [o[0] for o in out])
    new_mu = tree_unflatten_like(params, [o[1] for o in out])
    new_nu = tree_unflatten_like(params, [o[2] for o in out])
    return new_params, {"mu": new_mu, "nu": new_nu, "step": step}, gnorm
