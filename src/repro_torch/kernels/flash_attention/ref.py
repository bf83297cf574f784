"""Plain PyTorch flash-attention oracle (full softmax).

A port of the reference's ``kernels/flash_attention/ref.py``.
"""

from __future__ import annotations

import torch

__all__ = ["flash_attention_ref"]

NEG_INF = -2.0e38


def flash_attention_ref(q, k, v, window, *, scale, logit_cap=0.0,
                        causal=True, q_offset=0):
    """q: (B, Sq, KG, hd); k/v: (B, Sk, K, hd); window: int, 0 = global."""
    B, Sq, KG, hd = q.shape
    _, Sk, K, _ = k.shape
    G = KG // K
    qg = q.reshape(B, Sq, K, G, hd).float() * scale
    s = torch.einsum("bqkgh,bskh->bqkgs", qg, k.float())
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    window = int(window)
    if window > 0:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgs,bskh->bqkgh", w, v.float())
    return out.reshape(B, Sq, KG, hd).to(q.dtype)
