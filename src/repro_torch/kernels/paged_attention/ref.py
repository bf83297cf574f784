"""Plain PyTorch paged decode attention: gather pages, masked softmax.

A port of the reference's ``kernels/paged_attention/ref.py`` that also
holds the kernel's two contract points the reference oracle does not:

* a dead row (``lens == 0``, or an all--1 table row) is exactly 0 — the
  masked probabilities are 0 and the output divides by ``max(l, 1e-30)``
  (the reference oracle would average V uniformly there);
* a live row is bitwise identical at any table width: the table is cut to
  the pages the longest sequence needs before anything is computed, so
  padding pages never enter a reduction.
"""

from __future__ import annotations

import torch

__all__ = ["paged_attention_ref"]

NEG_INF = -2.0e38


def paged_attention_ref(q, k_pages, v_pages, page_table, lens, *, scale):
    """q: (B, KG, hd); pages: (P, page, K, hd); table: (B, W); lens: (B,)."""
    B, KG, hd = q.shape
    _, page_size, K, _ = k_pages.shape
    G = KG // K
    need = -(-int(lens.max()) // page_size) if B else 0
    table = page_table[:, :max(min(need, page_table.shape[1]), 1)]
    W = table.shape[1]
    safe = table.clamp(min=0).long()                     # (B, W)
    S = W * page_size
    k = k_pages[safe].reshape(B, S, K, hd)
    v = v_pages[safe].reshape(B, S, K, hd)
    qg = q.reshape(B, K, G, hd).float() * scale
    s = torch.einsum("bkgh,bskh->bkgs", qg, k.float())
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] < lens[:, None]                  # (B, S)
    mask &= torch.repeat_interleave(table >= 0, page_size, dim=1)
    mask = mask[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskh->bkgh", p, v.float()) / l.clamp(min=1e-30)
    return out.reshape(B, KG, hd).to(q.dtype)
