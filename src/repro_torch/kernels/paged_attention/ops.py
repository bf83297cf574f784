"""Dispatching wrapper for paged decode attention.

A tensor on the CPU runs the plain PyTorch version (``ref.py``); a CUDA
tensor launches the hand-written kernel or raises — there is no fallback.
``paged_attention.launches`` counts kernel launches, so a run can show its
decode steps went through the kernel.  The page table and lengths may come
straight from :meth:`repro_torch.core.arena.PagedKVAllocator.page_table`
and :meth:`seq_lens` as numpy int32.
"""

from __future__ import annotations

import torch

from .paged_attention import paged_attention_cuda
from .ref import paged_attention_ref

__all__ = ["paged_attention"]


def paged_attention(q, k_pages, v_pages, page_table, lens, *, scale):
    """q: (B, KG, hd); pages: (P, page, K, hd); table: (B, W); lens: (B,)."""
    page_table = torch.as_tensor(page_table, dtype=torch.int32, device=q.device)
    lens = torch.as_tensor(lens, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, lens,
                                   scale=scale)
    out = paged_attention_cuda(q, k_pages, v_pages, page_table, lens,
                               scale=scale)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
