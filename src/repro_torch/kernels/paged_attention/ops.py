"""Dispatching wrapper for paged decode attention.

A tensor on the CPU runs the plain PyTorch version (``ref.py``); a CUDA
tensor launches the hand-written kernel or raises — there is no fallback.
``paged_attention.launches`` counts kernel launches, so a run can show its
decode steps went through the kernel.  ``paged_attention_sharded`` runs it
over the kv-head slices of a serving mesh's ranks, each in its worker
(where the launches are counted).  The page table and lengths may come
straight from :meth:`repro_torch.core.arena.PagedKVAllocator.page_table`
and :meth:`seq_lens` as numpy int32.
"""

from __future__ import annotations

import numpy as np
import torch

from .paged_attention import paged_attention_cuda
from .ref import paged_attention_ref

__all__ = ["paged_attention", "paged_attention_sharded"]


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


def paged_attention_sharded(q, k_pages, v_pages, page_table, lens, *,
                            scale, mesh, axis_name: str = "model"):
    """Head-sharded paged attention over a tensor-parallel mesh.

    Each rank of ``mesh`` (a :class:`~repro_torch.launch.mesh.ServingMesh`)
    runs :func:`paged_attention` on its device over its kv-head slice of
    the pages (q heads are KV-major, so its q slice is contiguous); the
    outputs concatenate over the head axis, on ``q``'s device.  Per-kv-head
    online softmax is independent, so the result is bit-identical to the
    unsharded call.  With no mesh, a mesh of one, or head counts that do
    not divide it, this is the unsharded call, as in the reference (it is
    the reference's semantics: a CUDA tensor still goes to the kernel).
    """
    num_kv = k_pages.shape[2]
    num_q = q.shape[1]
    n = mesh.size if mesh is not None else 1
    if mesh is None or n <= 1 or num_kv % n or num_q % n:
        return paged_attention(q, k_pages, v_pages, page_table, lens,
                               scale=scale)
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh has axes {mesh.axis_names}, not {axis_name!r}")
    table = np.asarray(torch.as_tensor(page_table).cpu(), np.int32)
    lens = np.asarray(torch.as_tensor(lens).cpu(), np.int32)
    qh, kh = num_q // n, num_kv // n
    outs = mesh.run("attention", [
        (q[:, r * qh:(r + 1) * qh], k_pages[:, :, r * kh:(r + 1) * kh],
         v_pages[:, :, r * kh:(r + 1) * kh], table, lens, scale)
        for r in range(n)])
    return torch.cat([o.to(q.device) for o in outs], dim=1)
