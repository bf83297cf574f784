"""Dispatching wrapper for segment zero-fill.

``segment_zero(x, lo, hi)`` keeps the reference's signature: over a flat
buffer, ``out[i] = 0 if lo <= i < hi else x[i]``, exactly.  A tensor on
the CPU runs the plain PyTorch version (``ref.py``); a CUDA tensor
launches the hand-written kernel or raises — there is no fallback.
``segment_zero.launches`` counts kernel launches.
"""

from __future__ import annotations

from .ref import segment_zero_ref
from .segment_zero import segment_zero_cuda

__all__ = ["segment_zero"]


def segment_zero(x, lo, hi):
    if x.device.type == "cpu":
        return segment_zero_ref(x, lo, hi)
    out = segment_zero_cuda(x, lo, hi)
    segment_zero.launches += 1
    return out


segment_zero.launches = 0
