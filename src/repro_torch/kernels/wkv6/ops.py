"""Dispatching wrapper for the WKV6 recurrence.

``wkv6(r, k, v, w, u, state0)`` keeps the reference's signature and its
(B, T, H, hd) layout.  A tensor on the CPU runs the plain PyTorch version
(``ref.py``); a CUDA tensor launches the hand-written kernel or raises —
there is no fallback.  ``wkv6.launches`` counts kernel launches.  As in
the reference, the state is carried in fp32 (``state0`` is cast), and so
are the decay and the bonus.
"""

from __future__ import annotations

from .ref import wkv6_ref
from .wkv6 import wkv6_cuda

__all__ = ["wkv6"]


def wkv6(r, k, v, w, u, state0):
    """Returns (final state (B, H, hd, hd) fp32, y (B, T, H, hd) in r's
    dtype)."""
    w, u, state0 = w.float(), u.float(), state0.float()
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, state0)
    out = wkv6_cuda(r, k, v, w, u, state0)
    wkv6.launches += 1
    return out


wkv6.launches = 0
