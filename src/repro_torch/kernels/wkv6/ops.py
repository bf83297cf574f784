"""Dispatching wrapper for the WKV6 recurrence.

``wkv6(r, k, v, w, u, state0)`` keeps the reference's signature and its
(B, T, H, hd) layout.  A tensor on the CPU runs the plain PyTorch version
(``ref.py``); a CUDA tensor launches the hand-written kernels or raises —
there is no fallback.  bf16 r/k/v take the chunked form on the tensor
cores, float32 r/k/v the exact per-token kernel.  ``wkv6.launches`` counts
calls that ran on the card: one per call, whatever number of CUDA launches
the route makes (three for bf16, one for float32).  As in the reference,
the state is carried in fp32 (``state0`` is cast), and so are the decay
and the bonus.
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
