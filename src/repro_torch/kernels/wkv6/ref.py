"""Plain PyTorch WKV6 oracle: the exact per-token scan in fp32.

A port of the reference's ``kernels/wkv6/ref.py``.  It takes any T (the
reference's chunked kernel and XLA scan need their chunk to divide T; the
per-token function does not), and returns y in r's dtype, as the kernel
does.
"""

from __future__ import annotations

import torch

__all__ = ["wkv6_ref"]


def wkv6_ref(r, k, v, w, u, state0):
    """r/k/v/w: (B, T, H, hd); u: (H, hd); state0: (B, H, hd, hd).

    Returns (final state (B, H, hd, hd) fp32, y (B, T, H, hd) in r's
    dtype).
    """
    r32, k32, v32, w32 = (x.float() for x in (r, k, v, w))
    u = u.float()[None, :, :, None]
    S = state0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhi,bhj->bhij", k32[:, t], v32[:, t])
        ys.append(torch.einsum("bhi,bhij->bhj", r32[:, t], S + u * kv))
        S = S * w32[:, t, :, :, None] + kv
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(r32)
    return S, y.to(r.dtype)
