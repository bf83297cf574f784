"""Plain PyTorch segment zero-fill oracle.

A port of the reference's ``kernels/segment_zero/ref.py``.
"""

from __future__ import annotations

import torch

__all__ = ["segment_zero_ref"]


def segment_zero_ref(x, lo, hi):
    """x: (N,) flat buffer; ``out[i] = 0 if lo <= i < hi else x[i]``."""
    idx = torch.arange(x.shape[0], device=x.device)
    return torch.where((idx >= int(lo)) & (idx < int(hi)),
                       torch.zeros_like(x), x)
