"""Dispatching wrapper for prefill flash attention.

``flash_attention`` takes the model-side layout (B, S, K, G, hd) of
:mod:`repro_torch.models.attention` and returns the same layout.  A tensor
on the CPU runs the plain PyTorch version (``ref.py``); a CUDA tensor
launches the hand-written kernel or raises — there is no fallback.
``flash_attention.launches`` counts kernel launches.  Keys sit at
positions ``arange(Sk)`` and query row i at ``q_offset + i`` (0 in the
reference, whose kernel has no offset; a serving rank's chunk of the
sequence starts later): ``q_positions`` and ``k_positions`` are accepted
and not read.
"""

from __future__ import annotations

from .flash_attention import flash_attention_cuda
from .ref import flash_attention_ref

__all__ = ["flash_attention"]


def flash_attention(qg, k, v, *, q_positions=None, k_positions=None,
                    window, scale: float, logit_cap: float = 0.0,
                    causal: bool = True, q_offset: int = 0):
    B, Sq, K, G, hd = qg.shape
    q = qg.reshape(B, Sq, K * G, hd)
    window = int(window)
    if q.device.type == "cpu":
        out = flash_attention_ref(q, k, v, window, scale=scale,
                                  logit_cap=logit_cap, causal=causal,
                                  q_offset=int(q_offset))
    else:
        out = flash_attention_cuda(q, k, v, window, scale=scale,
                                   logit_cap=logit_cap, causal=causal,
                                   q_offset=int(q_offset))
        flash_attention.launches += 1
    return out.reshape(B, Sq, K, G, hd)


flash_attention.launches = 0
