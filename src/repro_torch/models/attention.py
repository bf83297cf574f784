"""Attention: GQA with RoPE, sliding windows and softcap, for prefill.

The counterpart of ``repro/models/attention.py``.  The port has no
``impl`` knob: prefill attention always goes through
:func:`repro_torch.kernels.flash_attention.ops.flash_attention` — the
hand-written CUDA kernel on the card, its plain PyTorch version on the
CPU.  Decode attention over the page pool lives in
:meth:`repro_torch.models.transformer.TransformerLM.paged_decode_step`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..kernels.flash_attention import ops as fa_ops
from .common import ArchConfig, rms_norm, rope

__all__ = ["NEG_INF", "attn_params_shape", "attention_block", "qkv"]

NEG_INF = -2.0e38


def attn_params_shape(cfg: ArchConfig) -> Dict[str, Any]:
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    shapes = {
        "wq": (D, H, hd),
        "wk": (D, K, hd),
        "wv": (D, K, hd),
        "wo": (H * hd, D),
    }
    if cfg.qkv_bias:
        shapes.update({"bq": (H, hd), "bk": (K, hd), "bv": (K, hd)})
    if cfg.qk_norm:
        shapes.update({"q_norm": (hd,), "k_norm": (hd,)})
    return shapes


def qkv(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ArchConfig,
        positions: torch.Tensor, rope_base):
    """Projections, bias, qk-norm and RoPE: (…, D) → q (…, H, hd), k, v."""
    # "...d,dhk->...hk" as one matmul each over the flattened head axis
    q = (x @ p["wq"].flatten(1)).unflatten(-1, p["wq"].shape[1:])
    k = (x @ p["wk"].flatten(1)).unflatten(-1, p["wk"].shape[1:])
    v = (x @ p["wv"].flatten(1)).unflatten(-1, p["wv"].shape[1:])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope_base is not None:
        q = rope(q, positions, rope_base)
        k = rope(k, positions, rope_base)
    return q, k, v


def attention_block(
    x: torch.Tensor,                  # (B, S, D)
    p: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    *,
    window: int,                      # per-layer; 0 => global
    rope_base,                        # per-layer
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    return_kv: bool = False,
):
    B, S, D = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    G = H // K
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = qkv(x, p, cfg, positions, rope_base)
    scale = cfg.query_scale or (1.0 / math.sqrt(hd))
    out = fa_ops.flash_attention(
        q.reshape(B, S, K, G, hd).contiguous(), k.contiguous(),
        v.contiguous(), q_positions=positions, k_positions=positions,
        window=window, scale=scale, logit_cap=cfg.attn_logit_softcap,
        causal=causal,
    )
    y = out.reshape(B, S, H * hd) @ p["wo"]
    if return_kv:
        return y, (k, v)
    return y
