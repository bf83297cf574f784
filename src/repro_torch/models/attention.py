"""Attention: GQA with RoPE, sliding windows and softcap.

The counterpart of ``repro/models/attention.py``.  Prefill attention goes
through :func:`repro_torch.kernels.flash_attention.ops.flash_attention` —
the hand-written CUDA kernel on the card, its plain PyTorch version on the
CPU.  The kernel has no backward (nor has the reference's Pallas kernel),
so the training route, ``attention_block(..., impl="xla")`` as the
reference's trainer calls it, runs :func:`blockwise_attn`, differentiable,
on every device.  Decode attention over the page pool lives in
:meth:`repro_torch.models.transformer.TransformerLM.paged_decode_step`;
decode over a dense (B, max_seq) cache is :func:`update_cache` and
:func:`decode_attn`, plain PyTorch as the reference computed them in XLA
(no TPU kernel).  The reference's ``layout`` knob (the decode cache's
sharding, which only its dry run sets: ROADMAP.md queue 1, item 11) is
not ported.  :func:`blockwise_attn` is the
reference's XLA online-softmax attention over KV chunks, in plain PyTorch:
the enc-dec model's self- and cross-attention run through it, as they do
in the reference (no TPU kernel computes it).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..kernels.flash_attention import ops as fa_ops
from .common import ArchConfig, rms_norm, rope, softcap

__all__ = ["NEG_INF", "attn_params_shape", "attention_block",
           "blockwise_attn", "decode_attn", "qkv", "update_cache"]

NEG_INF = -2.0e38
_SENTINEL = 2 ** 30


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


def blockwise_attn(
    q: torch.Tensor,              # (B, Sq, K, G, hd): q already grouped
    k: torch.Tensor,              # (B, Sk, K, hd)
    v: torch.Tensor,              # (B, Sk, K, hd)
    *,
    q_positions: torch.Tensor,    # (Sq,) absolute positions of queries
    k_positions: torch.Tensor,    # (Sk,)
    window,                       # 0 => global
    scale: float,
    logit_cap: float = 0.0,
    causal: bool = True,
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks; returns (B, Sq, K, G, hd)
    in q's dtype.

    The reference's arithmetic step for step: scores in fp32, the softcap
    before the mask, masked scores set to ``NEG_INF``, a running max ``m``,
    sum ``l`` and accumulator rescaled per chunk, ``l`` clamped at 1e-30.
    A ragged KV (whisper's 1500 encoder frames) is zero-padded to the
    chunk and its tail masked through sentinel positions.
    """
    B, Sq, K, G, hd = q.shape
    Sk = k.shape[1]
    chunk = min(chunk, Sk)
    pad = (-Sk) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_positions = torch.cat([k_positions, torch.full(
            (pad,), _SENTINEL, dtype=k_positions.dtype,
            device=k_positions.device)])
        Sk += pad
    window = int(window)
    qf = q.float() * scale
    m = torch.full((B, Sq, K, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, K, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, K, G, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, Sk, chunk):
        k_j = k[:, c0:c0 + chunk].float()
        v_j = v[:, c0:c0 + chunk].float()
        kp_j = k_positions[c0:c0 + chunk]
        s = torch.einsum("bqkgh,bckh->bqkgc", qf, k_j)
        if logit_cap:
            s = softcap(s, logit_cap)
        mask = (kp_j[None, :] < _SENTINEL).expand(Sq, -1)
        if causal:
            mask = mask & (kp_j[None, :] <= q_positions[:, None])
        if window > 0:
            mask = mask & (q_positions[:, None] - kp_j[None, :] < window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        l_corr = torch.exp(m - m_new)
        l = l_corr * l + p.sum(dim=-1)
        acc = acc * l_corr[..., None] + torch.einsum("bqkgc,bckh->bqkgh",
                                                     p, v_j)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype)


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
    impl: str = "kernel",
):
    """``impl="kernel"``: the flash kernel (K2) on the card, serving;
    ``impl="xla"``: :func:`blockwise_attn`, the reference's training
    route."""
    B, S, D = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    G = H // K
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = qkv(x, p, cfg, positions, rope_base)
    scale = cfg.query_scale or (1.0 / math.sqrt(hd))
    if impl == "xla":
        out = blockwise_attn(
            q.reshape(B, S, K, G, hd), k, v, q_positions=positions,
            k_positions=positions, window=window, scale=scale,
            logit_cap=cfg.attn_logit_softcap, causal=causal,
        )
    else:
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


# --------------------------------------------------------------------------
# decode path (dense cache)
# --------------------------------------------------------------------------


def update_cache(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, pos: torch.Tensor):
    """Insert one token's K/V at per-sequence positions, in place.

    cache: (B, S, K, hd); k_new/v_new: (B, K, hd); pos: (B,) int.  The
    reference's ``.at[b, pos].set`` drops a write whose position lies
    outside the cache (a free lane of the dense batch keeps counting past
    ``max_seq``), while an out-of-range index asserts on CUDA.  So such a
    lane writes its own row's old value back at a clamped position: the
    cache is unchanged and the step needs no host sync.
    """
    B, S = cache_k.shape[:2]
    b_idx = torch.arange(B, device=cache_k.device)
    pos = pos.long()
    pos = torch.where(pos < 0, pos + S, pos)     # numpy-style negatives
    valid = ((pos >= 0) & (pos < S))[:, None, None]
    at = pos.clamp(0, S - 1)
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        cache[b_idx, at] = torch.where(valid, new.to(cache.dtype),
                                       cache[b_idx, at])
    return cache_k, cache_v


def decode_attn(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                pos: torch.Tensor, cfg: ArchConfig, *,
                window: int) -> torch.Tensor:
    """One token's attention over a dense cache: (B, H, hd) → (B, H*hd) fp32.

    The reference's numerics: q scaled in fp32 and rounded back to its
    dtype; scores summed in fp32 from the cache in its storage dtype (the
    operands are upcast — a product of two bf16 values is exact in fp32 —
    never a bf16 score tensor); the softcap before the mask; the mask
    ``idx <= pos`` and ``pos - idx < window``; the weights rounded to the
    cache's dtype before P·V, which sums in fp32.
    """
    B, S, K, hd = cache_k.shape
    H = cfg.num_heads
    G = H // K
    scale = cfg.query_scale or (1.0 / math.sqrt(hd))
    qg = (q.reshape(B, K, G, hd).float() * scale).to(q.dtype)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), cache_k.float())
    if cfg.attn_logit_softcap:
        s = softcap(s, cfg.attn_logit_softcap)
    idx = torch.arange(S, device=cache_k.device)
    pos = pos.long()
    mask = idx[None, :] <= pos[:, None]                      # (B, S)
    if int(window) > 0:
        mask &= pos[:, None] - idx[None, :] < int(window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", w.to(cache_v.dtype).float(),
                       cache_v.float())
    return out.reshape(B, H * hd)
