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
(no TPU kernel).  On a serving mesh, the reference's ``layout`` knob
(the decode cache split over ``model`` by sequence or by kv heads) is
the ``ServeLayout`` that :func:`split_attention` (prefill),
:func:`split_decode`, :func:`update_cache` and :func:`decode_attn` take.
:func:`blockwise_attn` is the
reference's XLA online-softmax attention over KV chunks, in plain PyTorch:
the enc-dec model's self- and cross-attention run through it, as they do
in the reference (no TPU kernel computes it).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import ops as fa_ops
from ..parallel.collectives import softmax_over
from .common import ArchConfig, rms_norm, rope, softcap

__all__ = ["NEG_INF", "attn_params_shape", "attention_block",
           "blockwise_attn", "decode_attn", "qkv", "split_attention",
           "split_decode", "update_cache"]

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


def _project(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str,
             cfg: ArchConfig, positions: torch.Tensor, rope_base,
             heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One of q, k, v (``name``): the projection, its bias, qk-norm and
    RoPE; with ``heads`` ``(lo, hi)``, only those heads of the leaves."""
    # "...d,dhk->...hk" as one matmul over the flattened head axis; each
    # leaf read once (on a mesh a read gathers it)
    w = p[f"w{name}"]
    if heads is not None:
        w = w[:, heads[0]:heads[1]]
    y = (x @ w.flatten(1)).unflatten(-1, w.shape[1:])
    if cfg.qkv_bias:
        b = p[f"b{name}"]
        y = y + (b if heads is None else b[heads[0]:heads[1]])
    if cfg.qk_norm and name != "v":
        y = rms_norm(y, p[f"{name}_norm"], cfg.norm_eps)
    if rope_base is not None and name != "v":
        y = rope(y, positions, rope_base)
    return y


def qkv(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ArchConfig,
        positions: torch.Tensor, rope_base):
    """Projections, bias, qk-norm and RoPE: (…, D) → q (…, H, hd), k, v."""
    return tuple(_project(x, p, n, cfg, positions, rope_base)
                 for n in ("q", "k", "v"))


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


def split_attention(
    x: torch.Tensor,                  # (B, c, D): this rank's chunk
    p: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    *,
    window: int,
    rope_base,
    layout,
    impl: str = "xla",
):
    """Attention on a mesh that splits it over ``model`` (``layout``: a
    ``parallel.sharding.TrainLayout``, or a ``ServeLayout`` for a prefill),
    as the reference's GSPMD layout splits it: ``x`` is this rank's chunk
    of the (padded) sequence, and so is the output projection it returns.

    Where the q heads divide the axis, the sequence is gathered and the
    rank computes its q heads ``[r·H/M, (r+1)·H/M)`` (``wq``, ``bq`` and
    ``wo`` as their stored ``model`` shards) against the kv heads they use
    (``h // G``, sliced from the replicated ``wk``/``wv``); its partial
    output projection is reduce-scattered back to its chunk.  With
    ``impl="kernel"`` and no gradient, that branch runs the flash kernel
    (K2) on the rank's heads.  Else (§Perf-B5) the rank computes q, k and v
    on its own rows with the replicated weights, gathers only k and v,
    attends its queries over all keys, and ``wo`` is a local product; with
    ``impl="kernel"`` and no gradient, through K2 with the query offset
    ``layout.seq_start`` (its chunk's first position), else
    ``blockwise_attn``.  Padding past the sequence's end sits after every
    real token, so the causal mask keeps real queries off it.

    Under a ``ServeLayout`` it returns ``(y, (k, v))``: the K/V rows of
    the rank's cache window (``layout.cache_rows`` of the rows, zero past
    the prompt, and ``layout.cache_heads``), from the gathered sequence.
    """
    B, c, D = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    G = H // K
    M = layout.model_size
    S = c * M
    q_pos = torch.arange(layout.seq_start, layout.seq_start + c,
                         device=x.device)
    k_pos = torch.arange(S, device=x.device)
    attn = dict(window=window, scale=cfg.query_scale or (1.0 / math.sqrt(hd)),
                logit_cap=cfg.attn_logit_softcap)
    cache = layout.serving
    if H % M:
        w = {"wq": layout.whole(p["wq"], 1, H), "wk": p["wk"],
             "wv": p["wv"]}
        if cfg.qkv_bias:
            w.update(bq=layout.whole(p["bq"], 0, H), bk=p["bk"], bv=p["bv"])
        if cfg.qk_norm:
            w.update(q_norm=p["q_norm"], k_norm=p["k_norm"])
        q, k, v = qkv(x, w, cfg, q_pos, rope_base)
        k, v = layout.gather_seq(k), layout.gather_seq(v)
        q = q.reshape(B, c, K, G, hd)
        if impl == "kernel" and not torch.is_grad_enabled():
            out = fa_ops.flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                q_positions=q_pos, k_positions=k_pos, causal=True,
                q_offset=layout.seq_start, **attn)
        else:
            out = blockwise_attn(q, k, v, q_positions=q_pos,
                                 k_positions=k_pos, **attn)
        y = out.reshape(B, c, H * hd) @ layout.whole(p["wo"], 0, H * hd)
        if not cache:
            return y
        return y, _cache_window(layout, k, v)
    h0, h1 = layout.part(H)
    k0, k1 = h0 // G, (h1 - 1) // G + 1
    w = {"wq": layout.local(p["wq"], 1, H),
         "wk": layout.whole(p["wk"], 1, K), "wv": layout.whole(p["wv"], 1, K)}
    if cfg.qkv_bias:
        w.update(bq=layout.local(p["bq"], 0, H),
                 bk=layout.whole(p["bk"], 0, K),
                 bv=layout.whole(p["bv"], 0, K))
    if cfg.qk_norm:
        w.update(q_norm=p["q_norm"], k_norm=p["k_norm"])
    xg = layout.gather_seq(x)
    q = _project(xg, w, "q", cfg, k_pos, rope_base)
    k = _project(xg, w, "k", cfg, k_pos, rope_base, (k0, k1))
    v = _project(xg, w, "v", cfg, k_pos, rope_base, (k0, k1))
    Hr = h1 - h0
    kq, vq = k, v
    if h0 % G == 0 and Hr % G == 0:       # whole groups
        q = q.reshape(B, S, k1 - k0, G, hd)
    elif k1 - k0 == 1:                    # part of one group
        q = q.reshape(B, S, 1, Hr, hd)
    else:                                 # parts of several: kv per q head
        idx = torch.arange(h0, h1, device=x.device) // G - k0
        kq, vq = k[:, :, idx], v[:, :, idx]
        q = q.reshape(B, S, Hr, 1, hd)
    if impl == "kernel" and not torch.is_grad_enabled():
        out = fa_ops.flash_attention(
            q.contiguous(), kq.contiguous(), vq.contiguous(),
            q_positions=k_pos, k_positions=k_pos, window=window,
            scale=attn["scale"], logit_cap=attn["logit_cap"], causal=True)
    else:
        out = blockwise_attn(q, kq, vq, q_positions=k_pos, k_positions=k_pos,
                             **attn)
    y = out.reshape(B, S, Hr * hd) @ layout.local(p["wo"], 0, H * hd)
    y = layout.scatter_seq(y)
    if not cache:
        return y
    j0, j1 = layout.cache_heads
    if k0 <= j0 and j1 <= k1:             # the window's heads are at hand
        return y, _cache_window(layout, k, v, k0)
    r0, r1 = layout.cache_rows
    hi = min(r1, layout.seq_len)
    lo = min(r0, hi)
    kw = _project(xg[:, lo:hi], w, "k", cfg, k_pos[lo:hi], rope_base,
                  (j0, j1))
    vw = _project(xg[:, lo:hi], w, "v", cfg, k_pos[lo:hi], rope_base,
                  (j0, j1))
    return y, _cache_window(layout, kw, vw, j0, first_row=lo)


def _cache_window(layout, k: torch.Tensor, v: torch.Tensor, head0: int = 0,
                  first_row: int = 0):
    """This rank's cache window (``layout.cache_rows`` x
    ``layout.cache_heads``) cut from ``k``/``v`` (B, rows, heads, hd),
    whose first row is sequence row ``first_row`` and first head kv head
    ``head0``: rows past the prompt are zero, as the reference pads
    them."""
    (r0, r1), (j0, j1) = layout.cache_rows, layout.cache_heads
    hi = min(r1, layout.seq_len)
    lo = min(r0, hi)
    out = []
    for t in (k, v):
        t = t[:, lo - first_row:hi - first_row, j0 - head0:j1 - head0]
        out.append(torch.nn.functional.pad(
            t, (0, 0, 0, 0, 0, (r1 - r0) - (hi - lo))))
    return tuple(out)


# --------------------------------------------------------------------------
# decode path (dense cache)
# --------------------------------------------------------------------------


def update_cache(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, pos: torch.Tensor,
                 *, start: int = 0, max_seq: Optional[int] = None):
    """Insert one token's K/V at per-sequence positions, in place.

    cache: (B, S, K, hd); k_new/v_new: (B, K, hd); pos: (B,) int.  The
    reference's ``.at[b, pos].set`` drops a write whose position lies
    outside the cache (a free lane of the dense batch keeps counting past
    ``max_seq``), while an out-of-range index asserts on CUDA.  So such a
    lane writes its own row's old value back at a clamped position: the
    cache is unchanged and the step needs no host sync.  On a serving mesh
    the cache is a window of a cache of ``max_seq`` rows, whose first row
    is row ``start``: only the rank whose window holds ``pos[b]`` writes
    lane b.
    """
    B, S = cache_k.shape[:2]
    max_seq = S if max_seq is None else max_seq
    b_idx = torch.arange(B, device=cache_k.device)
    pos = pos.long()
    pos = torch.where(pos < 0, pos + max_seq, pos)  # numpy-style negatives
    local = pos - start
    valid = ((pos >= 0) & (pos < max_seq) & (local >= 0)
             & (local < S))[:, None, None]
    at = local.clamp(0, S - 1)
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        cache[b_idx, at] = torch.where(valid, new.to(cache.dtype),
                                       cache[b_idx, at])
    return cache_k, cache_v


def decode_attn(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                pos: torch.Tensor, cfg: ArchConfig, *,
                window: int, layout=None) -> torch.Tensor:
    """One token's attention over a dense cache: (B, H, hd) → (B, H*hd) fp32.

    The reference's numerics: q scaled in fp32 and rounded back to its
    dtype; scores summed in fp32 from the cache in its storage dtype (the
    operands are upcast — a product of two bf16 values is exact in fp32 —
    never a bf16 score tensor); the softcap before the mask; the mask
    ``idx <= pos`` and ``pos - idx < window``; the weights rounded to the
    cache's dtype before P·V, which sums in fp32.

    On a serving mesh (``layout``: a ``ServeLayout``) the cache is the
    rank's window, and ``q`` holds the q heads of its kv heads.  Its rows
    are ``layout.cache_rows`` of the whole, masked by their global
    indices; where they are split over ``model``, the softmax takes the
    rows' global max and sum (``softmax_over``) and is normalised before
    the weights are rounded, as the reference's ``jax.nn.softmax`` then
    ``.astype``, and the partial P·V is summed over ``model`` in fp32.
    """
    B, S, K, hd = cache_k.shape
    G = cfg.num_heads // cfg.num_kv_heads
    scale = cfg.query_scale or (1.0 / math.sqrt(hd))
    qg = (q.reshape(B, K, G, hd).float() * scale).to(q.dtype)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), cache_k.float())
    if cfg.attn_logit_softcap:
        s = softcap(s, cfg.attn_logit_softcap)
    start = layout.cache_rows[0] if layout is not None else 0
    idx = torch.arange(start, start + S, device=cache_k.device)
    pos = pos.long()
    mask = idx[None, :] <= pos[:, None]                      # (B, S)
    if int(window) > 0:
        mask &= pos[:, None] - idx[None, :] < int(window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    split = layout is not None and layout.rows_split
    w = softmax_over(s, layout.mesh, "model") if split else \
        torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", w.to(cache_v.dtype).float(),
                       cache_v.float())
    if split:
        out = layout.mesh.all_reduce(out, ["model"])
    return out.reshape(B, K * G * hd)


def split_decode(x: torch.Tensor, p: Dict[str, torch.Tensor],
                 cfg: ArchConfig, cache_k: torch.Tensor,
                 cache_v: torch.Tensor, pos: torch.Tensor, *, window: int,
                 rope_base, layout) -> torch.Tensor:
    """A decode step's attention sublayer on a serving mesh (``layout``: a
    decoding ``ServeLayout``): ``x`` (B, D) the lanes every ``model`` rank
    holds, the cache this rank's window (written in place), the sum over
    ``model`` of the output projection returned, (B, D).

    Each rank projects the q heads whose ``wq`` it holds (its heads where
    they divide the axis, else all) and every kv head, writes the K/V rows
    of its window (:func:`update_cache`), and attends: with all q heads
    (all-gathered where it holds some) where the cache holds every kv
    head, over its rows or all of them; with its own q heads where the
    cache is split by heads.  Its part of ``wo``'s product is then summed
    over ``model``; where the heads do not divide the axis, ``wo`` is
    whole and every rank computes the whole product.
    """
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _project(x, p, "q", cfg, pos, rope_base)       # stored q heads
    k = _project(x, p, "k", cfg, pos, rope_base)
    v = _project(x, p, "v", cfg, pos, rope_base)
    (r0, _), (j0, j1) = layout.cache_rows, layout.cache_heads
    update_cache(cache_k, cache_v, k[:, j0:j1], v[:, j0:j1], pos, start=r0,
                 max_seq=layout.max_seq)
    # a cache split by heads implies q heads that divide the axis: then
    # the rank's stored q heads are those of its kv heads
    whole_heads = j1 - j0 == K
    if whole_heads and q.shape[1] != H:
        q = layout.mesh.all_gather(q, "model", 1)
    o = decode_attn(q, cache_k, cache_v, pos, cfg, window=window,
                    layout=layout).to(x.dtype)
    wo = p["wo"]
    if wo.shape[0] == H * hd:       # heads that do not divide: all of wo
        return o @ wo
    if whole_heads:                 # the rank's rows of wo: its q heads'
        lo = layout.part(H)[0] * hd
        o = o[:, lo:lo + wo.shape[0]]
    return layout.scatter_seq(o @ wo)
