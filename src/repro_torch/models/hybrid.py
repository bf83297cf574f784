"""Hymba-style hybrid: parallel attention and selective-SSM (Mamba) heads
in every layer, as a PyTorch ``nn.Module``.

The counterpart of ``repro/models/hybrid.py``: the same stacked-parameter
layout (layer ``l``'s ``w_in`` is ``layers.ssm.w_in[l]``), the same
functions, and a Python loop over layers where the reference scanned.
Each layer feeds one normed input to a GQA attention branch (a sliding
window on every layer but the first, middle and last) and to a selective
SSM branch; the two outputs are RMS-normed, averaged and added to the
residual (arXiv:2411.13676; meta tokens and the depthwise conv are left
out, as in the reference).

Prompt attention goes through :func:`~repro_torch.models.attention.
attention_block`, so through the flash kernel (K2) on the card.  The SSM
recurrence is plain PyTorch in fp32 (:func:`ssm_scan`, a ``lax.scan`` in
the reference, no TPU kernel).  A decode step runs the dense-cache
attention and :func:`ssm_step`.  The engine serves this model in its
dense mode (``init_decode_state`` / ``prefill`` / ``decode_step``); the
state holds the K/V cache and each layer's fp32 SSM state.  Weights live
on the module; on one device the serving functions take no ``params``
argument.  On a serving mesh (``launch.steps.make_prefill_fn`` /
``make_decode_fn`` with ``shardings=``, which bind a
``parallel.sharding.ServeLayout``) they take ``params=``, this rank's
shards, and the state is this rank's shards of it (``_mesh_prefill``,
``_mesh_decode``): attention as ``TransformerLM``'s (K2 on the rank's q
heads or, where they do not divide the axis, on its query rows at their
offset), the SSM by ``d_inner``, each rank keeping its window of the
cache and its columns of the SSM state.

``loss(params, batch)`` trains through the reference's training route:
attention through :func:`~repro_torch.models.attention.blockwise_attn`
(``impl="xla"``; the flash kernel has no backward) and the SSM through
:func:`ssm_scan` (each chunk of 64 tokens checkpointed), each layer
under activation checkpointing where ``remat="full"`` (the default) and
bare otherwise: the reference's ``"dots"`` is its ``"none"`` here.  On
a training mesh that splits the work over ``model``
(``models.common.split_layout``) the reference's ``constrain`` sites lay
it out: the residual stream is the rank's chunk of the sequence; attention goes through
:func:`~repro_torch.models.attention.split_attention`; the SSM branch
splits ``d_inner`` over ``model`` (``xc``, ``z``, ``dt`` and the scan on
the rank's columns, ``xc @ w_B`` and ``xc @ w_C`` summed over the ranks,
``y @ w_out`` reduce-scattered to the chunk; the whole branch on every
rank where ``model`` does not divide ``d_inner``, as ``fit_spec`` drops
the axis); the MLP goes through
:func:`~repro_torch.models.common.split_mlp`; the logits are the rank's
own tokens against the whole table.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..launch.hlo_cost import token_loop
from .attention import (
    attention_block,
    attn_params_shape,
    decode_attn,
    qkv,
    split_attention,
    split_decode,
    update_cache,
)
from .common import (
    ArchConfig,
    check_remat,
    cross_entropy,
    frozen,
    gated_mlp,
    mesh_embedding,
    mesh_scores,
    remat_call,
    remat_chunk,
    resolve_device,
    rms_norm,
    serve_layout,
    split_layout,
    split_mlp,
    take_embedding,
    torch_dtype,
    unstack_layers,
    whole_table,
)

__all__ = ["FP32_PARAMS", "HybridLM", "hymba_windows", "ssm_scan",
           "ssm_step"]

#: parameters kept in float32 whatever the model dtype, as the reference
#: initialises them
FP32_PARAMS = ("layers.ssm.dt_bias", "layers.ssm.A_log", "layers.ssm.D_skip")


def hymba_windows(cfg: ArchConfig) -> np.ndarray:
    """(L,) sliding window per layer: ``local_window`` (or 1024)
    everywhere but the first, middle and last layers, which are global."""
    L = cfg.num_layers
    out = np.full(L, cfg.local_window or 1024, np.int32)
    for g in (0, L // 2, L - 1):
        out[g] = 0
    return out


# --------------------------------------------------------------------------
# selective SSM
# --------------------------------------------------------------------------


def ssm_step(h, x, dt, B_t, C_t, A):
    """One token.  h: (..., di, N); x/dt: (..., di); B_t/C_t: (..., N);
    A: (di, N)."""
    dA = torch.exp(dt[..., None] * A)
    dBx = (dt * x)[..., None] * B_t[..., None, :]
    h = h * dA + dBx
    y = torch.einsum("...dn,...n->...d", h, C_t)
    return h, y


def _ssm_chunk(h, x, dt, b, c, A):
    """One chunk of :func:`ssm_scan`, time-major: x/dt (c, B, di), b/c
    (c, B, N) from state h → (final h, y (B, c, di))."""
    dA = torch.exp(dt[..., None] * A)                          # (c, B, di, N)
    dBx = (dt * x)[..., None] * b[:, :, None, :]
    states = []
    for t in range(x.shape[0]):
        h = torch.addcmul(dBx[t], h, dA[t])
        states.append(h)
    return h, torch.einsum("tbdn,tbn->btd", torch.stack(states), c)


@token_loop(per_token=(0, 1, 2, 3), per_token_out=(1,))
def ssm_scan(x, dt, Bp, Cp, A, h0, *, chunk: int = 64):
    """x/dt: (B, T, di); Bp/Cp: (B, T, N) → (final h, y (B, T, di) in x's
    dtype): :func:`ssm_step`'s recurrence in fp32, token by token, for any
    T (the reference's scan needs ``min(64, T)`` to divide T; here the
    last chunk may be short).

    Per chunk of up to ``chunk`` tokens the decays ``exp(dt·A)`` and inputs
    ``dt·x·B`` are formed at once, each token's state is one fused
    multiply-add, and the outputs are one product with ``C`` over the
    chunk's stacked states.  With gradients on, each chunk runs under a
    checkpoint (:func:`~repro_torch.models.common.remat_chunk`), as the
    reference's ``@jax.checkpoint`` ``chunk_fn``: the backward keeps one
    state per chunk boundary and recomputes one chunk's states at a time,
    not one state per token.  Inside a layer's checkpoint (``remat=
    "full"``) the two nest, as in the reference.  Under the dry run's
    ``CostMode`` (``token_loop``) the scan runs on the mode's first
    ``loop_chunk`` tokens, chunked and checkpointed alike, scaled to T.
    """
    Bsz, T, di = x.shape
    # time-major, so each token's slice of a chunk buffer is contiguous
    xt, dtt, bt, ct = (v.float().transpose(0, 1) for v in (x, dt, Bp, Cp))
    A = A.float()
    h = h0.float()
    run = remat_chunk(_ssm_chunk)
    ys = []
    for s in range(0, T, chunk):
        e = min(s + chunk, T)
        h, y = run(h, xt[s:e], dtt[s:e], bt[s:e], ct[s:e], A)
        ys.append(y)
    return h, torch.cat(ys, dim=1).to(x.dtype)


class HybridLM(nn.Module):
    """Hymba-style hybrid LM; parameters are allocated, not initialised —
    call :meth:`init` or ``load_state_dict``."""

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 impl: str = "kernel", remat: str = "full") -> None:
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(
                f"HybridLM needs family 'hybrid', got {cfg.family!r}")
        self.cfg = cfg
        self.impl = impl
        # the reference checkpoints a layer under "full" alone: its "dots"
        # runs the layer bare, as "none"
        self.remat = "full" if check_remat(remat) == "full" else "none"
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        self.windows = hymba_windows(cfg)
        self.di = cfg.ssm_d_inner or 2 * cfg.d_model
        self.N = cfg.ssm_state_size
        L, D, F_, di, N = (cfg.num_layers, cfg.d_model, cfg.d_ff, self.di,
                           self.N)
        dt, dev = self.dtype, self.device
        self.embed = frozen((cfg.vocab_size, D), dt, dev)
        self.final_norm = frozen((D,), dt, dev)
        self.layers = nn.Module()
        for name in ("ln1", "ln2", "attn_norm", "ssm_norm"):
            setattr(self.layers, name, frozen((L, D), dt, dev))
        self.layers.attn = nn.Module()
        for name, shape in attn_params_shape(cfg).items():
            setattr(self.layers.attn, name, frozen((L, *shape), dt, dev))
        self.layers.ssm = nn.Module()
        for name, shape in {"w_in": (D, 2 * di), "w_dt": (di, di),
                            "dt_bias": (di,), "w_B": (di, N), "w_C": (di, N),
                            "A_log": (di, N), "D_skip": (di,),
                            "w_out": (di, D)}.items():
            leaf_dt = (torch.float32 if f"layers.ssm.{name}" in FP32_PARAMS
                       else dt)
            setattr(self.layers.ssm, name, frozen((L, *shape), leaf_dt, dev))
        self.layers.mlp = nn.Module()
        self.layers.mlp.wg = frozen((L, D, F_), dt, dev)
        self.layers.mlp.wu = frozen((L, D, F_), dt, dev)
        self.layers.mlp.wd = frozen((L, F_, D), dt, dev)

    # ------------------------------------------------------------- params

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "HybridLM":
        """Random weights with the reference's distributions, drawn from
        ``generator`` (which must live on the model's device), one layer
        at a time."""
        cfg, dev = self.cfg, self.device
        D, di, N = cfg.d_model, self.di, self.N
        s_d, s_di = 1 / math.sqrt(D), 1 / math.sqrt(di)
        std = {"attn.wq": s_d, "attn.wk": s_d, "attn.wv": s_d, "attn.wo": s_d,
               "ssm.w_in": s_d, "ssm.w_dt": s_di, "ssm.w_B": s_di,
               "ssm.w_C": s_di, "ssm.w_out": s_di, "mlp.wg": s_d,
               "mlp.wu": s_d, "mlp.wd": 1 / math.sqrt(cfg.d_ff)}

        def normal(shape, scale, dtype):
            x = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32)
            return (x * scale).to(dtype)

        self.embed.copy_(normal(self.embed.shape, s_d, self.dtype))
        self.final_norm.fill_(1)
        a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                       device=dev)).expand(di, N)
        for name, t in self.layers.named_parameters():
            if name in std:
                for l in range(cfg.num_layers):
                    t[l].copy_(normal(t.shape[1:], std[name], t.dtype))
            elif name == "ssm.A_log":
                t.copy_(a_log)
            elif name.startswith("attn.b") or name == "ssm.dt_bias":
                t.zero_()
            else:                      # the norms' scales and D_skip
                t.fill_(1)
        return self

    def _layer_params(self, l: int) -> Dict[str, Any]:
        p: Dict[str, Any] = {
            name: t[l] for name, t in self.layers.named_parameters()
            if "." not in name
        }
        for group in ("attn", "ssm", "mlp"):
            p[group] = {n: t[l] for n, t in
                        getattr(self.layers, group).named_parameters()}
        return p

    # ----------------------------------------------------------- branches

    def _ssm_branch(self, x, p, h0):
        """x: (B, T, D) → ((B, T, D), final fp32 state (B, di, N)).  The
        skip adds in y's dtype after the scan, as the reference's prefill
        does."""
        xc, z = torch.chunk(x @ p["w_in"], 2, dim=-1)
        dt = F.softplus(xc @ p["w_dt"] + p["dt_bias"])   # fp32: bias is fp32
        A = -torch.exp(p["A_log"])
        h, y = ssm_scan(xc, dt, xc @ p["w_B"], xc @ p["w_C"], A, h0)
        y = y + p["D_skip"].to(y.dtype) * xc
        y = y * F.silu(z)
        return y @ p["w_out"], h

    def _split_ssm_branch(self, x, p, layout, length: Optional[int] = None):
        """:meth:`_ssm_branch` on a mesh that splits ``d_inner`` over
        ``model``: ``x`` is this rank's chunk (B, c, D) of the sequence, and
        so is the output.  The rank takes its columns ``[lo, hi)`` of both
        halves of ``w_in`` (the stored ``model`` split of its ``2·di``
        outputs is not the halves': the leaf is gathered whole), gathers
        ``xc`` whole for ``w_dt``'s input, sums the ranks' ``xc @ w_B`` and
        ``xc @ w_C``, scans its columns and reduce-scatters its part of
        ``y @ w_out``.  ``length``: the scan runs over the first ``length``
        tokens alone (a prompt, not its padding).  Returns (the output, the
        final state of the rank's columns, all ``d_inner`` where ``model``
        does not divide it)."""
        di, N = self.di, self.N
        xg = layout.gather_seq(x)
        T = xg.shape[1] if length is None else length
        w_in = layout.whole(p["w_in"], 1, 2 * di)
        if di % layout.model_size:
            # the reference's constraint cannot split d_inner (fit_spec
            # drops the axis): the whole branch on every rank, each keeping
            # its chunk (the other leaves are stored whole)
            w = {k: p[k] for k in ("w_dt", "dt_bias", "w_B", "w_C", "A_log",
                                   "D_skip", "w_out")}
            h0 = torch.zeros((x.shape[0], di, N), dtype=torch.float32,
                             device=x.device)
            y, h = self._ssm_branch(xg[:, :T], {"w_in": w_in, **w}, h0)
            y = F.pad(y, (0, 0, 0, xg.shape[1] - T))
            return y.narrow(1, layout.seq_start, layout.chunk), h
        lo, hi = layout.part(di)
        local = lambda k, d: layout.local(p[k], d, di)
        xc = xg @ w_in[:, lo:hi]
        z = xg @ w_in[:, di + lo:di + hi]
        dt = F.softplus(layout.whole(xc, 2, di) @ local("w_dt", 1)
                        + local("dt_bias", 0))
        Bp = layout.sum_parts(xc @ local("w_B", 0))
        Cp = layout.sum_parts(xc @ local("w_C", 0))
        A = -torch.exp(local("A_log", 0))
        h0 = torch.zeros((x.shape[0], hi - lo, N), dtype=torch.float32,
                         device=x.device)
        h, y = ssm_scan(xc[:, :T], dt[:, :T], Bp[:, :T], Cp[:, :T], A, h0)
        y = F.pad(y, (0, 0, 0, xg.shape[1] - T))
        y = y + local("D_skip", 0).to(y.dtype) * xc
        y = y * F.silu(z)
        return layout.scatter_seq(y @ local("w_out", 0)), h

    def _fuse(self, h, attn_y, ssm_y, p, layout=None):
        """The residual add of both branches, then the gated MLP
        (``layout``: a training mesh's that splits it over ``model``)."""
        cfg = self.cfg
        h = h + 0.5 * (rms_norm(attn_y, p["attn_norm"], cfg.norm_eps)
                       + rms_norm(ssm_y, p["ssm_norm"], cfg.norm_eps))
        m = rms_norm(h, p["ln2"], cfg.norm_eps)
        mlp = p["mlp"]
        if layout is not None:
            return h + split_mlp(m, mlp["wu"], mlp["wg"], mlp["wd"],
                                 cfg.activation, layout, cfg.d_ff)
        return h + gated_mlp(m, mlp["wu"], mlp["wg"], mlp["wd"],
                             cfg.activation)

    def _layers(self, h: torch.Tensor, positions: torch.Tensor):
        """Every layer over the full prompt from a zero SSM state; yields
        (h, (k, v), final SSM state) per layer."""
        cfg = self.cfg
        B = h.shape[0]
        for l in range(cfg.num_layers):
            p = self._layer_params(l)
            a = rms_norm(h, p["ln1"], cfg.norm_eps)
            attn_y, kv = attention_block(
                a, p["attn"], cfg, window=int(self.windows[l]),
                rope_base=cfg.rope_base, positions=positions, return_kv=True,
                impl=self.impl)
            h0 = torch.zeros((B, self.di, self.N), dtype=torch.float32,
                             device=h.device)
            ssm_y, hs = self._ssm_branch(a, p["ssm"], h0)
            h = self._fuse(h, attn_y, ssm_y, p)
            yield h, kv, hs

    def _final(self, h: torch.Tensor) -> torch.Tensor:
        h = rms_norm(h, self.final_norm, self.cfg.norm_eps)
        return h @ self.embed.T                      # tied embedding

    # ------------------------------------------------------------ forward

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T) tokens → (B, T, V) logits (+ the aux loss, 0)."""
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        h = take_embedding(self.embed, tokens)
        for h, _, _ in self._layers(h, positions):
            pass
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        return self._final(h), aux

    # ------------------------------------------------------------ training

    def _train_layer(self, h, p, l: int, positions):
        cfg = self.cfg
        layout = split_layout()
        a = rms_norm(h, p["ln1"], cfg.norm_eps)
        if layout is not None:
            attn_y = split_attention(
                a, p["attn"], cfg, window=int(self.windows[l]),
                rope_base=cfg.rope_base, layout=layout)
            ssm_y, _ = self._split_ssm_branch(a, p["ssm"], layout)
            return self._fuse(h, attn_y, ssm_y, p, layout)
        attn_y = attention_block(
            a, p["attn"], cfg, window=int(self.windows[l]),
            rope_base=cfg.rope_base, positions=positions, impl="xla")
        h0 = torch.zeros((h.shape[0], self.di, self.N), dtype=torch.float32,
                         device=h.device)
        ssm_y, _ = self._ssm_branch(a, p["ssm"], h0)
        return self._fuse(h, attn_y, ssm_y, p)

    def train_forward(self, params: Dict[str, Any], tokens: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``forward(params, tokens)``: (B, T, V) logits
        (+ the aux loss, 0), differentiable in ``params``.  On a mesh that
        splits the work over ``model``, ``tokens`` are this rank's chunk of
        the sequence, and so are the logits."""
        cfg = self.cfg
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        embed = whole_table(params["embed"], cfg.vocab_size)
        h = take_embedding(embed, tokens)
        for l, p in enumerate(unstack_layers(params["layers"],
                                             cfg.num_layers)):
            h = remat_call(self._train_layer, h, p, l, positions,
                           policy=self.remat)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        # split over model, the tied table is gathered once (its two uses
        # add their gradients before its one reduction); elsewhere each
        # use reads the leaf
        table = embed if split_layout() is not None else params["embed"]
        return h @ table.T, aux

    def loss(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        """(ce, {"ce", "aux", "tokens"}), as the reference's ``loss``."""
        logits, aux = self.train_forward(params, batch["tokens"])
        ce, denom = cross_entropy(logits, batch)
        return ce, {"ce": ce, "aux": aux, "tokens": denom}

    # ------------------------------------------------------------ serving

    def init_decode_state(self, batch_size: int, max_seq: int, dtype=None,
                          device=None) -> Dict[str, torch.Tensor]:
        """Zero decode state for ``batch_size`` slots; ``device`` overrides
        the model's (``"meta"`` gives the shapes alone)."""
        cfg = self.cfg
        dtype = dtype or self.dtype
        dev = self.device if device is None else device
        shape = (cfg.num_layers, batch_size, max_seq, cfg.num_kv_heads, cfg.hd)
        return {
            "cache_k": torch.zeros(shape, dtype=dtype, device=dev),
            "cache_v": torch.zeros(shape, dtype=dtype, device=dev),
            "ssm_h": torch.zeros((cfg.num_layers, batch_size, self.di, self.N),
                                 dtype=torch.float32, device=dev),
            "pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
        }

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, max_seq: Optional[int] = None,
                params: Optional[Dict[str, Any]] = None):
        """Run the prompt, return (decode_state, logits at last position).
        Under a serving mesh's ``ServeLayout``, :meth:`_mesh_prefill` on
        ``params`` (this rank's shards)."""
        layout = serve_layout()
        if layout is not None:
            return self._mesh_prefill(params, tokens, layout)
        B, S = tokens.shape
        max_seq = max_seq or S
        positions = torch.arange(S, device=tokens.device)
        h = take_embedding(self.embed, tokens)
        ks, vs, hs = [], [], []
        for h, (k, v), state in self._layers(h, positions):
            if max_seq > S:
                pad = (0, 0, 0, 0, 0, max_seq - S)
                k = F.pad(k, pad)
                v = F.pad(v, pad)
            ks.append(k)
            vs.append(v)
            hs.append(state)
        state = {
            "cache_k": torch.stack(ks), "cache_v": torch.stack(vs),
            "ssm_h": torch.stack(hs),
            "pos": torch.full((B,), S, dtype=torch.int32, device=tokens.device),
        }
        return state, self._final(h[:, -1])

    @torch.no_grad()
    def decode_step(self, state: Dict[str, Any], tokens: torch.Tensor, *,
                    params: Optional[Dict[str, Any]] = None):
        """One token per slot: (state, (B, V) logits).  Lane b writes its
        K/V at ``pos[b]`` and attends rows ``<= pos[b]`` within its layer's
        window; the cache and the SSM states are written in place and
        returned; ``pos`` advances by one on every lane.  The SSM skip adds
        in fp32 before the cast, as the reference's decode does.  Under a
        serving mesh's ``ServeLayout``, :meth:`_mesh_decode` on
        ``params``."""
        layout = serve_layout()
        if layout is not None:
            return self._mesh_decode(params, state, tokens, layout)
        cfg = self.cfg
        pos = state["pos"]
        h = take_embedding(self.embed, tokens)
        for l in range(cfg.num_layers):
            p = self._layer_params(l)
            a = rms_norm(h, p["ln1"], cfg.norm_eps)
            q, k, v = qkv(a, p["attn"], cfg, pos, cfg.rope_base)
            ck, cv = state["cache_k"][l], state["cache_v"][l]
            update_cache(ck, cv, k, v, pos)
            o = decode_attn(q, ck, cv, pos, cfg, window=int(self.windows[l]))
            attn_y = o.to(h.dtype) @ p["attn"]["wo"]
            ps = p["ssm"]
            xc, z = torch.chunk(a @ ps["w_in"], 2, dim=-1)
            dt = F.softplus(xc @ ps["w_dt"] + ps["dt_bias"])
            A = -torch.exp(ps["A_log"])
            hs, y = ssm_step(state["ssm_h"][l], xc.float(), dt.float(),
                             (xc @ ps["w_B"]).float(),
                             (xc @ ps["w_C"]).float(), A)
            state["ssm_h"][l] = hs
            y = (y + ps["D_skip"] * xc).to(h.dtype) * F.silu(z)
            h = self._fuse(h, attn_y, y @ ps["w_out"], p)
        new_state = {"cache_k": state["cache_k"], "cache_v": state["cache_v"],
                     "ssm_h": state["ssm_h"], "pos": pos + 1}
        return new_state, self._final(h)

    # ----------------------------------------------- serving on a mesh
    #
    # The reference's serving cell on a production mesh: the weights rest
    # in their shards and each layer's are gathered where it reads them
    # (``parallel.sharding.ServeLayout``), the prefill runs as a training
    # step's forward does, and each rank keeps its window of the cache
    # (rows or kv heads) and its ``d_inner`` columns of the SSM state.

    def _mesh_prefill(self, params, tokens: torch.Tensor, layout):
        """The prompt on a serving mesh: ``tokens`` (B, S) are this rank's
        rows, whole; the residual stream is its chunk of them (padded at
        the end to a multiple of ``model``).  Attention through
        ``split_attention`` (K2 on the rank's q heads, or on its query rows
        at their offset), keeping the K/V of the rank's cache window; the
        SSM branch split by ``d_inner``, its scan over the S tokens alone,
        keeping the final state of the rank's columns; the MLP split by
        ``d_ff``.  Returns (this rank's shards of the decode state, the
        last logits (B, V), from the rank whose chunk holds token
        S - 1)."""
        cfg = self.cfg
        B, S = tokens.shape
        tokens = F.pad(tokens, (0, layout.chunk * layout.model_size - S))
        h = mesh_embedding(params["embed"], tokens, layout, cfg)
        ks, vs, hs = [], [], []
        for l, p in enumerate(unstack_layers(params["layers"],
                                             cfg.num_layers)):
            a = rms_norm(h, p["ln1"], cfg.norm_eps)
            attn_y, (k, v) = split_attention(
                a, p["attn"], cfg, window=int(self.windows[l]),
                rope_base=cfg.rope_base, layout=layout, impl=self.impl)
            ssm_y, state = self._split_ssm_branch(a, p["ssm"], layout,
                                                  length=S)
            h = self._fuse(h, attn_y, ssm_y, p, layout)
            ks.append(k)
            vs.append(v)
            hs.append(state)
        h = rms_norm(layout.row(h, S - 1), params["final_norm"],
                     cfg.norm_eps)
        state = {
            "cache_k": torch.stack(ks), "cache_v": torch.stack(vs),
            "ssm_h": torch.stack(hs),
            "pos": torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device),
        }
        return state, mesh_scores(h, params["embed"], layout,
                                  cfg.vocab_size)

    def _mesh_decode(self, params, state, tokens: torch.Tensor, layout):
        """A decode step on a serving mesh: the lanes (this rank's rows,
        whole on every ``model`` rank), the state this rank's shards,
        written in place.  Attention through ``split_decode`` on the
        cache's window; the SSM step on the rank's ``d_inner`` columns
        ``[c0, c1)`` (``a @ w_in`` gathered from the ranks' columns of
        ``w_in``, ``xc`` gathered for ``w_dt``'s input, ``xc @ w_B``,
        ``xc @ w_C`` and ``y @ w_out`` summed over ``model``); the MLP
        split by ``d_ff``."""
        cfg = self.cfg
        di = self.di
        pos = state["pos"]
        cols = layout.window("ssm_h", 2)
        c0, c1 = cols
        split = c1 - c0 < di
        part = lambda y: layout.sum_parts(y) if split else y
        h = mesh_embedding(params["embed"], tokens, layout, cfg)
        for l, p in enumerate(unstack_layers(params["layers"],
                                             cfg.num_layers)):
            a = rms_norm(h, p["ln1"], cfg.norm_eps)
            attn_y = split_decode(
                a, p["attn"], cfg, state["cache_k"][l], state["cache_v"][l],
                pos, window=int(self.windows[l]), rope_base=cfg.rope_base,
                layout=layout)
            ps = p["ssm"]
            cut = lambda k, d: layout.cut(ps[k], d, di, cols)
            xz = layout.product(a, ps["w_in"], 2 * di)
            xc, z = xz[:, c0:c1], xz[:, di + c0:di + c1]
            xc_all = layout.mesh.all_gather(xc, "model", 1) if split else xc
            dt = F.softplus(xc_all @ cut("w_dt", 1) + cut("dt_bias", 0))
            A = -torch.exp(cut("A_log", 0))
            hs, y = ssm_step(state["ssm_h"][l], xc.float(), dt.float(),
                             part(xc @ cut("w_B", 0)).float(),
                             part(xc @ cut("w_C", 0)).float(), A)
            state["ssm_h"][l] = hs
            y = (y + cut("D_skip", 0) * xc).to(h.dtype) * F.silu(z)
            h = self._fuse(h, attn_y, part(y @ cut("w_out", 0)), p, layout)
        new_state = {"cache_k": state["cache_k"], "cache_v": state["cache_v"],
                     "ssm_h": state["ssm_h"], "pos": pos + 1}
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        return new_state, mesh_scores(h, params["embed"], layout,
                                      cfg.vocab_size)
