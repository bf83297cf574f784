"""Whisper-style encoder-decoder backbone (audio family), as a PyTorch
``nn.Module``.

The counterpart of ``repro/models/encdec.py``.  The conv/mel frontend is
a stub, as there: callers pass precomputed frame embeddings ``frames``
(B, T_enc, D).  The encoder is bidirectional attention and a plain GELU
MLP over sinusoidal positions; the decoder has learned positions, causal
self-attention and cross-attention to the encoder's output; LayerNorm
with a bias throughout (arXiv:2212.04356).  Attention is plain MHA
through :func:`~repro_torch.models.attention.blockwise_attn` (chunk
``min(512, Sk)``), K without a bias, Q and V with one.

Like the reference, the model runs through ``forward``, ``prefill`` and
``decode_step``, each given ``frames``: the serving engine passes none, so
``prefill`` without them raises a ``ValueError`` (the reference fails
there too).  The decode state holds the self-attention cache and each
layer's cross-attention K/V.  A decode step adds the learned position of
slot 0 to every slot (``pos_embed[pos[0]]``), as the reference does.
Weights live on the module; on one device the serving functions take no
``params`` argument.  On a serving mesh (``launch.steps.make_prefill_fn``
/ ``make_decode_fn`` with ``shardings=``, which bind a
``parallel.sharding.ServeLayout``) they take ``params=``, this rank's
shards, and the state is this rank's shards of it (``_mesh_prefill``,
``_mesh_decode``): the prefill as the training layout below, each rank
keeping its window of the self-attention cache and its heads of the cross
K/V.  ``loss(params, batch)`` trains on ``batch["frames"]`` through
the same layers, grad-enabled, each decoder layer under activation
checkpointing whatever ``remat`` says, as the reference's.

On a training mesh that splits the work over ``model``
(``models.common.split_layout``) the reference's ``constrain`` sites lay
it out: the encoder's residual is the rank's chunk of its frames (padded
at their end to a multiple of ``model``), the decoder's the rank's chunk
of the tokens; each attention reads its input whole (:func:`_split_mha`:
by heads where they divide ``model``, else the rank's query rows against
gathered K/V), cross-attention the whole encoder output, and its output
comes back to the chunk; the MLP splits ``d_ff`` (:func:`_mlp`); the
decoder's positions are its chunk's rows of ``pos_embed``; the logits are
the rank's own tokens against the whole table.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import softmax_over
from .attention import NEG_INF, _cache_window, blockwise_attn, update_cache
from .common import (
    ArchConfig,
    check_remat,
    cross_entropy,
    frozen,
    mesh_columns,
    mesh_embedding,
    mesh_scores,
    remat_call,
    resolve_device,
    serve_layout,
    split_layout,
    take_embedding,
    torch_dtype,
    unstack_layers,
    whole_table,
)

__all__ = ["EncDecLM", "layer_norm", "sinusoids"]


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm in fp32 (population variance), cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return ((x - mu) * torch.rsqrt(var + eps) * scale + bias).to(dt)


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's encoder positions: (length, channels) float32."""
    t = np.arange(length)[:, None]
    inv = np.exp(-np.log(10000.0) * np.arange(channels // 2)
                 / (channels // 2 - 1))
    ang = t * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(
        np.float32)


def _gelu(x):
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def _mha(x, kv, p, cfg, *, causal, positions=None):
    """Plain MHA (whisper: H == K).  x: (B, Sq, D), kv: (B, Sk, D) →
    (y (B, Sq, D), (k, v) (B, Sk, H, hd))."""
    B, Sq, D = x.shape
    Sk = kv.shape[1]
    H, hd = cfg.num_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, Sq, H, hd) + p["bq"]
    k = (kv @ p["wk"]).reshape(B, Sk, H, hd)
    v = (kv @ p["wv"]).reshape(B, Sk, H, hd) + p["bv"]
    if positions is None:
        positions = torch.arange(Sq, device=x.device)
    out = blockwise_attn(
        q.reshape(B, Sq, H, 1, hd), k, v, q_positions=positions,
        k_positions=torch.arange(Sk, device=x.device), window=0,
        scale=1.0 / math.sqrt(hd), causal=causal, chunk=min(512, Sk))
    y = out.reshape(B, Sq, H * hd) @ p["wo"] + p["bo"]
    return y, (k, v)


def _split_mha(x, p, cfg, layout, *, causal, length, kv=None, keep=False):
    """:func:`_mha` on a mesh that splits it over ``model`` (``layout``, a
    ``TrainLayout``): ``x`` (B, c, D) is this rank's chunk of a sequence of
    ``length`` positions padded to a multiple of the axis, and so is the
    output.  Self-attention reads the whole sequence (its first ``length``
    rows as keys: no padding is attended); cross-attention reads ``kv``
    (B, Sk, D), the whole encoder output.

    Where the heads divide the axis, the queries are gathered and the rank
    computes its heads ``[r·H/M, (r+1)·H/M)`` (``wq``, ``bq`` and ``wo``
    as their stored ``model`` shards, ``wk``, ``wv`` and ``bv`` sliced
    from the replicated leaves); its partial output projection is
    reduce-scattered back to its chunk and ``bo`` added once.  Else the
    rank computes all heads for its own queries against gathered K/V
    (self-attention projects its chunk's K/V and gathers only them), and
    ``wo`` is a local product.

    ``keep`` (a serving prefill's ``ServeLayout``): also returns the K/V
    of the rank's window of the decode state, ``(y, (k, v))``: for
    self-attention the cache's rows and heads (``_cache_window``), for
    cross-attention the heads of ``xk``/``xv`` over every frame."""
    B, c, D = x.shape
    H, hd = cfg.num_heads, cfg.hd
    start, _ = layout.span(length)
    attn = dict(window=0, scale=1.0 / math.sqrt(hd), causal=causal)
    if H % layout.model_size:
        whole = lambda k, d, n: layout.whole(p[k], d, n)
        q = (x @ whole("wq", 1, H * hd)).reshape(B, c, H, hd) \
            + whole("bq", 0, H)
        src = x if kv is None else kv
        k = (src @ whole("wk", 1, H * hd)).reshape(B, -1, H, hd)
        v = (src @ whole("wv", 1, H * hd)).reshape(B, -1, H, hd) \
            + whole("bv", 0, H)
        if kv is None:
            k = layout.gather_seq(k)[:, :length]
            v = layout.gather_seq(v)[:, :length]
        Sk = k.shape[1]
        out = blockwise_attn(
            q.reshape(B, c, H, 1, hd), k, v,
            q_positions=torch.arange(start, start + c, device=x.device),
            k_positions=torch.arange(Sk, device=x.device),
            chunk=min(512, Sk), **attn)
        y = out.reshape(B, c, H * hd) @ whole("wo", 0, H * hd) + p["bo"]
        if not keep:
            return y
        return y, (k, v) if kv is not None else _cache_window(layout, k, v)
    h0, h1 = layout.part(H)
    Hr = h1 - h0
    local = lambda k, d, n: layout.local(p[k], d, n)
    xg = layout.gather_seq(x)
    S = xg.shape[1]
    src = xg[:, :length] if kv is None else kv
    Sk = src.shape[1]
    q = (xg @ local("wq", 1, H * hd)).reshape(B, S, Hr, hd) \
        + local("bq", 0, H)
    k = (src @ local("wk", 1, H * hd)).reshape(B, Sk, Hr, hd)
    v = (src @ local("wv", 1, H * hd)).reshape(B, Sk, Hr, hd) \
        + local("bv", 0, H)
    out = blockwise_attn(
        q.reshape(B, S, Hr, 1, hd), k, v,
        q_positions=torch.arange(S, device=x.device),
        k_positions=torch.arange(Sk, device=x.device),
        chunk=min(512, Sk), **attn)
    y = layout.scatter_seq(out.reshape(B, S, Hr * hd)
                           @ local("wo", 0, H * hd)) + p["bo"]
    if not keep:
        return y
    if kv is not None:                    # the rank's heads of xk / xv
        return y, (k, v)
    (r0, r1), (j0, j1) = layout.cache_rows, layout.cache_heads
    if h0 <= j0 and j1 <= h1:             # the window's heads are at hand
        return y, _cache_window(layout, k, v, h0)
    lo = min(r0, length)
    rows = xg[:, lo:min(r1, length)]
    cols = (j0 * hd, j1 * hd)
    kw = (rows @ layout.cut(p["wk"], 1, H * hd, cols)).unflatten(-1, (-1, hd))
    vw = (rows @ layout.cut(p["wv"], 1, H * hd, cols)).unflatten(-1, (-1, hd)) \
        + layout.cut(p["bv"], 0, H, (j0, j1))
    return y, _cache_window(layout, kw, vw, j0, first_row=lo)


def _mlp(x, p, layout=None, d_ff: int = 0):
    """Whisper's GELU MLP; ``layout``: a training mesh's that splits its
    hidden over ``model`` (the reference's ``constrain(m, "data", None,
    "model")``): the rank's chunk ``x`` gathered, its slice of ``d_ff``
    (``w1``/``b1`` by columns, ``w2`` by rows), the partial product
    reduce-scattered back to its chunk and ``b2`` added once."""
    if layout is None:
        return _gelu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    h = _gelu(layout.gather_seq(x) @ layout.local(p["w1"], 1, d_ff)
              + layout.local(p["b1"], 0, d_ff))
    return layout.scatter_seq(h @ layout.local(p["w2"], 0, d_ff)) + p["b2"]


def _attend(q, k, v, mask=None):
    """One query row per slot over (B, S, H, hd) K/V, in fp32 as the
    reference's decode: (B, H, hd) → (B, H, hd)."""
    hd = q.shape[-1]
    s = torch.einsum("bhd,bshd->bhs", q.float() / math.sqrt(hd), k.float())
    if mask is not None:
        s = torch.where(mask[:, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", w, v.float())


def _attn_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.hd
    return {"wq": (D, H * hd), "wk": (D, H * hd), "wv": (D, H * hd),
            "wo": (H * hd, D), "bq": (H, hd), "bv": (H, hd), "bo": (D,)}


def _mlp_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    D, F_ = cfg.d_model, cfg.d_ff
    return {"w1": (D, F_), "b1": (F_,), "w2": (F_, D), "b2": (D,)}


def _stack(groups: Dict[str, Dict[str, tuple]], L: int, dtype,
           device) -> nn.Module:
    """A module of submodules ``groups`` whose leaves are stacked over L
    layers on axis 0."""
    out = nn.Module()
    for group, shapes in groups.items():
        sub = nn.Module()
        for name, shape in shapes.items():
            setattr(sub, name, frozen((L, *shape), dtype, device))
        setattr(out, group, sub)
    return out


class EncDecLM(nn.Module):
    """Whisper-style encoder-decoder LM; parameters are allocated, not
    initialised — call :meth:`init` or ``load_state_dict``."""

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 max_target_positions: int = 4096,
                 impl: str = "kernel", remat: str = "full") -> None:
        super().__init__()
        if cfg.family != "audio":
            raise ValueError(
                f"EncDecLM needs family 'audio', got {cfg.family!r}")
        # taken and ignored, as the reference's: every decoder layer is
        # checkpointed
        check_remat(remat)
        self.cfg = cfg
        self.impl = impl          # no kernel on this family's path
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        self.max_target_positions = max_target_positions
        D = cfg.d_model
        dt, dev = self.dtype, self.device
        ln = {"scale": (D,), "bias": (D,)}
        self.embed = frozen((cfg.vocab_size, D), dt, dev)
        self.pos_embed = frozen((max_target_positions, D), dt, dev)
        self.enc_layers = _stack(
            {"ln1": ln, "ln2": ln, "attn": _attn_shapes(cfg),
             "mlp": _mlp_shapes(cfg)}, cfg.encoder_layers, dt, dev)
        self.dec_layers = _stack(
            {"ln1": ln, "ln_x": ln, "ln2": ln,
             "self_attn": _attn_shapes(cfg), "cross_attn": _attn_shapes(cfg),
             "mlp": _mlp_shapes(cfg)}, cfg.num_layers, dt, dev)
        self.enc_final_ln = nn.Module()
        self.dec_final_ln = nn.Module()
        for final in (self.enc_final_ln, self.dec_final_ln):
            for name, shape in ln.items():
                setattr(final, name, frozen(shape, dt, dev))

    # ------------------------------------------------------------- params

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "EncDecLM":
        """Random weights with the reference's distributions, drawn from
        ``generator`` (which must live on the model's device)."""
        cfg, dev = self.cfg, self.device
        D, F_ = cfg.d_model, cfg.d_ff

        def normal(shape, scale):
            x = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32)
            return (x * scale).to(self.dtype)

        self.embed.copy_(normal(self.embed.shape, 1 / math.sqrt(D)))
        self.pos_embed.copy_(normal(self.pos_embed.shape, 0.01))
        std = {"wq": 1 / math.sqrt(D), "wk": 1 / math.sqrt(D),
               "wv": 1 / math.sqrt(D), "wo": 1 / math.sqrt(D),
               "w1": 1 / math.sqrt(D), "w2": 1 / math.sqrt(F_)}
        for name, t in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in ("embed", "pos_embed"):
                continue
            if leaf in std:
                for l in range(t.shape[0]):
                    t[l].copy_(normal(t.shape[1:], std[leaf]))
            elif leaf == "scale":
                t.fill_(1)
            else:                                    # the biases
                t.zero_()
        return self

    @staticmethod
    def _layer_params(layers: nn.Module, l: int) -> Dict[str, Any]:
        return {group: {n: t[l] for n, t in sub.named_parameters()}
                for group, sub in layers.named_children()}

    # ------------------------------------------------------------- encode

    def _encode(self, frames: torch.Tensor, layers, final_ln,
                layout=None) -> torch.Tensor:
        """The encoder over per-layer parameter dicts ``layers`` and the
        final LayerNorm's ``{"scale", "bias"}``.  On a mesh that splits the
        work over ``model`` (a training step's, or ``layout``: a serving
        prefill's), the output is this rank's chunk of the frames (padded
        at their end to a multiple of the axis)."""
        cfg = self.cfg
        if layout is None:
            layout = split_layout()
        T = frames.shape[1]
        pos = torch.from_numpy(sinusoids(T, cfg.d_model)).to(frames.device)
        h = (frames + pos).to(self.dtype)
        if layout is not None:
            h = layout.take_chunk(h)
        for p in layers:
            a = layer_norm(h, p["ln1"]["scale"], p["ln1"]["bias"])
            if layout is not None:
                y = _split_mha(a, p["attn"], cfg, layout, causal=False,
                               length=T)
            else:
                y, _ = _mha(a, a, p["attn"], cfg, causal=False)
            h = h + y
            m = layer_norm(h, p["ln2"]["scale"], p["ln2"]["bias"])
            h = h + _mlp(m, p["mlp"], layout, cfg.d_ff)
        return layer_norm(h, final_ln["scale"], final_ln["bias"])

    @torch.no_grad()
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T_enc, D) precomputed embeddings (frontend stub) →
        the encoder's output, in the model's dtype."""
        layers = [self._layer_params(self.enc_layers, l)
                  for l in range(self.cfg.encoder_layers)]
        final = {"scale": self.enc_final_ln.scale,
                 "bias": self.enc_final_ln.bias}
        return self._encode(frames, layers, final)

    # ------------------------------------------------------------ decoder

    def _frames(self, frames, patch_embeds, what: str) -> torch.Tensor:
        """The encoder's input: ``frames``, else ``patch_embeds`` (the one
        slot the reference's launcher passes the stub through)."""
        frames = patch_embeds if frames is None else frames
        if frames is None:
            raise ValueError(
                f"EncDecLM.{what} needs frames: the encoder's input "
                f"embeddings (B, T_enc, {self.cfg.d_model}); the audio "
                "frontend is a stub and the serving engine passes none")
        return frames.to(self.device)

    def _decoder(self, tokens, enc_out):
        """Every decoder layer over the full prompt; yields (h, (k, v),
        (cross k, cross v)) per layer."""
        cfg = self.cfg
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)
        h = take_embedding(self.embed, tokens) + self.pos_embed[:S]
        for l in range(cfg.num_layers):
            p = self._layer_params(self.dec_layers, l)
            h, kv, xkv = self._dec_layer(h, p, enc_out, positions)
            yield h, kv, xkv

    def _dec_layer(self, h, p, enc_out, positions):
        """One decoder layer: (h, self-attention (k, v), cross (k, v))."""
        cfg = self.cfg
        a = layer_norm(h, p["ln1"]["scale"], p["ln1"]["bias"])
        y, kv = _mha(a, a, p["self_attn"], cfg, causal=True,
                     positions=positions)
        h = h + y
        x = layer_norm(h, p["ln_x"]["scale"], p["ln_x"]["bias"])
        y2, xkv = _mha(x, enc_out, p["cross_attn"], cfg, causal=False,
                       positions=positions)
        h = h + y2
        m = layer_norm(h, p["ln2"]["scale"], p["ln2"]["bias"])
        return h + _mlp(m, p["mlp"]), kv, xkv

    def _split_dec_layer(self, h, p, enc_out, layout):
        """One decoder layer on a mesh that splits it over ``model``: ``h``
        is this rank's chunk of the tokens, ``enc_out`` the whole encoder
        output."""
        cfg = self.cfg
        S = layout.seq_len
        a = layer_norm(h, p["ln1"]["scale"], p["ln1"]["bias"])
        h = h + _split_mha(a, p["self_attn"], cfg, layout, causal=True,
                           length=S)
        x = layer_norm(h, p["ln_x"]["scale"], p["ln_x"]["bias"])
        h = h + _split_mha(x, p["cross_attn"], cfg, layout, causal=False,
                           length=S, kv=enc_out)
        m = layer_norm(h, p["ln2"]["scale"], p["ln2"]["bias"])
        return h + _mlp(m, p["mlp"], layout, cfg.d_ff)

    def _final(self, h: torch.Tensor) -> torch.Tensor:
        h = layer_norm(h, self.dec_final_ln.scale, self.dec_final_ln.bias)
        return h @ self.embed.T

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *,
                frames: Optional[torch.Tensor] = None,
                patch_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced decoder logits (B, S, V) over the encoded
        ``frames`` (+ the aux loss, 0)."""
        enc_out = self.encode(self._frames(frames, patch_embeds, "forward"))
        for h, _, _ in self._decoder(tokens, enc_out):
            pass
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        return self._final(h), aux

    # ------------------------------------------------------------ training

    def train_forward(self, params: Dict[str, Any], tokens: torch.Tensor,
                      frames: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``forward(params, tokens, frames=)``:
        teacher-forced (B, S, V) logits (+ the aux loss, 0),
        differentiable in ``params``.  On a mesh that splits the work over
        ``model``, ``tokens`` are this rank's chunk of the sequence, and so
        are the logits; ``frames`` are whole."""
        cfg = self.cfg
        D = cfg.d_model
        layout = split_layout()
        frames = frames.to(self.device)
        enc_out = self._encode(
            frames, unstack_layers(params["enc_layers"], cfg.encoder_layers),
            params["enc_final_ln"])
        S = tokens.shape[1]
        embed = whole_table(params["embed"], cfg.vocab_size)
        if layout is None:
            positions = torch.arange(S, device=tokens.device)
            h = take_embedding(embed, tokens) + params["pos_embed"][:S]
            layer = lambda h, p: self._dec_layer(h, p, enc_out,
                                                 positions)[0]
            table = params["embed"]
        else:
            # the chunk's rows of the positions (zeros past the table, on
            # padding), and the encoder output whole for cross-attention
            start = layout.seq_start
            pos = params["pos_embed"][start:start + S]
            pos = torch.cat([pos, pos.new_zeros((S - pos.shape[0], D))])
            h = take_embedding(embed, tokens) + pos
            enc_out = layout.gather_seq(enc_out)[:, :frames.shape[1]]
            layer = lambda h, p: self._split_dec_layer(h, p, enc_out, layout)
            # gathered once: its two uses add their gradients before its
            # one reduction
            table = embed
        for p in unstack_layers(params["dec_layers"], cfg.num_layers):
            h = remat_call(layer, h, p)
        h = layer_norm(h, params["dec_final_ln"]["scale"],
                       params["dec_final_ln"]["bias"])
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        return h @ table.T, aux

    def loss(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        """(ce, {"ce", "aux", "tokens"}), as the reference's ``loss``;
        ``batch["frames"]`` is the encoder's input."""
        logits, aux = self.train_forward(params, batch["tokens"],
                                         batch["frames"])
        ce, denom = cross_entropy(logits, batch)
        return ce, {"ce": ce, "aux": aux, "tokens": denom}

    # ------------------------------------------------------------ serving

    def init_decode_state(self, batch_size: int, max_seq: int, dtype=None,
                          device=None) -> Dict[str, torch.Tensor]:
        """Zero decode state for ``batch_size`` slots (cross K/V over
        ``encoder_len`` frames); ``device`` overrides the model's."""
        cfg = self.cfg
        dtype = dtype or self.dtype
        dev = self.device if device is None else device
        L, H, hd = cfg.num_layers, cfg.num_heads, cfg.hd
        self_kv = (L, batch_size, max_seq, H, hd)
        cross_kv = (L, batch_size, cfg.encoder_len, H, hd)
        return {
            "cache_k": torch.zeros(self_kv, dtype=dtype, device=dev),
            "cache_v": torch.zeros(self_kv, dtype=dtype, device=dev),
            "xk": torch.zeros(cross_kv, dtype=dtype, device=dev),
            "xv": torch.zeros(cross_kv, dtype=dtype, device=dev),
            "pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
        }

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, max_seq: Optional[int] = None,
                frames: Optional[torch.Tensor] = None,
                patch_embeds: Optional[torch.Tensor] = None,
                params: Optional[Dict[str, Any]] = None):
        """Encode ``frames`` and run the prompt: (decode_state, logits at
        the last position).  Under a serving mesh's ``ServeLayout``,
        :meth:`_mesh_prefill` on ``params`` (this rank's shards)."""
        layout = serve_layout()
        if layout is not None:
            return self._mesh_prefill(
                params, tokens, self._frames(frames, patch_embeds, "prefill"),
                layout)
        enc_out = self.encode(self._frames(frames, patch_embeds, "prefill"))
        B, S = tokens.shape
        max_seq = max_seq or S
        ks, vs, xks, xvs = [], [], [], []
        for h, (k, v), (xk, xv) in self._decoder(tokens, enc_out):
            if max_seq > S:
                pad = (0, 0, 0, 0, 0, max_seq - S)
                k, v = F.pad(k, pad), F.pad(v, pad)
            ks.append(k)
            vs.append(v)
            xks.append(xk)
            xvs.append(xv)
        state = {
            "cache_k": torch.stack(ks), "cache_v": torch.stack(vs),
            "xk": torch.stack(xks), "xv": torch.stack(xvs),
            "pos": torch.full((B,), S, dtype=torch.int32, device=tokens.device),
        }
        return state, self._final(h[:, -1])

    @torch.no_grad()
    def decode_step(self, state: Dict[str, Any], tokens: torch.Tensor, *,
                    params: Optional[Dict[str, Any]] = None):
        """One token per slot: (state, (B, V) logits).  Lane b writes its
        self-attention K/V at ``pos[b]`` (in place) and attends rows
        ``<= pos[b]``, then the fixed cross K/V; every lane takes slot 0's
        learned position, as in the reference.  Under a serving mesh's
        ``ServeLayout``, :meth:`_mesh_decode` on ``params``."""
        layout = serve_layout()
        if layout is not None:
            return self._mesh_decode(params, state, tokens, layout)
        cfg = self.cfg
        B = tokens.shape[0]
        H, hd = cfg.num_heads, cfg.hd
        pos = state["pos"]
        h = take_embedding(self.embed, tokens) + self.pos_embed[pos[:1].long()]
        live = (torch.arange(state["cache_k"].shape[2], device=h.device)[None]
                <= pos.long()[:, None])
        for l in range(cfg.num_layers):
            p = self._layer_params(self.dec_layers, l)
            sa, xa = p["self_attn"], p["cross_attn"]
            a = layer_norm(h, p["ln1"]["scale"], p["ln1"]["bias"])
            q = (a @ sa["wq"]).reshape(B, H, hd) + sa["bq"]
            k = (a @ sa["wk"]).reshape(B, H, hd)
            v = (a @ sa["wv"]).reshape(B, H, hd) + sa["bv"]
            ck, cv = state["cache_k"][l], state["cache_v"][l]
            update_cache(ck, cv, k, v, pos)
            o = _attend(q, ck, cv, live)
            h = h + (o.reshape(B, H * hd).to(h.dtype) @ sa["wo"] + sa["bo"])
            x = layer_norm(h, p["ln_x"]["scale"], p["ln_x"]["bias"])
            qx = (x @ xa["wq"]).reshape(B, H, hd) + xa["bq"]
            ox = _attend(qx, state["xk"][l], state["xv"][l])
            h = h + (ox.reshape(B, H * hd).to(h.dtype) @ xa["wo"] + xa["bo"])
            m = layer_norm(h, p["ln2"]["scale"], p["ln2"]["bias"])
            m = _gelu(m @ p["mlp"]["w1"] + p["mlp"]["b1"])
            h = h + (m @ p["mlp"]["w2"] + p["mlp"]["b2"])
        new_state = {"cache_k": state["cache_k"], "cache_v": state["cache_v"],
                     "xk": state["xk"], "xv": state["xv"], "pos": pos + 1}
        return new_state, self._final(h)

    # ----------------------------------------------- serving on a mesh
    #
    # The reference's serving cell on a production mesh: the weights rest
    # in their shards and each layer's are gathered where it reads them
    # (``parallel.sharding.ServeLayout``), the prefill runs as a training
    # step's forward does, and each rank keeps its window of the
    # self-attention cache (rows or heads) and its heads of the cross K/V.

    def _mesh_prefill(self, params, tokens: torch.Tensor,
                      frames: torch.Tensor, layout):
        """Frames and prompt on a serving mesh: ``tokens`` (B, S) and
        ``frames`` (B, T, D) are this rank's rows, whole.  The encoder is
        sequence-parallel over its T frames (padded to a multiple of
        ``model``) and its output gathered whole; the decoder over the
        tokens, its self-attention and cross-attention through
        :func:`_split_mha` (keeping the rank's cache window and its heads
        of the cross K/V), its MLP split by ``d_ff``.  Returns (this rank's
        shards of the decode state, the last logits (B, V), from the rank
        whose chunk holds token S - 1)."""
        cfg = self.cfg
        B, S = tokens.shape
        D, T = cfg.d_model, frames.shape[1]
        enc = self._encode(
            frames, unstack_layers(params["enc_layers"], cfg.encoder_layers),
            params["enc_final_ln"], layout)
        enc_out = layout.gather_seq(enc)[:, :T]
        padded = layout.chunk * layout.model_size
        tokens = F.pad(tokens, (0, padded - S))
        # the chunk's rows of the positions (zeros past the table, on
        # padding)
        start = layout.seq_start
        pos = mesh_columns(params["pos_embed"][:padded], layout, D)
        pos = torch.cat([pos, pos.new_zeros((padded - pos.shape[0], D))])
        pos = pos[start:start + layout.chunk]
        h = mesh_embedding(params["embed"], tokens, layout, cfg) + pos
        ks, vs, xks, xvs = [], [], [], []
        for p in unstack_layers(params["dec_layers"], cfg.num_layers):
            a = layer_norm(h, p["ln1"]["scale"], p["ln1"]["bias"])
            y, (k, v) = _split_mha(a, p["self_attn"], cfg, layout,
                                   causal=True, length=S, keep=True)
            h = h + y
            x = layer_norm(h, p["ln_x"]["scale"], p["ln_x"]["bias"])
            y, (xk, xv) = _split_mha(x, p["cross_attn"], cfg, layout,
                                     causal=False, length=S, kv=enc_out,
                                     keep=True)
            h = h + y
            m = layer_norm(h, p["ln2"]["scale"], p["ln2"]["bias"])
            h = h + _mlp(m, p["mlp"], layout, cfg.d_ff)
            ks.append(k)
            vs.append(v)
            xks.append(xk)
            xvs.append(xv)
        h = layer_norm(layout.row(h, S - 1), params["dec_final_ln"]["scale"],
                       params["dec_final_ln"]["bias"])
        state = {
            "cache_k": torch.stack(ks), "cache_v": torch.stack(vs),
            "xk": torch.stack(xks), "xv": torch.stack(xvs),
            "pos": torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device),
        }
        return state, mesh_scores(h, params["embed"], layout,
                                  cfg.vocab_size)

    def _mesh_decode(self, params, state, tokens: torch.Tensor, layout):
        """A decode step on a serving mesh: the lanes (this rank's rows,
        whole on every ``model`` rank), the state this rank's shards, the
        cache written in place.  Self-attention over the cache's window
        (:func:`_decode_self_attn`, the softmax over ``model`` where the
        rows are split), cross-attention on the rank's heads of the cross
        K/V (:func:`_decode_cross_attn`), the MLP split by ``d_ff``; every
        lane takes slot 0's learned position, as the reference does."""
        cfg = self.cfg
        pos = state["pos"]
        h = mesh_embedding(params["embed"], tokens, layout, cfg) \
            + mesh_columns(params["pos_embed"][pos[:1].long()], layout,
                           cfg.d_model)
        for l, p in enumerate(unstack_layers(params["dec_layers"],
                                             cfg.num_layers)):
            a = layer_norm(h, p["ln1"]["scale"], p["ln1"]["bias"])
            h = h + _decode_self_attn(a, p["self_attn"], cfg,
                                      state["cache_k"][l],
                                      state["cache_v"][l], pos, layout)
            x = layer_norm(h, p["ln_x"]["scale"], p["ln_x"]["bias"])
            h = h + _decode_cross_attn(x, p["cross_attn"], cfg,
                                       state["xk"][l], state["xv"][l],
                                       layout)
            m = layer_norm(h, p["ln2"]["scale"], p["ln2"]["bias"])
            h = h + _mlp(m, p["mlp"], layout, cfg.d_ff)
        new_state = {"cache_k": state["cache_k"], "cache_v": state["cache_v"],
                     "xk": state["xk"], "xv": state["xv"], "pos": pos + 1}
        h = layer_norm(h, params["dec_final_ln"]["scale"],
                       params["dec_final_ln"]["bias"])
        return new_state, mesh_scores(h, params["embed"], layout,
                                      cfg.vocab_size)


# --------------------------------------------------------------------------
# a decode step's attention on a serving mesh
# --------------------------------------------------------------------------


def _heads_out(o: torch.Tensor, p, layout, heads, H: int, hd: int
               ) -> torch.Tensor:
    """The output projection of ``o`` (B, (j1 - j0)·hd), the heads
    ``heads`` = (j0, j1), on a decoding ``ServeLayout``: the rank's rows of
    ``wo`` for its heads where they are split, else its slice of the rows
    for all heads, the partial products summed over ``model``; ``bo`` once."""
    j0, j1 = heads
    if j1 - j0 < H:
        y = o @ layout.cut(p["wo"], 0, H * hd, (j0 * hd, j1 * hd))
    else:
        lo, hi = layout.part(H * hd)
        y = o[:, lo:hi] @ layout.local(p["wo"], 0, H * hd)
    return layout.sum_parts(y) + p["bo"]


def _q_heads(x, p, layout, heads, H: int, hd: int) -> torch.Tensor:
    """q (B, j1 - j0, hd) of the heads ``heads`` = (j0, j1): where they are
    all of them and ``wq`` rests split over ``model`` (by columns, whole
    heads or not), each rank's product with its columns, all-gathered;
    else the product with their columns of ``wq``."""
    j0, j1 = heads
    if j1 - j0 == H:
        q = layout.product(x, p["wq"], H * hd)
    else:
        q = x @ layout.cut(p["wq"], 1, H * hd, (j0 * hd, j1 * hd))
    return q.unflatten(-1, (-1, hd)) + layout.cut(p["bq"], 0, H, heads)


def _decode_self_attn(x, p, cfg, cache_k, cache_v, pos, layout):
    """Whisper's decode self-attention on a serving mesh (``layout``: a
    decoding ``ServeLayout``), the sibling of ``split_decode`` for MHA with
    biases and no RoPE: ``x`` (B, D) the lanes, the cache this rank's
    window (rows ``cache_rows``, heads ``cache_heads``), written in place.
    The rank projects q for the window's heads (:func:`_q_heads`), k and v
    for them, writes the K/V rows of its window, and attends over its rows in
    fp32, as the reference: the softmax takes the rows' global max and sum
    over ``model`` where they are split (``softmax_over``), and the partial
    P·V is summed over ``model``.  Returns the output projection summed
    over ``model`` (:func:`_heads_out`), (B, D)."""
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.hd
    (r0, _), heads = layout.cache_rows, layout.cache_heads
    j0, j1 = heads
    cols = (j0 * hd, j1 * hd)
    q = _q_heads(x, p, layout, heads, H, hd)
    k = (x @ layout.cut(p["wk"], 1, H * hd, cols)).unflatten(-1, (-1, hd))
    v = (x @ layout.cut(p["wv"], 1, H * hd, cols)).unflatten(-1, (-1, hd)) \
        + layout.cut(p["bv"], 0, H, heads)
    update_cache(cache_k, cache_v, k, v, pos, start=r0,
                 max_seq=layout.max_seq)
    s = torch.einsum("bhd,bshd->bhs", q.float() / math.sqrt(hd),
                     cache_k.float())
    idx = torch.arange(r0, r0 + cache_k.shape[1], device=x.device)
    s = torch.where((idx[None, :] <= pos.long()[:, None])[:, None], s,
                    NEG_INF)
    split = layout.rows_split
    w = softmax_over(s, layout.mesh, "model") if split else \
        torch.softmax(s, dim=-1)
    o = torch.einsum("bhs,bshd->bhd", w, cache_v.float())
    if split:
        o = layout.mesh.all_reduce(o, ["model"])
    return _heads_out(o.reshape(B, -1).to(x.dtype), p, layout, heads, H, hd)


def _decode_cross_attn(x, p, cfg, xk, xv, layout):
    """Whisper's decode cross-attention on a serving mesh over the rank's
    heads of the fixed cross K/V (all of them where the heads do not
    divide ``model``): the output projection summed over ``model``."""
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.hd
    heads = layout.window("xk", 3)
    o = _attend(_q_heads(x, p, layout, heads, H, hd), xk, xv)
    return _heads_out(o.reshape(B, -1).to(x.dtype), p, layout, heads, H, hd)
