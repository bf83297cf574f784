"""RWKV6 ("Finch"), attention-free LM with data-dependent decay, in PyTorch.

The counterpart of ``repro/models/rwkv.py``: the same stacked-parameter
layout (layer ``l``'s ``wr`` is ``layers.wr[l]`` of shape ``(D, D)``), the
same functions, and a Python loop over layers where the reference scanned.
Per layer, a time mix (the WKV6 recurrence over a per-head ``(hd, hd)``
fp32 state, per-channel decay ``w_t = exp(-exp(w0 + lora(x_t)))`` and
bonus ``u``) and a channel mix (squared-ReLU FFN), both with token-shift
ddlerp mixing (arXiv:2404.05892).

Prompts run the recurrence through :func:`repro_torch.kernels.wkv6.ops.
wkv6` (the hand-written kernel on the card, its plain version on the CPU);
a decode step runs :func:`wkv6_step` in plain PyTorch, as the reference
runs it outside any Pallas kernel.  Serving state is O(1) per sequence and
there is no KV cache, so the engine serves this model in its dense mode
(``init_decode_state`` / ``prefill`` / ``decode_step``).  Weights live on
the module; on one device the serving functions take no ``params``
argument.  On a serving mesh (``launch.steps.make_prefill_fn`` /
``make_decode_fn`` with ``shardings=``, which bind a
``parallel.sharding.ServeLayout``) they take ``params=``, this rank's
shards, and the state is this rank's shards of it (``_mesh_prefill``,
``_mesh_decode``): the prefill runs as the training layout below, the
recurrence through K3 on the rank's rows of the prompt's tokens, and each
rank keeps its value columns of the ``wkv`` state.

``loss(params, batch)`` trains through the reference's training route:
the recurrence in :func:`wkv6_scan` (the XLA scan's counterpart,
differentiable; the kernel has no backward, nor has the reference's
Pallas kernel a VJP; each chunk of 64 tokens checkpointed), each layer
under activation checkpointing whatever ``remat`` says, as the
reference's.  On a training mesh that splits the work over ``model``
(``models.common.split_layout``) the reference's ``constrain`` sites lay
it out: the residual stream is the rank's chunk
of the sequence between layers; the time mix runs on the rank's rows of
the whole sequence, the batch split over ``("data", "model")`` (§Perf-A2;
all the rows where ``model`` does not divide them), with its weights
whole; the channel mix splits ``d_ff`` over ``model``, its partial
product reduce-scattered to the chunk and gated there; and the logits
are the rank's own tokens against the whole table.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.wkv6.ops import wkv6
from ..launch.hlo_cost import token_loop
from .common import (
    ArchConfig,
    check_remat,
    cross_entropy,
    frozen,
    mesh_embedding,
    mesh_scores,
    remat_call,
    remat_chunk,
    resolve_device,
    rms_norm,
    serve_layout,
    split_layout,
    take_embedding,
    torch_dtype,
    unstack_layers,
    whole_table,
)

__all__ = ["FP32_PARAMS", "RwkvLM", "wkv6_scan", "wkv6_step"]

TM_LORA = 32
DECAY_LORA = 64
#: parameters kept in float32 whatever the model dtype, as the reference
#: initialises them
FP32_PARAMS = ("layers.w0", "layers.u")


# --------------------------------------------------------------------------
# WKV6 recurrence
# --------------------------------------------------------------------------


def wkv6_step(state, r, k, v, w, u):
    """One token.  state: (..., H, hd, hd); r/k/v/w: (..., H, hd); u: (H, hd).

    y_t[j] = sum_i r[i] * (S[i,j] + u[i] k[i] v[j]);  S = w⊙S + k^T v.
    """
    rk = r * u * k
    y = torch.einsum("...hi,...hij->...hj", r, state) + torch.einsum(
        "...hi,...hj->...hj", rk, v)
    state = state * w[..., None] + torch.einsum("...hi,...hj->...hij", k, v)
    return state, y


def _wkv6_chunk(state, r, k, v, w, u):
    """One chunk of :func:`wkv6_scan`: (B, c, H, hd) fp32 inputs from
    ``state`` → (final state, (B, c, H, hd) outputs)."""
    ys = []
    for t in range(r.shape[1]):
        state, y = wkv6_step(state, r[:, t], k[:, t], v[:, t], w[:, t], u)
        ys.append(y)
    return state, torch.stack(ys, dim=1)


@token_loop(per_token=(0, 1, 2, 3), per_token_out=(1,))
def wkv6_scan(r, k, v, w, u, state0, *, chunk: int = 64):
    """(B, T, H, hd) inputs → final state + (B, T, H, hd) outputs in r's
    dtype: the exact per-token scan of :func:`wkv6_step` in fp32, in
    chunks of up to ``chunk`` tokens, for any T (the reference's XLA scan
    needs ``min(64, T)`` to divide T; here the last chunk may be short).

    With gradients on, each chunk runs under a checkpoint
    (:func:`~repro_torch.models.common.remat_chunk`), as the reference's
    ``@jax.checkpoint`` ``chunk_fn``: the backward keeps one state per
    chunk boundary and recomputes one chunk's states at a time, not one
    state per token; inside the layer's checkpoint the two nest, as in
    the reference.  Under the dry run's ``CostMode`` (``token_loop``) the
    scan runs on the mode's first ``loop_chunk`` tokens, chunked and
    checkpointed alike, and every count is scaled to T: the forward, the
    chunks' recompute in the backward and the boundary states the
    backward keeps."""
    r32, k32, v32, w32 = (x.float() for x in (r, k, v, w))
    state, u = state0.float(), u.float()
    run = remat_chunk(_wkv6_chunk)
    ys = []
    for s in range(0, r.shape[1], chunk):
        e = min(s + chunk, r.shape[1])
        state, y = run(state, r32[:, s:e], k32[:, s:e], v32[:, s:e],
                       w32[:, s:e], u)
        ys.append(y)
    return state, torch.cat(ys, dim=1).to(r.dtype)


# --------------------------------------------------------------------------
# layer pieces
# --------------------------------------------------------------------------


def _token_shift(x, prev=None):
    """shift(x)[t] = x[t-1]; position 0 gets ``prev`` (or zeros)."""
    first = torch.zeros_like(x[:, :1]) if prev is None \
        else prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _group_norm(x, scale, bias, H, eps=64e-5):
    """RWKV's per-head GroupNorm on (..., H*hd), population variance."""
    shp = x.shape
    xh = x.reshape(*shp[:-1], H, shp[-1] // H).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, unbiased=False)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    out = xh.reshape(shp) * scale.float() + bias.float()
    return out.to(x.dtype)


def _layer_shapes(cfg: ArchConfig, H: int, hd: int) -> Dict[str, tuple]:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "ln1": (D,), "ln2": (D,), "mu_x": (D,), "mu_rkvwg": (5, D),
        "tm_w1": (D, 5 * TM_LORA), "tm_w2": (5, TM_LORA, D),
        "w0": (D,), "dw1": (D, DECAY_LORA), "dw2": (DECAY_LORA, D),
        "u": (H, hd),
        "wr": (D, D), "wk": (D, D), "wv": (D, D), "wg": (D, D), "wo": (D, D),
        "lnx_scale": (D,), "lnx_bias": (D,), "cmu_k": (D,), "cmu_r": (D,),
        "wck": (D, F_), "wcv": (F_, D), "wcr": (D, D),
    }


class RwkvLM(nn.Module):
    """RWKV6 LM; parameters are allocated, not initialised — call
    :meth:`init` or ``load_state_dict``."""

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 impl: str = "kernel", remat: str = "full") -> None:
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"RwkvLM needs family 'ssm', got {cfg.family!r}")
        # taken and ignored, as the reference's: every layer is checkpointed
        check_remat(remat)
        self.cfg = cfg
        self.impl = impl
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        self.hd = cfg.rwkv_head_size
        self.H = cfg.d_model // self.hd
        L, D = cfg.num_layers, cfg.d_model
        dt, dev = self.dtype, self.device
        self.embed = frozen((cfg.vocab_size, D), dt, dev)
        self.final_norm = frozen((D,), dt, dev)
        self.layers = nn.Module()
        for name, shape in _layer_shapes(cfg, self.H, self.hd).items():
            ldt = torch.float32 if f"layers.{name}" in FP32_PARAMS else dt
            setattr(self.layers, name, frozen((L, *shape), ldt, dev))

    # ------------------------------------------------------------- params

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "RwkvLM":
        """Random weights with the reference's distributions, drawn from
        ``generator`` (which must live on the model's device)."""
        cfg, dev = self.cfg, self.device
        D, F_ = cfg.d_model, cfg.d_ff
        s = 1.0 / math.sqrt(D)
        std = {"tm_w1": s, "tm_w2": 0.1, "dw1": s, "dw2": 0.1, "u": 0.1,
               "wr": s, "wk": s, "wv": s, "wg": s, "wo": s, "wck": s,
               "wcv": 1.0 / math.sqrt(F_), "wcr": s}
        fill = {"ln1": 1.0, "ln2": 1.0, "lnx_scale": 1.0, "w0": -2.0}

        def normal(shape, scale, dtype):
            x = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32)
            return (x * scale).to(dtype)

        self.embed.copy_(normal(self.embed.shape, s, self.dtype))
        self.final_norm.fill_(1)
        for name, t in self.layers.named_parameters():
            if name in std:
                for l in range(cfg.num_layers):   # one layer at a time
                    t[l].copy_(normal(t.shape[1:], std[name], t.dtype))
            else:
                t.fill_(fill.get(name, 0.0))
        return self

    def _layer_params(self, l: int) -> Dict[str, torch.Tensor]:
        return {name: t[l] for name, t in self.layers.named_parameters()}

    # ----------------------------------------------------------- time mix

    def _ddlerp(self, x, xx, p):
        """Data-dependent lerp producing the 5 mixed inputs (r,k,v,w,g)."""
        B, T, D = x.shape
        base = x + xx * p["mu_x"]
        lora = torch.tanh(base @ p["tm_w1"]).reshape(B, T, 5, TM_LORA)
        delta = torch.einsum("btfl,fld->btfd", lora, p["tm_w2"])
        mixed = x[:, :, None] + xx[:, :, None] * (p["mu_rkvwg"] + delta)
        return [mixed[:, :, i] for i in range(5)]

    def _time_mix(self, x, p, state, prev, impl: str = "kernel"):
        """``impl="kernel"``: the recurrence through K3 (its plain version
        on the CPU); ``impl="xla"``: :func:`wkv6_scan`, the training
        route."""
        B, T, D = x.shape
        H, hd = self.H, self.hd
        xx = _token_shift(x, prev) - x
        xr, xk, xv, xw, xg = self._ddlerp(x, xx, p)
        r = (xr @ p["wr"]).reshape(B, T, H, hd)
        k = (xk @ p["wk"]).reshape(B, T, H, hd)
        v = (xv @ p["wv"]).reshape(B, T, H, hd)
        g = F.silu(xg @ p["wg"])
        dec = p["w0"] + torch.tanh(xw @ p["dw1"]) @ p["dw2"]
        w = torch.exp(-torch.exp(dec.float())).reshape(B, T, H, hd)
        recurrence = wkv6_scan if impl == "xla" else wkv6
        state, y = recurrence(r, k, v, w, p["u"], state)
        y = _group_norm(y.reshape(B, T, D), p["lnx_scale"], p["lnx_bias"], H)
        return (y * g) @ p["wo"], state, x[:, -1]

    def _channel_mix(self, x, p, prev):
        xx = _token_shift(x, prev) - x
        xk = x + xx * p["cmu_k"]
        xr = x + xx * p["cmu_r"]
        h = torch.square(torch.relu(xk @ p["wck"]))
        return torch.sigmoid(xr @ p["wcr"]) * (h @ p["wcv"]), x[:, -1]

    # ------------------------------------------------------------ forward

    def _layers(self, h):
        """Every layer over the whole prompt from a zero state; yields
        (h, wkv state, normed time-mix input, normed channel-mix input)."""
        cfg = self.cfg
        B = h.shape[0]
        for l in range(cfg.num_layers):
            p = self._layer_params(l)
            a = rms_norm(h, p["ln1"], cfg.norm_eps)
            state0 = torch.zeros((B, self.H, self.hd, self.hd),
                                 dtype=torch.float32, device=h.device)
            a2, state, _ = self._time_mix(a, p, state0, None,
                                          impl=self.impl)
            h = h + a2
            m = rms_norm(h, p["ln2"], cfg.norm_eps)
            m2, _ = self._channel_mix(m, p, None)
            h = h + m2
            yield h, state, a, m

    def _final(self, h):
        h = rms_norm(h, self.final_norm, self.cfg.norm_eps)
        return h @ self.embed.T                      # tied embedding

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T) tokens → (B, T, V) logits (+ the aux loss, 0)."""
        h = take_embedding(self.embed, tokens)
        for h, _, _, _ in self._layers(h):
            pass
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        return self._final(h), aux

    # ------------------------------------------------------------ training

    def _train_layer(self, h, p):
        cfg = self.cfg
        layout = split_layout()
        if layout is not None:
            return self._split_layer(h, p, layout)
        state0 = torch.zeros((h.shape[0], self.H, self.hd, self.hd),
                             dtype=torch.float32, device=h.device)
        a = rms_norm(h, p["ln1"], cfg.norm_eps)
        a, _, _ = self._time_mix(a, p, state0, None, impl="xla")
        h = h + a
        m = rms_norm(h, p["ln2"], cfg.norm_eps)
        m, _ = self._channel_mix(m, p, None)
        return h + m

    def _split_layer(self, h, p, layout):
        """One layer on a mesh that splits its work over ``model``: ``h`` is
        this rank's chunk of the (padded) sequence of its rows, and so is
        the output (:meth:`_split_time_mix`, :meth:`_split_channel_mix`)."""
        h, _ = self._split_time_mix(h, p, layout, impl="xla")
        h, _ = self._split_channel_mix(h, p, layout)
        return h

    def _split_time_mix(self, h, p, layout, *, impl: str,
                        length: Optional[int] = None):
        """``h`` plus the time mix, on a mesh that splits the work over
        ``model``: it runs on the rank's rows of the whole sequence (the
        token shift and the recurrence need it whole) with its weights
        whole, and comes back to the chunk.  ``length``: the recurrence
        runs over the first ``length`` tokens alone (a prompt, not its
        padding), so its final state is the prompt's.  Returns (h, the
        final state of the rank's rows)."""
        cfg = self.cfg
        D, H = cfg.d_model, self.H
        rows = layout.seq_to_rows(h)
        T = rows.shape[1] if length is None else length
        tm = {k: p[k] for k in ("ln1", "mu_x", "mu_rkvwg", "tm_w1", "tm_w2",
                                "w0", "dw1", "dw2", "lnx_scale", "lnx_bias")}
        for k in ("wr", "wk", "wv", "wg"):
            tm[k] = layout.whole(p[k], 1, D)
        tm["wo"] = layout.whole(p["wo"], 0, D)
        tm["u"] = layout.whole(p["u"], 0, H)
        state0 = torch.zeros((rows.shape[0], H, self.hd, self.hd),
                             dtype=torch.float32, device=h.device)
        a = rms_norm(rows[:, :T], tm["ln1"], cfg.norm_eps)
        a, state, _ = self._time_mix(a, tm, state0, None, impl=impl)
        if T < rows.shape[1]:
            a = F.pad(a, (0, 0, 0, rows.shape[1] - T))
        return h + layout.rows_to_seq(a, h.shape[0]), state

    def _split_channel_mix(self, h, p, layout):
        """``h`` plus the channel mix on the gathered sequence with the
        rank's slice of ``d_ff``, its gate on the chunk alone.  Returns
        (h, the normed input ``m`` of the chunk)."""
        cfg = self.cfg
        D, F_ = cfg.d_model, cfg.d_ff
        m = rms_norm(h, p["ln2"], cfg.norm_eps)
        whole = layout.gather_seq(m)
        xx = _token_shift(whole) - whole
        xk = whole + xx * p["cmu_k"]
        xr = m + xx.narrow(1, layout.seq_start, layout.chunk) * p["cmu_r"]
        k = torch.square(torch.relu(xk @ layout.local(p["wck"], 1, F_)))
        kv = layout.scatter_seq(k @ layout.local(p["wcv"], 0, F_))
        return h + torch.sigmoid(xr @ layout.whole(p["wcr"], 1, D)) * kv, m

    def train_forward(self, params: Dict[str, Any], tokens: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``forward(params, tokens)``: (B, T, V) logits
        (+ the aux loss, 0), differentiable in ``params``.  On a mesh that
        splits the work over ``model``, ``tokens`` are this rank's chunk of
        the sequence, and so are the logits."""
        cfg = self.cfg
        embed = whole_table(params["embed"], cfg.vocab_size)
        h = take_embedding(embed, tokens)
        for p in unstack_layers(params["layers"], cfg.num_layers):
            h = remat_call(self._train_layer, h, p)
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
        L, D, H, hd = cfg.num_layers, cfg.d_model, self.H, self.hd
        dev = self.device if device is None else device
        return {
            "wkv": torch.zeros((L, batch_size, H, hd, hd),
                               dtype=torch.float32, device=dev),
            "tm_prev": torch.zeros((L, batch_size, D), dtype=self.dtype,
                                   device=dev),
            "cm_prev": torch.zeros((L, batch_size, D), dtype=self.dtype,
                                   device=dev),
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
        B, T = tokens.shape
        wkv, tm_prev, cm_prev = [], [], []
        h = take_embedding(self.embed, tokens)
        for h, state, a, m in self._layers(h):
            wkv.append(state)
            tm_prev.append(a[:, -1])
            cm_prev.append(m[:, -1])
        logits = self._final(h[:, -1])
        state = {
            "wkv": torch.stack(wkv), "tm_prev": torch.stack(tm_prev),
            "cm_prev": torch.stack(cm_prev),
            "pos": torch.full((B,), T, dtype=torch.int32, device=tokens.device),
        }
        return state, logits

    @torch.no_grad()
    def decode_step(self, state: Dict[str, Any], tokens: torch.Tensor, *,
                    params: Optional[Dict[str, Any]] = None):
        """One token per slot: (new decode state, (B, V) logits).  Under a
        serving mesh's ``ServeLayout``, :meth:`_mesh_decode` on
        ``params``."""
        layout = serve_layout()
        if layout is not None:
            return self._mesh_decode(params, state, tokens, layout)
        cfg = self.cfg
        B = tokens.shape[0]
        D, H, hd = cfg.d_model, self.H, self.hd
        h = take_embedding(self.embed, tokens)
        wkv, tm_prev, cm_prev = [], [], []
        for l in range(cfg.num_layers):
            p = self._layer_params(l)
            a = rms_norm(h, p["ln1"], cfg.norm_eps)
            # single-token time mix (closed form of _time_mix with T=1)
            xx = state["tm_prev"][l].to(a.dtype) - a
            base = a + xx * p["mu_x"]
            lora = torch.tanh(base @ p["tm_w1"]).reshape(B, 5, TM_LORA)
            delta = torch.einsum("bfl,fld->bfd", lora, p["tm_w2"])
            mixed = a[:, None] + xx[:, None] * (p["mu_rkvwg"] + delta)
            xr, xk, xv, xw, xg = [mixed[:, i] for i in range(5)]
            r = (xr @ p["wr"]).reshape(B, H, hd).float()
            k = (xk @ p["wk"]).reshape(B, H, hd).float()
            v = (xv @ p["wv"]).reshape(B, H, hd).float()
            g = F.silu(xg @ p["wg"])
            dec = p["w0"] + torch.tanh(xw @ p["dw1"]) @ p["dw2"]
            w = torch.exp(-torch.exp(dec.float())).reshape(B, H, hd)
            s, y = wkv6_step(state["wkv"][l], r, k, v, w, p["u"])
            y = _group_norm(y.reshape(B, D).to(a.dtype), p["lnx_scale"],
                            p["lnx_bias"], H)
            h = h + (y * g) @ p["wo"]
            # channel mix
            m = rms_norm(h, p["ln2"], cfg.norm_eps)
            xx2 = state["cm_prev"][l].to(m.dtype) - m
            xk2 = m + xx2 * p["cmu_k"]
            xr2 = m + xx2 * p["cmu_r"]
            cm = torch.sigmoid(xr2 @ p["wcr"]) * (
                torch.square(torch.relu(xk2 @ p["wck"])) @ p["wcv"])
            h = h + cm
            wkv.append(s)
            tm_prev.append(a)
            cm_prev.append(m)
        new_state = {
            "wkv": torch.stack(wkv), "tm_prev": torch.stack(tm_prev),
            "cm_prev": torch.stack(cm_prev), "pos": state["pos"] + 1,
        }
        return new_state, self._final(h)

    # ----------------------------------------------- serving on a mesh
    #
    # The reference's serving cell on a production mesh: the weights rest
    # in their shards and each layer's are gathered where it reads them
    # (``parallel.sharding.ServeLayout``), the prefill runs as a training
    # step's forward does, and each rank keeps the value columns ``hd_v``
    # of the ``wkv`` state that ``decode_state_shardings`` gives it.

    def _wkv_window(self, state: torch.Tensor, B: int, layout):
        """The prompt's final ``wkv`` state of the rank's rows (B / model
        of its B lanes, or all B where ``model`` does not divide them) →
        the rank's window of every lane's, (B, H, hd, hd_v window): the
        columns sent to their owners (an all-to-all), or the rows gathered
        where the columns do not split."""
        j0, j1 = layout.window("wkv", 4)
        if not layout.rows_divide(B):
            return state[..., j0:j1]
        if j1 - j0 < self.hd:
            return layout.mesh.all_to_all(state, "model", 3, 0)
        return layout.mesh.all_gather(state, "model", 0)

    def _mesh_prefill(self, params, tokens: torch.Tensor, layout):
        """The prompt on a serving mesh, as the reference's prefill lays it
        out: ``tokens`` (B, S) are this rank's rows, whole; the residual
        stream is its chunk of them (padded at the end to a multiple of
        ``model``); each layer's time mix runs K3 (``impl``) on the rank's
        rows of the first S tokens and its channel mix splits ``d_ff``
        (:meth:`_split_time_mix`, :meth:`_split_channel_mix`).  The state:
        each rank's ``wkv`` window of every lane, and ``tm_prev`` /
        ``cm_prev``, the normed inputs of token S - 1, from the rank whose
        chunk holds it.  Returns (this rank's shards of the decode state,
        the last logits (B, V))."""
        cfg = self.cfg
        B, S = tokens.shape
        tokens = F.pad(tokens, (0, layout.chunk * layout.model_size - S))
        h = mesh_embedding(params["embed"], tokens, layout, cfg)
        wkv, tm_prev, cm_prev = [], [], []
        for p in unstack_layers(params["layers"], cfg.num_layers):
            tm_prev.append(rms_norm(layout.row(h, S - 1), p["ln1"],
                                    cfg.norm_eps))
            h, state = self._split_time_mix(h, p, layout, impl=self.impl,
                                            length=S)
            wkv.append(self._wkv_window(state, B, layout))
            h, m = self._split_channel_mix(h, p, layout)
            cm_prev.append(layout.row(m, S - 1))
        h = rms_norm(layout.row(h, S - 1), params["final_norm"],
                     cfg.norm_eps)
        state = {
            "wkv": torch.stack(wkv), "tm_prev": torch.stack(tm_prev),
            "cm_prev": torch.stack(cm_prev),
            "pos": torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device),
        }
        return state, mesh_scores(h, params["embed"], layout,
                                  cfg.vocab_size)

    def _mesh_decode(self, params, state, tokens: torch.Tensor, layout):
        """A decode step on a serving mesh: the lanes (this rank's rows,
        whole on every ``model`` rank), the state this rank's shards.  The
        rank updates only its value columns ``[j0, j1)`` of each head's
        state (output column j reads state column j alone; r, k, w and u
        are whole).  r, k, v and the channel mix's receptance are each
        rank's product with its stored columns of the weight, all-gathered
        (``ServeLayout.product``: the lanes' rows, not the leaf), and the
        rank keeps v's columns ``[j0, j1)`` of each head (strided across
        heads, so not its stored shard); y is all-gathered over them before
        the per-head group norm; the gate and ``wo`` split ``D`` over
        ``model`` (a sum of partial products), and the channel mix
        ``d_ff``."""
        cfg = self.cfg
        B = tokens.shape[0]
        D, F_, H, hd = cfg.d_model, cfg.d_ff, self.H, self.hd
        j0, j1 = layout.window("wkv", 4)
        lo, hi = layout.part(D)
        h = mesh_embedding(params["embed"], tokens, layout, cfg)
        wkv, tm_prev, cm_prev = [], [], []
        for l, p in enumerate(unstack_layers(params["layers"],
                                             cfg.num_layers)):
            a = rms_norm(h, p["ln1"], cfg.norm_eps)
            xx = state["tm_prev"][l].to(a.dtype) - a
            base = a + xx * p["mu_x"]
            lora = torch.tanh(base @ p["tm_w1"]).reshape(B, 5, TM_LORA)
            delta = torch.einsum("bfl,fld->bfd", lora, p["tm_w2"])
            mixed = a[:, None] + xx[:, None] * (p["mu_rkvwg"] + delta)
            xr, xk, xv, xw, xg = [mixed[:, i] for i in range(5)]
            r = layout.product(xr, p["wr"], D).reshape(B, H, hd).float()
            k = layout.product(xk, p["wk"], D).reshape(B, H, hd).float()
            v = layout.product(xv, p["wv"], D).reshape(B, H, hd)[..., j0:j1]
            dec = p["w0"] + torch.tanh(xw @ p["dw1"]) @ p["dw2"]
            w = torch.exp(-torch.exp(dec.float())).reshape(B, H, hd)
            s, y = wkv6_step(state["wkv"][l], r, k, v.float(), w,
                             layout.whole(p["u"], 0, H))
            if j1 - j0 < hd:
                y = layout.mesh.all_gather(y, "model", 2)
            y = _group_norm(y.reshape(B, D).to(a.dtype), p["lnx_scale"],
                            p["lnx_bias"], H)
            g = F.silu(xg @ layout.local(p["wg"], 1, D))
            h = h + layout.sum_parts((y[:, lo:hi] * g)
                                     @ layout.local(p["wo"], 0, D))
            m = rms_norm(h, p["ln2"], cfg.norm_eps)
            xx2 = state["cm_prev"][l].to(m.dtype) - m
            xk2 = m + xx2 * p["cmu_k"]
            xr2 = m + xx2 * p["cmu_r"]
            kk = torch.square(torch.relu(xk2 @ layout.local(p["wck"], 1, F_)))
            h = h + torch.sigmoid(layout.product(xr2, p["wcr"], D)) * \
                layout.sum_parts(kk @ layout.local(p["wcv"], 0, F_))
            wkv.append(s)
            tm_prev.append(a)
            cm_prev.append(m)
        new_state = {
            "wkv": torch.stack(wkv), "tm_prev": torch.stack(tm_prev),
            "cm_prev": torch.stack(cm_prev), "pos": state["pos"] + 1,
        }
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        return new_state, mesh_scores(h, params["embed"], layout,
                                      cfg.vocab_size)
