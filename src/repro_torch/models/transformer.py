"""Decoder-only transformer, dense, MoE and VLM families, as a PyTorch
``nn.Module``.

The counterpart of ``repro/models/transformer.py`` for the dense family
(gemma2/3, starcoder2, qwen2.5), the MoE family (qwen3-moe,
llama4-scout) and the VLM family (llava-next-34b, a dense backbone):
the same stacked-parameter layout (layer ``l``'s ``wq`` is
``layers.attn.wq[l]`` of shape ``(D, H, hd)``; an MoE layer holds
``layers.moe.*`` in place of ``layers.mlp.*``), the same public functions,
and a Python loop over layers where the reference scanned.  Weights live
on the module; the serving functions take no ``params`` argument.

An MoE layer routes with the capacity counted over the rows the call sees
(the B·S rows of ``forward``, ``prefill``, ``prefill_chunk`` and
``paged_prefill_at``: a padded batch, one chunk, one suffix), as the
reference counts it, and losslessly over the B lanes of a decode step.

The modality prefix (VLM early fusion, a frontend stub as in the
reference): ``forward`` and the dense ``prefill`` take ``patch_embeds``
(B, P, D), which replace the first P token embeddings; the paged
functions and ``decode_step`` take none, as the reference's take none, so
the engine serves such a model on text.

Paged serving interface (``ServingEngine`` in paged mode):
  ``supports_paged_decode``                       → bool
  ``init_paged_state(num_pages, page_size)``      → pool dict
  ``paged_prefill(tokens)``                       → (kv_rows, last_logits)
  ``paged_write_prefill(pool, rows, page_ids, offsets)`` → pool
  ``paged_decode_step(pool, tokens, page_table, pos)``   → (pool, logits)
  ``paged_prefill_at(tokens, pool, page_table, start)``  → (kv_rows, logits)
  ``paged_copy_page(pool, src, dst)``             → pool   (COW clone)
Pools are ``(L, P, page, K, hd)`` and page tables int32 padded with -1, as
in the reference.  Where the reference donated the pool to a jitted
function and got a new one back, the port updates the pool in place and
returns the same dict.

Tensor-parallel serving (``ServingEngine(mesh=...)``), as the reference's
hooks: ``tp_supported(n)``, ``tp_param_specs()`` (a spec per parameter
name), ``tp_pool_specs(pool)`` and ``tp_local(n)``, the class and config
of one rank's module (H/n q and K/n kv heads).  Each rank of the mesh runs
that module over its heads, K1 and K2 at the local head counts, and the
wo products are summed over the ranks (``maybe_psum``, the identity on
one device) before the residual.

Dense serving interface (``ServingEngine`` in dense mode, which gemma2/3
need: the paged kernel has no window or softcap):
  ``init_decode_state(batch, max_seq)``      → state dict
  ``prefill(tokens, max_seq=)``              → (state, last_logits)
  ``decode_step(state, tokens)``             → (state, logits)
  ``prefill_chunk(tokens, state, start)``    → (state, last_logits)
States hold ``cache_k``/``cache_v`` of ``(L, B, max_seq, K, hd)`` and
``pos`` (B,) int32.  ``decode_step`` and ``prefill_chunk`` write the cache
rows in place and return the same cache tensors.  On a serving mesh
(``launch.steps.make_prefill_fn`` / ``make_decode_fn`` with
``shardings=``, which bind a ``parallel.sharding.ServeLayout``),
``prefill`` and ``decode_step`` take ``params=``, this rank's shards, and
the state is this rank's shards of it: the reference's serving layout
(``_mesh_prefill``, ``_mesh_decode``).  ``prefill_chunk`` and the paged
functions have no mesh layout.

``impl="xla"`` (``build_model(cfg, impl="xla")``, the reference's dry-run
build) serves through the plain routes on any device: ``blockwise_attn``
for prompts, the plain paged attention for paged decode steps.

Training interface (``Trainer``): ``loss(params, batch)`` → (scalar,
metrics), where ``params`` is the reference's nested dict of tensors
(:func:`~repro_torch.models.common.param_tree` gives the module's own).
It runs grad-enabled through the reference's training route
(``impl="xla"``: :func:`~repro_torch.models.attention.blockwise_attn`,
never the flash kernel, which has no backward), each layer under the
reference's remat policy (``remat=``, :func:`~repro_torch.models.common.
remat_call`): ``"full"`` (the default) checkpoints the layer, ``"dots"``
keeps its products with no batch dimension and recomputes the rest,
``"none"`` checkpoints nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels.paged_attention.ops import paged_attention
from ..kernels.paged_attention.ref import paged_attention_ref
from ..parallel.collectives import maybe_psum
from ..parallel.sharding import P
from .attention import (
    NEG_INF,
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
    layer_rope_bases,
    layer_windows,
    mesh_embedding,
    mesh_scores,
    resolve_device,
    remat_call,
    rms_norm,
    scale_embedding,
    serve_layout,
    softcap,
    split_layout,
    split_mlp,
    take_embedding,
    torch_dtype,
    unstack_layers,
    whole_table,
)
from .moe import FP32_PARAMS as MOE_FP32_PARAMS
from .moe import moe_block, moe_params_shape

__all__ = ["TransformerLM"]


class TransformerLM(nn.Module):
    """Decoder-only LM (dense or MoE); parameters are allocated, not
    initialised — call :meth:`init` or ``load_state_dict``."""

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 impl: str = "kernel", remat: str = "full") -> None:
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(
                f"TransformerLM needs family 'dense', 'moe' or 'vlm', got "
                f"{cfg.family!r}")
        self.cfg = cfg
        self.impl = impl
        self.remat = check_remat(remat)
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        self.windows = layer_windows(cfg)
        self.rope_bases = layer_rope_bases(cfg)
        L, D, F, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
        dt, dev = self.dtype, self.device
        self.embed = frozen((V, D), dt, dev)
        if not cfg.tie_embeddings:
            self.unembed = frozen((V, D), dt, dev)
        self.final_norm = frozen((D,), dt, dev)
        self.layers = nn.Module()
        norms = ["ln1", "ln2"] + (["ln1_post", "ln2_post"]
                                  if cfg.post_norms else [])
        for name in norms:
            setattr(self.layers, name, frozen((L, D), dt, dev))
        self.layers.attn = nn.Module()
        for name, shape in attn_params_shape(cfg).items():
            setattr(self.layers.attn, name, frozen((L, *shape), dt, dev))
        if cfg.is_moe:
            self.layers.moe = nn.Module()
            for name, shape in moe_params_shape(cfg).items():
                leaf_dt = (torch.float32 if f"layers.moe.{name}" in
                           MOE_FP32_PARAMS else dt)
                setattr(self.layers.moe, name,
                        frozen((L, *shape), leaf_dt, dev))
        else:
            self.layers.mlp = nn.Module()
            self.layers.mlp.wu = frozen((L, D, F), dt, dev)
            self.layers.mlp.wd = frozen((L, F, D), dt, dev)
            if cfg.gated:
                self.layers.mlp.wg = frozen((L, D, F), dt, dev)

    # ------------------------------------------------------------- params

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "TransformerLM":
        """Random weights with the reference's distributions, drawn from
        ``generator`` (which must live on the model's device).  Experts
        are drawn one at a time, so the fp32 draw of a full-width MoE
        layer never lies on the device whole."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        D, F = cfg.d_model, cfg.d_ff

        def normal(shape, std, dtype=dt):
            x = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32)
            return (x * std).to(dtype)

        self.embed.copy_(normal(self.embed.shape, 1 / math.sqrt(D)))
        for name, t in self.layers.named_parameters():
            if name.startswith("ln"):
                t.fill_(1)
        for l in range(cfg.num_layers):
            for name, shape in attn_params_shape(cfg).items():
                t = getattr(self.layers.attn, name)[l]
                if name.startswith("b"):
                    t.zero_()
                elif name.endswith("_norm"):
                    t.fill_(1)
                else:
                    t.copy_(normal(shape, 1 / math.sqrt(D)))
            if cfg.is_moe:
                # the reference's N(0, 1) / sqrt(fan_in), fan_in = shape[-2]
                for t in self.layers.moe.parameters():
                    t = t[l]
                    if t.dim() == 3:                  # (E, ·, ·): by expert
                        for e in range(t.shape[0]):
                            t[e].copy_(normal(t.shape[1:],
                                              t.shape[-2] ** -0.5))
                    else:
                        t.copy_(normal(t.shape, t.shape[-2] ** -0.5,
                                       t.dtype))
                continue
            mlp = self.layers.mlp
            mlp.wu[l].copy_(normal((D, F), 1 / math.sqrt(D)))
            mlp.wd[l].copy_(normal((F, D), 1 / math.sqrt(F)))
            if cfg.gated:
                mlp.wg[l].copy_(normal((D, F), 1 / math.sqrt(D)))
        self.final_norm.fill_(1)
        if not cfg.tie_embeddings:
            self.unembed.copy_(normal(self.unembed.shape, 1 / math.sqrt(D)))
        return self

    def _layer_params(self, l: int) -> Dict[str, Any]:
        p: Dict[str, Any] = {
            name: t[l] for name, t in self.layers.named_parameters()
            if "." not in name
        }
        p["attn"] = {n: t[l] for n, t in self.layers.attn.named_parameters()}
        ffn = "moe" if self.cfg.is_moe else "mlp"
        p[ffn] = {n: t[l] for n, t in
                  getattr(self.layers, ffn).named_parameters()}
        return p

    def _rope_base(self, l: int) -> float:
        return float(self.rope_bases[l])

    # ------------------------------------------------------------ forward

    def _embed_inputs(self, tokens: torch.Tensor,
                      patch_embeds: Optional[torch.Tensor] = None,
                      table: Optional[torch.Tensor] = None,
                      start: int = 0) -> torch.Tensor:
        """Token embeddings (gemma's scaling applied) from ``table`` (the
        module's own by default); with ``patch_embeds`` (B, P, D) and a
        config that has patches, rows ``[0, P)`` of the sequence are the
        patch embeddings in the model's dtype.  ``tokens`` are the
        sequence's columns from ``start`` on (a rank's chunk)."""
        table = self.embed if table is None else table
        h = scale_embedding(take_embedding(table, tokens), self.cfg)
        return self._with_patches(h, patch_embeds, start)

    def _with_patches(self, h: torch.Tensor,
                      patch_embeds: Optional[torch.Tensor],
                      start: int) -> torch.Tensor:
        if patch_embeds is not None and self.cfg.num_patches:
            n = max(0, min(patch_embeds.shape[1] - start, h.shape[1]))
            h = torch.cat([patch_embeds[:, start:start + n].to(
                device=h.device, dtype=h.dtype), h[:, n:]], dim=1)
        return h

    def _mlp_residual(self, h: torch.Tensor, p: Dict[str, Any], *,
                      lossless: bool = False, layout=None):
        """h + the layer's MLP (or MoE block) → (h, the MoE aux loss or
        None).  ``lossless``: a decode step's routing, no copy dropped.
        ``layout``: a training mesh's that splits the work over
        ``model`` (``h`` is this rank's chunk of the sequence)."""
        cfg = self.cfg
        m = rms_norm(h, p["ln2"], cfg.norm_eps, plus_one=cfg.post_norms)
        aux = None
        if cfg.is_moe:
            m, aux = moe_block(m, p["moe"], cfg, lossless=lossless)
        elif layout is not None:
            mlp = p["mlp"]
            m = split_mlp(m, mlp["wu"], mlp.get("wg"), mlp["wd"],
                          cfg.activation, layout, cfg.d_ff)
        else:
            m = gated_mlp(m, p["mlp"]["wu"], p["mlp"].get("wg"),
                          p["mlp"]["wd"], cfg.activation)
        if cfg.post_norms:
            m = rms_norm(m, p["ln2_post"], cfg.norm_eps, plus_one=True)
        return h + m, aux

    def _attn_residual(self, h: torch.Tensor, a: torch.Tensor,
                       p: Dict[str, Any]) -> torch.Tensor:
        # ``a`` is the attention's product with wo: under serving TP, wo is
        # row-sharded and the ranks' partial products are summed here,
        # before any post-norm sees them (the identity on one device)
        a = maybe_psum(a)
        if self.cfg.post_norms:
            a = rms_norm(a, p["ln1_post"], self.cfg.norm_eps, plus_one=True)
        return h + a

    def _layers(self, h: torch.Tensor, positions: torch.Tensor):
        """Every layer over the full prompt; yields K/V rows per layer."""
        cfg = self.cfg
        for l in range(cfg.num_layers):
            p = self._layer_params(l)
            a = rms_norm(h, p["ln1"], cfg.norm_eps, plus_one=cfg.post_norms)
            a, kv = attention_block(
                a, p["attn"], cfg, window=int(self.windows[l]),
                rope_base=self._rope_base(l), positions=positions,
                return_kv=True, impl=self.impl,
            )
            h, aux = self._mlp_residual(self._attn_residual(h, a, p), p)
            yield h, kv, aux

    def _unembed(self, h: torch.Tensor,
                 table: Optional[torch.Tensor] = None) -> torch.Tensor:
        if table is None:
            table = self.unembed if not self.cfg.tie_embeddings else self.embed
        logits = h @ table.T
        if self.cfg.final_logit_softcap:
            logits = softcap(logits, self.cfg.final_logit_softcap)
        return logits

    def _final(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = rms_norm(h, self.final_norm, cfg.norm_eps, plus_one=cfg.post_norms)
        return self._unembed(h)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *,
                patch_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S) tokens → (B, S, V) logits (+ the aux loss summed over
        layers, 0 for dense)."""
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        h = self._embed_inputs(tokens, patch_embeds)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for h, _, layer_aux in self._layers(h, positions):
            if layer_aux is not None:
                aux = aux + layer_aux
        return self._final(h), aux

    # ------------------------------------------------------------ training

    def _train_layer(self, h: torch.Tensor, p: Dict[str, Any], l: int,
                     positions: torch.Tensor):
        cfg = self.cfg
        layout = split_layout()
        a = rms_norm(h, p["ln1"], cfg.norm_eps, plus_one=cfg.post_norms)
        if layout is not None:
            a = split_attention(a, p["attn"], cfg, window=int(self.windows[l]),
                                rope_base=self._rope_base(l), layout=layout)
        else:
            a = attention_block(
                a, p["attn"], cfg, window=int(self.windows[l]),
                rope_base=self._rope_base(l), positions=positions,
                impl="xla")
        h, aux = self._mlp_residual(self._attn_residual(h, a, p), p,
                                    layout=layout)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return h, aux

    def train_forward(self, params: Dict[str, Any], tokens: torch.Tensor, *,
                      patch_embeds: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``forward(params, tokens)`` on the training
        route: (B, S, V) logits and the aux loss summed over layers,
        differentiable in ``params``.  On a mesh that splits the work
        over ``model``, ``tokens`` are this rank's chunk of the sequence,
        and so are the logits."""
        cfg = self.cfg
        layout = split_layout()
        start = layout.seq_start if layout is not None else 0
        positions = torch.arange(start, start + tokens.shape[1],
                                 device=tokens.device)
        # gathered once (on a mesh, a read gathers it): a tied table's two
        # uses add their gradients before its one reduction
        embed = whole_table(params["embed"], cfg.vocab_size)
        h = self._embed_inputs(tokens, patch_embeds, table=embed,
                               start=start)
        auxes = []
        for l, p in enumerate(unstack_layers(params["layers"],
                                             cfg.num_layers)):
            h, aux = remat_call(self._train_layer, h, p, l, positions,
                                policy=self.remat)
            auxes.append(aux)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps,
                     plus_one=cfg.post_norms)
        table = (whole_table(params["unembed"], cfg.vocab_size)
                 if "unembed" in params else embed)
        return self._unembed(h, table), torch.stack(auxes).sum()

    def loss(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        """(ce + ``router_aux_coef`` · aux, {"ce", "aux", "tokens"}), as the
        reference's ``loss``; ``batch`` holds ``tokens``, ``targets``, and
        optionally ``loss_mask`` and ``patch_embeds``."""
        logits, aux = self.train_forward(
            params, batch["tokens"], patch_embeds=batch.get("patch_embeds"))
        ce, denom = cross_entropy(logits, batch)
        total = ce + self.cfg.router_aux_coef * aux
        return total, {"ce": ce, "aux": aux, "tokens": denom}

    # ------------------------------------------------------------ serving

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, max_seq: Optional[int] = None,
                patch_embeds: Optional[torch.Tensor] = None,
                params: Optional[Dict[str, Any]] = None):
        """Run the prompt, return (decode_state, logits at last position).
        Under a serving mesh's ``ServeLayout``, :meth:`_mesh_prefill` on
        ``params`` (this rank's shards)."""
        layout = serve_layout()
        if layout is not None:
            return self._mesh_prefill(params, tokens, patch_embeds, layout)
        B, S = tokens.shape
        max_seq = max_seq or S
        positions = torch.arange(S, device=tokens.device)
        h = self._embed_inputs(tokens, patch_embeds)
        ks, vs = [], []
        for h, (k, v), _ in self._layers(h, positions):
            if max_seq > S:
                pad = (0, 0, 0, 0, 0, max_seq - S)
                k = torch.nn.functional.pad(k, pad)
                v = torch.nn.functional.pad(v, pad)
            ks.append(k)
            vs.append(v)
        logits = self._final(h[:, -1])
        state = {
            "cache_k": torch.stack(ks),
            "cache_v": torch.stack(vs),
            "pos": torch.full((B,), S, dtype=torch.int32, device=tokens.device),
        }
        return state, logits

    # ----------------------------------------------- serving (dense cache)

    def init_decode_state(self, batch_size: int, max_seq: int, dtype=None,
                          device=None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        dtype = dtype or self.dtype
        dev = self.device if device is None else device
        shape = (cfg.num_layers, batch_size, max_seq, cfg.num_kv_heads, cfg.hd)
        return {
            "cache_k": torch.zeros(shape, dtype=dtype, device=dev),
            "cache_v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
        }

    @torch.no_grad()
    def prefill_chunk(self, tokens, state, start):
        """Chunked dense prefill: consume ``tokens`` (1, S) at positions
        ``[start, start + S)`` of a batch-of-one decode state, attending
        through the cache rows earlier chunks wrote.

        Row ``start + i`` attends the cached rows ``< start`` plus chunk
        rows ``<= i`` (plain PyTorch in fp32, as the reference's einsums),
        so chunks compose to the monolithic prefill.  The chunk's K/V rows
        are written in place at ``start``, clamped to ``[0, max_seq - S]``
        as ``dynamic_update_slice`` clamps; ``pos`` becomes ``start + S``.
        Returns the state and the logits at the chunk's last position.
        """
        cfg = self.cfg
        if cfg.attn_logit_softcap or any(w != 0 for w in self.windows):
            raise NotImplementedError(
                "chunked dense prefill supports neither attention logit "
                "softcap nor sliding windows"
            )
        B, S = tokens.shape
        max_seq = state["cache_k"].shape[2]
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
        G = H // K
        scale = cfg.query_scale or (1.0 / math.sqrt(hd))
        start = int(start)
        at = min(max(start, 0), max_seq - S)
        dev = tokens.device
        positions = start + torch.arange(S, device=dev)
        h = self._embed_inputs(tokens)
        prefix_live = (torch.arange(max_seq, device=dev)
                       < start)[None, None, None, None, :]
        causal = (torch.arange(S, device=dev)[None, :]
                  <= torch.arange(S, device=dev)[:, None])[None, :, None, None, :]
        for l in range(cfg.num_layers):
            p = self._layer_params(l)
            ck, cv = state["cache_k"][l], state["cache_v"][l]
            a = rms_norm(h, p["ln1"], cfg.norm_eps, plus_one=cfg.post_norms)
            q, k, v = qkv(a, p["attn"], cfg, positions, self._rope_base(l))
            qf = q.reshape(B, S, K, G, hd).float() * scale
            s_pre = torch.einsum("bskgh,bpkh->bskgp", qf, ck.float())
            s_pre = torch.where(prefix_live, s_pre, NEG_INF)
            s_suf = torch.einsum("bskgh,btkh->bskgt", qf, k.float())
            s_suf = torch.where(causal, s_suf, NEG_INF)
            w = torch.softmax(torch.cat([s_pre, s_suf], dim=-1), dim=-1)
            o = torch.einsum("bskgp,bpkh->bskgh", w[..., :max_seq], cv.float()) \
                + torch.einsum("bskgt,btkh->bskgh", w[..., max_seq:], v.float())
            o = o.reshape(B, S, H * hd).to(h.dtype) @ p["attn"]["wo"]
            h, _ = self._mlp_residual(self._attn_residual(h, o, p), p)
            # this layer's rows < start are all it read: write the chunk now
            ck[:, at:at + S] = k.to(ck.dtype)
            cv[:, at:at + S] = v.to(cv.dtype)
        logits = self._final(h[:, -1])
        state["pos"] = torch.full_like(state["pos"], start + S)
        return state, logits

    @torch.no_grad()
    def decode_step(self, state, tokens, *,
                    params: Optional[Dict[str, Any]] = None):
        """One token per sequence against the dense cache: ``tokens`` (B,)
        → (state, logits (B, V)).  Lane b writes its K/V at ``pos[b]`` (a
        lane past ``max_seq`` writes nothing, as in the reference) and
        attends rows ``<= pos[b]`` within its layer's window; ``pos``
        advances by one on every lane.  Under a serving mesh's
        ``ServeLayout``, :meth:`_mesh_decode` on ``params``."""
        layout = serve_layout()
        if layout is not None:
            return self._mesh_decode(params, state, tokens, layout)
        cfg = self.cfg
        pos = state["pos"]
        h = self._embed_inputs(tokens)
        for l in range(cfg.num_layers):
            p = self._layer_params(l)
            a = rms_norm(h, p["ln1"], cfg.norm_eps, plus_one=cfg.post_norms)
            q, k, v = qkv(a, p["attn"], cfg, pos, self._rope_base(l))
            ck, cv = state["cache_k"][l], state["cache_v"][l]
            update_cache(ck, cv, k, v, pos)
            o = decode_attn(q, ck, cv, pos, cfg, window=int(self.windows[l]))
            o = o.to(h.dtype) @ p["attn"]["wo"]
            h, _ = self._mlp_residual(self._attn_residual(h, o, p), p,
                                      lossless=True)
        new_state = {"cache_k": state["cache_k"], "cache_v": state["cache_v"],
                     "pos": pos + 1}
        return new_state, self._final(h)

    # ----------------------------------------------- serving on a mesh
    #
    # The reference's serving cell on a production mesh: the weights rest
    # in their shards and each layer's are gathered where it reads them
    # (``parallel.sharding.ServeLayout``), the prefill runs sequence-
    # parallel as a training step does, and the decode cache is this
    # rank's window, split by sequence or by kv heads.

    def _mesh_embed(self, table: torch.Tensor, tokens: torch.Tensor,
                    layout, patch_embeds=None) -> torch.Tensor:
        """Embeddings on a serving mesh (``mesh_embedding``), scaled, with
        the patch prefix where the model has one."""
        start = 0 if layout.decoding else layout.seq_start
        h = mesh_embedding(table, tokens, layout, self.cfg)
        return self._with_patches(scale_embedding(h, self.cfg), patch_embeds,
                                  start)

    def _mesh_logits(self, params, h: torch.Tensor, layout) -> torch.Tensor:
        """(B, D) → (B, V) on every rank (``mesh_scores``)."""
        cfg = self.cfg
        h = rms_norm(h, params["final_norm"], cfg.norm_eps,
                     plus_one=cfg.post_norms)
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        logits = mesh_scores(h, table, layout, cfg.vocab_size)
        if cfg.final_logit_softcap:
            logits = softcap(logits, cfg.final_logit_softcap)
        return logits

    def _mesh_prefill(self, params, tokens: torch.Tensor,
                      patch_embeds: Optional[torch.Tensor], layout):
        """The prompt on a serving mesh, as the reference's prefill lays it
        out (``constrain(h, "data", "model", None)`` after every layer):
        ``tokens`` (B, S) are this rank's rows, whole; the layers run
        sequence-parallel on its chunk of them (padded at the end to a
        multiple of ``model``), as ``_train_layer`` does with no gradient;
        each layer's K/V rows of the rank's cache window are kept
        (``split_attention``).  The last-token logits come from the rank
        whose chunk holds token S - 1, on every rank.  Returns (this
        rank's shards of the decode state, the logits (B, V))."""
        cfg = self.cfg
        B, S = tokens.shape
        tokens = torch.nn.functional.pad(
            tokens, (0, layout.chunk * layout.model_size - S))
        h = self._mesh_embed(params["embed"], tokens, layout, patch_embeds)
        ks, vs = [], []
        for l, p in enumerate(unstack_layers(params["layers"],
                                             cfg.num_layers)):
            a = rms_norm(h, p["ln1"], cfg.norm_eps, plus_one=cfg.post_norms)
            a, (k, v) = split_attention(
                a, p["attn"], cfg, window=int(self.windows[l]),
                rope_base=self._rope_base(l), layout=layout, impl=self.impl)
            h, _ = self._mlp_residual(self._attn_residual(h, a, p), p,
                                      layout=layout)
            ks.append(k)
            vs.append(v)
        logits = self._mesh_logits(params, layout.row(h, S - 1), layout)
        state = {
            "cache_k": torch.stack(ks),
            "cache_v": torch.stack(vs),
            "pos": torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device),
        }
        return state, logits

    def _mesh_decode(self, params, state, tokens: torch.Tensor, layout):
        """A decode step on a serving mesh, as the reference's
        ``decode_step`` lays it out: the lanes (this rank's rows, whole on
        every ``model`` rank), the state this rank's shards, the cache
        window written in place (``split_decode``), the MLP split by
        ``d_ff`` and the experts by ``model``, lossless."""
        cfg = self.cfg
        pos = state["pos"]
        h = self._mesh_embed(params["embed"], tokens, layout)
        for l, p in enumerate(unstack_layers(params["layers"],
                                             cfg.num_layers)):
            a = rms_norm(h, p["ln1"], cfg.norm_eps, plus_one=cfg.post_norms)
            o = split_decode(a, p["attn"], cfg, state["cache_k"][l],
                             state["cache_v"][l], pos,
                             window=int(self.windows[l]),
                             rope_base=self._rope_base(l), layout=layout)
            h, _ = self._mlp_residual(self._attn_residual(h, o, p), p,
                                      lossless=True, layout=layout)
        new_state = {"cache_k": state["cache_k"], "cache_v": state["cache_v"],
                     "pos": pos + 1}
        return new_state, self._mesh_logits(params, h, layout)

    # ----------------------------------------------- serving (paged cache)

    @property
    def supports_paged_decode(self) -> bool:
        # the paged kernel has no logit-softcap or sliding-window support
        return (not self.cfg.attn_logit_softcap) and all(
            w == 0 for w in self.windows
        )

    def init_paged_state(self, num_pages: int, page_size: int,
                         dtype=None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, cfg.hd)
        dtype = dtype or self.dtype
        return {
            "k_pages": torch.zeros(shape, dtype=dtype, device=self.device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=self.device),
        }

    def paged_prefill(self, tokens: torch.Tensor):
        """Prompt K/V rows (for page scatter) + logits at the last token."""
        state, logits = self.prefill(tokens, max_seq=tokens.shape[1])
        return {"k": state["cache_k"], "v": state["cache_v"]}, logits

    @torch.no_grad()
    def paged_write_prefill(self, pool, rows, page_ids, offsets):
        """Scatter one sequence's prefill rows into its allocated pages.

        Token i lands at ``(page_ids[i], offsets[i])`` of every layer, in
        place (the reference donated the pool instead).
        """
        page_ids = torch.as_tensor(page_ids, device=self.device).long()
        offsets = torch.as_tensor(offsets, device=self.device).long()
        for name, src in (("k_pages", rows["k"]), ("v_pages", rows["v"])):
            dst = pool[name]
            dst[:, page_ids, offsets] = src[:, 0].to(dst.dtype)
        return pool

    @torch.no_grad()
    def paged_prefill_at(self, tokens, pool, page_table, start: int):
        """Suffix prefill: K/V rows + last logits for tokens at positions
        ``[start, start + S)``, attending through the shared-prefix rows
        already resident in the page pool.

        ``tokens``: (1, S); ``page_table``: (1, W) int32, -1 padded; rows
        ``< start`` of those pages hold the donor-written prefix K/V.  The
        attention here is plain PyTorch, as it was plain einsum in the
        reference: no TPU kernel computes it.
        """
        cfg = self.cfg
        B, S = tokens.shape
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
        G = H // K
        page_size = pool["k_pages"].shape[2]
        page_table = torch.as_tensor(page_table, device=self.device)
        W = page_table.shape[1]
        P = W * page_size
        start = int(start)
        scale = cfg.query_scale or (1.0 / math.sqrt(hd))
        dev = tokens.device
        positions = start + torch.arange(S, device=dev)
        h = self._embed_inputs(tokens)
        pages = torch.where(page_table[0] >= 0, page_table[0], 0).long()
        prefix_live = (torch.arange(P, device=dev) < start)[None, None, None, None, :]
        causal = (torch.arange(S, device=dev)[None, :]
                  <= torch.arange(S, device=dev)[:, None])[None, :, None, None, :]
        ks, vs = [], []
        for l in range(cfg.num_layers):
            p = self._layer_params(l)
            a = rms_norm(h, p["ln1"], cfg.norm_eps, plus_one=cfg.post_norms)
            q, k, v = qkv(a, p["attn"], cfg, positions, self._rope_base(l))
            pk = pool["k_pages"][l][pages].reshape(P, K, hd)
            pv = pool["v_pages"][l][pages].reshape(P, K, hd)
            qf = q.reshape(B, S, K, G, hd).float() * scale
            s_pre = torch.einsum("bskgh,pkh->bskgp", qf, pk.float())
            s_pre = torch.where(prefix_live, s_pre, NEG_INF)
            s_suf = torch.einsum("bskgh,btkh->bskgt", qf, k.float())
            s_suf = torch.where(causal, s_suf, NEG_INF)
            w = torch.softmax(torch.cat([s_pre, s_suf], dim=-1), dim=-1)
            o = torch.einsum("bskgp,pkh->bskgh", w[..., :P], pv.float()) \
                + torch.einsum("bskgt,btkh->bskgh", w[..., P:], v.float())
            o = o.reshape(B, S, H * hd).to(h.dtype) @ p["attn"]["wo"]
            h, _ = self._mlp_residual(self._attn_residual(h, o, p), p)
            ks.append(k)
            vs.append(v)
        logits = self._final(h[:, -1])
        return {"k": torch.stack(ks), "v": torch.stack(vs)}, logits

    @torch.no_grad()
    def paged_copy_page(self, pool, src: int, dst: int):
        """Clone page ``src`` into ``dst`` across all layers (COW), in place."""
        for name in ("k_pages", "v_pages"):
            pool[name][:, int(dst)] = pool[name][:, int(src)]
        return pool

    @torch.no_grad()
    def paged_decode_step(self, pool, tokens, page_table, pos):
        """One decode step against the arena-backed page pool.

        ``page_table``: (B, W) int32, row i = slot i's physical pages, -1
        padded (empty slots are all--1 rows).  ``pos``: (B,) int32 — the
        row this step's K/V is written to; attention covers ``pos + 1``
        tokens.  Dead and out-of-range lanes change nothing: the reference
        sent them to page id ``num_pages`` and XLA dropped the
        out-of-bounds scatter, while an out-of-bounds index asserts on
        CUDA.  Here they repeat the first live lane's write (with no live
        lane, they rewrite page 0's first row with itself): every index
        then receives one value, and the lane count stays fixed, so the
        step needs no host sync before its layers launch.
        """
        cfg = self.cfg
        B = tokens.shape[0]
        page_size = pool["k_pages"].shape[2]
        W = page_table.shape[1]
        scale = cfg.query_scale or (1.0 / math.sqrt(cfg.hd))
        h = self._embed_inputs(tokens)
        b_idx = torch.arange(B, device=tokens.device)
        pos = pos.to(torch.int32)
        logical = (pos // page_size).long()
        write_page = page_table[b_idx, logical.clamp(max=W - 1)].long()
        offset = (pos % page_size).long()
        valid = (write_page >= 0) & (logical < W)
        first = torch.argmax(valid.to(torch.int32)).view(1)
        any_live = valid.any()
        write_page = torch.where(
            valid, write_page, torch.where(any_live, write_page[first], 0))
        offset = torch.where(
            valid, offset, torch.where(any_live, offset[first], 0))

        def lane_rows(x, pages):
            x = x.to(pages.dtype)
            fill = torch.where(any_live, x[first], pages[0, 0])
            return torch.where(valid[:, None, None], x, fill)

        lens = pos + 1
        # impl="xla": the plain version on any device, as ``_layers``
        attend = paged_attention_ref if self.impl == "xla" \
            else paged_attention
        for l in range(cfg.num_layers):
            p = self._layer_params(l)
            a = rms_norm(h, p["ln1"], cfg.norm_eps, plus_one=cfg.post_norms)
            q, k, v = qkv(a, p["attn"], cfg, pos, self._rope_base(l))
            kp, vp = pool["k_pages"][l], pool["v_pages"][l]
            # in place, where the reference donated the pool to the step
            kp[write_page, offset] = lane_rows(k, kp)
            vp[write_page, offset] = lane_rows(v, vp)
            o = attend(q.contiguous(), kp, vp, page_table, lens,
                       scale=scale)
            o = o.reshape(B, -1).to(h.dtype) @ p["attn"]["wo"]
            h, _ = self._mlp_residual(self._attn_residual(h, o, p), p,
                                      lossless=True)
        return pool, self._final(h)

    # ------------------------------------------ tensor-parallel serving
    #
    # TP shards the kv-head axis: each rank of a serving mesh holds H/n q
    # heads, K/n kv heads, the matching rows of wo and the head slice of
    # every physical page.  Q heads are KV-major (head h serves kv head
    # h // G), so contiguous H/n chunks align to group boundaries exactly
    # when K % n == 0; the only cross-rank operation per layer is the sum
    # after wo (``_attn_residual``).

    def tp_supported(self, n: int) -> bool:
        """Whether paged serving can shard over an ``n``-way model axis."""
        return (n >= 1 and self.supports_paged_decode
                and self.cfg.num_kv_heads % n == 0
                and self.cfg.num_heads % n == 0)

    def tp_param_specs(self) -> Dict[str, P]:
        """A spec per parameter, by its name in ``named_parameters()``.

        q/k/v projections split on the head axis, wo on its rows (summed
        by ``maybe_psum``); norms, MLP/MoE and embeddings replicated: a
        decode batch is tiny, so the replicated FFN is cheaper than two
        more collectives per layer."""
        attn_rules = {
            "wq": P(None, None, "model", None),
            "wk": P(None, None, "model", None),
            "wv": P(None, None, "model", None),
            "wo": P(None, "model", None),
            "bq": P(None, "model", None),
            "bk": P(None, "model", None),
            "bv": P(None, "model", None),
        }
        specs = {}
        for name, t in self.named_parameters():
            keys = name.split(".")
            specs[name] = (attn_rules[keys[-1]]
                           if "attn" in keys and keys[-1] in attn_rules
                           else P(*([None] * t.dim())))
        return specs

    def tp_pool_specs(self, store) -> Dict[str, P]:
        """Page pools (L, P, page, K, hd) split the kv-head axis."""
        return {k: P(None, None, None, "model", None) for k in store}

    def tp_local(self, n: int):
        """(class, kwargs) of one rank's module: the same config with H/n
        q and K/n kv heads (the head dim pinned)."""
        cfg = self.cfg
        return type(self), {"cfg": dataclasses.replace(
            cfg, num_heads=cfg.num_heads // n,
            num_kv_heads=cfg.num_kv_heads // n, head_dim=cfg.hd)}
