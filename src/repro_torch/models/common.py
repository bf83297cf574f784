"""Shared model config, primitive layers and the mesh context, in PyTorch.

The counterpart of ``repro/models/common.py``: the same
:class:`ArchConfig` and the same primitive functions on tensors.
Per-layer heterogeneity (local/global windows, per-layer RoPE bases) is
carried by ``(L,)`` numpy vectors exactly as in the reference.

The mesh context is the reference's: :func:`mesh_context` binds a
training mesh (``launch.mesh.TrainMesh``, or any object with ``.shape``)
that :func:`current_mesh` and :func:`axis_size` read, and :func:`fit_spec`
(defined beside the rules in ``parallel/sharding.py``) fits a spec to it.
With the mesh it binds the step's layout
(``parallel.sharding.TrainLayout``, :func:`current_layout`): the
parameter tree a model's ``loss`` reads on a mesh gathers each leaf where
it is read, and :func:`unstack_layers` splits it into layers whose leaves
are gathered inside their :func:`remat_call`.  The reference's
``constrain`` is not ported as a function: where its GSPMD layout splits
work over ``model``, a model body reads the layout (:func:`split_layout`)
and computes its part (``models/transformer.py``, ``models/attention.py``,
``models/moe.py``, ``models/rwkv.py``, ``models/hybrid.py``,
``models/encdec.py``, :func:`split_mlp`, :func:`whole_table`).  Serving
on a mesh runs shard-local modules instead (:mod:`repro_torch.launch.mesh`).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..parallel.sharding import Shards, fit_spec, regather_saved_leaves

__all__ = [
    "ArchConfig",
    "axis_size",
    "check_remat",
    "cross_entropy",
    "current_layout",
    "current_mesh",
    "fit_spec",
    "mesh_context",
    "frozen",
    "resolve_device",
    "rms_norm",
    "rope",
    "rope_angles",
    "gated_mlp",
    "layer_windows",
    "layer_rope_bases",
    "mesh_columns",
    "mesh_embedding",
    "mesh_scores",
    "param_tree",
    "REMAT_POLICIES",
    "SAVED_DOTS",
    "remat_call",
    "remat_chunk",
    "scale_embedding",
    "serve_layout",
    "softcap",
    "split_layout",
    "split_mlp",
    "take_embedding",
    "torch_dtype",
    "unstack_layers",
    "whole_table",
]

# --------------------------------------------------------------------------
# architecture configuration
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    """Complete static description of one architecture."""

    arch_id: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // num_heads

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    query_scale: Optional[float] = None   # default 1/sqrt(head_dim)
    rope_base: float = 10_000.0
    rope_base_local: Optional[float] = None   # gemma3: different base for local
    # sliding-window pattern: ratio "local:global"; 0 window = global/full
    local_window: int = 0
    pattern_local: int = 0            # e.g. gemma3: 5 local per 1 global
    pattern_global: int = 1
    post_norms: bool = False          # gemma2-style sandwich norms
    embed_scale: bool = False         # gemma: embeddings * sqrt(d_model)
    tie_embeddings: bool = True

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    expert_d_ff: int = 0
    num_shared_experts: int = 0
    router_score: str = "softmax_topk"    # | "sigmoid_top1"
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # SSM / RWKV
    ssm_state_size: int = 0
    rwkv_head_size: int = 64
    ssm_d_inner: int = 0              # hymba mamba branch width

    # enc-dec / multimodal frontends (stubs provide embeddings directly)
    encoder_layers: int = 0
    encoder_len: int = 0              # whisper: 1500 frame positions
    num_patches: int = 0              # vlm: patch-embedding prefix length

    norm_eps: float = 1e-6
    activation: str = "silu"          # | "gelu" | "gelu_tanh"
    gated: bool = True                # False: plain 2-matrix MLP (starcoder2)
    dtype: str = "bfloat16"

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid") or self.local_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        D, F_, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        H, K, hd = self.num_heads, self.num_kv_heads, self.hd
        attn = D * (H * hd) + 2 * D * (K * hd) + (H * hd) * D
        if self.qkv_bias:
            attn += (H + 2 * K) * hd
        if self.is_moe:
            ff = self.num_experts * 3 * D * self.expert_d_ff + D * self.num_experts
            ff += self.num_shared_experts * 3 * D * self.expert_d_ff
        else:
            ff = 3 * D * F_
        ssm = 0
        if self.family == "ssm":  # rwkv6: r,k,v,g,o + decay lora + channel mix
            attn = 0
            ssm = L and (5 * D * D + 2 * D * 64 + 2 * D * (int(3.5 * D)))
            ssm //= L if L else 1
        if self.family == "hybrid":
            di = self.ssm_d_inner or self.d_model
            ssm = 2 * D * di + di * D + di * (2 * self.ssm_state_size + 2)
        per_layer = attn + ff + ssm + 2 * D
        total = L * per_layer + V * D + D
        if not self.tie_embeddings:
            total += V * D
        if self.encoder_layers:
            total += self.encoder_layers * (4 * D * D + 2 * D * F_ + 2 * D)
            total += L * (D * (H * hd) + 2 * D * (K * hd) + (H * hd) * D + 2 * D)
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.param_count()
        D, L = self.d_model, self.num_layers
        dense = self.param_count() - L * (
            self.num_experts * 3 * D * self.expert_d_ff
        )
        active = L * (self.experts_per_token * 3 * D * self.expert_d_ff)
        return int(dense + active)


# --------------------------------------------------------------------------
# mesh context: the MoE block reads the training mesh without threading it
# --------------------------------------------------------------------------

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)
_LAYOUT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_layout", default=None)


@contextlib.contextmanager
def mesh_context(mesh, layout=None):
    """Binds ``mesh`` and, on a training step's mesh, its ``layout``."""
    token, ltoken = _MESH.set(mesh), _LAYOUT.set(layout)
    try:
        yield mesh
    finally:
        _LAYOUT.reset(ltoken)
        _MESH.reset(token)


def current_mesh():
    return _MESH.get()


def current_layout():
    """The training step's ``TrainLayout`` bound here, or None."""
    return _LAYOUT.get()


def split_layout():
    """The training layout bound here if it splits the work over
    ``model`` (a ``TrainLayout`` on a ``model`` axis of more than one
    rank), else None."""
    layout = _LAYOUT.get()
    return layout if layout is not None and layout.split_model and \
        not layout.serving else None


def serve_layout():
    """The serving step's ``ServeLayout`` bound here (a prefill or decode
    step on a serving mesh), or None."""
    layout = _LAYOUT.get()
    return layout if layout is not None and layout.serving else None


def mesh_embedding(table: torch.Tensor, tokens: torch.Tensor, layout,
                   cfg: ArchConfig) -> torch.Tensor:
    """Embeddings on a serving mesh (``layout``): a prefill's padded
    (B, S) tokens → this rank's chunk (B, c, D); a decode step's (B,) →
    (B, D).  Where the table is split over ``model`` by vocabulary, each
    rank looks the tokens up in its rows, zeros for the others', and the
    parts are summed over ``model`` (``scatter_seq``): exact, one term
    nonzero.  Where it is split by its columns (``model`` does not divide
    the vocabulary), each rank looks them up in its columns and they are
    all-gathered (:func:`mesh_columns`)."""
    vocab = cfg.vocab_size
    if table.shape[0] == vocab:
        # a prefill's chunk of the tokens; of a table split by its columns,
        # cut after the gather, whose ranks must look up the same rows
        chunk = slice(layout.seq_start, layout.seq_start + layout.chunk)
        split = table.shape[1] != cfg.d_model
        if not layout.decoding and not split:
            tokens = tokens[:, chunk]
        h = mesh_columns(take_embedding(table, tokens), layout, cfg.d_model)
        return h[:, chunk] if split and not layout.decoding else h
    n = table.shape[0]
    local = tokens.long() - layout.part(vocab)[0]
    mine = (local >= 0) & (local < n)
    h = torch.where(mine[..., None], table[local.clamp(0, n - 1)], 0)
    return layout.scatter_seq(h)


def mesh_columns(x: torch.Tensor, layout, width: int) -> torch.Tensor:
    """Rows ``x`` of a table, whole along their last dimension of
    ``width``: all-gathered over ``model`` where the table rests split by
    its columns (every rank's ``x`` the same rows), else ``x``."""
    if x.shape[-1] == width:
        return x
    return layout.mesh.all_gather(x, "model", x.dim() - 1)


def mesh_scores(h: torch.Tensor, table: torch.Tensor, layout,
                vocab: int) -> torch.Tensor:
    """(B, D) → (B, V) logits on every rank of a serving mesh: each rank
    scores its slice of the vocabulary (of a table split over ``model``, or
    its ``part`` of a whole one where ``model`` does not divide V, padded
    to the equal chunk), and the slices are all-gathered; of a table split
    by its columns, each rank's part of the contraction over ``D``, summed
    over ``model``."""
    if table.shape[1] != h.shape[-1]:
        lo, hi = layout.part(h.shape[-1])
        return layout.sum_parts(h[..., lo:hi] @ table.T)
    if table.shape[0] != vocab:
        return layout.mesh.all_gather(h @ table.T, "model", 1)
    if not layout.split_model:
        return h @ table.T
    lo, hi = layout.part(vocab)
    n = -(-vocab // layout.model_size)
    part = torch.nn.functional.pad(h @ table[lo:hi].T, (0, n - (hi - lo)))
    return layout.mesh.all_gather(part, "model", 1)[:, :vocab]


def whole_table(table: torch.Tensor, vocab: int) -> torch.Tensor:
    """A ``(V, D)`` embedding table whole: on a training mesh that splits
    the work over ``model``, all-gathered over it (the vocabulary is
    stored split) where it is used, each rank then looking up and scoring
    its own tokens; the table itself elsewhere."""
    layout = split_layout()
    if layout is None:
        return table
    return layout.whole(table, 0, vocab)


def axis_size(name: str) -> int:
    mesh = _MESH.get()
    if mesh is None:
        return 1
    return dict(mesh.shape).get(name, 1)


def torch_dtype(name: str) -> torch.dtype:
    """``ArchConfig.dtype`` name → torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA asked for and absent raises.

    Entry points default to ``"cuda"`` and never carry on on the CPU
    behind the caller's back: the CPU is used only when asked for.  Under
    a ``FakeTensorMode`` (a dry run's trace) CUDA needs no card: fake
    tensors hold no memory.
    """
    from torch._guards import detect_fake_mode

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available() \
            and detect_fake_mode() is None:
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def frozen(shape, dtype, device) -> nn.Parameter:
    """An allocated, uninitialised parameter that takes no gradient: the
    models' weights are set by ``init`` or ``load_state_dict``."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# --------------------------------------------------------------------------
# primitive layers (pure functions on tensors)
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6, *,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm computed in fp32 and cast back to the input dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = w + 1.0
    return (x * w).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def rope_angles(positions: torch.Tensor, head_dim: int, base) -> torch.Tensor:
    """Rotary angles for ``positions`` (any shape) → (…, head_dim/2), fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = torch.tensor(float(base), dtype=torch.float32,
                            device=positions.device) ** -exponent
    return positions.float()[..., None] * inv_freq


def rope(x: torch.Tensor, positions: torch.Tensor, base) -> torch.Tensor:
    """Rotary embedding on split halves (not interleaved pairs).

    x: (..., S, H, hd); positions: (..., S).
    """
    hd = x.shape[-1]
    ang = rope_angles(positions, hd, base)           # (..., S, hd/2)
    sin = torch.sin(ang)[..., None, :]               # broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation, so "gelu" maps to it
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def gated_mlp(x: torch.Tensor, w_in: torch.Tensor,
              w_gate: Optional[torch.Tensor], w_out: torch.Tensor,
              activation: str = "silu") -> torch.Tensor:
    """SwiGLU/GeGLU: act(x·w_gate) * (x·w_in) · w_out.

    ``w_gate=None`` gives the plain two-matrix MLP (starcoder2).
    """
    act = _act(activation)
    if w_gate is None:
        h = act(x @ w_in)
    else:
        h = act(x @ w_gate) * (x @ w_in)
    return h @ w_out


def split_mlp(x: torch.Tensor, w_in: torch.Tensor,
              w_gate: Optional[torch.Tensor], w_out: torch.Tensor,
              activation: str, layout, d_ff: int) -> torch.Tensor:
    """:func:`gated_mlp` on this rank's chunk ``x`` (B, c, D) of the
    sequence, its hidden split over ``model`` (the reference's
    ``constrain(h, "data", None, "model")``): the sequence is gathered,
    the rank computes its part of the ``d_ff`` hidden from its parts of the
    weights, and the partial products are reduce-scattered back to its
    chunk."""
    w_in = layout.local(w_in, 1, d_ff)
    w_gate = None if w_gate is None else layout.local(w_gate, 1, d_ff)
    w_out = layout.local(w_out, 0, d_ff)
    y = gated_mlp(layout.gather_seq(x), w_in, w_gate, w_out, activation)
    return layout.scatter_seq(y)


def take_embedding(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding lookup: ``table[tokens]``."""
    return table[tokens.long()]


def scale_embedding(h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """gemma's ``embeddings * sqrt(d_model)``, in fp32 then back."""
    if not cfg.embed_scale:
        return h
    return (h.float() * math.sqrt(cfg.d_model)).to(h.dtype)


# --------------------------------------------------------------------------
# per-layer flag vectors
# --------------------------------------------------------------------------


def layer_windows(cfg: ArchConfig) -> np.ndarray:
    """(L,) int32 sliding-window size per layer; 0 = global/full attention."""
    L = cfg.num_layers
    out = np.zeros(L, np.int32)
    if cfg.local_window == 0:
        return out
    period = cfg.pattern_local + cfg.pattern_global
    for i in range(L):
        # local layers first within each period, global layer(s) last
        out[i] = cfg.local_window if (i % period) < cfg.pattern_local else 0
    return out


def layer_rope_bases(cfg: ArchConfig) -> np.ndarray:
    """(L,) float32 RoPE base per layer (gemma3 uses 10k local / 1M global)."""
    w = layer_windows(cfg)
    base_local = cfg.rope_base_local or cfg.rope_base
    return np.where(w > 0, base_local, cfg.rope_base).astype(np.float32)


# --------------------------------------------------------------------------
# training: parameter trees, the loss, rematerialisation
# --------------------------------------------------------------------------


def param_tree(module: nn.Module) -> Dict[str, Any]:
    """The module's weights as the reference's nested dict
    (``{"layers": {"attn": {"wq": ...}}}``), each leaf a detached view
    that shares the parameter's storage."""
    tree: Dict[str, Any] = {}
    for name, t in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach()
    return tree


def unstack_layers(tree: Mapping[str, Any], L: int) -> List[Dict[str, Any]]:
    """Split a tree of stacked ``(L, ...)`` leaves into L per-layer trees,
    one ``unbind`` per leaf: its backward stacks the L gradients once,
    where indexing ``t[l]`` per layer would allocate a zeroed copy of the
    whole stacked gradient for each layer.  A :class:`Shards` tree (a
    training step's on a mesh) gives per-layer :class:`Shards`."""
    if isinstance(tree, Shards):
        return tree.unstack(L)
    if isinstance(tree, Mapping):
        subs = {k: unstack_layers(v, L) for k, v in tree.items()}
        return [{k: subs[k][l] for k in subs} for l in range(L)]
    return list(tree.unbind(0))


#: the reference's layer remat policies (``build_model(cfg, remat=...)``)
REMAT_POLICIES = ("full", "dots", "none")

#: products with no batch dimension: the outputs ``remat="dots"`` saves
#: (``x @ w`` on a 2-D weight lowers to one of them; ``einsum``, ``bmm``
#: and ``baddbmm`` carry a batch dimension and are recomputed)
SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def check_remat(policy: str) -> str:
    """``policy`` if it is one of :data:`REMAT_POLICIES`, else a
    ``ValueError``."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got "
                         f"{policy!r}")
    return policy


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: save
    what :data:`SAVED_DOTS` return, recompute everything else (the
    collectives of a mesh, gathers of weights included)."""
    if op in SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn: Callable, *args, policy: str = "full"):
    """``fn(*args)`` (one layer) under the reference's remat ``policy``
    when gradients are on:

    * ``"full"`` (``jax.checkpoint(policy=None)``): only the layer's inputs
      are kept, and its activations are recomputed in the backward pass;
    * ``"dots"`` (``dots_with_no_batch_dims_saveable``): a selective
      checkpoint that keeps the outputs of the products with no batch
      dimension (:data:`SAVED_DOTS`) and recomputes the rest;
    * ``"none"``: no checkpoint; autograd keeps what it saves.

    On a training mesh a layer's :class:`Shards` are gathered where ``fn``
    reads them, so inside the checkpoint: the recompute gathers them
    again, and the backward reduces their gradients as it leaves the
    layer.  Under ``"none"``, where nothing is recomputed,
    ``parallel.sharding.regather_saved_leaves`` keeps the same property:
    a gathered leaf that autograd saves is kept as its shard and gathered
    again when the backward reads it.  The recompute binds the mesh and
    layout bound here: on a CUDA device the backward runs on the autograd
    engine's own thread, which does not see this thread's context
    variables."""
    check_remat(policy)
    if not torch.is_grad_enabled():
        return fn(*args)
    mesh, layout = current_mesh(), current_layout()
    if policy == "none":
        if layout is None:
            return fn(*args)
        with regather_saved_leaves():
            return fn(*args)

    def contexts():
        if policy == "full":
            return contextlib.nullcontext(), mesh_context(mesh, layout)
        save, recompute = create_selective_checkpoint_contexts(_dots_policy)
        return save, _both(recompute, mesh_context(mesh, layout))

    return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts)


def remat_chunk(fn: Callable) -> Callable:
    """``fn`` (one chunk of a recurrence) as the scans call it: with
    gradients on, under a checkpoint, as the reference's ``@jax.checkpoint``
    ``chunk_fn`` (the backward keeps the chunk's inputs alone and
    recomputes its states); ``fn`` itself otherwise."""
    if not torch.is_grad_enabled():
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def cross_entropy(logits: torch.Tensor, batch: Mapping[str, Any]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's next-token loss: fp32 logits, ``logsumexp`` less the
    target's logit, the mean over ``loss_mask`` (all ones if absent),
    divided by ``max(sum(mask), 1)``.  Returns (ce, that divisor)."""
    targets = batch["targets"].to(torch.int64)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None])[..., 0]
    denom = torch.clamp(torch.sum(mask), min=1.0)
    ce = torch.sum((lse - ll) * mask) / denom
    return ce, denom
