"""Plain PyTorch reference of the dense GQA decoder (qwen2.5, starcoder2).

Float32 throughout, TF32 off, no kernel, no cache, no batching: each
sequence runs whole through every layer, and a layer's weights are drawn
from the seed (``perfbench.weights``) when it runs, so the reference reads
nothing the program made.  It imports nothing of the program.

The equations, per layer: ``a = rmsnorm(h)``; q, k, v = a·W + b with q
heads grouped over the kv heads (q head j reads kv head j // G); RoPE
on split halves (not interleaved pairs) at base ``rope_base``; causal
softmax attention scaled by 1/sqrt(hd); ``h += o·Wo``; ``m =
rmsnorm(h)``; ``h += silu(m·Wg) * (m·Wu) · Wd`` (gated) or
``gelu_tanh(m·Wu) · Wd`` (plain); logits = rmsnorm(h)·Eᵀ with the untied
output table.  Departures of the served model from the published ones,
followed here: starcoder2 publishes LayerNorm with a bias and biases on
every projection and on both MLP matrices; the served model uses RMSNorm
and biases on q, k and v alone (the configuration files list them).

``precision="fp8"`` is the control: the same equations with every matmul
input (weights per output column, activations per row) and every K/V
row per head rounded to float8 e4m3 with a per-row scale, the step below
the bfloat16 the configuration serves in.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["leaf_specs", "Reference"]

_FP8_MAX = 448.0


def _dims(cfg: Mapping):
    D, H, K = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    return D, H, K, cfg.get("head_dim") or D // H


def leaf_specs(cfg: Mapping) -> Dict[str, tuple]:
    """Every weight by name: (shape of one layer or of the leaf, stacked
    over layers, mean, std).  Projections N(0, 1/fan_in), biases N(0,
    0.1), norm gains N(1, 0.1): every term of the equations is live."""
    D, H, K, hd = _dims(cfg)
    Fd, V = cfg["d_ff"], cfg["vocab_size"]
    s = {
        "embed": ((V, D), False, 0.0, D ** -0.5),
        "unembed": ((V, D), False, 0.0, D ** -0.5),
        "final_norm": ((D,), False, 1.0, 0.1),
        "layers.ln1": ((D,), True, 1.0, 0.1),
        "layers.ln2": ((D,), True, 1.0, 0.1),
        "layers.attn.wq": ((D, H, hd), True, 0.0, D ** -0.5),
        "layers.attn.wk": ((D, K, hd), True, 0.0, D ** -0.5),
        "layers.attn.wv": ((D, K, hd), True, 0.0, D ** -0.5),
        "layers.attn.wo": ((H * hd, D), True, 0.0, (H * hd) ** -0.5),
        "layers.mlp.wu": ((D, Fd), True, 0.0, D ** -0.5),
        "layers.mlp.wd": ((Fd, D), True, 0.0, Fd ** -0.5),
    }
    if cfg.get("gated", True):
        s["layers.mlp.wg"] = ((D, Fd), True, 0.0, D ** -0.5)
    if cfg.get("qkv_bias", False):
        s.update({
            "layers.attn.bq": ((H, hd), True, 0.0, 0.1),
            "layers.attn.bk": ((K, hd), True, 0.0, 0.1),
            "layers.attn.bv": ((K, hd), True, 0.0, 0.1),
        })
    if cfg.get("tie_embeddings", False):
        del s["unembed"]
    return s


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the slice's largest magnitude maps to 448), back in fp32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    """The model of one configuration, drawn from ``draw(name, layer)``
    (a leaf of the served dtype, on ``device``)."""

    def __init__(self, cfg: Mapping, draw: Callable, device,
                 precision: str = "fp32", query_block: int = 1024) -> None:
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.cfg = cfg
        self.draw = draw
        self.device = torch.device(device)
        self.fp8 = precision == "fp8"
        self.query_block = query_block
        self.eps = float(cfg.get("norm_eps", 1e-6))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------- pieces

    def _leaf(self, name: str, layer: Optional[int]) -> torch.Tensor:
        return self.draw(name, layer).float()

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (T, in) · w (in, out); the control rounds both to fp8."""
        if self.fp8:
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * w

    def _rope(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        hd = x.shape[-1]
        inv = float(self.cfg["rope_base"]) ** -(
            torch.arange(0, hd, 2, dtype=torch.float64,
                         device=x.device) / hd)
        ang = (positions.double()[:, None] * inv).float()[:, None, :]
        x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * ang.cos() - x2 * ang.sin(),
                          x2 * ang.cos() + x1 * ang.sin()], dim=-1)

    def _attention(self, q, k, v) -> torch.Tensor:
        """Causal attention of one sequence: q (T, H, hd), k/v (T, K, hd)
        → (T, H·hd), in blocks of query rows."""
        T, H, hd = q.shape
        K = k.shape[1]
        G = H // K
        if self.fp8:
            k, v = _fp8(k, -1), _fp8(v, -1)
        kh = k.repeat_interleave(G, dim=1).transpose(0, 1)   # (H, T, hd)
        vh = v.repeat_interleave(G, dim=1).transpose(0, 1)
        qh = q.transpose(0, 1) / math.sqrt(hd)
        out = torch.empty((H, T, hd), dtype=torch.float32, device=q.device)
        keys = torch.arange(T, device=q.device)
        for i0 in range(0, T, self.query_block):
            i1 = min(i0 + self.query_block, T)
            s = qh[:, i0:i1] @ kh[:, :i1].transpose(1, 2)      # (H, b, i1)
            mask = keys[None, :i1] <= torch.arange(i0, i1,
                                                   device=q.device)[:, None]
            s = s.masked_fill(~mask, float("-inf"))
            out[:, i0:i1] = torch.softmax(s, dim=-1) @ vh[:, :i1]
        return out.transpose(0, 1).reshape(T, H * hd)

    def _layer(self, hs: List[torch.Tensor], l: int) -> None:
        cfg = self.cfg
        D, H, K, hd = _dims(cfg)
        w = {n: self._leaf(f"layers.{n}", l) for n in
             ("ln1", "ln2", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
              "mlp.wu", "mlp.wd")}
        if cfg.get("gated", True):
            w["mlp.wg"] = self._leaf("layers.mlp.wg", l)
        if cfg.get("qkv_bias", False):
            for n in ("bq", "bk", "bv"):
                w[f"attn.{n}"] = self._leaf(f"layers.attn.{n}", l)
        gelu = cfg.get("activation", "silu") in ("gelu", "gelu_tanh")
        for i, h in enumerate(hs):
            T = h.shape[0]
            pos = torch.arange(T, device=h.device)
            a = self._norm(h, w["ln1"])
            proj = {}
            for n, heads in (("q", H), ("k", K), ("v", K)):
                y = self._mm(a, w[f"attn.w{n}"].reshape(D, heads * hd))
                if f"attn.b{n}" in w:
                    y = y + w[f"attn.b{n}"].reshape(-1)
                proj[n] = y.reshape(T, heads, hd)
            q = self._rope(proj["q"], pos)
            k = self._rope(proj["k"], pos)
            h = h + self._mm(self._attention(q, k, proj["v"]), w["attn.wo"])
            m = self._norm(h, w["ln2"])
            up = self._mm(m, w["mlp.wu"])
            if "mlp.wg" in w:
                act = F.silu(self._mm(m, w["mlp.wg"])) * up
            else:
                act = (F.gelu(up, approximate="tanh") if gelu
                       else F.silu(up))
            hs[i] = h + self._mm(act, w["mlp.wd"])

    # ---------------------------------------------------------- public

    @torch.no_grad()
    def logits(self, streams: Sequence[torch.Tensor],
               rows: Sequence[slice]) -> List[torch.Tensor]:
        """Logits (n, V) in fp32 at positions ``rows[i]`` of each token
        stream ``streams[i]`` (int64, on the device)."""
        cfg = self.cfg
        embed = self.draw("embed", None)
        hs = [embed[s.long()].float() for s in streams]
        del embed
        for l in range(cfg["num_layers"]):
            self._layer(hs, l)
        fn = self._leaf("final_norm", None)
        table = self._leaf("embed" if cfg.get("tie_embeddings", False)
                           else "unembed", None)
        if self.fp8:
            table = _fp8(table, -1)
        out = []
        for h, r in zip(hs, rows):
            x = self._norm(h[r], fn)
            out.append((_fp8(x, -1) if self.fp8 else x) @ table.T)
        return out
