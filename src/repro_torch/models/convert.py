"""Reference parameters → the port's state dict.

:func:`params_from_numpy` takes the reference ``init`` output as a nested
dict of numpy arrays — layers stacked on axis 0 (``layers.attn.wq`` is
``(L, D, H, hd)``) — and returns the flat state dict that the port's
model's ``load_state_dict`` takes (the enc-dec tree's ``enc_layers.*``,
``dec_layers.*``, ``enc_final_ln``, ``dec_final_ln`` and ``pos_embed``
included).  Every leaf is cast to ``cfg.dtype``, except the ones the model
keeps in float32 whatever its dtype (RWKV's ``w0`` and ``u``, the MoE
router, and the hybrid's ``dt_bias``, ``A_log`` and ``D_skip``, as the
reference initialises them).
No jax import is needed: the caller converts the leaves with
``np.asarray``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .common import ArchConfig, torch_dtype
from .hybrid import FP32_PARAMS as HYBRID_FP32_PARAMS
from .moe import FP32_PARAMS as MOE_FP32_PARAMS
from .rwkv import FP32_PARAMS as RWKV_FP32_PARAMS

__all__ = ["params_from_numpy"]


def _tensor(leaf: Any, dtype: torch.dtype) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 has no torch.from_numpy mapping; the trip
        # through float32 is exact
        arr = arr.astype(np.float32)
    # a writable copy: jax hands out read-only buffers
    return torch.from_numpy(np.array(arr)).to(dtype)


def params_from_numpy(cfg: ArchConfig,
                      tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flatten ``tree`` to ``{"layers.attn.wq": tensor, ...}`` in
    ``cfg.dtype`` (RWKV's, the MoE router's and the hybrid SSM's float32
    leaves stay float32)."""
    dtype = torch_dtype(cfg.dtype)
    keep_fp32 = (RWKV_FP32_PARAMS if cfg.family == "ssm" else
                 HYBRID_FP32_PARAMS if cfg.family == "hybrid" else
                 MOE_FP32_PARAMS if cfg.is_moe else ())
    out: Dict[str, torch.Tensor] = {}

    def visit(prefix: str, node: Mapping[str, Any]) -> None:
        for key, val in node.items():
            name = f"{prefix}.{key}" if prefix else key
            if isinstance(val, Mapping):
                visit(name, val)
            else:
                out[name] = _tensor(
                    val, torch.float32 if name in keep_fp32 else dtype)

    visit("", tree)
    return out
