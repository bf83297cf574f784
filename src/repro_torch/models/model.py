"""Model factory: family → implementation dispatch.

The dense and MoE families (``TransformerLM``) and RWKV6 (``RwkvLM``,
family ``"ssm"``) are ported; the others raise and are queued in
ROADMAP.md (queue 1, item 7).
"""

from __future__ import annotations

from typing import Any

from .common import ArchConfig
from .rwkv import RwkvLM
from .transformer import TransformerLM

__all__ = ["build_model"]

_FAMILIES = {"dense": TransformerLM, "moe": TransformerLM, "ssm": RwkvLM}
_KNOWN = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def build_model(cfg: ArchConfig, *, device="cuda") -> Any:
    cls = _FAMILIES.get(cfg.family)
    if cls is None:
        if cfg.family in _KNOWN:
            raise NotImplementedError(
                f"{cfg.arch_id}: family {cfg.family!r} is not ported yet "
                "(ROADMAP.md queue 1, item 7: other model families)"
            )
        raise ValueError(f"unknown family {cfg.family!r} for {cfg.arch_id}")
    return cls(cfg, device=device)
