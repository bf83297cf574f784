"""Model factory: family → implementation dispatch, as the reference's
``repro/models/model.py``: every family it builds, the port builds."""

from __future__ import annotations

from typing import Any

from .common import ArchConfig
from .encdec import EncDecLM
from .hybrid import HybridLM
from .rwkv import RwkvLM
from .transformer import TransformerLM

__all__ = ["build_model"]

_FAMILIES = {
    "dense": TransformerLM,
    "moe": TransformerLM,
    "vlm": TransformerLM,
    "ssm": RwkvLM,
    "hybrid": HybridLM,
    "audio": EncDecLM,
}


def build_model(cfg: ArchConfig, *, device="cuda", remat: str = "full",
                **kw) -> Any:
    """The family's model on ``device``.  ``impl="xla"`` (the reference's
    ``build_model(cfg, impl="xla")``, which its dry run lowers) serves
    through the plain routes, never a kernel; the default ``"kernel"``
    serves through the hand-written kernels on the card.  ``remat``: the
    reference's layer remat policy in training, ``"full"``, ``"dots"`` or
    ``"none"`` (``models.common.remat_call``), with its meaning per family:
    ``TransformerLM`` takes all three, ``HybridLM`` runs ``"dots"`` as
    ``"none"``, and ``RwkvLM`` and ``EncDecLM`` checkpoint every layer
    whatever it says."""
    try:
        cls = _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(
            f"unknown family {cfg.family!r} for {cfg.arch_id}") from None
    if cfg.family == "audio":
        kw.setdefault("max_target_positions", 32768 + 8)
    return cls(cfg, device=device, remat=remat, **kw)
