"""Architecture registry: ``--arch <id>`` resolution for every launcher."""

from __future__ import annotations

import importlib
from typing import List, Tuple

from repro_torch.models.common import ArchConfig

__all__ = ["ARCH_IDS", "get_config", "get_reduced", "list_archs"]

_MODULES = {
    "gemma2-9b": "gemma2_9b",
    "gemma3-12b": "gemma3_12b",
    "starcoder2-7b": "starcoder2_7b",
    "qwen2.5-32b": "qwen2_5_32b",
    "rwkv6-3b": "rwkv6_3b",
    "whisper-tiny": "whisper_tiny",
    "hymba-1.5b": "hymba_1_5b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "llama4-scout-17b-a16e": "llama4_scout",
    "llava-next-34b": "llava_next_34b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)


def _load(arch_id: str):
    try:
        mod = _MODULES[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {', '.join(ARCH_IDS)}"
        ) from None
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str) -> ArchConfig:
    return _load(arch_id).CONFIG


def get_reduced(arch_id: str) -> ArchConfig:
    return _load(arch_id).REDUCED


def list_archs() -> List[str]:
    return list(ARCH_IDS)
