"""Assigned input shapes (one set, paired with every LM architecture).

A copy of ``repro/configs/shapes.py`` (pure Python).

``decode_*``/``long_*`` lower ``serve_step`` (single new token against a
KV cache of ``seq_len``), not ``train_step``.  ``long_500k`` requires
sub-quadratic attention and only runs for eligible archs (DESIGN.md §4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

__all__ = ["ShapeSpec", "SHAPES", "LONG_CONTEXT_ARCHS", "cells_for"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

#: archs eligible for long_500k (sub-quadratic decode; DESIGN.md §4)
LONG_CONTEXT_ARCHS = frozenset(
    {"rwkv6-3b", "hymba-1.5b", "gemma2-9b", "gemma3-12b", "llama4-scout-17b-a16e"}
)


def cells_for(arch_id: str) -> Tuple[str, ...]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if arch_id in LONG_CONTEXT_ARCHS:
        names.append("long_500k")
    return tuple(names)
