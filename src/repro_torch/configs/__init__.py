from .registry import ARCH_IDS, get_config, get_reduced, list_archs
from .shapes import LONG_CONTEXT_ARCHS, SHAPES, ShapeSpec, cells_for

__all__ = [
    "ARCH_IDS", "get_config", "get_reduced", "list_archs",
    "LONG_CONTEXT_ARCHS", "SHAPES", "ShapeSpec", "cells_for",
]
