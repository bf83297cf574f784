"""Weights drawn from the seed, leaf by leaf, on the device.

Each leaf (and each layer of a stacked leaf) has its own generator,
seeded from ``(seed, leaf name, layer)``, and is drawn in the type it is
served in with one ``normal_`` call.  So the program's copy and the
reference's copy are the same numbers drawn twice: the reference never
reads a tensor the program holds, and draws one layer at a time.
"""

from __future__ import annotations

import zlib
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["leaf_seed", "draw", "fill"]

_MASK = (1 << 63) - 1


def leaf_seed(seed: int, name: str, layer: Optional[int]) -> int:
    """A 63-bit seed for one leaf (one layer of it, for a stacked leaf)."""
    state = np.random.SeedSequence(
        [int(seed) & _MASK, zlib.crc32(name.encode()),
         0 if layer is None else layer + 1]).generate_state(2, np.uint32)
    return ((int(state[0]) << 32) | int(state[1])) & _MASK


def draw(seed: int, name: str, layer: Optional[int],
         spec: Tuple[tuple, bool, float, float], device,
         dtype: torch.dtype) -> torch.Tensor:
    """One leaf (or one layer of a stacked leaf) from its spec
    ``(shape of one layer or of the leaf, stacked, mean, std)``."""
    shape, _, mean, std = spec
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, name, layer))
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.normal_(mean, std, generator=gen)


@torch.no_grad()
def fill(params: Mapping[str, torch.Tensor], specs: Mapping, seed: int,
         num_layers: int) -> None:
    """Draw every parameter in ``params`` (the program's, by name) in
    place; every name must have a spec and every spec a parameter, of the
    same shape."""
    missing = sorted(set(params) ^ set(specs))
    if missing:
        raise ValueError(f"weights: parameters and specs differ: {missing}")
    for name, p in params.items():
        shape, stacked, _, _ = specs[name]
        want = (num_layers, *shape) if stacked else tuple(shape)
        if tuple(p.shape) != want:
            raise ValueError(f"weights: {name} is {tuple(p.shape)}, the "
                             f"spec says {want}")
        if stacked:
            for l in range(num_layers):
                p[l].copy_(draw(seed, name, l, specs[name], p.device, p.dtype))
        else:
            p.copy_(draw(seed, name, None, specs[name], p.device, p.dtype))
