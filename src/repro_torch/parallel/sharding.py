"""Tensor-parallel serving shardings: a model's TP specs → each rank's slices.

The serving part of ``repro/parallel/sharding.py``.  A model's
``tp_param_specs()`` and ``tp_pool_specs(store)`` give one :class:`P` per
leaf (the reference's ``PartitionSpec``): ``P(None, None, "model", None)``
splits dimension 2 into ``n`` equal contiguous chunks, one per rank of the
serving mesh, and a spec without the axis replicates the leaf.  The specs
are exact by contract: a model declares ``tp_supported(n)`` only where
every split dimension divides.

The training rules (``param_spec``, FSDP on ``data``, batch and
decode-state shardings) wait for training on a mesh (ROADMAP.md queue 1,
item 9c).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

__all__ = ["P", "gather_shards", "serving_tp_shards"]

#: the serving mesh's one axis (``launch.mesh.SERVING_AXIS``)
_AXIS = "model"


class P(tuple):
    """A partition spec: per dimension, the mesh axis it is split over or
    None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _split_dim(spec: P) -> Optional[int]:
    """The dimension ``spec`` splits over the serving axis, or None."""
    dims = [i for i, a in enumerate(spec) if a == _AXIS]
    if len(dims) > 1:
        raise ValueError(f"{spec} splits more than one dimension over "
                         f"{_AXIS!r}")
    return dims[0] if dims else None


def _shard_slice(t: torch.Tensor, spec: P, rank: int, n: int
                 ) -> torch.Tensor:
    """Rank ``rank``'s view of ``t`` under ``spec`` over ``n`` ranks."""
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} for a tensor of shape "
                         f"{tuple(t.shape)}")
    dim = _split_dim(spec)
    if dim is None:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"divide over {n} ranks")
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size)


def serving_tp_shards(specs: Dict[str, P], tree: Dict[str, torch.Tensor],
                      n: int) -> List[Dict[str, torch.Tensor]]:
    """Per rank, ``tree``'s leaves sliced by ``specs`` (views, not
    copies).  ``specs`` must name every leaf of ``tree``."""
    if set(specs) != set(tree):
        raise ValueError(f"specs and tree differ: "
                         f"{sorted(set(specs) ^ set(tree))}")
    return [{name: _shard_slice(t, specs[name], rank, n)
             for name, t in tree.items()} for rank in range(n)]


def gather_shards(shards: List[torch.Tensor], spec: P) -> torch.Tensor:
    """The whole tensor from its ranks' slices (rank order)."""
    dim = _split_dim(spec)
    return shards[0] if dim is None else torch.cat(shards, dim=dim)
