"""Partition rules and the shards they give: parameters, optimizer state,
batches, decode state, and tensor-parallel serving.

The counterpart of ``repro/parallel/sharding.py``.  Mesh axes
(``launch/mesh.py``): ``pod`` (pure DP across pods), ``data`` (batch DP +
FSDP parameter sharding), ``model`` (TP for d_ff and q-heads, EP for
experts, sequence-parallel residual, seq- or head-sharded KV).

A :class:`P` is the reference's ``PartitionSpec``: per dimension, the mesh
axis (or tuple of axes, the first the major one) it is split over, or
None.  The rules are the reference's, function for function: each takes a
leaf's path, its shape and a mesh's shape and returns a :class:`P`, fitted
by :func:`fit_spec` so that every split divides (a non-dividing dimension
falls back to replication, as under JAX).  A mesh here is anything with
``.shape`` (axis name → size): an :class:`AbstractMesh` (names and sizes,
no process group: the rules of the 256-chip pod are checked on one host)
or a ``launch.mesh.TrainMesh`` over the ``torch.distributed`` world.
:class:`NamedSharding` pairs a mesh with a fitted spec, as the
reference's does; its ``placements`` are the same layout as DTensor's
``Shard(d)`` / ``Replicate()`` per mesh dimension.

Below the rules, the functions that move trees between layouts on a
``TrainMesh``: :func:`shard_tree` (this rank's slice of each whole leaf),
:func:`gather_tree` (the whole leaves back, all-gathered),
:func:`gather_leaf_to_host0` (one whole leaf on rank 0 alone, for a
checkpoint) and
:func:`reduce_tree` (a gradient computed on every rank from its rows,
summed over the batch axes and scattered to the leaf's shard).  Slices
are contiguous chunks, in the rank order of the axes, as JAX lays out a
``NamedSharding``.

The serving part: a model's ``tp_param_specs()`` and
``tp_pool_specs(store)`` give one :class:`P` per leaf; ``P(None, None,
"model", None)`` splits dimension 2 into ``n`` equal chunks, one per rank
of the one-axis serving mesh, exact by contract (a model declares
``tp_supported(n)`` only where every split divides).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..tree import tree_flatten_with_path, tree_unflatten_like

__all__ = [
    "AbstractMesh",
    "NamedSharding",
    "P",
    "batch_rows",
    "batch_shardings",
    "batch_specs",
    "decode_state_shardings",
    "expert_parallel",
    "fit_spec",
    "gather_leaf",
    "gather_shards",
    "gather_leaf_to_host0",
    "gather_tree",
    "named",
    "opt_state_shardings",
    "param_shardings",
    "param_spec",
    "reduce_tree",
    "serving_tp_shards",
    "shard_tree",
]

#: the axes a batch is split over, outermost first
BATCH_AXES = ("pod", "data")


class P(tuple):
    """A partition spec: per dimension, the mesh axis (or tuple of axes) it
    is split over, or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class AbstractMesh:
    """A mesh's axis names and sizes, without devices or a process group
    (``jax.sharding.AbstractMesh``)."""

    def __init__(self, axis_sizes: Sequence[int],
                 axis_names: Sequence[str]) -> None:
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for axes "
                             f"{tuple(axis_names)}")
        self.shape: Dict[str, int] = dict(zip(axis_names,
                                              map(int, axis_sizes)))
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.size = math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


def fit_spec(mesh, spec, shape) -> P:
    """Make ``spec`` legal for ``shape`` on ``mesh``.

    Per dimension: axis names missing from the mesh are dropped, and the
    axis tuple is truncated to the largest prefix whose size product
    divides the dimension (JAX requires exact divisibility), so 36 q-heads
    on a 16-way ``model`` axis fall back to replication.
    """
    entries = list(spec) + [None] * (len(shape) - len(spec))
    axes = dict(mesh.shape)
    out = []
    for dim, entry in zip(shape, entries[: len(shape)]):
        if entry is None:
            out.append(None)
            continue
        names = [a for a in _names(entry) if a in axes]
        kept, prod = [], 1
        for a in names:
            if dim % (prod * axes[a]) == 0:
                kept.append(a)
                prod *= axes[a]
            else:
                break
        out.append(tuple(kept) if len(kept) > 1 else
                   (kept[0] if kept else None))
    return P(*out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec of one leaf (``jax.sharding.NamedSharding``); a
    leaf of the trees in ``repro_torch.tree``, not a container."""

    mesh: Any
    spec: P

    def _split(self, shape) -> List[Tuple[str, ...]]:
        entries = list(self.spec) + [None] * (len(shape) - len(self.spec))
        if len(entries) > len(shape):
            raise ValueError(f"{self.spec} for a leaf of shape "
                             f"{tuple(shape)}")
        return [_names(e) for e in entries]

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """One shard's shape; raises where a split does not divide."""
        out = []
        for dim, names in zip(shape, self._split(shape)):
            n = math.prod(self.mesh.shape[a] for a in names)
            if dim % n:
                raise ValueError(f"dimension {dim} of {tuple(shape)} does "
                                 f"not divide over {names} ({n}-way)")
            out.append(dim // n)
        return tuple(out)

    def global_shape(self, shard_shape) -> Tuple[int, ...]:
        """The whole leaf's shape from one shard's."""
        return tuple(dim * math.prod(self.mesh.shape[a] for a in names)
                     for dim, names in zip(shard_shape,
                                           self._split(shard_shape)))

    @property
    def placements(self) -> tuple:
        """Per mesh axis, ``Shard(d)`` for the dimension split over it or
        ``Replicate()`` (DTensor's description of the same layout; an
        axis tuple on one dimension must follow the mesh's axis order)."""
        from torch.distributed.tensor import Replicate, Shard

        order = {a: i for i, a in enumerate(self.mesh.axis_names)}
        out = [Replicate() for _ in self.mesh.axis_names]
        for d, entry in enumerate(self.spec):
            names = _names(entry)
            if [order[a] for a in names] != sorted(order[a] for a in names):
                raise ValueError(f"{self.spec}: the axes of dimension {d} "
                                 "are not in the mesh's order")
            for a in names:
                out[order[a]] = Shard(d)
        return tuple(out)


def named(mesh, spec, shape: Optional[Tuple[int, ...]] = None
          ) -> NamedSharding:
    """A :class:`NamedSharding` with missing axes dropped and, given
    ``shape``, divisibility enforced by :func:`fit_spec`."""
    if shape is not None:
        return NamedSharding(mesh, fit_spec(mesh, spec, shape))
    axes = set(mesh.axis_names)

    def keep(entry):
        kept = tuple(a for a in _names(entry) if a in axes)
        if isinstance(entry, (tuple, list)):
            return kept or None
        return kept[0] if kept else None

    return NamedSharding(mesh, P(*(keep(e) for e in spec)))


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def param_spec(path: str, ndim: int, *, heads_divisible: bool = True
               ) -> P:  # noqa: C901 (rule table)
    """PartitionSpec for one parameter leaf.

    ``path`` is the slash-joined tree path; stacked layer leaves have a
    leading L dimension (never sharded: it is the scan axis).

    ``heads_divisible=False``: the arch's q-heads don't divide the model
    axis, so attention runs sequence-parallel and ``wo``'s input dim must
    NOT be model-sharded.
    """
    def stacked(*tail):
        # leaf may or may not carry the leading (L,) scan dim
        if ndim == len(tail) + 1:
            return P(None, *tail)
        if ndim != len(tail):
            raise ValueError(f"{path}: rank {ndim} for the rule {tail}")
        return P(*tail)

    leaf = path.split("/")[-1]

    # ---- embeddings -------------------------------------------------------
    if leaf in ("embed", "unembed"):
        return P("model", "data")
    if leaf == "pos_embed":
        return P(None, "data")

    # ---- attention (dense 4D: (L, D, H, hd); whisper 3D: (L, D, H*hd)) ----
    if "attn" in path:
        if leaf == "wq":
            return stacked("data", "model", None) if ndim >= 4 else \
                stacked("data", "model")
        if leaf in ("wk", "wv"):
            # kv heads < model axis on every arch: replicate over model,
            # FSDP-shard the input dim over data
            return stacked("data", None, None) if ndim >= 4 else \
                stacked("data", None)
        if leaf == "wo":
            if not heads_divisible:
                return stacked(None, "data")
            return stacked("model", "data")
        if leaf == "bq":
            return stacked("model", None) if ndim >= 3 else stacked(None, None)
        if leaf in ("bk", "bv"):
            return stacked(None, None)
        if leaf == "bo":
            return stacked(None)
        if leaf in ("q_norm", "k_norm"):
            return stacked(None)

    # ---- MoE ---------------------------------------------------------------
    if "moe" in path:
        if leaf == "router":
            return stacked(None, None)
        if leaf in ("wg", "wu"):
            return stacked("model", None, "data")
        if leaf == "wd":
            return stacked("model", "data", None)
        if leaf in ("swg", "swu"):
            return stacked("data", "model")
        if leaf == "swd":
            return stacked("model", "data")

    # ---- dense / shared MLP -------------------------------------------------
    if "mlp" in path:
        if leaf in ("wg", "wu", "w1", "wck"):
            return stacked("data", "model")
        if leaf in ("wd", "w2", "wcv"):
            return stacked("model", "data")
        if leaf in ("b1",):
            return stacked("model")
        if leaf in ("b2",):
            return stacked(None)

    # ---- RWKV time/channel mix ----------------------------------------------
    if leaf in ("wr", "wk", "wv", "wg", "wcr") and ndim == 3:
        return stacked("data", "model")
    if leaf == "wo" and ndim == 3:
        return stacked("model", "data")
    if leaf in ("wck",):
        return stacked("data", "model")
    if leaf in ("wcv",):
        return stacked("model", "data")
    if leaf == "tm_w1":
        return stacked("data", None)
    if leaf == "tm_w2":
        return stacked(None, None, "data")
    if leaf == "dw1":
        return stacked("data", None)
    if leaf == "dw2":
        return stacked(None, "data")
    if leaf == "u" and ndim == 3:
        return stacked("model", None)
    if leaf == "mu_rkvwg":
        return stacked(None, None)

    # ---- hybrid SSM ----------------------------------------------------------
    if "ssm" in path:
        if leaf == "w_in":
            return stacked("data", "model")
        if leaf == "w_dt":
            return stacked("data", "model")
        if leaf in ("w_B", "w_C"):
            return stacked("model", None)
        if leaf == "A_log":
            return stacked("model", None)
        if leaf in ("D_skip", "dt_bias"):
            return stacked("model")
        if leaf == "w_out":
            return stacked("model", "data")

    # ---- everything else (norms, scalars, small vectors): replicated --------
    return P(*([None] * ndim))


def _path_str(path: Tuple) -> str:
    return "/".join(map(str, path))


def _map_with_path(fn: Callable, tree):
    flat = tree_flatten_with_path(tree)
    return tree_unflatten_like(tree, [fn(_path_str(p), leaf)
                                      for p, leaf in flat])


def param_shardings(params_shape, mesh, *, mode: str = "train",
                    heads_divisible: bool = True):
    """A params (shape-)tree's :class:`NamedSharding` per leaf (leaves are
    anything with ``.shape``: tensors, ``meta`` tensors).

    ``mode="serve"``: drop the FSDP ``data`` sharding of dense weights
    (serving has no optimizer state) and re-home it onto ``model`` where
    that axis is unused and divides; MoE expert weights keep their 2-D
    sharding.
    """
    model_size = dict(mesh.shape).get("model", 1)

    def visit(p, leaf):
        shape = tuple(leaf.shape)
        spec = param_spec(p, len(shape), heads_divisible=heads_divisible)
        if mode == "serve" and "moe" not in p:
            fitted = fit_spec(mesh, spec, shape)
            ents = list(fitted) + [None] * (len(shape) - len(fitted))
            used_model = any("model" in _names(e) for e in ents)
            out = []
            for dim, e in zip(shape, ents):
                if "data" in _names(e):
                    # re-home the FSDP shard onto the model axis
                    if not used_model and dim % model_size == 0:
                        out.append("model")
                        used_model = True
                    else:
                        out.append(None)
                else:
                    out.append(e)
            return named(mesh, P(*out), shape)
        return named(mesh, spec, shape)

    return _map_with_path(visit, params_shape)


def opt_state_shardings(opt_shape, mesh, *, heads_divisible: bool = True):
    """Adam moments shard exactly like their parameters; the step count is
    replicated."""
    def visit(p, leaf):
        if p.startswith(("mu/", "nu/")):
            p = p.split("/", 1)[1]
        shape = tuple(leaf.shape)
        if shape == ():
            return named(mesh, P())
        return named(mesh, param_spec(p, len(shape),
                                      heads_divisible=heads_divisible), shape)

    return _map_with_path(visit, opt_shape)


def expert_parallel(path: str) -> bool:
    """Whether a parameter leaf holds MoE experts, which the training step
    keeps split over ``model`` (expert parallelism) where every other leaf
    is gathered whole."""
    return "moe" in path and path.split("/")[-1] in ("wg", "wu", "wd")


# --------------------------------------------------------------------------
# batches & decode state
# --------------------------------------------------------------------------

def batch_specs(batch_shape, *, batch_divisible: bool = True
                ) -> Dict[str, P]:
    """Specs for a train/prefill batch dict (tokens/targets/mask/frames…)."""
    b_axes: Any = BATCH_AXES if batch_divisible else None
    specs = {}
    for key, leaf in batch_shape.items():
        nd = len(leaf.shape)
        if key in ("tokens", "targets", "loss_mask"):
            specs[key] = P(b_axes, "model") if nd == 2 else P(b_axes)
        elif key in ("frames", "patch_embeds"):
            specs[key] = P(b_axes, None, None)
        else:
            specs[key] = P(*([None] * nd))
    return specs


def batch_shardings(batch_shape, mesh, **kw) -> Dict[str, NamedSharding]:
    return {k: named(mesh, s, tuple(batch_shape[k].shape))
            for k, s in batch_specs(batch_shape, **kw).items()}


def decode_state_shardings(state_shape, mesh, *, layout: str = "seq",
                           batch_divisible: bool = True):
    """Shardings for the decode-state dict of any family.

    ``layout="seq"`` (default) shards the KV cache over the sequence axis;
    ``layout="heads"`` is only legal when kv_heads divides the model axis.
    """
    b_axes: Any = BATCH_AXES if batch_divisible else None

    def visit(key, leaf):
        shp = tuple(leaf.shape)
        if key.startswith(("cache_k", "cache_v")):
            if layout == "seq":
                return named(mesh, P(None, b_axes, "model", None, None), shp)
            return named(mesh, P(None, b_axes, None, "model", None), shp)
        if key.startswith(("xk", "xv")):           # whisper cross-attn K/V
            return named(mesh, P(None, b_axes, None, "model", None), shp)
        if key.startswith("wkv"):                   # rwkv (L,B,H,hd,hd_v)
            return named(mesh, P(None, b_axes, None, None, "model"), shp)
        if key.startswith("ssm_h"):                 # hymba (L,B,di,N)
            return named(mesh, P(None, b_axes, "model", None), shp)
        if key.startswith(("tm_prev", "cm_prev")):  # rwkv shifts (L,B,D)
            return named(mesh, P(None, b_axes, None), shp)
        if key.startswith("pos"):
            return named(mesh, P(b_axes), shp)
        return named(mesh, P(*([None] * len(shp))))

    return _map_with_path(visit, state_shape)


# --------------------------------------------------------------------------
# trees on a training mesh
# --------------------------------------------------------------------------

def _chunk(t: torch.Tensor, dim: int, names, mesh,
           coords: Optional[Mapping[str, int]] = None) -> torch.Tensor:
    """This rank's (or the rank at ``coords``') contiguous chunk of ``t``
    along ``dim`` over the axes ``names`` (the first the major one)."""
    coords = mesh.coords if coords is None else coords
    index, n = 0, 1
    for a in names:
        index = index * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"divide over {names}")
    size = t.shape[dim] // n
    return t.narrow(dim, index * size, size)


def _local(t: torch.Tensor, sharding: NamedSharding,
           axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """This rank's view of ``t`` split by ``sharding`` (over ``axes`` only,
    if given)."""
    for d, names in enumerate(sharding._split(t.shape)):
        names = [a for a in names if axes is None or a in axes]
        t = _chunk(t, d, names, sharding.mesh)
    return t


def shard_tree(tree, shardings):
    """Each whole leaf's slice on this rank (views: clone to free the
    whole)."""
    return tree_unflatten_like(tree, [
        _local(t, s) for t, s in zip(_leaves(tree), _leaves(shardings))])


def _leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def _kept_axes(path: str, mesh) -> Tuple[str, ...]:
    """The axes a leaf stays split over inside the training step."""
    return ("model",) if expert_parallel(path) and "model" in mesh.shape \
        else ()


def gather_leaf(path: str, t: torch.Tensor, s: NamedSharding, *,
                whole: bool = False) -> torch.Tensor:
    """One leaf as the training step computes with it: all-gathered over
    every axis it is split on, an expert leaf over all but ``model``; with
    ``whole``, the whole leaf (a checkpoint's)."""
    keep = () if whole else _kept_axes(path, s.mesh)
    for d, names in enumerate(s._split(t.shape)):
        # the innermost axis first: each gather joins whole chunks of the
        # axis outside it
        for a in reversed(names):
            if a not in keep:
                t = s.mesh.all_gather(t, a, d)
    return t


def _coords_of(mesh, rank: int) -> Dict[str, int]:
    """The coordinates of ``rank`` (row-major over the mesh's axes)."""
    out = {}
    for a in reversed(mesh.axis_names):
        rank, out[a] = divmod(rank, mesh.shape[a])
    return out


def gather_leaf_to_host0(t: torch.Tensor, s: NamedSharding
                         ) -> Optional[torch.Tensor]:
    """The whole leaf in rank 0's host memory, None on the other ranks.
    Each distinct shard (that of the ranks at coordinate 0 on every axis
    the leaf is not split over) is sent to rank 0 alone: no other rank
    receives or holds the whole leaf, and a replicated leaf moves
    nothing.  Every rank calls this, leaf by leaf in the same order."""
    mesh = s.mesh
    split = s._split(t.shape)
    used = {a for names in split for a in names}
    holders = [r for r in range(mesh.size)
               if all(c == 0 for a, c in _coords_of(mesh, r).items()
                      if a not in used)]
    if mesh.rank:
        if mesh.rank in holders:
            mesh.send(t, 0)
        return None
    whole = torch.empty(s.global_shape(tuple(t.shape)), dtype=t.dtype)
    for r in holders:
        view = whole
        for d, names in enumerate(split):
            view = _chunk(view, d, names, mesh, _coords_of(mesh, r))
        view.copy_(t if r == 0 else mesh.recv(t, r))
    return whole


def gather_tree(tree, shardings):
    """:func:`gather_leaf` of every leaf."""
    flat = tree_flatten_with_path(tree)
    return tree_unflatten_like(tree, [
        gather_leaf(_path_str(p), t, s)
        for (p, t), s in zip(flat, _leaves(shardings))])


def reduce_tree(grads, shardings):
    """The gradient of each leaf's shard from ``grads`` (laid out as
    :func:`gather_tree` gives the leaves): summed over the batch axes,
    which hold different rows, and cut to this rank's shard.  A leaf split
    over a batch axis is reduce-scattered over it, any other all-reduced;
    the cut over ``model`` (where every rank computed the same gradient)
    comes first, so the reductions move only this rank's share.  The sums
    run in the gradient's dtype, as GSPMD's reduction of it does."""
    def visit(p, g, s):
        mesh = s.mesh
        keep = _kept_axes(p, mesh)
        batch = [a for a in BATCH_AXES if a in mesh.shape]
        split = s._split(g.shape)
        for d, names in enumerate(split):
            if not any(a in batch for a in names):
                g = _chunk(g, d, [a for a in names if a not in keep], mesh)
        for d, names in enumerate(split):
            if any(a in batch for a in names):
                for a in names:
                    if a in batch:
                        g = mesh.reduce_scatter(g, a, d)
                    elif a not in keep:
                        g = _chunk(g, d, [a], mesh)
        used = {a for names in split for a in names}
        rest = [a for a in batch if a not in used]
        return mesh.all_reduce(g, rest) if rest else g.contiguous()

    flat = tree_flatten_with_path(grads)
    return tree_unflatten_like(grads, [
        visit(_path_str(p), g, s)
        for (p, g), s in zip(flat, _leaves(shardings))])


def batch_rows(batch: Mapping[str, torch.Tensor], mesh
               ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch, split over the batch axes as
    :func:`batch_shardings` splits them; the rows must divide."""
    axes = [a for a in BATCH_AXES if a in mesh.shape]
    n = math.prod(mesh.shape[a] for a in axes)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split over {axes} ({n}-way)")
        out[k] = _chunk(v, 0, axes, mesh)
    return out


# --------------------------------------------------------------------------
# sharded serving (tensor-parallel paged decode)
# --------------------------------------------------------------------------

#: the serving mesh's one axis (``launch.mesh.SERVING_AXIS``)
_AXIS = "model"


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
