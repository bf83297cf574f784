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
:func:`gather_leaf` (a whole leaf back, all-gathered),
:func:`gather_leaf_to_host0` (one whole leaf on rank 0 alone, for a
checkpoint), and :class:`TrainLayout` with :class:`Shards`: how a
training step gathers each leaf where it is used and reduces its
gradient as the backward leaves it; :class:`ServeLayout`, the same for a
serving step, with the decode state's windows.  Slices are contiguous
chunks, in the rank order of the axes, as JAX lays out a
``NamedSharding``.

The serving part: a model's ``tp_param_specs()`` and
``tp_pool_specs(store)`` give one :class:`P` per leaf; ``P(None, None,
"model", None)`` splits dimension 2 into ``n`` equal chunks, one per rank
of the one-axis serving mesh, exact by contract (a model declares
``tp_supported(n)`` only where every split divides).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import weakref
from collections.abc import Mapping as MappingABC
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

import torch

from ..tree import tree_flatten_with_path, tree_unflatten_like
from .collectives import (
    all_to_all,
    gather_sum_grads,
    reduce_scatter_over,
    sum_grads_over,
    sum_over,
)

__all__ = [
    "AbstractMesh",
    "NamedSharding",
    "P",
    "ServeLayout",
    "Shards",
    "TrainLayout",
    "batch_rows",
    "batch_shardings",
    "batch_specs",
    "decode_state_shardings",
    "expert_parallel",
    "fit_spec",
    "gather_leaf",
    "gather_shards",
    "gather_leaf_to_host0",
    "named",
    "opt_state_shardings",
    "param_shardings",
    "param_spec",
    "regather_saved_leaves",
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
    keeps split over ``model`` (expert parallelism) whether or not the
    rest of the model splits its work over it."""
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


def gather_leaf(t: torch.Tensor, s: NamedSharding) -> torch.Tensor:
    """The whole leaf from this rank's shard ``t``, all-gathered over every
    axis it is split on (a checkpoint's, a test's)."""
    for d, names in enumerate(s._split(t.shape)):
        # the innermost axis first: each gather joins whole chunks of the
        # axis outside it
        for a in reversed(names):
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


def batch_rows(batch: Mapping[str, torch.Tensor], mesh, *,
               seq_axis: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch, split over the batch axes as
    :func:`batch_shardings` splits them; the rows must divide.  With
    ``seq_axis`` (``"model"``), also this rank's columns of ``tokens``,
    ``targets`` and ``loss_mask`` over that axis, as ``batch_specs``
    splits them: the sequence is padded at its end to a multiple of the
    axis with masked tokens (a ``loss_mask`` of ones is made first where
    the batch has none), and the rank takes its equal chunk."""
    axes = [a for a in BATCH_AXES if a in mesh.shape]
    n = math.prod(mesh.shape[a] for a in axes)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split over {axes} ({n}-way)")
        out[k] = _chunk(v, 0, axes, mesh)
    if seq_axis is None or mesh.shape.get(seq_axis, 1) == 1:
        return out
    if "loss_mask" not in out:
        out["loss_mask"] = torch.ones(out["targets"].shape,
                                      dtype=torch.float32,
                                      device=out["targets"].device)
    m = mesh.shape[seq_axis]
    for k in ("tokens", "targets", "loss_mask"):
        v = out[k]
        pad = (-v.shape[1]) % m
        if pad:
            v = torch.nn.functional.pad(v, (0, pad))
        out[k] = _chunk(v, 1, [seq_axis], mesh)
    return out


# --------------------------------------------------------------------------
# gathered leaves saved for a backward with no recompute
# --------------------------------------------------------------------------

#: what the layer running under :func:`regather_saved_leaves` gathered:
#: storage key -> (shard, gathers, gathered shape)
_GATHERED: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_gathered", default=None)


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """``gather_sum_grads(t, mesh, axis, dim)``, noted where
    :func:`regather_saved_leaves` is in force: the result can be gathered
    again from ``t``'s shard (a gather of a gathered leaf chains)."""
    out = gather_sum_grads(t, mesh, axis, dim)
    gathered = _GATHERED.get()
    if gathered is not None:
        base, steps = t, ()
        entry = gathered.get(_storage_key(t))
        if entry is not None and t.is_contiguous() and \
                t.storage_offset() == 0 and tuple(t.shape) == entry[2]:
            base, steps = entry[0], entry[1]
        key = _storage_key(out)
        gathered[key] = (base, steps + ((mesh, axis, dim),),
                         tuple(out.shape))
        weakref.finalize(out.untyped_storage(), gathered.pop, key, None)
    return out


@dataclass
class _Regather:
    """A saved view of a gathered leaf, kept as the leaf's shard."""

    base: torch.Tensor
    steps: tuple
    size: torch.Size
    stride: Tuple[int, ...]
    offset: int

    def unpack(self) -> torch.Tensor:
        with torch.no_grad():
            t = self.base
            for mesh, axis, dim in self.steps:
                t = mesh.all_gather(t, axis, dim)
        return t.as_strided(self.size, self.stride, self.offset)


@contextlib.contextmanager
def regather_saved_leaves():
    """Within the block (one layer under ``remat="none"``), a tensor that
    autograd saves for the backward and that views one gathered here
    (a leaf, by :meth:`TrainLayout.leaf` or :meth:`TrainLayout.whole`, or
    what else ``whole`` gathers, as the hybrid's ``xc``) is kept as the
    rank's shard, and gathered again when the backward reads it.  So no
    whole leaf outlives the layer's forward, as under a checkpoint, at
    the cost of one more gather a saved tensor in the backward.  Every
    rank runs the same graph, so the backward gathers in the same order
    on every rank."""
    gathered: Dict[int, tuple] = {}

    def pack(t: torch.Tensor):
        entry = gathered.get(_storage_key(t))
        if entry is None:
            return t
        return _Regather(entry[0], entry[1], t.size(), t.stride(),
                         t.storage_offset())

    def unpack(x):
        return x.unpack() if isinstance(x, _Regather) else x

    token = _GATHERED.set(gathered)
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield
    finally:
        _GATHERED.reset(token)


# --------------------------------------------------------------------------
# the layout a training step computes in
# --------------------------------------------------------------------------

class TrainLayout:
    """How this rank's step computes with its shards, as the reference's
    GSPMD step lays it out (``models.common.mesh_context`` binds it).

    Every leaf is all-gathered where the model reads it, through
    :class:`Shards` (FSDP): a layer's leaves inside the function that
    ``remat_call`` checkpoints, so the recompute gathers them again and no
    whole layer outlives its use, the others (``embed``, ``final_norm``,
    ...) at their use.  Under each remat policy no whole leaf of a layer
    is kept for the backward: ``"full"`` keeps the layer's inputs alone;
    ``"dots"`` keeps its products' outputs and recomputes the gathers
    with the rest; ``"none"`` runs the layer under
    :func:`regather_saved_leaves`, which keeps a gathered leaf that
    autograd saves as its shard and gathers it again when the backward
    reads it.  A leaf is gathered over the batch axes it is
    split on, with the backward reduce-scattering the ranks' gradients
    (``gather_sum_grads``); over the batch axes it is not split on, its
    gradient is all-reduced.  So each leaf's gradient leaves the backward
    summed over the ranks and cut to this rank's shard: no reduction is
    left for the step.

    ``split_model`` (a ``model`` axis of more than one rank): the model
    splits its work over ``model``.  Its leaves keep their ``model``
    split (a rank's q heads, its slice of ``d_ff``, its experts, its
    slice of the vocabulary), the residual stream is this rank's
    ``chunk`` of the sequence (``seq_len`` padded to a multiple of the
    axis), and a leaf replicated over ``model`` has its gradient summed
    over it (each rank's gradient is its tokens' or its heads' part).
    Between the sequence's chunks and the batch's rows,
    :meth:`seq_to_rows` and :meth:`rows_to_seq` move a tensor (RWKV's
    recurrence runs on the rank's rows of the whole sequence); a second
    sequence (whisper's encoder frames) is chunked by :meth:`span` and
    :meth:`take_chunk`.
    """

    #: a serving step's layout (:class:`ServeLayout`) sets these
    serving = False
    decoding = False

    def __init__(self, mesh, shardings, *, seq_len: int = 0) -> None:
        self.mesh = mesh
        self.shardings = shardings
        self.model_size = mesh.shape.get("model", 1)
        self.split_model = self.model_size > 1
        self.seq_len = seq_len
        #: this rank's columns of the sequence: [seq_start, + chunk)
        self.chunk = -(-seq_len // self.model_size)
        self.rank = mesh.coords.get("model", 0)
        self.seq_start = self.rank * self.chunk

    def tree(self, params) -> "Shards":
        """``params`` (this rank's shards, laid out as ``shardings``) as
        the model reads them."""
        return Shards(self, params, self.shardings, "")

    def leaf(self, path: str, t: torch.Tensor,
             split: Sequence[Tuple[str, ...]], layer: bool = False
             ) -> torch.Tensor:
        """The shard ``t`` of the leaf at ``path``, split per dimension over
        the axes ``split``, as the step computes with it (``layer``: one
        layer's slice of a stacked leaf)."""
        mesh = self.mesh
        batch = [a for a in BATCH_AXES if a in mesh.shape]
        used = {a for names in split for a in names}
        sums = [a for a in batch if a not in used and mesh.shape[a] > 1]
        if self.split_model and "model" not in used:
            sums.append("model")
        if sums:
            t = sum_grads_over(t, mesh, sums)
        for d, names in enumerate(split):
            # the innermost axis first: each gather joins whole chunks of
            # the axis outside it
            for a in reversed(names):
                if mesh.shape[a] == 1:
                    continue
                if a in batch:
                    t = _gather(t, mesh, a, d)
        return t

    # -------------------------------------- the split over ``model``

    def part(self, full: int) -> Tuple[int, int]:
        """This rank's range ``[lo, hi)`` of a dimension of ``full``
        entries split over ``model``: equal chunks, the last ones short
        (or empty) where the axis does not divide."""
        n = -(-full // self.model_size)
        lo = min(self.rank * n, full)
        return lo, min(lo + n, full)

    def local(self, w: torch.Tensor, dim: int, full: int) -> torch.Tensor:
        """This rank's part of ``w`` along ``dim`` (``full`` entries whole):
        ``w`` itself where it is stored split over ``model``; where it is
        replicated (the split does not divide), a slice of it, whose
        gradient the layout sums over ``model``."""
        if not self.split_model or w.shape[dim] != full:
            return w
        lo, hi = self.part(full)
        return w.narrow(dim, lo, hi - lo)

    def whole(self, w: torch.Tensor, dim: int, full: int) -> torch.Tensor:
        """``w`` whole along ``dim``: all-gathered over ``model`` where it is
        stored split, the backward summing the ranks' gradients."""
        if not self.split_model or w.shape[dim] == full:
            return w
        return _gather(w, self.mesh, "model", dim)

    def gather_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole (padded) sequence from the ranks' chunks."""
        if not self.split_model:
            return x
        return gather_sum_grads(x, self.mesh, "model", dim)

    def scatter_seq(self, y: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The sum of the ranks' partial ``y`` over the whole sequence,
        this rank's chunk of it."""
        if not self.split_model:
            return y
        return reduce_scatter_over(y, self.mesh, "model", dim)

    def sum_parts(self, y: torch.Tensor) -> torch.Tensor:
        """The sum over ``model`` of the ranks' partial ``y`` (each the
        product of its slice of a contracted dimension), on every rank,
        which each then uses for its own part of the work."""
        if not self.split_model:
            return y
        return sum_over(y, self.mesh, ["model"])

    def span(self, length: int) -> Tuple[int, int]:
        """``(start, size)`` of this rank's chunk of a sequence of
        ``length`` positions padded at its end to a multiple of ``model``
        (``seq_start`` and ``chunk`` for the tokens)."""
        if not self.split_model:
            return 0, length
        size = -(-length // self.model_size)
        return self.rank * size, size

    def take_chunk(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's chunk (:meth:`span`) of ``x``, whole along ``dim``:
        zeros pad its end to a multiple of ``model``."""
        if not self.split_model:
            return x
        start, size = self.span(x.shape[dim])
        pad = size * self.model_size - x.shape[dim]
        if pad:
            x = torch.cat([x, x.new_zeros(
                (*x.shape[:dim], pad, *x.shape[dim + 1:]))], dim=dim)
        return x.narrow(dim, start, size)

    def rows_divide(self, rows: int) -> bool:
        """Whether ``model`` splits ``rows`` of the batch (dimension 0),
        as the reference's ``(("data", "model"), ...)`` constraint splits
        them; where it does not, ``fit_spec`` drops the axis and every
        ``model`` rank takes all the rows."""
        return self.split_model and rows % self.model_size == 0

    def seq_to_rows(self, x: torch.Tensor) -> torch.Tensor:
        """From this rank's chunk of the sequence of all its rows, ``x``
        ``(B, chunk, ...)``, to its rows of the whole (padded) sequence,
        ``(B / model, chunk · model, ...)``: an all-to-all over
        ``model``.  Where ``model`` does not divide B, every ``model``
        rank takes all the rows: the sequence gathered."""
        if not self.split_model:
            return x
        if not self.rows_divide(x.shape[0]):
            return self.gather_seq(x)
        return all_to_all(x, self.mesh, "model", 0, 1)

    def rows_to_seq(self, y: torch.Tensor, rows: int) -> torch.Tensor:
        """:meth:`seq_to_rows`'s inverse for a batch of ``rows``: from this
        rank's rows of the whole sequence back to its chunk of all the
        rows (where every rank held all the rows, its chunk of them)."""
        if not self.split_model:
            return y
        if not self.rows_divide(rows):
            return y.narrow(1, self.seq_start, self.chunk)
        return all_to_all(y, self.mesh, "model", 1, 0)


#: the embedding tables, which a serving step reads only through
#: ``models.common``'s mesh helpers (``mesh_embedding``, ``mesh_scores``,
#: ``mesh_columns``)
TABLES = ("embed", "unembed", "pos_embed")


class ServeLayout(TrainLayout):
    """How a serving rank computes a family's prefill or decode step with
    its shards, as the reference's serving cell lays it out
    (``launch/dryrun.py``'s ``build_cell``, the models' ``constrain``
    sites); ``models.common.mesh_context`` binds it.  No gradients.

    The weights rest as ``shardings`` gives them (``param_shardings``,
    training or serving rules).  A leaf is all-gathered where the model
    reads it (:class:`Shards`; a layer's leaves when the layer runs, so a
    rank holds one layer's gathered weights at a time): over the batch
    axes it is split on, and over ``model`` unless its ``model`` split is
    one the work is split by, the training rules' (a rank's q heads, its
    slice of ``d_ff`` or ``d_inner``, its experts, its slice of the
    vocabulary).  An embedding table (``TABLES``) keeps its ``model``
    split whichever dimension it is on: ``models.common``'s mesh helpers
    look rows up and score on the split table.  The serving rules re-home a dense leaf's FSDP split onto
    ``model`` where that axis is free (``wk``/``wv`` on ``D``, ``wq``/``wo``
    where the heads do not divide): such a leaf is gathered whole where it
    is read.

    Prefill (``decoding`` False): the residual stream is this rank's
    chunk of the sequence of ``seq_len`` tokens padded to a multiple of
    ``model``, as in training.  A decode step (``decoding`` True): every
    ``model`` rank holds the same lanes whole, :meth:`gather_seq` is the
    identity and :meth:`scatter_seq` the sum over ``model``.

    The decode state is this rank's shard of
    ``decode_state_shardings(layout=cache_layout)`` of ``state_shape``
    (the family's ``init_decode_state`` on ``meta``): :meth:`window` gives
    each leaf's ``[lo, hi)`` along a dimension, read off that spec, so the
    layout and the state's sharding cannot disagree.  The cache's rows
    (``seq``, ``cache_rows``) or kv heads (``heads``, ``cache_heads``),
    whisper's cross K/V by heads, RWKV's ``wkv`` by ``hd_v`` and the
    hybrid's ``ssm_h`` by ``d_inner``, each split over ``model`` only where
    the axis divides it (``fit_spec``); else the leaf is whole on every
    rank, as the reference's is.
    """

    serving = True

    def __init__(self, mesh, shardings, *, state_shape: Mapping[str, Any],
                 max_seq: int, seq_len: int = 0, cache_layout: str = "seq",
                 decoding: bool = False, heads_divisible: bool = True
                 ) -> None:
        if cache_layout not in ("seq", "heads"):
            raise ValueError(f"cache layout {cache_layout!r}: seq or heads")
        super().__init__(mesh, shardings, seq_len=seq_len)
        self.decoding = bool(decoding)
        self.max_seq = max_seq
        self.cache_layout = cache_layout
        self.heads_divisible = heads_divisible
        specs = decode_state_shardings(state_shape, mesh, layout=cache_layout,
                                       batch_divisible=False)
        M, r = self.model_size, self.rank
        self._windows: Dict[str, Tuple[Tuple[int, int], ...]] = {}
        for key, leaf in state_shape.items():
            split = specs[key]._split(tuple(leaf.shape))
            self._windows[key] = tuple(
                (r * (n // M), (r + 1) * (n // M)) if "model" in names
                else (0, n) for n, names in zip(leaf.shape, split))
        self._work_dims: Dict[str, frozenset] = {}

    def window(self, key: str, dim: int) -> Tuple[int, int]:
        """``[lo, hi)`` of this rank's shard of the decode-state leaf
        ``key`` along ``dim``."""
        return self._windows[key][dim]

    @property
    def cache_rows(self) -> Tuple[int, int]:
        """This rank's rows of the attention cache (its ``window`` of
        ``cache_k`` along the sequence)."""
        return self.window("cache_k", 2)

    @property
    def cache_heads(self) -> Tuple[int, int]:
        """This rank's kv heads of the attention cache."""
        return self.window("cache_k", 3)

    def cut(self, w: torch.Tensor, dim: int, full: int,
            window: Tuple[int, int]) -> torch.Tensor:
        """Entries ``window`` of ``w`` along ``dim`` (``full`` whole): the
        stored ``model`` shard where that is the window, else a slice of
        ``w`` whole (gathered where it is stored split)."""
        lo, hi = window
        if w.shape[dim] != full:
            if (lo, hi) == self.part(full) and w.shape[dim] == hi - lo:
                return w
            w = self.whole(w, dim, full)
        return w.narrow(dim, lo, hi - lo)

    def product(self, x: torch.Tensor, w: torch.Tensor, full: int
                ) -> torch.Tensor:
        """``x @ w`` with all ``full`` columns: where ``w`` rests split over
        ``model`` by its columns, each rank's product with its own,
        all-gathered (``x``'s rows by ``full``, not ``w``)."""
        y = x @ w
        if w.shape[-1] == full:
            return y
        return self.mesh.all_gather(y, "model", y.dim() - 1)

    @property
    def rows_split(self) -> bool:
        """Whether this rank's cache holds only some of the rows."""
        return self.cache_rows[1] - self.cache_rows[0] < self.max_seq

    def _model_work_dims(self, path: str, t: torch.Tensor,
                         split: Sequence[Tuple[str, ...]], layer: bool
                         ) -> frozenset:
        """The dimensions of the leaf at ``path`` whose ``model`` split the
        work keeps: those the training rules split over ``model``."""
        if path not in self._work_dims and path in TABLES:
            self._work_dims[path] = frozenset(range(t.dim()))
        if path not in self._work_dims:
            mesh = self.mesh
            whole = tuple(n * math.prod(mesh.shape[a] for a in names)
                          for n, names in zip(t.shape, split))
            spec = fit_spec(mesh, param_spec(
                path, t.dim() + layer,
                heads_divisible=self.heads_divisible), (1,) * layer + whole)
            self._work_dims[path] = frozenset(
                d - layer for d, e in enumerate(spec)
                if "model" in _names(e))
        return self._work_dims[path]

    def leaf(self, path: str, t: torch.Tensor,
             split: Sequence[Tuple[str, ...]], layer: bool = False
             ) -> torch.Tensor:
        keep = self._model_work_dims(path, t, split, layer)
        for d, names in enumerate(split):
            # the innermost axis first, as TrainLayout.leaf
            for a in reversed(names):
                if self.mesh.shape[a] > 1 and not (a == "model" and d in keep):
                    t = self.mesh.all_gather(t, a, d)
        return t

    def gather_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return x if self.decoding else super().gather_seq(x, dim)

    def scatter_seq(self, y: torch.Tensor, dim: int = 1) -> torch.Tensor:
        if not self.decoding:
            return super().scatter_seq(y, dim)
        return self.mesh.all_reduce(y, ["model"]) if self.split_model else y

    def row(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Row ``i`` of the sequence (dimension 1) from the rank whose chunk
        holds it, on every rank (the others add zeros: exact)."""
        if not self.split_model:
            return x[:, i]
        owner, at = divmod(i, self.chunk)
        mine = x[:, at] if self.rank == owner else torch.zeros_like(x[:, 0])
        return self.mesh.all_reduce(mine, ["model"])


class Shards(MappingABC):
    """A tree of this rank's shards that gathers a leaf where the model
    reads it (:meth:`TrainLayout.leaf`).  Reading a subtree gives its
    :class:`Shards`; :meth:`unstack` splits stacked layers into per-layer
    trees (``models.common.unstack_layers`` calls it), whose leaves are
    gathered when the layer reads them.  A leaf read twice is gathered
    twice."""

    def __init__(self, layout: TrainLayout, tree, shardings, path: str,
                 layer: bool = False) -> None:
        self._layout, self._tree, self._shardings = layout, tree, shardings
        self._path, self._layer = path, layer

    def __getitem__(self, key):
        value, s = self._tree[key], self._shardings[key]
        path = f"{self._path}/{key}" if self._path else str(key)
        if isinstance(value, Mapping):
            return Shards(self._layout, value, s, path, self._layer)
        split = s._split((1,) * (value.dim() + self._layer))
        return self._layout.leaf(path, value, split[self._layer:],
                                 self._layer)

    def __iter__(self) -> Iterator:
        return iter(self._tree)

    def __len__(self) -> int:
        return len(self._tree)

    def unstack(self, L: int) -> List["Shards"]:
        """One tree per layer of stacked ``(L, ...)`` leaves, each leaf
        unbound once (its backward stacks the L gradients once)."""
        from ..models.common import unstack_layers

        return [Shards(self._layout, t, self._shardings, self._path,
                       layer=True)
                for t in unstack_layers(self._tree, L)]


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
