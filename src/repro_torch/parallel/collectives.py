"""Collectives of tensor-parallel serving, of the expert-parallel MoE
block, and compressed gradient reduction.

The counterpart of ``repro/parallel/collectives.py`` over
``torch.distributed``.  ``maybe_psum`` is the one cross-shard operation of
a tensor-parallel model step: the shard workers of a serving mesh
(:mod:`repro_torch.launch.mesh`) bind their process group to the axis
name with :func:`bind_axis` around each step, and a model body that calls
``maybe_psum`` after a row-sharded product then sums the partial products
over the group; with no group bound (one device, training, the tests) it
is the identity, as the reference's is under plain ``jit``.

The differentiable collectives of a training step run over the axes of a
training mesh (``launch.mesh.TrainMesh``); their backward passes are
those of ``shard_map``'s transpose.  :func:`gather_sum_grads` is the
all-gather of chunks that the ranks use differently (a weight's FSDP
shards over ``data``, whose ranks hold other rows; the sequence-parallel
residual over ``model``, whose ranks take other heads or another slice of
``d_ff``): its backward reduce-scatters the sum of the ranks' gradients.
:func:`reduce_scatter_over` is its transpose: the sum of the ranks'
partial products, this rank's chunk of it, and the gradient all-gathered.
:func:`sum_grads_over` is the identity whose gradient is
summed over the axes (a weight each rank applied to its own tokens or
heads); :func:`sum_over` sums the ranks' partial products into a whole
that each rank then uses differently (the hybrid's ``xc @ w_B`` over its
slice of ``d_inner``), so its backward sums the gradients too;
:func:`mean_over` averages a value over the axes, and
:func:`scale_grad` divides the gradient of a value each rank computed
whole; :func:`all_to_all` is ``jax.lax.all_to_all(tiled=True)``, its own
transpose with the two dimensions swapped.

:func:`softmax_over` is a serving step's one collective of its own: the
softmax of a decode step's scores over a cache whose rows are split over
``model`` (``models.attention.decode_attn``), no gradient.

``compressed_psum`` is the int8 all-reduce for the bandwidth-starved hop:
every member all-gathers the per-block int8 payloads and scales and sums
the dequantized blocks itself.  ``ErrorFeedback`` carries the quantization
residual into the next step's gradient.  ``compressed_grad_tree`` applies
it over one named dimension of a ``DeviceMesh``.  As in the reference,
nothing calls it: the reference's trainer reduces gradients at full
precision.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Optional

import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_map, tree_unflatten_like

__all__ = ["BLOCK", "ErrorFeedback", "all_to_all", "bind_axis",
           "bound_group", "compressed_grad_tree", "compressed_psum",
           "dequantize_int8", "gather_sum_grads", "maybe_psum",
           "mean_over", "quantize_int8", "reduce_scatter_over", "scale_grad",
           "softmax_over", "sum_grads_over", "sum_over"]

BLOCK = 256

#: axis name -> the process group a shard step bound to it
_BOUND: contextvars.ContextVar[Dict[str, object]] = contextvars.ContextVar(
    "repro_torch_bound_axes", default={})


@contextlib.contextmanager
def bind_axis(axis_name: str, group) -> Iterator[None]:
    """Within the block, ``maybe_psum(x, axis_name)`` all-reduces over
    ``group`` (the reference's axis bound by ``shard_map``)."""
    token = _BOUND.set({**_BOUND.get(), axis_name: group})
    try:
        yield
    finally:
        _BOUND.reset(token)


def bound_group(axis_name: str = "model"):
    """The group bound to ``axis_name`` here, or None."""
    return _BOUND.get().get(axis_name)


def maybe_psum(x: torch.Tensor, axis_name: str = "model") -> torch.Tensor:
    """The sum of ``x`` over the group bound to ``axis_name``, or ``x``
    itself when none is bound.

    Model bodies call this after every row-sharded product, so one
    definition serves both modes.  Integer operands sum exactly, which is
    what lets the sharded-against-unsharded tests of the integer ``ToyLM``
    demand byte equality.  The sum goes into a new tensor; ``x`` is not
    written.
    """
    group = bound_group(axis_name)
    if group is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


# ------------------------------------------ a training step's collectives


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return mesh.reduce_scatter(g, axis, dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return mesh.reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return mesh.all_gather(g, axis, dim), None, None, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return mesh.all_reduce(g, axes), None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return mesh.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return mesh.all_reduce(g, axes), None, None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        ctx.n = n
        return mesh.all_reduce(x, axes) / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return mesh.all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return (mesh.all_to_all(g.contiguous(), axis, concat_dim, split_dim),
                None, None, None, None)


def gather_sum_grads(x: torch.Tensor, mesh, axis: str, dim: int
                     ) -> torch.Tensor:
    """The ranks' chunks joined along ``dim``; the backward reduce-
    scatters the ranks' gradients (each rank used the whole differently,
    so this rank's chunk's gradient is the sum of theirs)."""
    return _GatherSum.apply(x, mesh, axis, dim)


def reduce_scatter_over(x: torch.Tensor, mesh, axis: str, dim: int
                        ) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``x`` over the ranks
    of ``axis`` (partial products); the backward all-gathers."""
    return _ReduceScatter.apply(x, mesh, axis, dim)


def sum_grads_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x``, with its gradient summed over the ranks of ``axes``."""
    return _SumGrads.apply(x, mesh, tuple(axes))


def sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over ``axes``, on every rank;
    each rank uses the sum differently, so the backward sums the ranks'
    gradients as well."""
    return _Sum.apply(x, mesh, tuple(axes))


def mean_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``axes`` (``jax.lax.pmean``)."""
    return _Mean.apply(x, mesh, tuple(axes))


def scale_grad(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x``, with its gradient divided by ``n``."""
    return _ScaleGrad.apply(x, n)


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``,
    differentiable."""
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


# ------------------------------------------------ a serving step's softmax


def softmax_over(s: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``torch.softmax(s, -1)`` where the last dimension of ``s`` is split
    over the ranks of ``axis``, each holding its columns: the rows' max,
    then the sums of their exponentials, all-reduced over the axis in
    fp32.  Returns this rank's columns of the weights, already divided by
    the global sum (the reference's ``jax.nn.softmax`` over the whole row;
    no later rescale)."""
    s = s.float()
    m = mesh.all_reduce(s.amax(dim=-1, keepdim=True), [axis], op="max")
    e = torch.exp(s - m)
    return e / mesh.all_reduce(e.sum(dim=-1, keepdim=True), [axis])


# ------------------------------------------------ compressed reduction


def quantize_int8(x: torch.Tensor, block: int = BLOCK):
    """Flat per-block symmetric int8 quantization → (q, scales, pad)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block).to(torch.float32)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, pad


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, pad: int, shape):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8 all-gather + local dequantize-and-sum ≅ the sum of ``x`` over
    ``group`` (the default group if None), with ~3.5x less wire than a
    bf16 all-reduce.  Every member reconstructs the sum itself."""
    q, scale, pad = quantize_int8(x)
    n = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(ss, scale, group=group)
    total = torch.sum(torch.stack(qs).to(torch.float32) * torch.stack(ss),
                      dim=0)
    flat = total.reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(x.shape).to(x.dtype)


class ErrorFeedback:
    """Residual accumulator for biased compressed reductions."""

    @staticmethod
    def init(tree):
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                              device=g.device), tree)

    @staticmethod
    def apply(grads, residual):
        """Returns (corrected_grads, fn(compressed) -> new_residual)."""
        corrected = tree_unflatten_like(grads, [
            g.to(torch.float32) + r
            for g, r in zip(tree_leaves(grads), tree_leaves(residual))])

        def update(compressed):
            return tree_unflatten_like(compressed, [
                co - c.to(torch.float32)
                for c, co in zip(tree_leaves(compressed),
                                 tree_leaves(corrected))])

        return corrected, update


def compressed_grad_tree(grads, mesh, axis_name: str = "pod"):
    """Compressed sum of a gradient tree over one dimension of ``mesh`` (a
    ``DeviceMesh``), called on every rank; the tree unchanged when there
    is no mesh or it has no dimension of that name."""
    names: Optional[tuple] = getattr(mesh, "mesh_dim_names", None)
    if mesh is None or not names or axis_name not in names:
        return grads
    group = mesh.get_group(axis_name)
    return tree_map(lambda g: compressed_psum(g, group), grads)
