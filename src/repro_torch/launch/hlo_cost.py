"""Static cost of a step, counted over its aten operations.

The counterpart of ``repro/launch/hlo_cost.py``, under the same name.  The
reference parses a compiled module's HLO text and re-derives the three
roofline terms from it, multiplying each ``while`` body by its trip count.
Here a step is run once under :class:`CostMode`, a dispatch mode that
counts every aten operation as it is dispatched and keeps no graph, so a
trace of millions of operations holds no more memory than the step
itself.  Run over fake tensors (``FakeTensorMode``) it costs a step of any
size without a card; run over real tensors it counts what the real step
dispatches.

Per operation, times the multiplier in force (:meth:`CostMode.scaled`):

* **FLOPs**: products and convolutions from their shapes, by the
  Sentry's rules (``core.sentry.product_flops`` / ``conv_flops``: one
  copy of each).  The plain routes reach no fused attention
  (``aten._scaled_dot_product_*``) and no convolution backward, so no
  rule counts them.  Elementwise work is not counted, as the reference's
  HLO count and ``torch.utils.flop_counter`` count none.  Kept by the
  products' dtype, since the card's peak differs by dtype.
* **HBM bytes**, two counts.  ``bytes_eager``: every operation's operands
  and results (``core.sentry.tensor_bytes``), what this eager code moves;
  views and ``empty`` move nothing.  ``bytes``: the reference's fused
  rule: elementwise operations, dtype conversions, concatenation and
  padding charge nothing (``_FUSIBLE_ELEMENTWISE`` at
  ``repro/launch/hlo_cost.py``); a slice is a view whose consumer reads
  only its window; a gather charges twice its result and its indices;
  an in-place update (``index_put_``, ``copy_``, scatter) twice its
  update; never more than the eager count of the same operation.  The
  roofline's memory term uses ``bytes``, so that its bound stays a lower
  bound.
* **Collectives**: ``c10d`` operations by the size of their group, with
  the reference's ring-adjusted wire bytes (:func:`wire_bytes`), and by
  link: a group whose ranks lie in one node of :data:`NODE_CARDS` cards
  rides NVLink, any other the network.
* **Control flow**: the body of a ``scan`` is counted once times its
  length, as the reference multiplies a ``while`` body by its trip count;
  both branches of a ``cond`` once, as the reference counts every branch
  of a ``conditional``; a ``while_loop`` on real tensors by the trips it
  makes (on fake ones its trip count is data the trace lacks, and it
  raises).
* **Token loops**: a function marked :func:`token_loop` (the plain
  per-token recurrences of RWKV6 and the hybrid's SSM) runs, when the mode
  was given ``loop_chunk``, on its first ``loop_chunk`` tokens with every
  count multiplied by ``T / loop_chunk``, forward and backward, and its
  per-token outputs widened to T: its cost is linear in T, and the trace of
  a 32k-token prefill is then thousands of operations, not millions.
  A loop that checkpoints its chunks under grad (the scans' 64-token
  chunks) runs them so on its ``loop_chunk`` tokens too: the chunks'
  recompute in the backward is counted, scaled alike, and the boundary
  states its backward keeps are charged ``T / loop_chunk`` times.
* **Peak memory**: each new storage an operation returns is live until
  its storage is freed; the peak over the step, plus what the caller
  declares resident (parameters, state), is ``peak_bytes``.  A chunked
  token loop charges the tensors its backward saves ``T / loop_chunk``
  times, as the whole loop would hold them.

The constants are datasheet figures for one NVIDIA H100 SXM 80GB (700 W),
not measurements: :data:`PEAK_FLOPS` (dense, per dtype), :data:`HBM_BW`,
:data:`NVLINK_BW` (per direction per card inside a node of 8) and
:data:`NET_BW` (per card across nodes, 400 Gb/s).
"""

from __future__ import annotations

import contextlib
import functools
import math
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)

from ..core.sentry import (
    PRODUCTS,
    conv_flops,
    primitive_name,
    product_flops,
    tensor_bytes,
)

__all__ = ["CostMode", "HBM_BW", "HloCost", "NET_BW", "NODE_CARDS",
           "NVLINK_BW", "PEAK_FLOPS", "analyze_graph", "token_loop",
           "wire_bytes"]

# ---- one NVIDIA H100 SXM 80GB at 700 W: datasheet figures ---------------
#: dense peak FLOP/s by the products' dtype (fp32 off the tensor cores)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
#: HBM3 bytes/s
HBM_BW = 3.35e12
#: NVLink bytes/s per direction per card, inside a node
NVLINK_BW = 450e9
#: network bytes/s per card across nodes (400 Gb/s)
NET_BW = 50e9
#: cards per node (an HGX H100 board)
NODE_CARDS = 8

#: ``c10d`` operations by the reference's HLO names: those a training
#: mesh runs (``launch.mesh.TrainMesh``) and send/recv
_COLLECTIVES = {
    "c10d.allreduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}

#: operations that move no bytes: tensor metadata, allocation without a
#: write, aliases (views are found by their schema)
_FREE = frozenset({
    "prim.device", "prim.dtype", "prim.layout", "aten.empty",
    "aten.empty_strided", "aten.empty_like", "aten.new_empty",
    "aten.new_empty_strided", "aten.detach", "aten.alias", "aten.lift_fresh",
    "aten._local_scalar_dense",
})

#: operations a fusing compiler folds into their producers and consumers,
#: besides every operation tagged pointwise: the reference's
#: ``_FUSIBLE_ELEMENTWISE`` convert, concatenate, pad, iota and broadcast
#: of a constant
_FUSIBLE = frozenset({
    "aten._to_copy", "aten.cat", "aten.stack", "aten.constant_pad_nd",
    "aten.arange", "aten.full", "aten.zeros", "aten.zeros_like",
    "aten.new_zeros", "aten.ones_like", "aten.scalar_tensor",
})

#: gathers: twice the result (the window read, then written) and the
#: indices
_GATHERS = frozenset({"aten.index", "aten.index_select", "aten.gather",
                      "aten.embedding"})

#: in-place updates and their autograd counterparts: twice the update, by
#: its position among the operands
_UPDATES = {"aten.index_put_": 2, "aten.index_put": 2, "aten.copy_": 1,
            "aten.scatter": 3, "aten.scatter_add": 3,
            "aten.select_backward": 0, "aten.slice_backward": 0}


def wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Ring-adjusted bytes one rank sends for a collective over ``n``
    ranks (the reference's ``_wire_bytes``): ``nbytes`` is the reduced
    tensor, the gathered result, the scattered result or the exchanged
    buffer."""
    n = max(n, 2)
    if kind == "all-reduce":
        return 2.0 * nbytes * (n - 1) / n
    if kind == "all-gather":
        return nbytes * (n - 1) / n
    if kind == "reduce-scatter":
        return nbytes * (n - 1)
    if kind == "all-to-all":
        return nbytes * (n - 1) / n
    return nbytes                               # collective-permute


@dataclass
class HloCost:
    """What :class:`CostMode` counted: the reference's fields (``flops``,
    ``bytes``, ``wire_bytes``, ``collectives``, ``while_trip_counts``)
    and the port's (``bytes_eager``, FLOPs by dtype, wire bytes by link,
    the peak and the resident bytes, the operations counted)."""

    flops: float = 0.0
    bytes: float = 0.0
    wire_bytes: float = 0.0
    collectives: Dict[str, Dict[str, float]] = field(default_factory=dict)
    while_trip_counts: List[int] = field(default_factory=list)
    bytes_eager: float = 0.0
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)
    wire_by_link: Dict[str, float] = field(default_factory=dict)
    peak_bytes: float = 0.0
    resident_bytes: float = 0.0
    ops: int = 0

    def roofline(self) -> Dict[str, Any]:
        """The three terms on the H100 constants, the dominant one and
        the step's lower bound, in seconds."""
        compute_s = sum(f / PEAK_FLOPS.get(getattr(torch, d, None),
                                           PEAK_FLOPS[torch.float32])
                        for d, f in self.flops_by_dtype.items())
        memory_s = self.bytes / HBM_BW
        collective_s = (self.wire_by_link.get("nvlink", 0.0) / NVLINK_BW
                        + self.wire_by_link.get("network", 0.0) / NET_BW)
        terms = {"compute": compute_s, "memory": memory_s,
                 "collective": collective_s}
        dominant = max(terms, key=terms.get)
        return {"compute_s": compute_s, "memory_s": memory_s,
                "collective_s": collective_s, "dominant": dominant,
                "step_s_lower_bound": terms[dominant]}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _process_group(args) -> Any:
    """The ``ProcessGroup`` among a ``c10d`` operation's operands."""
    from torch._C._distributed_c10d import ProcessGroup

    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                "ProcessGroup" in a._type().qualified_name():
            return ProcessGroup.unbox(a)
    return None


class CostMode(TorchDispatchMode):
    """Counts the operations dispatched on this thread (and on the threads
    autograd runs its backward on) into :attr:`cost`.

    ``loop_chunk``: the tokens a :func:`token_loop` runs on before its
    counts are scaled to its length (None: every loop whole).
    ``resident``: tensors live before the step (parameters, optimizer and
    decode state, the batch), counted in the peak and never freed by it.
    """

    supports_higher_order_operators = True

    @classmethod
    def ignore_compile_internals(cls) -> bool:
        # torch's eager cond/scan/while_loop run through torch.compile;
        # see ``core.sentry._Recorder``
        return True

    def __init__(self, *, loop_chunk: Optional[int] = None,
                 resident: Iterable[torch.Tensor] = ()) -> None:
        super().__init__()
        self.cost = HloCost()
        self.loop_chunk = loop_chunk
        self._scale = 1.0
        self._paused = False
        self._live = 0.0
        self._held: Dict[int, float] = {}      # storage -> bytes charged
        self._resident: set = set()
        for t in resident:
            self._hold_resident(t)

    # ------------------------------------------------------- regions

    @contextlib.contextmanager
    def scaled(self, factor: float):
        """Counts inside the block are multiplied by ``factor``."""
        prev, self._scale = self._scale, self._scale * factor
        try:
            yield
        finally:
            self._scale = prev

    @contextlib.contextmanager
    def paused(self):
        """Operations inside the block are not counted (their memory is)."""
        prev, self._paused = self._paused, True
        try:
            yield
        finally:
            self._paused = prev

    # ------------------------------------------------------- memory

    def _hold_resident(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._resident:
            return
        self._resident.add(key)
        self.cost.resident_bytes += st.nbytes()
        self._live += st.nbytes()
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)

    def _release(self, key: int) -> None:
        self._live -= self._held.pop(key, 0.0)

    def _track(self, out: Any) -> None:
        for t in pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held or key in self._resident:
                continue
            nbytes = float(st.nbytes())
            self._held[key] = nbytes
            self._live += nbytes
            weakref.finalize(st, self._release, key)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)

    def inflate(self, t: torch.Tensor, factor: float) -> None:
        """Charge ``t``'s storage ``factor`` times (once)."""
        key = t.untyped_storage()._cdata
        if key in self._held and factor > 1:
            base = float(t.untyped_storage().nbytes())
            if self._held[key] <= base:
                self._held[key] = base * factor
                self._live += base * (factor - 1)
                self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)

    # ------------------------------------------------------- counting

    def _count(self, name: str, func, args, kwargs, out) -> None:
        c, k = self.cost, self._scale
        c.ops += 1
        if name in _FREE or getattr(func, "is_view", False):
            return
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            self._collective(kind, name, args)
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        flops = self._flops(name, args, outs)
        if flops:
            d = _dtype_name(ins[0].dtype) if ins else "float32"
            c.flops += k * flops
            c.flops_by_dtype[d] = c.flops_by_dtype.get(d, 0.0) + k * flops
        eager = tensor_bytes(ins) + tensor_bytes(outs)
        c.bytes_eager += k * eager
        c.bytes += k * min(eager, self._fused_bytes(func, name, args, outs,
                                                    eager))

    @staticmethod
    def _flops(name: str, args, outs) -> float:
        if name in PRODUCTS:
            return product_flops(tuple(args[-2].shape), tuple(args[-1].shape))
        if name == "aten.convolution":
            return conv_flops(outs[0].numel(), tuple(args[1].shape))
        return 0.0

    @staticmethod
    def _fused_bytes(func, name: str, args, outs, eager: float) -> float:
        if name in _FUSIBLE or torch.Tag.pointwise in func.tags:
            return 0.0
        if name == "aten.clone":
            return tensor_bytes(outs)             # a layout change: one write
        if name in _GATHERS:
            idx = [t for t in pytree.tree_leaves(args[1:])
                   if isinstance(t, torch.Tensor)]
            return 2.0 * tensor_bytes(outs) + tensor_bytes(idx)
        pos = _UPDATES.get(name)
        if pos is not None and pos < len(args):
            upd = [t for t in pytree.tree_leaves(args[pos])
                   if isinstance(t, torch.Tensor)]
            return 2.0 * tensor_bytes(upd)
        return eager

    def _collective(self, kind: str, name: str, args) -> None:
        import torch.distributed as dist

        pg = _process_group(args)
        n = pg.size() if pg is not None else 1
        # the result: every output of a list all-gather, else the first
        # operand (the base collectives' output, the tensor reduced, sent
        # or received)
        out = pytree.tree_leaves(args[0])
        nbytes = tensor_bytes(out if name == "c10d.allgather_" else out[:1])
        wire = self._scale * wire_bytes(kind, nbytes, n)
        ranks = dist.get_process_group_ranks(pg) if pg is not None else [0]
        link = ("nvlink" if len({r // NODE_CARDS for r in ranks}) == 1
                else "network")
        c = self.cost
        c.wire_bytes += wire
        c.wire_by_link[link] = c.wire_by_link.get(link, 0.0) + wire
        d = c.collectives.setdefault(kind, {"count": 0, "wire": 0.0})
        d["count"] += self._scale
        d["wire"] += wire

    # ------------------------------------------------------- dispatch

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return self._control_flow(func, args, kwargs)
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(primitive_name(func), func, args, kwargs, out)
        self._track(out)
        return out

    def _control_flow(self, func, args, kwargs):
        """Counts a body by the trips it makes, then runs the operator
        uncounted (the mode below, fake or real, computes its result)."""
        name = func.name()
        with self:
            if name == "scan":
                combine_fn, init, xs, additional = args
                trips = xs[0].shape[0] if xs else 1
                with self.scaled(trips):
                    combine_fn(*init, *[x.select(0, 0) for x in xs],
                               *additional)
                self.cost.while_trip_counts.append(trips)
            elif name == "cond":
                pred, true_fn, false_fn, operands = args
                true_fn(*operands)
                false_fn(*operands)
            elif name == "while_loop":
                cond_fn, body_fn, carried, additional = args
                carried, trips = tuple(carried), 0
                with self.paused():
                    go = cond_fn(*carried, *additional)
                if _is_fake(go):
                    raise ValueError(
                        "a while_loop's trip count depends on data a fake "
                        "trace does not hold")
                while bool(go):
                    carried = tuple(body_fn(*carried, *additional))
                    trips += 1
                    with self.paused():
                        go = cond_fn(*carried, *additional)
                self.cost.while_trip_counts.append(trips)
                return carried
            else:
                raise RuntimeError(
                    f"higher-order operator {name!r} cannot be costed")
        out = func(*args, **kwargs)        # this mode is off in here
        self._track(out)
        return out


def _is_fake(t: Any) -> bool:
    from torch._subclasses.fake_tensor import is_fake

    return isinstance(t, torch.Tensor) and is_fake(t)


def _active() -> Optional[CostMode]:
    """The :class:`CostMode` in force on this thread, if any (the dispatch
    mode stack, unlike a context variable, follows autograd onto the
    threads it runs a backward on)."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostMode):
            return mode
    return None


def analyze_graph(fn: Callable, args: Sequence[Any] = (),
                  kwargs: Optional[Dict[str, Any]] = None, *,
                  loop_chunk: Optional[int] = None,
                  resident: Iterable[torch.Tensor] = ()):
    """``fn(*args, **kwargs)`` under a :class:`CostMode`: (its
    :class:`HloCost`, its result).  ``args``' tensors are resident, as are
    those of ``resident``.  Run it inside a ``FakeTensorMode`` (with fake
    ``args``) to cost a step without running it."""
    held = [t for t in pytree.tree_leaves((args, kwargs or {}))
            if isinstance(t, torch.Tensor)] + list(resident)
    mode = CostMode(loop_chunk=loop_chunk, resident=held)
    with mode:
        out = fn(*args, **(kwargs or {}))
    mode.cost.while_trip_counts.sort(reverse=True)
    return mode.cost, out


# ---------------------------------------------------------------- loops


def token_loop(per_token: Sequence[int], per_token_out: Sequence[int]):
    """Marks a function whose work is linear in its token axis (dim 1 of
    the operands at ``per_token`` and of the results at
    ``per_token_out``): under a :class:`CostMode` with a ``loop_chunk``
    shorter than its inputs it is counted on one chunk and scaled (see the
    module's docstring); otherwise it runs as written."""
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            mode = _active()
            if mode is None or mode.loop_chunk is None:
                return fn(*args, **kwargs)
            T = args[per_token[0]].shape[1]
            if T <= mode.loop_chunk:
                return fn(*args, **kwargs)
            spec = (functools.partial(fn, **kwargs), mode, tuple(per_token),
                    tuple(per_token_out), mode.loop_chunk, T)
            outs = _Chunked.apply(spec, *args)
            return tuple(outs)
        return wrapper
    return deco


class _Chunked(torch.autograd.Function):
    """One chunk of a token loop counted ``T / chunk`` times; the results
    widened to T tokens uncounted, their gradient counted the same way."""

    @staticmethod
    def forward(ctx, spec, *args):
        fn, mode, per_token, per_out, chunk, T = spec
        ctx.spec = spec
        ctx.save_for_backward(*[a if isinstance(a, torch.Tensor) else None
                                for a in args])
        ctx.others = [None if isinstance(a, torch.Tensor) else a
                      for a in args]
        part = _narrow(args, per_token, chunk)
        with mode.scaled(T / chunk):
            outs = fn(*part)
        with mode.paused():
            return tuple(_widen(o, T) if i in per_out else o
                         for i, o in enumerate(outs))

    @staticmethod
    def backward(ctx, *grads):
        fn, mode, per_token, per_out, chunk, T = ctx.spec
        args = [s if s is not None else o
                for s, o in zip(ctx.saved_tensors, ctx.others)]
        needs = ctx.needs_input_grad[1:]
        with mode.paused():
            part = [a.detach().requires_grad_(True) if need else a
                    for a, need in zip(_narrow(args, per_token, chunk),
                                       needs)]
            wrt = [a for a, need in zip(part, needs) if need]
        factor = T / chunk

        def pack(t):
            mode.inflate(t, factor)
            return t

        with torch.enable_grad(), mode.paused(), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            outs = fn(*part)
        pairs = [(o, g.narrow(1, 0, chunk) if i in per_out else g)
                 for i, (o, g) in enumerate(zip(outs, grads))
                 if g is not None and o.requires_grad]
        with mode.scaled(factor):
            got = torch.autograd.grad([o for o, _ in pairs],
                                      wrt, [g for _, g in pairs],
                                      allow_unused=True)
        del outs, pairs, got
        with mode.paused():
            return (None, *[torch.zeros_like(a) if need else None
                            for a, need in zip(args, needs)])


def _narrow(args, per_token, chunk) -> list:
    return [a.narrow(1, 0, chunk) if i in per_token else a
            for i, a in enumerate(args)]


def _widen(t: torch.Tensor, T: int) -> torch.Tensor:
    return t.new_empty((t.shape[0], T, *t.shape[2:]))
