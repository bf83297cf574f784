"""The Sentry: user-space interception and emulation of aten graphs.

gVisor's Sentry implements the Linux syscall surface in Go, so sandboxed
code never talks to the host kernel directly.  This Sentry does the same one
level up: a user-submitted function is traced **abstractly** (fake tensors:
no device memory, no real data) to an aten graph, every ``call_function``
node (including those inside the bodies of ``cond`` / ``while_loop`` /
``scan``) is checked against the :class:`~repro_torch.core.policy.
SandboxPolicy` and **metered** against per-tenant resource budgets, and only
then run.

A node's "primitive" is its target's canonical name (:func:`primitive_name`):
``aten.mm``, ``aten.tanh``, ``higher_order.cond``, or a custom op's own
``<namespace>.<op>``.  Tuple projections (``operator.getitem``) are
structure, not operations, as a jaxpr's multiple outputs are.

Two execution modes, mirroring gVisor's architecture:

* :func:`static_verify` — load-time verification: walk the whole graph tree
  once and admit/deny.  Production path: after verification the function
  runs natively (eager PyTorch, the CUDA kernels behind it).
* :class:`SentryInterpreter` — full user-space emulation: evaluate the graph
  node by node, admitting each node before it runs; the bodies of control
  flow are verified first and then run whole.

Tracing (:func:`make_graph`) records the graph with a dispatch mode of its
own over ``FakeTensorMode`` rather than with ``make_fx``: ``make_fx`` yields
the same kind of graph, but for the length of a trace it patches
``torch.nn.Module.__call__`` and sets process-wide globals
(``CURRENT_PATCHER``, ``_CURRENT_MAKE_FX_TRACER``), so two traces on two
threads that both yield inside user code (the scheduler's workers do) undo
each other's state out of order and the later one fails
(``AssertionError: CURRENT_PATCHER is None``).  Dispatch modes are
thread-local: a trace records only its own thread's operations, whatever
the engine or other tenants run meanwhile.  A control-flow body that reads
a tensor traced outside it gets that tensor as an operand: ``torch.cond``,
``while_loop`` and ``scan`` lift such closures before they dispatch, nested
bodies included, as the reference's jaxpr carries them as operands.
"""

from __future__ import annotations

import math
import operator
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.fx as fx
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from .policy import SandboxPolicy

__all__ = [
    "ResourceMeter",
    "BudgetExceeded",
    "static_verify",
    "SentryInterpreter",
    "sandboxed",
    "iter_eqns",
    "make_graph",
    "primitive_name",
    "CONTROL_FLOW_PRIMITIVES",
    "PRODUCTS",
    "conv_flops",
    "product_flops",
    "tensor_bytes",
]

#: Structured control flow: recursed into for costing/verification, but
#: run whole by the interpreter (their bodies are verified first).
CONTROL_FLOW_PRIMITIVES: frozenset = frozenset(
    {"higher_order.scan", "higher_order.while_loop", "higher_order.cond"}
)


class BudgetExceeded(RuntimeError):
    """A tenant exceeded its FLOP or byte budget (resource isolation)."""


def primitive_name(target: Any) -> str:
    """Canonical ``<namespace>.<op>`` name of a graph node's target."""
    if isinstance(target, torch._ops.OpOverload):
        return target._schema.name.replace("::", ".")
    if isinstance(target, torch._ops.HigherOrderOperator):
        return f"higher_order.{target.name()}"
    mod = getattr(target, "__module__", None) or "builtins"
    return f"{mod}.{getattr(target, '__qualname__', repr(target))}"


def _is_eqn(node: fx.Node) -> bool:
    return node.op == "call_function" and node.target is not operator.getitem


@dataclass
class ResourceMeter:
    """Per-tenant resource accounting, enforced at interception time."""

    flop_budget: Optional[float] = None
    byte_budget: Optional[float] = None
    flops: float = 0.0
    bytes: float = 0.0
    eqn_count: int = 0
    by_primitive: Dict[str, int] = field(default_factory=dict)

    def charge(self, eqn: fx.Node) -> None:
        f = eqn_flops(eqn)
        b = eqn_bytes(eqn)
        self.flops += f
        self.bytes += b
        self.eqn_count += 1
        name = primitive_name(eqn.target)
        self.by_primitive[name] = self.by_primitive.get(name, 0) + 1
        self._check_budgets()

    def charge_totals(
        self,
        flops: float,
        bytes_: float,
        eqn_count: int,
        by_primitive: Optional[Dict[str, int]] = None,
    ) -> None:
        """Replay pre-computed charges (cached-admission path): same budget
        enforcement as :meth:`charge`, without re-walking the graph."""
        self.flops += flops
        self.bytes += bytes_
        self.eqn_count += eqn_count
        for name, n in (by_primitive or {}).items():
            self.by_primitive[name] = self.by_primitive.get(name, 0) + n
        self._check_budgets()

    def _check_budgets(self) -> None:
        if self.flop_budget is not None and self.flops > self.flop_budget:
            raise BudgetExceeded(
                f"FLOP budget exceeded: {self.flops:.3e} > {self.flop_budget:.3e}"
            )
        if self.byte_budget is not None and self.bytes > self.byte_budget:
            raise BudgetExceeded(
                f"byte budget exceeded: {self.bytes:.3e} > {self.byte_budget:.3e}"
            )


# --------------------------------------------------------------------------
# costing
# --------------------------------------------------------------------------

def _tensors(val: Any) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(val) if isinstance(t, torch.Tensor)]


def _shape(arg: Any) -> Tuple[int, ...]:
    return tuple(arg.meta["val"].shape)


#: products, charged 2 * batch * m * k * n from their last two operands
PRODUCTS = frozenset({"aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm",
                      "aten.matmul", "aten.mv", "aten.dot"})


def product_flops(lhs: Tuple[int, ...], rhs: Tuple[int, ...]) -> float:
    """FLOPs of a product of operands of shapes ``lhs`` and ``rhs`` (the
    last two of a :data:`PRODUCTS` operation; batch dimensions
    broadcast)."""
    lhs = tuple(lhs) if len(lhs) > 1 else (1, *lhs)
    rhs = tuple(rhs) if len(rhs) > 1 else (*rhs, 1)
    batch = math.prod(torch.broadcast_shapes(lhs[:-2], rhs[:-2]))
    return 2.0 * batch * lhs[-2] * lhs[-1] * rhs[-1]


def conv_flops(out_numel: int, weight: Tuple[int, ...]) -> float:
    """FLOPs of a convolution with ``out_numel`` output elements and a
    weight of shape ``(out, in / groups, *kernel)``."""
    if len(weight) > 2:
        return 2.0 * out_numel * math.prod(weight[2:]) * weight[1]
    return 2.0 * out_numel


def tensor_bytes(tensors) -> float:
    """Bytes of the tensors, each counted whole."""
    return float(sum(t.numel() * t.element_size() for t in tensors))


def eqn_flops(eqn: fx.Node) -> float:
    """Analytic FLOP estimate for one graph node."""
    prim = primitive_name(eqn.target)
    if prim in PRODUCTS:
        return product_flops(_shape(eqn.args[-2]), _shape(eqn.args[-1]))
    if prim == "aten.convolution":
        out = sum(t.numel() for t in _tensors(eqn.meta["val"]))
        return conv_flops(out, _shape(eqn.args[1]))
    if prim in CONTROL_FLOW_PRIMITIVES:
        total = 0.0
        for sub in _sub_graphs(eqn):
            total += sum(eqn_flops(e) for e in sub.graph.nodes if _is_eqn(e))
        if prim == "higher_order.scan":
            total *= _shape(eqn.args[2][0])[0]
        return total
    # elementwise-ish default: one flop per output element
    return float(sum(t.numel() for t in _tensors(eqn.meta.get("val"))))


def eqn_bytes(eqn: fx.Node) -> float:
    """Operands and results, each counted whole."""
    ins = [a.meta.get("val") for a in pytree.tree_leaves((eqn.args, eqn.kwargs))
           if isinstance(a, fx.Node)]
    return tensor_bytes(_tensors(ins) + _tensors(eqn.meta.get("val")))


# --------------------------------------------------------------------------
# graph tree walking
# --------------------------------------------------------------------------

def _sub_graphs(eqn: fx.Node) -> Iterator[fx.GraphModule]:
    """Yield every GraphModule a node takes as an argument (its bodies)."""
    owner = eqn.graph.owning_module
    for a in eqn.args:
        if isinstance(a, fx.Node) and a.op == "get_attr":
            sub = getattr(owner, a.target)
            if isinstance(sub, fx.GraphModule):
                yield sub


def iter_eqns(gm: fx.GraphModule) -> Iterator[fx.Node]:
    """Depth-first over all operation nodes, descending into bodies."""
    for eqn in gm.graph.nodes:
        if _is_eqn(eqn):
            yield eqn
            for sub in _sub_graphs(eqn):
                yield from iter_eqns(sub)


# --------------------------------------------------------------------------
# abstract tracing
# --------------------------------------------------------------------------

#: tensor metadata queries (a compiled control-flow wrapper asks for a
#: device): they read no data and are not recorded
_METADATA = frozenset({"prim.device", "prim.dtype", "prim.layout"})


class _Recorder(TorchDispatchMode):
    """Records every operation dispatched on this thread into ``graph``.

    Sits above a ``FakeTensorMode``, which computes each output's metadata;
    tensors map to the nodes that made them by identity.  A real tensor
    met as an input (a closed-over value, ``torch.tensor`` data) becomes a
    constant attribute of ``root``.
    """

    supports_higher_order_operators = True

    @classmethod
    def ignore_compile_internals(cls) -> bool:
        # torch's eager cond/scan/while_loop run through torch.compile;
        # under a mode that does not ignore compile internals, dynamo
        # skips their wrappers and remembers the skip for the process, and
        # later eager calls of the operator fail.  With this, dynamo
        # compiles the wrapper and the operator reaches this mode with the
        # bodies as graph modules
        return True

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self.root = torch.nn.Module()
        self.graph = fx.Graph()
        self._env: Dict[int, fx.Node] = {}
        self._alive: List[Any] = []        # pins ids for the trace's life
        self._n_attr = 0

    def bind(self, t: Any, node: fx.Node, val: Any = None) -> None:
        self._env[id(t)] = node
        self._alive.append(t)
        node.meta["val"] = t if val is None else val

    def _attr(self, prefix: str, value: Any) -> fx.Node:
        name = f"{prefix}{self._n_attr}"
        self._n_attr += 1
        setattr(self.root, name, value)
        return self.graph.get_attr(name)

    def node(self, x: Any) -> Any:
        if not isinstance(x, torch.Tensor):
            return x
        n = self._env.get(id(x))
        if n is not None:
            return n
        n = self._attr("_tensor_constant", x)
        self.bind(x, n, self.fake_mode.from_tensor(x))
        return n

    def output(self, value: Any) -> None:
        self.graph.output(pytree.tree_map(self.node, value))

    def module(self) -> fx.GraphModule:
        return fx.GraphModule(self.root, self.graph)

    def _bind_outputs(self, out: Any, node: fx.Node) -> None:
        if isinstance(out, torch.Tensor):
            self.bind(out, node)
        elif isinstance(out, (tuple, list)):
            for i, o in enumerate(out):
                if isinstance(o, torch.Tensor):
                    self.bind(o, self.graph.call_function(
                        operator.getitem, (node, i)))
            node.meta["val"] = out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return self._control_flow(func, args, kwargs)
        if primitive_name(func) in _METADATA:
            return func(*args, **kwargs)
        node_args, node_kwargs = pytree.tree_map(self.node, (args, kwargs))
        out = func(*args, **kwargs)            # the fake mode below
        node = self.graph.call_function(func, node_args, node_kwargs)
        self._bind_outputs(out, node)
        return out

    # -- control flow: trace each body into a subgraph -------------------

    def _body(self, fn: Callable, inputs,
              bare: bool = False) -> Tuple[fx.Node, list, Any]:
        """Trace ``fn(*inputs)`` into a subgraph held by ``root``: (its
        get_attr node, its output leaves, their tree structure).  The
        subgraph returns the tuple of leaves, or with ``bare`` its one
        leaf (a ``while_loop`` predicate)."""
        child = _Recorder(self.fake_mode)
        for i, x in enumerate(inputs):
            child.bind(x, child.graph.placeholder(f"arg{i}"))
        with child:
            out = fn(*inputs)
        leaves, spec = pytree.tree_flatten(out)
        child.output(leaves[0] if bare else tuple(leaves))
        return self._attr("body_graph_", child.module()), leaves, spec

    @staticmethod
    def _fresh(like: torch.Tensor, lead: Tuple[int, ...] = ()) -> torch.Tensor:
        # runs under the fake mode (this mode is off inside its dispatch)
        return torch.empty((*lead, *like.shape), dtype=like.dtype,
                           device=like.device)

    def _control_flow(self, func, args, kwargs):
        """``cond`` / ``while_loop`` / ``scan``: each body becomes a
        subgraph; the node's value is the flat tuple of its outputs, as
        the operator returns it when run on those subgraphs."""
        name = func.name()
        if name == "cond":
            pred, true_fn, false_fn, operands = args
            t_gm, t_out, spec = self._body(true_fn, operands)
            f_gm, _, _ = self._body(false_fn, operands)
            flat = [self._fresh(o) for o in t_out]
            result: Any = pytree.tree_unflatten(flat, spec)
            node_args = (self.node(pred), t_gm, f_gm,
                         tuple(self.node(o) for o in operands))
        elif name == "while_loop":
            cond_fn, body_fn, carried, additional = args
            inputs = (*carried, *additional)
            c_gm, _, _ = self._body(cond_fn, inputs, bare=True)
            b_gm, _, _ = self._body(body_fn, inputs)
            flat = [self._fresh(c) for c in carried]
            result = tuple(flat)
            node_args = (c_gm, b_gm, tuple(self.node(c) for c in carried),
                         tuple(self.node(a) for a in additional))
        elif name == "scan":
            combine_fn, init, xs, additional = args
            slices = [x.select(0, 0) for x in xs]
            s_gm, s_out, _ = self._body(combine_fn,
                                        (*init, *slices, *additional))
            flat = [self._fresh(c) for c in init] + [
                self._fresh(y, (xs[0].shape[0],)) for y in s_out[len(init):]]
            result = list(flat)
            node_args = (s_gm, [self.node(c) for c in init],
                         [self.node(x) for x in xs],
                         tuple(self.node(a) for a in additional))
        else:
            raise RuntimeError(
                f"higher-order operator {name!r} cannot be traced by the "
                "Sentry")
        node = self.graph.call_function(func, node_args, kwargs)
        self._bind_outputs(flat, node)
        return result


def make_graph(fn: Callable, args: Tuple = (),
               kwargs: Optional[Dict[str, Any]] = None):
    """Trace ``fn(*args, **kwargs)`` abstractly: (graph module, output tree).

    The counterpart of ``jax.make_jaxpr(..., return_shape=True)``.  The
    graph's placeholders are the flattened positional leaves and its output
    is the tuple of flattened output leaves; tensors are traced as fake
    tensors of their shape, dtype and device, so tracing allocates no
    device memory and reads no data.  Keyword values and non-tensor leaves
    are constants of the graph.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    kwargs = dict(kwargs or {})
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    leaves, in_spec = pytree.tree_flatten(args)
    rec = _Recorder(fake_mode)
    traced = []
    for i, x in enumerate(leaves):
        ph = rec.graph.placeholder(f"arg{i}")
        if isinstance(x, torch.Tensor):
            x = fake_mode.from_tensor(x)
            rec.bind(x, ph)
        traced.append(x)
    with fake_mode, rec:
        out = fn(*pytree.tree_unflatten(traced, in_spec), **kwargs)
    leaves, out_spec = pytree.tree_flatten(out)
    rec.output(tuple(leaves))
    return rec.module(), out_spec


# --------------------------------------------------------------------------
# static verification (the production path)
# --------------------------------------------------------------------------

def static_verify(
    gm: fx.GraphModule,
    policy: SandboxPolicy,
    meter: Optional[ResourceMeter] = None,
) -> Dict[str, int]:
    """Verify every operation in the program against ``policy``.

    Returns a primitive histogram; raises :class:`SandboxViolation` /
    :class:`BudgetExceeded` on the first offence.  After this passes, the
    function may run natively — the Sentry has already seen every
    operation it will perform.
    """
    histogram: Dict[str, int] = {}
    for eqn in iter_eqns(gm):
        name = primitive_name(eqn.target)
        policy.admit(name)
        histogram[name] = histogram.get(name, 0) + 1
    if meter is not None:
        # charge top-level nodes only: eqn_flops/eqn_bytes recurse into
        # bodies themselves (scaling scan bodies by their length), so
        # charging nested nodes again would double count
        for eqn in gm.graph.nodes:
            if _is_eqn(eqn):
                meter.charge(eqn)
    return histogram


# --------------------------------------------------------------------------
# dynamic emulation (the demonstration / untrusted-eval path)
# --------------------------------------------------------------------------

class SentryInterpreter:
    """Node-by-node user-space evaluation of a graph."""

    def __init__(self, policy: SandboxPolicy, meter: Optional[ResourceMeter] = None):
        self.policy = policy
        self.meter = meter

    def run(self, gm: fx.GraphModule, *args) -> tuple:
        """The graph's flat outputs on the flat positional ``args``."""
        return _AdmittingInterpreter(gm, self).run(*args)


class _AdmittingInterpreter(fx.Interpreter):
    def __init__(self, gm: fx.GraphModule, sentry: SentryInterpreter):
        super().__init__(gm)
        self.sentry = sentry

    def run_node(self, n: fx.Node) -> Any:
        if _is_eqn(n):
            self.sentry.policy.admit(primitive_name(n.target))
            bodies = list(_sub_graphs(n))
            if self.sentry.meter is not None and not bodies:
                self.sentry.meter.charge(n)
            # verify nested bodies (scan/while_loop/cond) before running
            # the operator whole
            for sub in bodies:
                static_verify(sub, self.sentry.policy, self.sentry.meter)
        return super().run_node(n)


# --------------------------------------------------------------------------
# public entry point
# --------------------------------------------------------------------------

def sandboxed(
    fn: Callable,
    policy: SandboxPolicy,
    *,
    meter: Optional[ResourceMeter] = None,
    mode: str = "verify",
    controller: Optional[Any] = None,
) -> Callable:
    """Wrap ``fn`` so it executes inside the Sentry.

    ``mode="verify"`` (production): trace → static verify → call the
    original function.  Zero steady-state overhead.
    ``mode="interpret"`` (full emulation): every call evaluates the graph
    node by node inside the interpreter.

    Admission routes through the shared
    :class:`~repro_torch.core.admission.AdmissionController` (the
    process-default one unless ``controller`` is given), so repeat calls
    with the same function/shapes/policy skip tracing and verification.
    """
    if mode not in ("verify", "interpret"):
        raise ValueError(mode)

    def wrapper(*args, **kwargs):
        # lazy import: admission builds on this module's verifier
        from .admission import default_controller

        ctl = controller if controller is not None else default_controller()
        ticket = ctl.admit(fn, args, kwargs, policy=policy, meter=meter)
        if mode == "verify":
            return fn(*args, **kwargs)
        interp = SentryInterpreter(policy, meter=None)  # already metered above
        out_flat = interp.run(ticket.graph, *pytree.tree_leaves(args))
        return pytree.tree_unflatten(list(out_flat), ticket.out_tree)

    wrapper.__name__ = f"sandboxed_{getattr(fn, '__name__', 'fn')}"
    return wrapper
