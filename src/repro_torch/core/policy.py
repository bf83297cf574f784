"""Sandbox policies: legacy primitive filtering vs modern Sentry emulation.

The paper's legacy sandbox enforced security with a **syscall allowlist**
(seccomp filtering) that needed constant curation; the modern sandbox
(gVisor) instead **implements** the syscall surface in user space, so
arbitrary workloads run without per-workload configuration.

In the port the "syscall" is the **aten-graph operator**: the Sentry
(:mod:`repro_torch.core.sentry`) traces a user function to a graph of
dispatcher calls and names each ``call_function`` node by its target's
canonical name, ``<namespace>.<op>``: ``aten.mm``, ``aten.tanh``,
``prims.convert_element_type``, ``higher_order.cond``.  A
``torch.library`` custom op keeps its own namespace (``mylib.leak``).

* :class:`LegacyFilterPolicy` — a literal allowlist.  Anything off-list
  raises :class:`SandboxViolation` (the SIGSYS analogue).  It ships with a
  *curated snapshot* and must be hand-extended every time user code
  exercises a new operator.
* :class:`ModernEmulationPolicy` — deny-by-class: every operator is
  admitted and emulated by the Sentry **except** the genuinely dangerous
  class: operators that run arbitrary host code or move data across the
  sandbox boundary.  That class is every operator outside the ``aten``,
  ``prims`` and ``higher_order`` namespaces (a custom op runs whatever
  its author registered, the counterpart of ``pure_callback`` /
  ``custom_call`` / ``ffi_call``) plus the names in
  :data:`DANGEROUS_PRIMITIVES`.  New compute operators need **no policy
  change**.

The reference's jaxpr primitives and their aten counterparts:

======================================  ====================================
reference (jaxpr primitive)             port (aten graph)
======================================  ====================================
``pure_callback``, ``io_callback``,     any op outside ``aten``/``prims``/
``callback``, ``custom_call``,          ``higher_order`` (``torch.library``
``ffi_call``, ``xla_call_module``,      custom ops, extension ops);
``host_callback_call``                  ``higher_order.call_torchbind``,
                                        ``flat_apply``,
                                        ``invoke_leaf_function``,
                                        ``autograd_function_apply``,
                                        ``custom_function_call``,
                                        ``auto_functionalized(_v2)``,
                                        ``with_effects``,
                                        ``inline_asm_elementwise``,
                                        ``triton_kernel_wrapper_*``,
                                        ``inductor_compiled_code``,
                                        ``aoti_call_delegate``,
                                        ``executorch_call_delegate``
``debug_callback``                      ``aten._print``,
                                        ``higher_order.print``
``infeed``, ``outfeed``                 ``aten._local_scalar_dense``,
                                        ``aten.item``, ``aten.save``
add sub mul div neg abs sign            aten.add sub rsub mul div
max min rem pow integer_pow square      reciprocal neg abs sign sgn maximum
                                        minimum max min remainder fmod pow
                                        square
sqrt rsqrt exp log log1p expm1 tanh     aten.sqrt rsqrt exp log log1p expm1
logistic floor ceil round clamp         tanh sigmoid floor ceil round clamp
is_finite                               clamp_min clamp_max isfinite
eq ne lt le gt ge and or not xor        aten.eq ne lt le gt ge logical_*
select_n                                bitwise_*, aten.where masked_fill
reshape transpose broadcast_in_dim      aten.view reshape _unsafe_view
expand_dims squeeze concatenate slice   permute transpose t expand unsqueeze
dynamic_slice dynamic_update_slice rev  squeeze cat slice select narrow
pad gather scatter scatter-add iota     slice_scatter select_scatter flip
convert_element_type                    constant_pad_nd gather index
bitcast_convert_type                    index_select scatter scatter_add
                                        index_put arange _to_copy clone
                                        alias full zeros ones scalar_tensor
                                        lift_fresh lift_fresh_copy
reduce_sum reduce_max reduce_min        aten.sum mean amax amin max min prod
reduce_prod reduce_and reduce_or        all any argmax argmin
argmax argmin
dot_general conv_general_dilated        aten.mm bmm addmm baddbmm matmul dot
                                        mv convolution
stop_gradient sort cumsum cummax        aten.detach sort cumsum cummax
cummin cumprod split                    cummin cumprod split
                                        split_with_sizes unbind
softmax, gelu (tanh), relu, silu:       aten._softmax _log_softmax gelu
compositions of the rows above          relu silu (one fused op each)
``cond``, ``while``                     ``higher_order.cond``,
(structural wrappers)                   ``higher_order.while_loop``
``scan`` (not on the list)              ``higher_order.scan`` (not on it)
``erf``, ``sin``, ``cos`` (not on it)   ``aten.erf``, ``aten.sin``,
                                        ``aten.cos`` (not on it)
======================================  ====================================

``pjit``, ``closed_call``, ``remat2`` and the ``custom_jvp``/``custom_vjp``
call wrappers have no counterpart: the port's graphs are flat except for
the control-flow operators, whose bodies the Sentry checks node by node.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet

__all__ = [
    "SandboxViolation",
    "SandboxPolicy",
    "LegacyFilterPolicy",
    "ModernEmulationPolicy",
    "PolicyDecision",
    "DANGEROUS_PRIMITIVES",
    "LEGACY_ALLOWLIST",
    "SAFE_NAMESPACES",
    "is_dangerous",
]


class SandboxViolation(Exception):
    """A primitive was rejected by the sandbox policy (SIGSYS analogue)."""

    def __init__(self, primitive: str, policy: str, reason: str) -> None:
        self.primitive = primitive
        self.policy = policy
        self.reason = reason
        super().__init__(f"[{policy}] primitive {primitive!r} rejected: {reason}")


#: Namespaces whose operators are computations on tensors.  Any other
#: namespace is a registered custom or extension op: arbitrary code.
SAFE_NAMESPACES: FrozenSet[str] = frozenset({"aten", "prims", "higher_order"})

#: Operators inside the safe namespaces that still run arbitrary host code
#: or move data across the sandbox boundary.  Neither policy admits these,
#: nor any operator outside :data:`SAFE_NAMESPACES`; the engine itself
#: performs I/O through the Gofer (core/gofer.py).
DANGEROUS_PRIMITIVES: FrozenSet[str] = frozenset(
    {
        # device -> host transfers and host-side effects
        "aten._local_scalar_dense",
        "aten.item",
        "aten._print",
        "aten.save",
        "higher_order.print",
        # opaque host code, compiled code and custom-op wrappers
        "higher_order.call_torchbind",
        "higher_order.flat_apply",
        "higher_order.invoke_leaf_function",
        "higher_order.autograd_function_apply",
        "higher_order.custom_function_call",
        "higher_order.auto_functionalized",
        "higher_order.auto_functionalized_v2",
        "higher_order.with_effects",
        "higher_order.inline_asm_elementwise",
        "higher_order.triton_kernel_wrapper_mutation",
        "higher_order.triton_kernel_wrapper_functional",
        "higher_order.inductor_compiled_code",
        "higher_order.aoti_call_delegate",
        "higher_order.executorch_call_delegate",
    }
)


def is_dangerous(primitive_name: str) -> bool:
    """True for the dangerous class: a named dangerous operator, or any
    operator outside :data:`SAFE_NAMESPACES`."""
    return (
        primitive_name in DANGEROUS_PRIMITIVES
        or primitive_name.split(".", 1)[0] not in SAFE_NAMESPACES
    )


#: The curated allowlist the legacy sandbox shipped with, as aten names.
#: Deliberately a *snapshot* of the reference's classic surface: broad
#: enough for classic DataFrame/ML UDFs, but missing ``scan`` and newer
#: numerics (``erf``, trigonometry) — exactly the maintenance treadmill
#: the paper describes.
LEGACY_ALLOWLIST: FrozenSet[str] = frozenset(
    "aten." + op for op in (
        # elementwise arithmetic
        "add", "sub", "rsub", "mul", "div", "reciprocal", "neg", "abs",
        "sign", "sgn", "maximum", "minimum", "remainder", "fmod", "pow",
        "square", "sqrt", "rsqrt", "exp", "log", "log1p", "expm1", "tanh",
        "sigmoid", "floor", "ceil", "round", "clamp", "clamp_min",
        "clamp_max", "isfinite",
        # comparison / logic
        "eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
        "logical_not", "logical_xor", "bitwise_and", "bitwise_or",
        "bitwise_not", "bitwise_xor", "where", "masked_fill",
        # shape / layout / constants
        "view", "reshape", "_unsafe_view", "permute", "transpose", "t",
        "expand", "unsqueeze", "squeeze", "cat", "slice", "select",
        "narrow", "slice_scatter", "select_scatter", "flip",
        "constant_pad_nd", "gather", "index", "index_select", "scatter",
        "scatter_add", "index_put", "arange", "_to_copy", "clone", "alias",
        "full", "zeros", "ones", "scalar_tensor", "lift_fresh",
        "lift_fresh_copy",
        # reductions
        "sum", "mean", "amax", "amin", "max", "min", "prod", "all", "any",
        "argmax", "argmin",
        # linear algebra (the classic ML core)
        "mm", "bmm", "addmm", "baddbmm", "matmul", "dot", "mv",
        "convolution",
        # misc classics, and fused forms of classic compositions
        "detach", "sort", "cumsum", "cummax", "cummin", "cumprod", "split",
        "split_with_sizes", "unbind", "_softmax", "_log_softmax", "gelu",
        "relu", "silu",
    )
) | frozenset(
    # structural wrappers: not syscalls — both sandboxes recurse into
    # their bodies and filter what's inside
    {"higher_order.cond", "higher_order.while_loop"}
)


@dataclass(frozen=True)
class PolicyDecision:
    admitted: bool
    emulated: bool
    reason: str


class SandboxPolicy:
    """Base policy interface."""

    name: str = "base"

    def check(self, primitive_name: str) -> PolicyDecision:  # pragma: no cover
        raise NotImplementedError

    def admit(self, primitive_name: str) -> None:
        """Raise SandboxViolation unless the primitive is admitted."""
        d = self.check(primitive_name)
        if not d.admitted:
            raise SandboxViolation(primitive_name, self.name, d.reason)


@dataclass(frozen=True)
class LegacyFilterPolicy(SandboxPolicy):
    """Syscall-filtering analogue: static allowlist, manual curation."""

    allowlist: FrozenSet[str] = LEGACY_ALLOWLIST
    name: str = "legacy-filter"

    def check(self, primitive_name: str) -> PolicyDecision:
        if is_dangerous(primitive_name):
            return PolicyDecision(False, False, "dangerous primitive")
        if primitive_name in self.allowlist:
            return PolicyDecision(True, False, "allowlisted")
        return PolicyDecision(
            False,
            False,
            "not in allowlist (legacy sandbox requires a config update)",
        )

    def extended(self, *names: str) -> "LegacyFilterPolicy":
        """The manual maintenance step the paper wants to eliminate."""
        return LegacyFilterPolicy(allowlist=self.allowlist | set(names))


@dataclass(frozen=True)
class ModernEmulationPolicy(SandboxPolicy):
    """gVisor analogue: emulate everything, deny only the dangerous class."""

    extra_denied: FrozenSet[str] = frozenset()
    name: str = "modern-sentry"

    def check(self, primitive_name: str) -> PolicyDecision:
        if is_dangerous(primitive_name) or primitive_name in self.extra_denied:
            return PolicyDecision(
                False, False, "dangerous primitive (never forwarded to host)"
            )
        return PolicyDecision(True, True, "emulated in user space")
