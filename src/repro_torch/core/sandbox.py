"""Sandbox facade — one object per tenant execution environment.

Composes the paper's pieces: a :class:`BaseImage` (standardized runtime),
a :class:`SandboxPolicy` (legacy filter vs modern Sentry emulation), a
:class:`MemoryManager` (the §IV.A allocator under test), a
:class:`ResourceMeter` (tenant isolation) and an optional :class:`Gofer`
(mediated I/O).  ``Sandbox.run`` is the single entry point the engine uses
to execute user-defined functions next to the data.

Admission (verification, budget pre-check, image-digest check) routes
through a shared :class:`~repro_torch.core.admission.AdmissionController`, so a
repeat submission of the same program skips tracing and verification
(warm-path admission); audit events flow to the attached
:class:`~repro_torch.core.telemetry.TelemetrySink`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from torch.utils import _pytree as pytree

from .admission import AdmissionController
from .gofer import Gofer
from .image import DEFAULT_IMAGE, BaseImage
from .mm import MemoryManager, MMConfig
from .policy import ModernEmulationPolicy, SandboxPolicy
from .sentry import ResourceMeter, SentryInterpreter
from .telemetry import TelemetryEvent, TelemetrySink, resolve_sink

__all__ = ["Sandbox", "SandboxResult"]


@dataclass
class SandboxResult:
    value: Any
    flops: float
    bytes: float
    eqn_count: int
    wall_s: float
    cache_hit: bool = False


class Sandbox:
    """A per-tenant execution environment colocated with the engine."""

    def __init__(
        self,
        *,
        tenant: str = "default",
        image: BaseImage = DEFAULT_IMAGE,
        policy: Optional[SandboxPolicy] = None,
        mm_config: Optional[MMConfig] = None,
        flop_budget: Optional[float] = None,
        byte_budget: Optional[float] = None,
        gofer: Optional[Gofer] = None,
        mode: str = "verify",
        admission: Optional[AdmissionController] = None,
        telemetry: Optional[TelemetrySink] = None,
    ) -> None:
        if mode not in ("verify", "interpret"):
            raise ValueError(f"unknown sandbox mode {mode!r}")
        self.tenant = tenant
        self.image = image
        self.policy = policy or ModernEmulationPolicy()
        self.mm = MemoryManager(mm_config or MMConfig.modern())
        self.gofer = gofer
        self.mode = mode
        self._flop_budget = flop_budget
        self._byte_budget = byte_budget
        self.telemetry = resolve_sink(admission, telemetry)
        self.admission = admission or AdmissionController(sink=self.telemetry)
        self.audit: List[TelemetryEvent] = []
        self._note("boot", f"image={image.describe()['digest']} policy={self.policy.name}")

    def _note(self, kind: str, detail: str = "") -> None:
        self.audit.append(
            self.telemetry.emit("sandbox", kind, tenant=self.tenant, detail=detail)
        )

    # ------------------------------------------------------------------ API

    def run(self, fn: Callable, *args, **kwargs) -> SandboxResult:
        """Execute ``fn(*args)`` inside the sandbox and meter it."""
        meter = ResourceMeter(
            flop_budget=self._flop_budget, byte_budget=self._byte_budget
        )
        t0 = time.perf_counter()
        try:
            ticket = self.admission.admit(
                fn, args, kwargs,
                policy=self.policy,
                tenant=self.tenant,
                image=self.image,
                meter=meter,
            )
            if self.mode == "verify":
                # production path: verified once, then native execution
                value = fn(*args, **kwargs)
            else:
                # the cached graph, node by node, on the caller's tensors
                # (so on the caller's device)
                interp = SentryInterpreter(self.policy, meter=None)
                out_flat = interp.run(ticket.graph, *pytree.tree_leaves(args))
                value = pytree.tree_unflatten(list(out_flat), ticket.out_tree)
        except Exception as e:
            self._note("violation", f"{type(e).__name__}: {e}")
            raise
        wall = time.perf_counter() - t0
        self._note(
            "run",
            f"{getattr(fn, '__name__', 'fn')} eqns={meter.eqn_count} "
            f"flops={meter.flops:.3e} cached={ticket.cache_hit}",
        )
        return SandboxResult(
            value, meter.flops, meter.bytes, meter.eqn_count, wall,
            cache_hit=ticket.cache_hit,
        )

    def verify_only(self, fn: Callable, *args, **kwargs) -> Dict[str, int]:
        """Admission check without execution (load-time verification)."""
        ticket = self.admission.admit(
            fn, args, kwargs,
            policy=self.policy,
            tenant=self.tenant,
            image=self.image,
            stage="verify",
        )
        self._note(
            "verify",
            f"{getattr(fn, '__name__', 'fn')}: "
            f"{sum(ticket.histogram.values())} eqns cached={ticket.cache_hit}",
        )
        return dict(ticket.histogram)

    def clone(self) -> "Sandbox":
        """A fresh sandbox with this one's configuration.

        Shares the admission controller / telemetry sink (warm cache) but
        nothing mutable — the pool uses this to replace a discarded
        (poisoned) sandbox without dropping the tenant's policy or budgets.
        """
        return Sandbox(
            tenant=self.tenant,
            image=self.image,
            policy=self.policy,
            mm_config=self.mm.config,
            flop_budget=self._flop_budget,
            byte_budget=self._byte_budget,
            gofer=self.gofer,
            mode=self.mode,
            admission=self.admission,
            telemetry=self.telemetry,
        )

    def op(self, name: str) -> Callable:
        """Resolve an op from the base image (never from host state)."""
        return self.image.op(name)
