"""Unified admission control plane (the paper's load-time interception story).

SEE++'s central performance claim is that interception cost is paid **once**
at load time (the Systrap move): after a program is verified, steady-state
execution runs at native speed.  :class:`AdmissionController` is the single
pipeline that ``Sandbox.run``, ``ServerlessScheduler`` and the server's
postprocess route through:

1. **image-digest check** — the sandbox must boot from a pinned base image
   (when the controller is configured with an allowed-digest set),
2. **verification cache** — keyed on function identity + code digest +
   captured state + abstract argument signature + policy fingerprint; a
   repeat submission of the same program skips
   :func:`~repro_torch.core.sentry.make_graph` + ``static_verify`` entirely
   and returns the cached primitive histogram,
3. **budget pre-check** — cached FLOP/byte totals are charged against the
   tenant's :class:`~repro_torch.core.sentry.ResourceMeter` *before*
   execution, so an over-budget program is rejected without running.

The port keys a tensor leaf by its shape, dtype and device type (abstract)
or, where its value bakes into the graph (keyword values, closure cells,
defaults), by its bytes under those: ``np.asarray`` refuses a CUDA tensor,
and ``repr`` summarises a tensor past 1000 elements, so a closure over
either would otherwise key by a string that two different tensors share.
Non-tensor positional leaves are constants of the traced graph, so they
are keyed by value.

Every layer also keeps its in-flight quota slots on this controller's
ledger (``slot_acquired`` / ``slot_released``), so a leaked slot on any
release path is detectable.
"""

from __future__ import annotations

import hashlib
import pickle
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .policy import SandboxPolicy, SandboxViolation
from .sentry import ResourceMeter, make_graph, static_verify
from .telemetry import TelemetrySink

__all__ = [
    "AdmissionController",
    "AdmissionTicket",
    "ImageDigestError",
    "default_controller",
    "system_task",
]


def system_task(fn: Callable) -> Callable:
    """Mark ``fn`` as a trusted runtime-internal task body.

    Admission's static verification exists for *tenant* programs; system
    bodies (e.g. the orchestrator's decode/train step tasks) are engine
    code whose side effects cannot be traced.  Marked fns skip the
    trace/verify stage — the image-digest gate still applies — and admit
    with a zero-cost ticket, which also keeps their admission behavior
    free of cold/warm variance across replays.
    """
    fn.__system_task__ = True
    return fn


class ImageDigestError(RuntimeError):
    """The sandbox's base image is not in the controller's pinned set."""


@dataclass(frozen=True)
class AdmissionTicket:
    """Proof that a program passed the admission pipeline."""

    tenant: str
    fn_name: str
    policy_name: str
    cache_hit: bool
    histogram: Mapping[str, int]
    flops: float
    bytes: float
    eqn_count: int
    graph: Any = None                # the verified fx.GraphModule
    out_tree: Any = None
    image_digest: str = ""


@dataclass
class _CacheEntry:
    fn: Callable                 # strong ref: keeps id(fn) stable for the key
    graph: Any                   # the verified fx.GraphModule
    out_tree: Any                # output pytree structure (interpret path)
    histogram: Dict[str, int]
    flops: float
    bytes: float
    eqn_count: int
    by_primitive: Dict[str, int]
    policy_name: str


def _code_digest(fn: Callable) -> str:
    try:
        code = fn.__code__.co_code
    except AttributeError:
        code = pickle.dumps(getattr(fn, "__name__", repr(fn)))
    return hashlib.sha256(code).hexdigest()[:16]


def _captured_state(fn: Callable) -> Tuple:
    """Closure cells + defaults, by value.

    Like kwargs, closed-over values and unsupplied defaults bake into the
    graph as constants at trace time; a function whose captured state
    mutates is a different program and must not get a stale cache hit.

    Module-level *globals* a function references are deliberately not
    keyed: keying them by value would defeat caching for any UDF touching
    mutable module state.
    """
    cells = getattr(fn, "__closure__", None) or ()
    defaults = getattr(fn, "__defaults__", None) or ()
    return (
        tuple(_concrete_leaf(c.cell_contents) for c in cells),
        tuple(_concrete_leaf(d) for d in defaults),
    )


def _policy_fingerprint(policy: SandboxPolicy) -> str:
    """Identity of a policy's *decision surface*, not just its name.

    ``LegacyFilterPolicy.extended(...)`` keeps the name but changes the
    allowlist; caching on the name alone would serve stale admissions
    across that config change.
    """
    parts = [policy.name]
    for attr in ("allowlist", "extra_denied"):
        s = getattr(policy, attr, None)
        if s is not None:
            parts.append(attr + ":" + ",".join(sorted(s)))
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def _tensor_bytes(x: torch.Tensor) -> bytes:
    host = x.detach().to("cpu").contiguous().reshape(-1)
    return host.view(torch.uint8).numpy().tobytes()


def _abstract_leaf(x) -> Tuple:
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype), x.device.type)
    # a non-tensor positional leaf is a constant of the traced graph
    return _concrete_leaf(x)


def _concrete_leaf(x) -> Tuple:
    if isinstance(x, torch.Tensor):
        key = (tuple(x.shape), str(x.dtype), x.device.type)
        data = _tensor_bytes(x)
        if x.numel() <= 64:
            return ("val", *key, data)
        return ("digest", *key, hashlib.sha256(data).hexdigest())
    try:
        arr = np.asarray(x)
        if arr.dtype != object:
            if arr.size <= 64:
                return ("val", arr.shape, str(arr.dtype), arr.tobytes())
            return (
                "digest", arr.shape, str(arr.dtype),
                hashlib.sha256(arr.tobytes()).hexdigest(),
            )
    except Exception:
        pass
    return ("repr", repr(x))


def _abstract_signature(args: Tuple, kwargs: Mapping[str, Any]) -> Tuple:
    """Positional args by (shape, dtype); kwargs by *value*.

    Positional tensors are traced, so only their abstract shapes/dtypes
    shape the graph.  Keyword args are closed over at trace time — their
    values bake into the graph as constants, so two calls differing only in
    a kwarg value are different programs and must not share a cache entry.
    """
    a_leaves, a_tree = pytree.tree_flatten(args)
    k_leaves, k_tree = pytree.tree_flatten(dict(kwargs))
    return (
        str(a_tree),
        tuple(_abstract_leaf(x) for x in a_leaves),
        str(k_tree),
        tuple(_concrete_leaf(x) for x in k_leaves),
    )


class AdmissionController:
    """One staged admission pipeline shared by every execution layer."""

    def __init__(
        self,
        *,
        sink: Optional[TelemetrySink] = None,
        max_entries: int = 512,
        allowed_image_digests: Optional[Any] = None,
    ) -> None:
        self.sink = sink or TelemetrySink()
        self._max_entries = max(1, int(max_entries))
        self._allowed_digests = (
            frozenset(allowed_image_digests)
            if allowed_image_digests is not None
            else None
        )
        self._cache: "OrderedDict[Tuple, _CacheEntry]" = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._invalidations = 0
        self._denials = 0
        # per-tenant hit/miss/denial split (the /metrics follow-on); the
        # cache itself stays global — verification is tenant-independent,
        # only the *accounting* is attributed
        self._per_tenant: Dict[str, Dict[str, int]] = {}
        # quota-slot ledger: tenant -> [acquired, released].  The
        # scheduler mirrors every in-flight slot it reserves/frees here,
        # giving the admission plane an independent second account of
        # slot lifetimes — after a clean drain the two books must agree
        # (slot_balance() == {}), so a leaked slot on ANY release path
        # (preemption, worker death, heartbeat reap) is detectable
        self._slots: Dict[str, List[int]] = {}
        # the concurrent scheduler admits from many workers at once: all
        # cache and counter mutations happen under this lock (tracing and
        # verification stay outside it so cold admissions don't serialize)
        self._lock = threading.Lock()

    # ---------------------------------------------------------------- admit

    def admit(
        self,
        fn: Callable,
        args: Tuple = (),
        kwargs: Optional[Mapping[str, Any]] = None,
        *,
        policy: SandboxPolicy,
        tenant: str = "default",
        image: Any = None,
        meter: Optional[ResourceMeter] = None,
        stage: str = "run",
    ) -> AdmissionTicket:
        """Run the staged pipeline; raise on the first failing stage.

        Raises :class:`ImageDigestError`, :class:`SandboxViolation` or
        :class:`~repro.core.sentry.BudgetExceeded`.
        """
        t0 = time.perf_counter()
        kwargs = dict(kwargs or {})
        fn_name = getattr(fn, "__name__", "fn")

        # stage 1: image-digest check (pinned base images only)
        digest = ""
        if image is not None:
            digest = image.digest() if callable(image.digest) else image.digest
            if self._allowed_digests is not None and digest not in self._allowed_digests:
                with self._lock:
                    self._denials += 1
                    self._bump_tenant_locked(tenant, "denials")
                self.sink.emit(
                    "admission", "image_rejected", tenant=tenant,
                    detail=f"digest={digest}", stage=stage,
                )
                raise ImageDigestError(
                    f"image digest {digest!r} not in pinned set"
                )

        # stage 1.5: trusted runtime-internal bodies bypass verification
        # (see :func:`system_task`); nothing to cost, nothing to cache
        if getattr(fn, "__system_task__", False):
            self.sink.count("admission.system_task")
            return AdmissionTicket(
                tenant=tenant,
                fn_name=fn_name,
                policy_name=policy.name,
                cache_hit=True,
                histogram={},
                flops=0.0,
                bytes=0.0,
                eqn_count=0,
                image_digest=digest,
            )

        # stage 2: verification cache
        key = (
            id(fn),
            _code_digest(fn),
            _captured_state(fn),
            _abstract_signature(args, kwargs),
            _policy_fingerprint(policy),
        )
        with self._lock:
            entry = self._cache.get(key)
            if entry is not None:
                self._cache.move_to_end(key)
                self._hits += 1
                self._bump_tenant_locked(tenant, "hits")
            else:
                self._misses += 1
                self._bump_tenant_locked(tenant, "misses")
        if entry is not None:
            self.sink.count("admission.cache_hit")
            cache_hit = True
        else:
            # trace + verify OUTSIDE the lock: a cold admission must not
            # serialize every other worker's warm hits; a racing duplicate
            # verification is idempotent (last insert wins)
            try:
                graph, out_tree = make_graph(fn, args, kwargs)
                scratch = ResourceMeter()   # budget-free costing pass
                hist = static_verify(graph, policy, scratch)
            except SandboxViolation as e:
                with self._lock:
                    self._denials += 1
                    self._bump_tenant_locked(tenant, "denials")
                self.sink.emit(
                    "admission", "denied", tenant=tenant,
                    detail=f"{fn_name}: {e}", stage=stage,
                )
                raise
            entry = _CacheEntry(
                fn=fn,
                graph=graph,
                out_tree=out_tree,
                histogram=hist,
                flops=scratch.flops,
                bytes=scratch.bytes,
                eqn_count=scratch.eqn_count,
                by_primitive=dict(scratch.by_primitive),
                policy_name=policy.name,
            )
            with self._lock:
                self._cache[key] = entry
                while len(self._cache) > self._max_entries:
                    self._cache.popitem(last=False)
                    self._evictions += 1
            self.sink.emit(
                "admission", "verified", tenant=tenant,
                detail=f"{fn_name}: {sum(hist.values())} eqns", stage=stage,
            )
            cache_hit = False

        # stage 3: budget pre-check against the tenant's meter
        if meter is not None:
            meter.charge_totals(
                entry.flops, entry.bytes, entry.eqn_count, entry.by_primitive
            )

        # the cold/warm split is the cache's whole story — export it as two
        # histograms so a scrape shows the amortized load-time cost
        self.sink.observe(
            "admission.warm_seconds" if cache_hit else "admission.cold_seconds",
            time.perf_counter() - t0,
            tenant=tenant,
        )
        return AdmissionTicket(
            tenant=tenant,
            fn_name=fn_name,
            policy_name=policy.name,
            cache_hit=cache_hit,
            histogram=dict(entry.histogram),
            flops=entry.flops,
            bytes=entry.bytes,
            eqn_count=entry.eqn_count,
            graph=entry.graph,
            out_tree=entry.out_tree,
            image_digest=digest,
        )

    # ----------------------------------------------------------- management

    def invalidate(self, policy: Optional[SandboxPolicy] = None) -> int:
        """Drop cached verifications; with ``policy``, only that policy's.

        Matching is by policy *fingerprint*, so entries verified under a
        since-mutated policy object (e.g. ``extended()``) stay live — they
        were verified under a different decision surface.
        """
        with self._lock:
            if policy is None:
                n = len(self._cache)
                self._cache.clear()
            else:
                fp = _policy_fingerprint(policy)
                doomed = [k for k in self._cache if k[-1] == fp]
                for k in doomed:
                    del self._cache[k]
                n = len(doomed)
            self._invalidations += n
        if n:
            self.sink.emit("admission", "invalidate", detail=f"{n} entries")
        return n

    def _bump_tenant_locked(self, tenant: str, key: str) -> None:
        bucket = self._per_tenant.get(tenant)
        if bucket is None:
            bucket = self._per_tenant[tenant] = {
                "hits": 0, "misses": 0, "denials": 0,
            }
        bucket[key] += 1

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "invalidations": self._invalidations,
                "denials": self._denials,
                "entries": len(self._cache),
            }

    def stats_by_tenant(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant hit/miss/denial counts (``/metrics`` follow-on)."""
        with self._lock:
            return {t: dict(b) for t, b in self._per_tenant.items()}

    # ------------------------------------------------- quota-slot ledger

    def slot_acquired(self, tenant: str) -> None:
        """Record one in-flight quota slot reserved for ``tenant``."""
        with self._lock:
            self._slots.setdefault(tenant, [0, 0])[0] += 1

    def slot_released(self, tenant: str) -> None:
        """Record one in-flight quota slot released for ``tenant``."""
        with self._lock:
            self._slots.setdefault(tenant, [0, 0])[1] += 1

    def slot_stats(self) -> Dict[str, Dict[str, int]]:
        """Acquired/released slot counts per tenant."""
        with self._lock:
            return {
                t: {"acquired": a, "released": r}
                for t, (a, r) in self._slots.items()
            }

    def slot_balance(self) -> Dict[str, int]:
        """Outstanding (acquired - released) slots per tenant.

        Empty after a clean drain; any surviving entry is a leaked slot —
        the chaos suite asserts this after every seed.
        """
        with self._lock:
            return {
                t: a - r for t, (a, r) in sorted(self._slots.items())
                if a != r
            }


# ---------------------------------------------------------------------------
# process-default controller (used by the bare ``sandboxed()`` convenience)
# ---------------------------------------------------------------------------

_default: Optional[AdmissionController] = None


def default_controller() -> AdmissionController:
    global _default
    if _default is None:
        _default = AdmissionController()
    return _default
