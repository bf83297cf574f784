"""Warm sandbox pool — the paper's startup-latency optimization (§III.B).

SEE++ hides sandbox startup cost by pooling and pre-warming execution
environments instead of constructing one per request.  :class:`SandboxPool`
keeps **per-tenant** free lists (a sandbox checked in by one tenant is
never handed to another — isolation is structural, not best-effort),
supports configurable pre-warming, evicts least-recently-used idle
sandboxes under a global cap, and exposes hit/miss/evict counters.

Background refill: with ``refill_watermark > 0`` the pool keeps
every known tenant's free list topped up to a low watermark, so
``checkout()`` never builds a cold sandbox on the hot path.  The pump is
either explicit — call :meth:`tick` from the engine loop (deterministic
under test) — or a daemon thread started with :meth:`start_refiller`,
which wakes immediately whenever a checkout dips a tenant below its
watermark.  ``pool.refill`` / ``pool.cold_checkout`` counters and warm/
cold checkout-latency histograms land in the shared
:class:`~repro.core.telemetry.TelemetrySink` so the effect is measurable
(``benchmarks/pool_bench.py``).

A sandbox that observed a policy violation is checked back in with
``discard=True`` and destroyed rather than recycled, so one tenant's
violation can never poison a pooled environment.  Checkin of a sandbox
the pool has never seen (no checkout, no seeded template, unknown tenant)
is refused and counted as ``pool.orphan_checkin`` instead of silently
growing a free list for a tenant that does not exist.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

from .sandbox import Sandbox
from .telemetry import TelemetrySink, resolve_sink

__all__ = ["SandboxPool", "PoolStats"]


@dataclass
class PoolStats:
    hits: int = 0            # checkout served from a warm sandbox
    misses: int = 0          # checkout built cold on the hot path
    evictions: int = 0       # idle sandbox dropped by the LRU cap
    discards: int = 0        # poisoned sandbox destroyed at checkin
    prewarmed: int = 0       # sandboxes built ahead of demand (explicit)
    refills: int = 0         # sandboxes built by the background refiller
    orphan_checkins: int = 0  # checkins the pool refused (unknown sandbox)

    def as_dict(self) -> Dict[str, int]:
        return dict(vars(self))


class SandboxPool:
    """Per-tenant checkout/checkin pool of warm :class:`Sandbox` instances."""

    def __init__(
        self,
        factory: Optional[Callable[[str], Sandbox]] = None,
        *,
        max_idle_per_tenant: int = 4,
        max_total_idle: int = 32,
        refill_watermark: int = 0,
        admission=None,
        telemetry: Optional[TelemetrySink] = None,
    ) -> None:
        self.telemetry = resolve_sink(admission, telemetry)
        self._admission = admission
        self._factory = factory or self._default_factory
        self._max_idle_per_tenant = max(0, int(max_idle_per_tenant))
        self._max_total_idle = max(0, int(max_total_idle))
        self._watermark = max(0, int(refill_watermark))
        self._watermarks: Dict[str, int] = {}  # per-tenant overrides
        # per-tenant LIFO of (checkin stamp, sandbox); stamps order the
        # global LRU used for eviction under max_total_idle
        self._idle: Dict[str, List[Tuple[int, Sandbox]]] = {}
        self._out: Dict[int, str] = {}   # id(sandbox) -> tenant
        self._templates: Dict[str, Sandbox] = {}  # seeded per-tenant config
        self._tenants: Set[str] = set()  # tenants the pool has ever served
        self._stamp = itertools.count()
        self._lock = threading.RLock()
        self._wake = threading.Event()   # kicks the refiller on drain
        # (thread, its private stop event): a per-thread event means a
        # stop racing a concurrent start can never kill the fresh thread
        self._refiller: Optional[Tuple[threading.Thread, threading.Event]] = None
        self.stats = PoolStats()

    def _default_factory(self, tenant: str) -> Sandbox:
        # a seeded sandbox is the tenant's template: replacements (e.g.
        # after a poisoned discard) keep its policy/budgets/image rather
        # than silently reverting to an unrestricted default
        template = self._templates.get(tenant)
        if template is not None:
            return template.clone()
        return Sandbox(
            tenant=tenant,
            admission=self._admission,
            telemetry=self.telemetry,
        )

    # ------------------------------------------------------------- lifecycle

    def prewarm(self, tenant: str, count: int = 1) -> int:
        """Build ``count`` warm sandboxes for ``tenant`` ahead of demand."""
        built = 0
        for _ in range(count):
            with self._lock:
                self._tenants.add(tenant)
                if not self._has_idle_room():
                    break
            sb = self._factory(tenant)
            with self._lock:
                self._idle.setdefault(tenant, []).append(
                    (next(self._stamp), sb)
                )
                self.stats.prewarmed += 1
            built += 1
        if built:
            self.telemetry.emit("pool", "prewarm", tenant=tenant, count=built)
        return built

    def seed(self, sandbox: Sandbox) -> None:
        """Adopt an externally-built sandbox into the warm pool.

        The sandbox also becomes its tenant's configuration template: if
        it is later discarded, replacements are built as clones of it.
        """
        with self._lock:
            self._tenants.add(sandbox.tenant)
            self._templates.setdefault(sandbox.tenant, sandbox)
            self._idle.setdefault(sandbox.tenant, []).append(
                (next(self._stamp), sandbox)
            )
            self._enforce_caps()

    def checkout(self, tenant: str) -> Sandbox:
        """Hand ``tenant`` a warm sandbox, building one only on miss."""
        t0 = time.perf_counter()
        with self._lock:
            self._tenants.add(tenant)
            bucket = self._idle.get(tenant)
            if bucket:
                _, sb = bucket.pop()           # LIFO: warmest first
                self.stats.hits += 1
                self._out[id(sb)] = tenant
                below = len(bucket) < self.refill_target(tenant)
            else:
                sb = None
                below = True
        if sb is not None:                     # warm hit: one fused sink call
            if below and self._refiller is not None:
                self._wake.set()               # refiller: top this tenant up
            self.telemetry.count_observe(
                "pool.hit", "pool.checkout_warm_seconds",
                time.perf_counter() - t0, tenant=tenant,
            )
            return sb
        # the cold build happens outside the lock: it may trace/emit and
        # must not block concurrent warm checkouts or the refiller
        sb = self._factory(tenant)
        with self._lock:
            # a miss IS a cold checkout: checkout always builds when the
            # free list is dry, so one counter backs both exported names
            # (pool_miss_total / pool_cold_checkout_total)
            self.stats.misses += 1
            self._out[id(sb)] = tenant
        self._wake.set()
        self.telemetry.emit("pool", "miss", tenant=tenant)
        self.telemetry.observe(
            "pool.checkout_cold_seconds",
            time.perf_counter() - t0,
            tenant=tenant,
        )
        return sb

    def checkin(self, sandbox: Sandbox, *, discard: bool = False) -> None:
        """Return a sandbox; ``discard=True`` destroys it (poisoned).

        A sandbox the pool has never seen — not checked out from here, no
        seeded template, tenant never served — is refused (counted as an
        orphan) rather than grown into a free list for a phantom tenant.
        Double checkins of the same object and checkins of an already-
        discarded (poisoned) sandbox are refused the same way.
        """
        with self._lock:
            tenant = self._out.pop(id(sandbox), None)
            if getattr(sandbox, "_pool_discarded", False):
                # destroyed-at-discard sandboxes never re-enter circulation
                self.stats.orphan_checkins += 1
                self.telemetry.emit(
                    "pool", "orphan_checkin",
                    tenant=tenant or sandbox.tenant,
                    detail="checkin after discard",
                )
                return
            if tenant is None:
                tenant = sandbox.tenant
                known = (
                    tenant in self._templates or tenant in self._tenants
                )
                already_idle = any(
                    entry[1] is sandbox
                    for entry in self._idle.get(tenant, ())
                )
                if not known or already_idle:
                    self.stats.orphan_checkins += 1
                    self.telemetry.emit(
                        "pool", "orphan_checkin", tenant=tenant,
                        detail="double checkin" if already_idle
                        else "unknown tenant",
                    )
                    return
            if discard:
                sandbox._pool_discarded = True
                self.stats.discards += 1
                self.telemetry.emit("pool", "discard", tenant=tenant)
                return
            self._idle.setdefault(tenant, []).append(
                (next(self._stamp), sandbox)
            )
            self._enforce_caps()

    # --------------------------------------------------------------- refill

    def watermark(self, tenant: str) -> int:
        """Low watermark for ``tenant`` (override, else pool default)."""
        return self._watermarks.get(tenant, self._watermark)

    def set_watermark(self, tenant: str, count: int) -> None:
        """Keep ``tenant`` topped up to ``count`` idle sandboxes."""
        with self._lock:
            self._tenants.add(tenant)
            self._watermarks[tenant] = max(0, int(count))
        self._wake.set()

    def refill_target(self, tenant: str) -> int:
        """The watermark clamped to the per-tenant idle cap — what the
        refiller actually fills to.

        Refilling past ``max_idle_per_tenant`` would build sandboxes the
        next checkin's cap enforcement immediately evicts — an endless
        build→evict churn loop when the refiller runs.  Callers waiting
        for the pool to warm up must wait on this, not :meth:`watermark`.
        """
        return min(self.watermark(tenant), self._max_idle_per_tenant)

    def _deficit_tenant(self) -> Optional[str]:
        """A known tenant below its refill target (deterministic order)."""
        if not self._has_idle_room():
            return None
        for tenant in sorted(self._tenants):
            if self.idle_count(tenant) < self.refill_target(tenant):
                return tenant
        return None

    def tick(self, max_builds: Optional[int] = None) -> int:
        """Top every known tenant up to its watermark; returns builds.

        This is the deterministic pump: engines embedding the pool call
        it between batches, tests call it directly, and the background
        refiller thread calls it on a timer + checkout kicks.  Builds run
        outside the pool lock so warm checkouts never wait on a build.
        """
        built = 0
        while max_builds is None or built < max_builds:
            with self._lock:
                tenant = self._deficit_tenant()
            if tenant is None:
                break
            sb = self._factory(tenant)
            with self._lock:
                # recheck under the lock: a concurrent prewarm/checkin may
                # have filled the bucket while we were building
                if not self._has_idle_room():
                    break               # global cap: nobody can refill
                if self.idle_count(tenant) < self.refill_target(tenant):
                    self._idle.setdefault(tenant, []).append(
                        (next(self._stamp), sb)
                    )
                    self.stats.refills += 1
                    self.telemetry.count("pool.refill")
                    built += 1
                # else: this tenant filled concurrently — drop the build
                # and move on so other deficit tenants are not starved
        if built:
            # distinct kind from the per-build "pool.refill" counter so the
            # event does not double-bump that counter's name
            self.telemetry.emit("pool", "refill_tick", count=built)
        return built

    def start_refiller(self, interval_s: float = 0.02) -> None:
        """Start the background refiller (idempotent, daemon thread)."""
        with self._lock:
            if self._refiller is not None and self._refiller[0].is_alive():
                return
            stop = threading.Event()
            thread = threading.Thread(
                target=self._refill_loop,
                args=(max(1e-4, float(interval_s)), stop),
                name="sandbox-pool-refiller",
                daemon=True,
            )
            self._refiller = (thread, stop)
            thread.start()

    def stop_refiller(self, timeout: float = 5.0) -> None:
        with self._lock:
            entry = self._refiller
            self._refiller = None
            if entry is not None:
                entry[1].set()          # only THIS thread's stop event
                self._wake.set()
        if entry is not None:
            entry[0].join(timeout=timeout)

    @property
    def refiller_running(self) -> bool:
        entry = self._refiller
        return entry is not None and entry[0].is_alive()

    def _refill_loop(self, interval_s: float, stop: threading.Event) -> None:
        while not stop.is_set():
            self._wake.clear()
            self.tick()
            self._wake.wait(timeout=interval_s)

    # --------------------------------------------------------------- internals

    def _total_idle(self) -> int:
        return sum(len(b) for b in self._idle.values())

    def _has_idle_room(self) -> bool:
        return self._total_idle() < self._max_total_idle

    def _enforce_caps(self) -> None:
        # per-tenant cap: drop the least recently used of that tenant
        for tenant, bucket in self._idle.items():
            while len(bucket) > self._max_idle_per_tenant:
                bucket.sort(key=lambda e: e[0])
                bucket.pop(0)
                self.stats.evictions += 1
                self.telemetry.emit("pool", "evict", tenant=tenant)
        # global cap: drop the globally least recently used idle sandbox
        while self._total_idle() > self._max_total_idle:
            tenant = min(
                (t for t, b in self._idle.items() if b),
                key=lambda t: min(e[0] for e in self._idle[t]),
            )
            bucket = self._idle[tenant]
            bucket.sort(key=lambda e: e[0])
            bucket.pop(0)
            self.stats.evictions += 1
            self.telemetry.emit("pool", "evict", tenant=tenant)

    # ------------------------------------------------------------------ stats

    def idle_count(self, tenant: Optional[str] = None) -> int:
        with self._lock:
            if tenant is not None:
                return len(self._idle.get(tenant, []))
            return self._total_idle()

    def checked_out(self) -> int:
        with self._lock:
            return len(self._out)

    def tenants(self) -> List[str]:
        """Every tenant the pool has served, seeded or been told to warm."""
        with self._lock:
            return sorted(self._tenants)
