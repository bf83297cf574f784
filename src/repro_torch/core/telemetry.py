"""Structured telemetry — one audit/metrics sink for every admission layer.

The seed grew three divergent audit trails: ``Sandbox`` kept an ad-hoc
``AuditEvent`` list, the scheduler kept task records, and the server kept
nothing.  The paper's admission story (§III, §V) is *centrally* audited:
every stage — image check, verification, budget, pool checkout — lands in
one place so an operator can reconstruct exactly why a program was admitted
or denied.  :class:`TelemetrySink` is that place: a bounded event log plus
monotonic counters and span totals, shared by :mod:`~repro.core.admission`,
:mod:`~repro.core.pool`, :class:`~repro.core.sandbox.Sandbox`,
:class:`~repro.core.tasks.ServerlessScheduler` and the serving loop.

Spans (:meth:`TelemetrySink.span`) time the host's work in named regions:
their count and seconds always accumulate in the sink, and while a
``torch.profiler`` runs each span is also a ``record_function`` range, so
it sits on the profiler's timeline beside the kernels it launched.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = [
    "DEFAULT_BUCKETS",
    "Histogram",
    "TelemetryEvent",
    "TelemetrySink",
    "resolve_sink",
]

_profiler_enabled = torch._C._autograd._profiler_enabled

# Latency-oriented upper bounds (seconds): 10us .. 10s, then +Inf.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0,
)


def resolve_sink(admission=None, telemetry=None) -> "TelemetrySink":
    """One sink for every admission layer: the controller's sink wins.

    Components accept both an ``admission`` controller and a ``telemetry``
    sink; honoring a distinct ``telemetry`` next to a controller would
    split the audit trail across two sinks, so the controller's own sink
    takes precedence whenever a controller is supplied.
    """
    if admission is not None:
        return admission.sink
    return telemetry if telemetry is not None else TelemetrySink()


@dataclass(frozen=True)
class TelemetryEvent:
    """One structured audit/metrics event.

    ``source`` is the emitting subsystem (``"sandbox"``, ``"admission"``,
    ``"pool"``, ``"scheduler"``, ``"server"``); ``kind`` is the event name
    within it (``"run"``, ``"cache_hit"``, ``"evict"``, ...).
    """

    when: float
    source: str
    kind: str
    tenant: str = ""
    detail: str = ""
    data: Tuple[Tuple[str, Any], ...] = ()

    def get(self, key: str, default: Any = None) -> Any:
        for k, v in self.data:
            if k == key:
                return v
        return default


class Histogram:
    """Prometheus-style histogram (fixed upper bounds + +Inf).

    ``observe`` is the hot path (the pool calls it on every checkout), so
    internal counts are per-bucket — one ``bisect`` + one increment — and
    the cumulative form the text exposition needs is produced at render
    time by :meth:`bucket_counts`.
    """

    __slots__ = ("buckets", "_counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # last slot = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        self.sum += value
        self.count += 1
        self._counts[bisect_left(self.buckets, value)] += 1

    def copy(self) -> "Histogram":
        """Point-in-time copy (the sink snapshots under its lock)."""
        out = Histogram.__new__(Histogram)
        out.buckets = self.buckets
        out._counts = list(self._counts)
        out.sum = self.sum
        out.count = self.count
        return out

    def merge(self, other: "Histogram") -> None:
        """Fold ``other`` into this histogram (same bucket layout only)."""
        if other.buckets != self.buckets:
            raise ValueError(
                f"cannot merge histograms with different buckets: "
                f"{self.buckets} vs {other.buckets}"
            )
        for i, n in enumerate(other._counts):
            self._counts[i] += n
        self.sum += other.sum
        self.count += other.count

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """``(le, cumulative_count)`` pairs, ending with ``(inf, count)``."""
        out: List[Tuple[float, int]] = []
        cum = 0
        for i, le in enumerate(self.buckets):
            cum += self._counts[i]
            out.append((le, cum))
        out.append((float("inf"), cum + self._counts[-1]))
        return out


class _Span:
    """One open span of a sink (see :meth:`TelemetrySink.span`)."""

    __slots__ = ("_sink", "_name", "_args", "_range", "_t0")

    def __init__(self, sink: "TelemetrySink", name: str, args: str) -> None:
        self._sink = sink
        self._name = name
        self._args = args
        self._range = None

    def __enter__(self) -> "_Span":
        if _profiler_enabled():
            self._range = torch.autograd.profiler.record_function(
                self._name, self._args or None)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> None:
        ns = time.perf_counter_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        self._sink.add_span(self._name, ns)


class TelemetrySink:
    """Bounded event log + counters + histograms + span totals shared
    across the plane.

    Thread-safe: the pool's background refiller and the serving loop may
    emit concurrently.
    """

    def __init__(self, capacity: int = 4096) -> None:
        self._events: "deque[TelemetryEvent]" = deque(maxlen=capacity)
        self._counters: Dict[str, int] = {}
        self._histograms: Dict[Tuple[str, str], Histogram] = {}
        #: span name -> [count, host nanoseconds]
        self._spans: Dict[str, List[int]] = {}
        self._lock = threading.Lock()

    # ----------------------------------------------------------------- emit

    def emit(
        self,
        source: str,
        kind: str,
        *,
        tenant: str = "",
        detail: str = "",
        **data: Any,
    ) -> TelemetryEvent:
        ev = TelemetryEvent(
            time.time(), source, kind, tenant, detail, tuple(sorted(data.items()))
        )
        name = f"{source}.{kind}"
        with self._lock:
            self._events.append(ev)
            self._counters[name] = self._counters.get(name, 0) + 1
        return ev

    def count(self, name: str, by: int = 1) -> None:
        """Bump a bare counter with no event record (hot-path metrics)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + by

    def observe(
        self,
        name: str,
        value: float,
        *,
        tenant: str = "",
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> None:
        """Record ``value`` into the ``(name, tenant)`` histogram.

        Raises :class:`ValueError` if the histogram already exists with a
        different bucket layout — silently binning into the wrong buckets
        would make the exported series meaningless.
        """
        key = (name, tenant)
        with self._lock:
            hist = self._histograms.get(key)
            if hist is None:
                hist = self._histograms[key] = Histogram(buckets)
            elif hist.buckets != buckets and hist.buckets != tuple(
                sorted(buckets)
            ):
                raise ValueError(
                    f"histogram {key!r} exists with buckets {hist.buckets}, "
                    f"refusing mismatched {tuple(sorted(buckets))}"
                )
            hist.observe(value)

    def count_observe(
        self,
        counter: str,
        name: str,
        value: float,
        *,
        tenant: str = "",
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> None:
        """Counter bump + histogram observation under one lock acquisition.

        The pool's warm-checkout path records both on every request; fusing
        them keeps the hot path to a single sink lock.  Same bucket-layout
        validation as :meth:`observe`.
        """
        key = (name, tenant)
        with self._lock:
            self._counters[counter] = self._counters.get(counter, 0) + 1
            hist = self._histograms.get(key)
            if hist is None:
                hist = self._histograms[key] = Histogram(buckets)
            elif hist.buckets != buckets and hist.buckets != tuple(
                sorted(buckets)
            ):
                raise ValueError(
                    f"histogram {key!r} exists with buckets {hist.buckets}, "
                    f"refusing mismatched {tuple(sorted(buckets))}"
                )
            hist.observe(value)

    def span(self, name: str, args: str = "") -> _Span:
        """Context manager timing the host's work in ``name``.

        Always adds one to the name's count and the seconds spent (host
        clock, ``time.perf_counter_ns``) to its total.  While a
        ``torch.profiler`` runs it also opens
        ``record_function(name, args)``, so the span and the kernels it
        launched share the profiler's clock; with none running a span is
        two clock reads and one update.  ``args`` (``req=<id>``,
        ``step=<n>``) names the instance to that range only.
        """
        return _Span(self, name, args)

    def add_span(self, name: str, ns: int, count: int = 1) -> None:
        """Add ``count`` spans of ``ns`` host nanoseconds in all to
        ``name``'s total: for work timed on the host clock in pieces too
        small to open a span each (no profiler range)."""
        with self._lock:
            tot = self._spans.get(name)
            if tot is None:
                self._spans[name] = [count, ns]
            else:
                tot[0] += count
                tot[1] += ns

    # ---------------------------------------------------------------- query

    def spans(self) -> Dict[str, List[float]]:
        """``{name: [count, seconds]}`` of every span closed so far
        (monotonic, like the counters)."""
        with self._lock:
            return {k: [n, ns * 1e-9] for k, (n, ns) in self._spans.items()}

    @property
    def events(self) -> List[TelemetryEvent]:
        with self._lock:
            return list(self._events)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def histograms(self) -> Dict[Tuple[str, str], Histogram]:
        """Consistent snapshot of every ``(name, tenant)`` histogram.

        Copies are taken under the sink lock so a renderer racing a
        concurrent ``observe`` never sees ``count``/``sum``/buckets
        mutually inconsistent (e.g. a +Inf bucket short of ``_count``).
        """
        with self._lock:
            return {k: h.copy() for k, h in self._histograms.items()}

    def histogram(self, name: str, tenant: str = "") -> Optional[Histogram]:
        """Snapshot of one histogram, or None if never observed."""
        with self._lock:
            hist = self._histograms.get((name, tenant))
            return hist.copy() if hist is not None else None

    def query(
        self,
        source: Optional[str] = None,
        kind: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> List[TelemetryEvent]:
        out: List[TelemetryEvent] = []
        for ev in self.events:
            if source is not None and ev.source != source:
                continue
            if kind is not None and ev.kind != kind:
                continue
            if tenant is not None and ev.tenant != tenant:
                continue
            out.append(ev)
        return out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._counters.clear()
            self._histograms.clear()
            self._spans.clear()
