"""Metrics export — Prometheus text exposition for the admission plane.

SEE++ credits much of its operability to *continuous measurement* of
sandbox startup, admission and pool behavior; every layer shares one
:class:`~repro_torch.core.telemetry.TelemetrySink`, whose counters are
only reachable from Python.  :class:`MetricsRegistry` closes the loop: it
renders the sink's counters and histograms, :class:`~repro.core.pool.
SandboxPool` hit/miss/evict/refill stats, :class:`~repro.core.admission.
AdmissionController` cache stats and per-tenant
:class:`~repro.core.tasks.ServerlessScheduler` queue depths into the
`Prometheus text exposition format`_, served over HTTP from
:class:`MetricsHTTPServer` (the ``/metrics`` endpoint) and snapshotted by
:meth:`MetricsRegistry.dump` for tests.

.. _Prometheus text exposition format:
   https://prometheus.io/docs/instrumenting/exposition_formats/
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from .telemetry import Histogram, TelemetrySink

__all__ = ["MetricsRegistry", "MetricsHTTPServer", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


# ---------------------------------------------------------------------------
# text-format primitives
# ---------------------------------------------------------------------------

def escape_label_value(value: str) -> str:
    """Escape a label value per the exposition format (\\ then " then \\n)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def escape_help(text: str) -> str:
    """HELP lines escape backslash and newline, but not quotes."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def format_value(v: float) -> str:
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels(pairs: Dict[str, str]) -> str:
    if not pairs:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in sorted(pairs.items())
    )
    return "{" + inner + "}"


class _Family:
    """One metric family: HELP/TYPE header + sample lines."""

    def __init__(self, name: str, kind: str, help_text: str) -> None:
        self.name = name
        self.kind = kind
        self.help = help_text
        self.samples: List[Tuple[str, Dict[str, str], float]] = []

    def add(self, value: float, labels: Optional[Dict[str, str]] = None,
            suffix: str = "") -> None:
        self.samples.append((suffix, dict(labels or {}), float(value)))

    def render(self) -> str:
        lines = [
            f"# HELP {self.name} {escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        for suffix, labels, value in self.samples:
            lines.append(
                f"{self.name}{suffix}{_labels(labels)} {format_value(value)}"
            )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Collects control-plane components and renders their live state.

    Components are registered once and *read at render time* — the
    registry holds no copies, so every scrape reflects the instant it was
    served.  All metric names share a ``namespace_`` prefix (default
    ``seepp_``) per Prometheus naming conventions.
    """

    def __init__(self, namespace: str = "seepp") -> None:
        self.namespace = namespace
        self._sinks: List[TelemetrySink] = []
        self._pools: List[Any] = []
        self._admissions: List[Any] = []
        self._schedulers: List[Any] = []
        self._servings: List[Any] = []
        self._replica_sets: List[Any] = []
        self._orchestrators: List[Any] = []
        self._autoscalers: List[Any] = []
        self._gauges: List[Tuple[str, str, Callable[[], float]]] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------ register

    def register_sink(self, sink: TelemetrySink) -> "MetricsRegistry":
        with self._lock:
            if sink not in self._sinks:
                self._sinks.append(sink)
        return self

    def register_pool(self, pool: Any) -> "MetricsRegistry":
        with self._lock:
            if pool not in self._pools:
                self._pools.append(pool)
        return self

    def register_admission(self, controller: Any) -> "MetricsRegistry":
        with self._lock:
            if controller not in self._admissions:
                self._admissions.append(controller)
        return self

    def register_scheduler(self, scheduler: Any) -> "MetricsRegistry":
        with self._lock:
            if scheduler not in self._schedulers:
                self._schedulers.append(scheduler)
        return self

    def register_serving(self, engine: Any) -> "MetricsRegistry":
        """Export a :class:`~repro.runtime.serve_loop.ServingEngine` as the
        ``seepp_serving_*`` families (queue depth, active slots, admission
        outcomes, token/prefill/decode counters, chaos counters)."""
        with self._lock:
            if engine not in self._servings:
                self._servings.append(engine)
        return self

    def register_replicas(self, replica_set: Any) -> "MetricsRegistry":
        """Export a :class:`~repro.runtime.replica.ReplicaSet` as the
        ``seepp_serving_replica_*`` / ``seepp_serving_mesh_*`` families
        (per-replica liveness/load/TP width, re-home and mesh-fault
        counters).  Register the member engines individually too if the
        per-tenant serving families should aggregate across them."""
        with self._lock:
            if replica_set not in self._replica_sets:
                self._replica_sets.append(replica_set)
        return self

    def register_orchestrator(self, orch: Any) -> "MetricsRegistry":
        """Export a :class:`~repro.runtime.orchestrator.WorkloadOrchestrator`
        as the ``seepp_orchestrator_*`` families (per-class step/job
        counters, preemptions, resubmits, class-lane queue depths)."""
        with self._lock:
            if orch not in self._orchestrators:
                self._orchestrators.append(orch)
        return self

    def register_elastic(self, autoscaler: Any) -> "MetricsRegistry":
        """Export an :class:`~repro.runtime.elastic.ElasticAutoscaler` as
        the ``seepp_elastic_*`` families (fleet size, scale events, device
        pool healthy/in-use/spare)."""
        with self._lock:
            if autoscaler not in self._autoscalers:
                self._autoscalers.append(autoscaler)
        return self

    def register_gauge(
        self, name: str, help_text: str, fn: Callable[[], float]
    ) -> "MetricsRegistry":
        """Attach an arbitrary callable sampled at scrape time."""
        with self._lock:
            self._gauges.append((name, help_text, fn))
        return self

    def register_arena(self, kv: Any) -> "MetricsRegistry":
        """Occupancy gauges for a :class:`~repro.core.arena.PagedKVAllocator`.

        Exposes the §IV.A story live: host-VMA count (the 182x fix keeps
        it flat), its high-water mark, contiguous-run counts (DMA
        descriptors) and live sequences — all sampled at scrape time.
        """
        mm = kv.arena.mm
        return (
            self.register_gauge(
                "arena_host_vmas",
                "Live host VMAs backing the KV arena "
                "(flat under the modern direction-aligned allocator).",
                mm.host_vma_count,
            )
            .register_gauge(
                "arena_host_vma_high_water",
                "High-water mark of host VMAs since arena creation.",
                lambda: mm.host_vma_high_water,
            )
            .register_gauge(
                "arena_contiguous_runs",
                "Contiguous physical runs across live sequences "
                "(DMA descriptors needed).",
                kv.total_runs,
            )
            .register_gauge(
                "arena_live_sequences",
                "Sequences currently holding KV pages in the arena.",
                lambda: float(len(kv.seq_lens())),
            )
        )

    # -------------------------------------------------------------- render

    def _n(self, name: str) -> str:
        return f"{self.namespace}_{name}" if self.namespace else name

    def _collect(self) -> List[_Family]:
        with self._lock:
            sinks = list(self._sinks)
            pools = list(self._pools)
            admissions = list(self._admissions)
            schedulers = list(self._schedulers)
            servings = list(self._servings)
            replica_sets = list(self._replica_sets)
            orchestrators = list(self._orchestrators)
            autoscalers = list(self._autoscalers)
            gauges = list(self._gauges)

        fams: List[_Family] = []

        # --- telemetry counters: one family, labelled by source/kind -----
        # merged across sinks first: emitting per-sink would produce
        # duplicate series, which Prometheus rejects at scrape time
        merged_counters: Dict[str, int] = {}
        for sink in sinks:
            for name, value in sink.counters().items():
                merged_counters[name] = merged_counters.get(name, 0) + value
        events = _Family(
            self._n("events_total"), "counter",
            "Telemetry counter by emitting subsystem and event kind.",
        )
        for name, value in sorted(merged_counters.items()):
            source, _, kind = name.partition(".")
            events.add(value, {"source": source, "kind": kind})
        if events.samples:
            fams.append(events)

        # --- telemetry histograms (merged across sinks, same reason) -----
        merged_hists: Dict[Tuple[str, str], Histogram] = {}
        for sink in sinks:
            for key, hist in sink.histograms().items():
                seen = merged_hists.get(key)
                if seen is None:
                    merged_hists[key] = hist     # already a snapshot copy
                elif seen.buckets == hist.buckets:
                    seen.merge(hist)
                # differing bucket layouts for the same (name, tenant) are
                # a config error; keep the first rather than emit an
                # inconsistent series
        hist_fams: Dict[str, _Family] = {}
        for (name, tenant), hist in sorted(merged_hists.items()):
            metric = self._n(name.replace(".", "_"))
            fam = hist_fams.get(metric)
            if fam is None:
                fam = hist_fams[metric] = _Family(
                    metric, "histogram",
                    f"Latency histogram for {name} (seconds).",
                )
            base = {"tenant": tenant} if tenant else {}
            self._add_histogram(fam, hist, base)
        fams.extend(hist_fams.values())

        # --- pool stats ---------------------------------------------------
        if pools:
            fams.extend(self._pool_families(pools))

        # --- admission cache stats ---------------------------------------
        if admissions:
            fams.extend(self._admission_families(admissions))

        # --- scheduler ----------------------------------------------------
        if schedulers:
            fams.extend(self._scheduler_families(schedulers))

        # --- serving engine -----------------------------------------------
        if servings:
            fams.extend(self._serving_families(servings))

        # --- replica sets -------------------------------------------------
        if replica_sets:
            fams.extend(self._replica_families(replica_sets))

        # --- workload orchestrator ----------------------------------------
        if orchestrators:
            fams.extend(self._orchestrator_families(orchestrators))

        # --- elastic autoscaler -------------------------------------------
        if autoscalers:
            fams.extend(self._elastic_families(autoscalers))

        # --- ad-hoc gauges ------------------------------------------------
        for name, help_text, fn in gauges:
            fam = _Family(self._n(name), "gauge", help_text)
            fam.add(float(fn()))
            fams.append(fam)

        return fams

    @staticmethod
    def _add_histogram(
        fam: _Family, hist: Histogram, base_labels: Dict[str, str]
    ) -> None:
        for le, cum in hist.bucket_counts():
            labels = dict(base_labels)
            labels["le"] = format_value(le)
            fam.add(cum, labels, suffix="_bucket")
        fam.add(hist.sum, base_labels, suffix="_sum")
        fam.add(hist.count, base_labels, suffix="_count")

    def _pool_families(self, pools: List[Any]) -> List[_Family]:
        # (stats key, metric name, help); "misses" feeds two families —
        # checkout always builds cold when the free list is dry, so the
        # paper-facing cold-checkout name is an alias of the miss counter
        families = [
            ("hits", "pool_hit_total",
             "Checkouts served from a warm sandbox."),
            ("misses", "pool_miss_total",
             "Checkouts that found no idle sandbox."),
            ("misses", "pool_cold_checkout_total",
             "Cold sandbox builds on the checkout hot path "
             "(alias of pool_miss_total)."),
            ("evictions", "pool_evict_total",
             "Idle sandboxes dropped by the LRU caps."),
            ("discards", "pool_discard_total",
             "Poisoned sandboxes destroyed at checkin."),
            ("prewarmed", "pool_prewarm_total",
             "Sandboxes built ahead of demand by explicit prewarm()."),
            ("refills", "pool_refill_total",
             "Sandboxes built by the background refiller."),
            ("orphan_checkins", "pool_orphan_checkin_total",
             "Checkins refused (unknown sandbox/tenant, double checkin, "
             "or checkin after discard)."),
        ]
        fams: List[_Family] = []
        merged: Dict[str, float] = {}
        for pool in pools:
            for key, value in pool.stats.as_dict().items():
                merged[key] = merged.get(key, 0) + value
        for key, name, help_text in families:
            fam = _Family(self._n(name), "counter", help_text)
            fam.add(merged.get(key, 0))
            fams.append(fam)

        idle = _Family(
            self._n("pool_idle_sandboxes"), "gauge",
            "Idle warm sandboxes per tenant.",
        )
        out = _Family(
            self._n("pool_checked_out_sandboxes"), "gauge",
            "Sandboxes currently checked out.",
        )
        total_out = 0
        per_tenant: Dict[str, int] = {}
        for pool in pools:
            total_out += pool.checked_out()
            for tenant in pool.tenants():
                per_tenant[tenant] = (
                    per_tenant.get(tenant, 0) + pool.idle_count(tenant)
                )
        for tenant, n in sorted(per_tenant.items()):
            idle.add(n, {"tenant": tenant})
        out.add(total_out)
        fams += [idle, out]
        return fams

    def _admission_families(self, admissions: List[Any]) -> List[_Family]:
        help_text = {
            "hits": "Verification-cache hits (warm admissions).",
            "misses": "Verification-cache misses (trace + verify).",
            "evictions": "Cache entries evicted by the LRU cap.",
            "invalidations": "Cache entries dropped by invalidate().",
            "denials": "Programs denied at admission.",
        }
        metric_name = {
            "hits": "admission_cache_hit_total",
            "misses": "admission_cache_miss_total",
            "evictions": "admission_cache_evict_total",
            "invalidations": "admission_cache_invalidate_total",
            "denials": "admission_denied_total",
        }
        merged: Dict[str, int] = {}
        for ctl in admissions:
            for key, value in ctl.stats().items():
                merged[key] = merged.get(key, 0) + value
        fams: List[_Family] = []
        for key, text in help_text.items():
            fam = _Family(self._n(metric_name[key]), "counter", text)
            fam.add(merged.get(key, 0))
            fams.append(fam)
        entries = _Family(
            self._n("admission_cache_entries"), "gauge",
            "Live verification-cache entries.",
        )
        entries.add(merged.get("entries", 0))
        fams.append(entries)

        # per-tenant split (the cache is global; accounting is attributed)
        tenant_merged: Dict[str, Dict[str, int]] = {}
        for ctl in admissions:
            by_tenant = getattr(ctl, "stats_by_tenant", None)
            if by_tenant is None:
                continue
            for tenant, bucket in by_tenant().items():
                agg = tenant_merged.setdefault(
                    tenant, {"hits": 0, "misses": 0, "denials": 0}
                )
                for key in agg:
                    agg[key] += bucket.get(key, 0)
        if tenant_merged:
            tenant_families = [
                ("hits", "admission_tenant_cache_hit_total",
                 "Verification-cache hits per tenant."),
                ("misses", "admission_tenant_cache_miss_total",
                 "Verification-cache misses per tenant."),
                ("denials", "admission_tenant_denied_total",
                 "Programs denied at admission per tenant."),
            ]
            for key, name, text in tenant_families:
                fam = _Family(self._n(name), "counter", text)
                for tenant in sorted(tenant_merged):
                    fam.add(tenant_merged[tenant][key], {"tenant": tenant})
                fams.append(fam)

        # quota-slot ledger: the scheduler mirrors slot acquire/release
        # into the admission plane; the outstanding balance is the leak
        # detector (should scrape as 0 whenever the plane is drained)
        slot_merged: Dict[str, Dict[str, int]] = {}
        for ctl in admissions:
            slot_fn = getattr(ctl, "slot_stats", None)
            if slot_fn is None:
                continue
            for tenant, bucket in slot_fn().items():
                agg = slot_merged.setdefault(
                    tenant, {"acquired": 0, "released": 0}
                )
                agg["acquired"] += bucket.get("acquired", 0)
                agg["released"] += bucket.get("released", 0)
        if slot_merged:
            slot_families = [
                ("acquired", "admission_tenant_slots_acquired_total",
                 "Quota slots reserved per tenant (scheduler mirror)."),
                ("released", "admission_tenant_slots_released_total",
                 "Quota slots released per tenant (scheduler mirror)."),
            ]
            for key, name, text in slot_families:
                fam = _Family(self._n(name), "counter", text)
                for tenant in sorted(slot_merged):
                    fam.add(slot_merged[tenant][key], {"tenant": tenant})
                fams.append(fam)
            balance = _Family(
                self._n("admission_tenant_slots_in_flight"), "gauge",
                "Outstanding quota slots per tenant "
                "(acquired - released; nonzero after drain = leak).",
            )
            for tenant in sorted(slot_merged):
                agg = slot_merged[tenant]
                balance.add(
                    agg["acquired"] - agg["released"], {"tenant": tenant}
                )
            fams.append(balance)
        return fams

    def _scheduler_families(self, schedulers: List[Any]) -> List[_Family]:
        depth = _Family(
            self._n("scheduler_queue_depth"), "gauge",
            "Pending tasks per tenant.",
        )
        flight = _Family(
            self._n("scheduler_in_flight"), "gauge",
            "Running tasks per tenant.",
        )
        states = _Family(
            self._n("scheduler_tasks_total"), "counter",
            "Tasks by terminal/current state.",
        )
        workers = _Family(
            self._n("scheduler_workers"), "gauge",
            "Configured worker threads (0 = serial drain mode).",
        )
        busy = _Family(
            self._n("scheduler_worker_busy_seconds_total"), "counter",
            "Cumulative busy time per worker (executor clock).",
        )
        per_worker = _Family(
            self._n("scheduler_worker_tasks_total"), "counter",
            "Tasks executed per worker.",
        )
        depths: Dict[str, int] = {}
        flights: Dict[str, int] = {}
        by_state: Dict[str, int] = {}
        n_workers = 0
        worker_busy: Dict[str, float] = {}
        worker_tasks: Dict[str, float] = {}
        for sched in schedulers:
            for tenant, n in sched.queue_depths().items():
                depths[tenant] = depths.get(tenant, 0) + n
            for tenant, n in sched.in_flight().items():
                flights[tenant] = flights.get(tenant, 0) + n
            for state, n in sched.stats().items():
                by_state[state] = by_state.get(state, 0) + n
            n_workers += getattr(sched, "worker_count", 0)
            stats_fn = getattr(sched, "worker_stats", None)
            if stats_fn is not None:
                for name, ws in stats_fn().items():
                    worker_busy[name] = (
                        worker_busy.get(name, 0.0) + ws["busy_seconds"]
                    )
                    worker_tasks[name] = (
                        worker_tasks.get(name, 0.0) + ws["tasks"]
                    )
        for tenant, n in sorted(depths.items()):
            depth.add(n, {"tenant": tenant})
        for tenant, n in sorted(flights.items()):
            flight.add(n, {"tenant": tenant})
        for state, n in sorted(by_state.items()):
            states.add(n, {"state": state})
        workers.add(n_workers)
        for name in sorted(worker_busy):
            busy.add(worker_busy[name], {"worker": name})
            per_worker.add(worker_tasks[name], {"worker": name})
        fams = [depth, flight, states, workers]
        if worker_busy:
            fams += [busy, per_worker]
        # resilience counters: stealing, cooperative preemption and the
        # two worker-reaping paths (heartbeat timeout, straggler evict)
        resilience = [
            ("steal_count", "scheduler_steal_total",
             "Tasks stolen from a foreign tenant by an idle worker."),
            ("preempt_count", "scheduler_preempted_total",
             "Running tasks preempted (cancel() or run-deadline expiry)."),
            ("heartbeat_death_count", "scheduler_heartbeat_death_total",
             "Workers reaped after their heartbeat went dark mid-task."),
            ("straggler_evict_count", "scheduler_straggler_evict_total",
             "Workers evicted by the straggler detector."),
        ]
        for attr, name, text in resilience:
            fam = _Family(self._n(name), "counter", text)
            fam.add(sum(getattr(s, attr, 0) for s in schedulers))
            fams.append(fam)
        return fams

    def _serving_families(self, servings: List[Any]) -> List[_Family]:
        """The ``seepp_serving_*`` families off ``serving_stats()``."""
        per_tenant = [
            ("queue_depth", "serving_queue_depth", "gauge",
             "Requests queued for admission per tenant."),
            ("active_slots", "serving_active_slots", "gauge",
             "Decode slots held per tenant."),
            ("admitted_total", "serving_admitted_total", "counter",
             "Requests admitted into a decode slot per tenant."),
            ("denied_total", "serving_denied_total", "counter",
             "Requests denied at admission per tenant (zero-slot quota)."),
            ("expired_total", "serving_expired_total", "counter",
             "Requests whose admit deadline passed while queued."),
            ("completed_total", "serving_completed_total", "counter",
             "Requests completed (with or without error) per tenant."),
            ("tokens_total", "serving_tokens_total", "counter",
             "Tokens decoded per tenant."),
        ]
        scalars = [
            ("decode_steps_total", "serving_decode_steps_total", "counter",
             "Batched decode steps executed."),
            ("batch_kill_total", "serving_batch_kill_total", "counter",
             "Decode batches killed mid-flight (chaos)."),
            ("arena_poison_total", "serving_arena_poison_total", "counter",
             "KV-arena sequences poisoned (chaos)."),
            ("evicted_total", "serving_evicted_total", "counter",
             "Live sequences evicted back to the admit queue "
             "(batch kills + arena poison)."),
            ("resumed_total", "serving_resumed_total", "counter",
             "Evicted sequences re-admitted without a prefill (paged "
             "mode: the pages survived, resume is a page-table edit)."),
            ("prefill_chunks_total", "serving_prefill_chunks_total",
             "counter",
             "Bounded prefill chunks executed (chunked prefill: each "
             "advances at most prefill_chunk_tokens prompt rows)."),
            ("kv_pages_allocated_total", "serving_kv_pages_allocated_total",
             "counter", "KV pages faulted in from the arena."),
            ("kv_pages_freed_total", "serving_kv_pages_freed_total",
             "counter",
             "KV pages released (allocated - freed = pages live now)."),
            ("prefix_hits_total", "serving_prefix_hits_total", "counter",
             "Admissions that mapped a shared prompt prefix read-only "
             "instead of prefilling it."),
            ("prefix_shared_pages_total", "serving_prefix_shared_pages_total",
             "counter",
             "KV pages mapped from a prefix donor (no fresh fault)."),
            ("prefix_cow_copies_total", "serving_prefix_cow_copies_total",
             "counter",
             "Shared pages copy-on-written before a divergent write."),
            ("prefix_prefill_tokens_saved_total",
             "serving_prefix_prefill_tokens_saved_total", "counter",
             "Prompt tokens not prefilled because their K/V rows were "
             "already resident in shared pages."),
        ]
        stats = [engine.serving_stats() for engine in servings]
        fams: List[_Family] = []
        for key, name, kind, text in per_tenant:
            merged: Dict[str, float] = {}
            for s in stats:
                for tenant, n in s.get(key, {}).items():
                    merged[tenant] = merged.get(tenant, 0) + n
            fam = _Family(self._n(name), kind, text)
            if merged:
                for tenant in sorted(merged):
                    fam.add(merged[tenant], {"tenant": tenant})
            else:
                fam.add(0)
            fams.append(fam)
        for key, name, kind, text in scalars:
            fam = _Family(self._n(name), kind, text)
            fam.add(sum(s.get(key, 0) for s in stats))
            fams.append(fam)
        # prefill split: mode="incremental" vs mode="full" is the whole
        # re-prefill story — full tokens >> incremental tokens means the
        # engine is paying the rebatching tax the tentpole removed
        for key, name, text in (
            ("prefill_sequences_total", "serving_prefill_sequences_total",
             "Prefill passes by mode (incremental slot vs full rebatch)."),
            ("prefill_tokens_total", "serving_prefill_tokens_total",
             "Tokens pushed through prefill by mode."),
        ):
            fam = _Family(self._n(name), "counter", text)
            merged = {}
            for s in stats:
                for mode, n in s.get(key, {}).items():
                    merged[mode] = merged.get(mode, 0) + n
            for mode in sorted(merged) or ("incremental",):
                fam.add(merged.get(mode, 0), {"mode": mode})
            fams.append(fam)
        # kv_mode info gauge: one sample per mode seen, value 1 — the
        # paged-vs-dense A/B shows up as a label, not a magic number
        fam = _Family(
            self._n("serving_kv_mode"), "gauge",
            "KV backing store in use (info gauge: 1 per active mode).",
        )
        modes = sorted({s.get("kv_mode", "dense") for s in stats}) or ["dense"]
        for mode in modes:
            fam.add(1, {"mode": mode})
        fams.append(fam)
        # sampler-family counters: every family always rendered, so a
        # dashboard sees zero-valued greedy/topp series appear the
        # moment the server starts, not when the first draw happens
        fam = _Family(
            self._n("serving_sampled_tokens_total"), "counter",
            "Tokens drawn per sampler family "
            "(greedy|temperature|topk|topp).",
        )
        for method in ("greedy", "temperature", "topk", "topp"):
            fam.add(
                sum(s.get("sampled_tokens_total", {}).get(method, 0)
                    for s in stats),
                {"method": method},
            )
        fams.append(fam)
        # host time by engine span: the totals live in the telemetry sink,
        # so engines sharing one sink are read once
        spans: Dict[str, List[float]] = {}
        seen = set()
        for engine, s in zip(servings, stats):
            sink = id(engine.telemetry)
            if sink in seen:
                continue
            seen.add(sink)
            for name, (n, sec) in s.get("spans", {}).items():
                tot = spans.setdefault(name, [0, 0.0])
                tot[0] += n
                tot[1] += sec
        secs = _Family(
            self._n("serving_span_seconds_total"), "counter",
            "Host seconds inside each serving span (engine.step, its "
            "phases and their arena, model, logits and sampler leaves).",
        )
        counts = _Family(
            self._n("serving_spans_total"), "counter",
            "Serving spans closed, by span.",
        )
        for name in sorted(spans):
            secs.add(spans[name][1], {"span": name})
            counts.add(spans[name][0], {"span": name})
        fams.extend((secs, counts))
        return fams

    def _replica_families(self, replica_sets: List[Any]) -> List[_Family]:
        """``seepp_serving_replica_*`` / ``seepp_serving_mesh_*`` families.

        Per-replica series carry a ``replica`` label (index within the
        set); set-level mesh-fault counters are summed across registered
        sets.  Everything is read off ``replica_stats()`` at scrape time.
        """
        stats = [rs.replica_stats() for rs in replica_sets]
        fams: List[_Family] = []
        per_replica = [
            ("alive", "serving_replica_alive", "gauge",
             "Replica liveness (0 = evacuated or mesh member dead)."),
            ("tp_shards", "serving_replica_tp_shards", "gauge",
             "Tensor-parallel width of the replica's paged decode."),
            ("active", "serving_replica_active_slots", "gauge",
             "Decode slots held on the replica."),
            ("queued", "serving_replica_queue_depth", "gauge",
             "Requests queued for admission on the replica."),
            ("completed", "serving_replica_completed_total", "counter",
             "Requests completed on the replica."),
            ("evictions", "serving_replica_evicted_total", "counter",
             "Sequences evicted on the replica (chaos + evacuation)."),
            ("live_pages", "serving_replica_live_pages", "gauge",
             "KV pages live on the replica's (per-shard) page pool."),
        ]
        for key, name, kind, text in per_replica:
            fam = _Family(self._n(name), kind, text)
            idx = 0
            for s in stats:
                for per in s["per_replica"]:
                    fam.add(per[key], {"replica": str(idx)})
                    idx += 1
            fams.append(fam)
        scalars = [
            ("rehomed_total", "serving_replica_rehomed_total", "counter",
             "Requests re-homed onto a surviving replica after a death."),
            ("replica_kills", "serving_replica_kills_total", "counter",
             "Replica processes killed loudly (chaos)."),
            ("orphaned", "serving_replica_orphaned_total", "counter",
             "Evacuated requests with no surviving replica to take them."),
            ("replicas_alive", "serving_mesh_replicas_alive", "gauge",
             "Replicas currently serving."),
            ("mesh_members_dead", "serving_mesh_members_dead", "gauge",
             "Mesh members currently dead and not yet reaped."),
            ("mesh_member_kills", "serving_mesh_member_kills_total",
             "counter", "Mesh members killed silently (chaos)."),
            ("heartbeat_reaps", "serving_mesh_heartbeat_reaps_total",
             "counter",
             "Silent replicas reaped by the heartbeat monitor."),
        ]
        for key, name, kind, text in scalars:
            fam = _Family(self._n(name), kind, text)
            fam.add(sum(s[key] for s in stats))
            fams.append(fam)
        return fams

    def _orchestrator_families(self, orchestrators: List[Any]) -> List[_Family]:
        """``seepp_orchestrator_*`` families off ``orchestrator_stats()``.

        Class-lane queue depths carry a ``workload_class`` label; scalar
        counters sum across registered orchestrators.
        """
        stats = [o.orchestrator_stats() for o in orchestrators]
        fams: List[_Family] = []
        scalars = [
            ("ticks", "orchestrator_ticks_total", "counter",
             "Orchestration rounds executed."),
            ("serving_steps", "orchestrator_serving_steps_total", "counter",
             "Decode step-tasks completed on the shared pool."),
            ("train_steps", "orchestrator_train_steps_total", "counter",
             "Training step-tasks completed on the shared pool."),
            ("serving_step_failures",
             "orchestrator_serving_step_failures_total", "counter",
             "Decode step-tasks that landed in a non-success state."),
            ("batch_jobs_submitted", "orchestrator_batch_jobs_submitted_total",
             "counter", "Batch jobs accepted by the orchestrator."),
            ("batch_jobs_done", "orchestrator_batch_jobs_done_total",
             "counter", "Batch jobs that completed successfully."),
            ("batch_jobs_failed", "orchestrator_batch_jobs_failed_total",
             "counter", "Batch jobs that failed terminally."),
            ("preemptions_total", "orchestrator_preemptions_total", "counter",
             "Batch tasks preempted to unblock a pending decode step."),
            ("batch_resubmits_total", "orchestrator_batch_resubmits_total",
             "counter", "Batch tasks resubmitted after preemption."),
            ("workers_active", "orchestrator_workers_active", "gauge",
             "Workers serving the shared pool (condemned excluded)."),
        ]
        for key, name, kind, text in scalars:
            fam = _Family(self._n(name), kind, text)
            fam.add(sum(s[key] for s in stats))
            fams.append(fam)
        depth = _Family(
            self._n("orchestrator_class_queue_depth"), "gauge",
            "Pending tasks per workload class on the shared pool.",
        )
        merged: Dict[str, int] = {}
        for o in orchestrators:
            for cls, n in o.class_queue_depths().items():
                merged[cls] = merged.get(cls, 0) + n
        for cls in sorted(merged):
            depth.add(merged[cls], {"workload_class": cls})
        fams.append(depth)
        return fams

    def _elastic_families(self, autoscalers: List[Any]) -> List[_Family]:
        """``seepp_elastic_*`` families off ``elastic_stats()``."""
        stats = [a.elastic_stats() for a in autoscalers]
        fams: List[_Family] = []
        scalars = [
            ("workers_active", "elastic_workers_active", "gauge",
             "Worker fleet size the autoscaler currently manages."),
            ("replicas_alive", "elastic_replicas_alive", "gauge",
             "Serving replicas alive under autoscaler management."),
            ("scale_up_total", "elastic_scale_up_total", "counter",
             "Worker scale-up actions taken."),
            ("scale_down_total", "elastic_scale_down_total", "counter",
             "Worker scale-down actions taken."),
            ("class_scale_down_total", "elastic_class_scale_down_total",
             "counter",
             "Worker scale-downs triggered by one workload class's "
             "queue idling (per-class lane shrink)."),
            ("replica_scale_up_total", "elastic_replica_scale_up_total",
             "counter", "Replica scale-up actions taken."),
            ("replica_scale_down_total", "elastic_replica_scale_down_total",
             "counter", "Replica scale-down actions taken."),
            ("decisions_total", "elastic_decisions_total", "counter",
             "Autoscaler ticks recorded in the decision log."),
            ("pool_healthy", "elastic_pool_healthy_devices", "gauge",
             "Healthy devices in the elastic pool."),
            ("pool_in_use", "elastic_pool_in_use_devices", "gauge",
             "Devices the planned mesh currently occupies."),
            ("pool_spare", "elastic_pool_spare_devices", "gauge",
             "Healthy devices the current mesh leaves idle."),
        ]
        for key, name, kind, text in scalars:
            fam = _Family(self._n(name), kind, text)
            fam.add(sum(s[key] for s in stats))
            fams.append(fam)
        return fams

    # -------------------------------------------------------------- output

    def render(self) -> str:
        """The full ``/metrics`` payload (trailing newline included)."""
        return "\n".join(f.render() for f in self._collect()) + "\n"

    def dump(self) -> Dict[str, Any]:
        """JSON-able snapshot of every sample, for tests and benches.

        ``{metric_name: {label_string: value}}`` — label_string is the
        rendered ``{k="v"}`` form ("" for unlabelled samples).
        """
        out: Dict[str, Dict[str, float]] = {}
        for fam in self._collect():
            for suffix, labels, value in fam.samples:
                out.setdefault(fam.name + suffix, {})[_labels(labels)] = value
        return out

    def to_json(self) -> str:
        return json.dumps(self.dump(), sort_keys=True)


# ---------------------------------------------------------------------------
# HTTP endpoint
# ---------------------------------------------------------------------------

class MetricsHTTPServer:
    """Background-thread HTTP server exposing ``GET /metrics``.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    ``GET /metrics.json`` serves the :meth:`MetricsRegistry.dump` snapshot
    for tooling that prefers JSON.
    """

    def __init__(
        self,
        registry: MetricsRegistry,
        port: int = 0,
        host: str = "127.0.0.1",
    ) -> None:
        self.registry = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(h) -> None:  # noqa: N805 - http.server idiom
                if h.path.split("?", 1)[0] in ("/metrics", "/"):
                    body = registry.render().encode()
                    h.send_response(200)
                    h.send_header("Content-Type", CONTENT_TYPE)
                    h.send_header("Content-Length", str(len(body)))
                    h.end_headers()
                    h.wfile.write(body)
                elif h.path.split("?", 1)[0] == "/metrics.json":
                    body = registry.to_json().encode()
                    h.send_response(200)
                    h.send_header("Content-Type", "application/json")
                    h.send_header("Content-Length", str(len(body)))
                    h.end_headers()
                    h.wfile.write(body)
                else:
                    h.send_error(404)

            def log_message(h, fmt: str, *args: Any) -> None:
                pass  # scrapes must not spam the engine's stdout

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="seepp-metrics",
            daemon=True,
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "MetricsHTTPServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
