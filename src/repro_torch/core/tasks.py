"""Serverless Tasks — concurrent multi-tenant scheduled execution (§V.A).

The paper's Serverless Tasks run many tenants' workloads *concurrently* on
warehouse nodes.  :class:`ServerlessScheduler` is the engine-side execution
plane: tenants submit tasks (sandboxed callables with resource quotas);
``workers`` threads drain per-tenant fair queues — weighted deficit
round-robin **across** tenants, priority order **within** a tenant — under
per-tenant in-flight caps that hold under parallelism.  Tasks carry
optional deadlines (an expired task lands in :attr:`TaskState.EXPIRED`
without consuming its quota slot) and pending tasks can be cancelled.

Concurrency runs on the :mod:`~repro.core.sim` substrate: production uses
:class:`~repro.core.sim.ThreadExecutor` (real threads, wall time) while
tests pass a :class:`~repro.core.sim.SimExecutor` (virtual clock + seeded
cooperative interleaving), so every concurrency test is deterministic and
replayable from a seed — including injected faults: poisoned sandboxes,
mid-task worker death (the task is requeued exactly once), slow builds,
sick nodes that stop heartbeating, and cooperative preemption.

Resilience plane:

* **Cooperative preemption** — every task carries a :class:`CancelToken`;
  ``cancel()`` on a *running* task (or an expired ``run_deadline_s``)
  trips the token, and the task lands in :attr:`TaskState.PREEMPTED` at
  its next checkpoint: between retry attempts for free, or mid-body
  wherever user code calls :func:`checkpoint`.  A preempted task always
  releases its quota slot; its sandbox is recycled when preemption was
  observed at an attempt boundary (clean) and discarded when the body
  was interrupted mid-run (state unknowable).
* **Work stealing** — with ``affinity`` configured (worker → home
  tenants), a worker whose home tenants are all at their in-flight cap
  (or idle) steals the best task from the most-backlogged *unthrottled*
  foreign tenant.  The steal reservation is atomic under the scheduler
  lock, so per-tenant caps and weighted-DRR fairness still hold.
* **Node-level faults** — workers heartbeat into a
  :class:`~repro_torch.runtime.fault.HeartbeatMonitor` driven by the executor
  clock; ``check_heartbeats()`` (or the production watchdog thread)
  reaps a worker that went dark mid-task: its slot is released, the task
  requeued through the existing exactly-once death path, and any zombie
  completion of the revoked dispatch is discarded.  A
  :class:`~repro_torch.runtime.fault.StragglerDetector` flags persistently
  slow workers for the same eviction path before they fail outright.

The serial API is preserved: ``run_pending()`` drains the queue on the
calling thread in global priority order, exactly as the seed did.

Sandboxes are drawn from a shared :class:`~repro.core.pool.SandboxPool`
(warm startup) and all verification routes through one
:class:`~repro.core.admission.AdmissionController`, so retries and
resubmissions of an already-verified program are warm admissions.  Every
scheduling decision lands in :meth:`trace` with executor timestamps —
byte-identical across sim runs with the same seed.
"""

from __future__ import annotations

import enum
import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import (
    TYPE_CHECKING, Callable, Dict, Iterable, List, Optional, Set, Tuple,
)

from .admission import AdmissionController
from .policy import SandboxViolation
from .pool import SandboxPool
from .sandbox import Sandbox, SandboxResult
from .sentry import BudgetExceeded
from .sim import Executor, ThreadExecutor, WorkerKilled
from .telemetry import TelemetrySink, resolve_sink

if TYPE_CHECKING:
    from repro_torch.runtime.fault import HeartbeatMonitor, StragglerDetector

    from .metrics import MetricsRegistry

__all__ = [
    "CancelToken",
    "TaskPreempted",
    "TaskState",
    "TaskSpec",
    "TaskRecord",
    "ServerlessScheduler",
    "TenantQuota",
    "checkpoint",
    "current_cancel_token",
]


class TaskState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    DENIED = "denied"        # sandbox policy violation at admission
    THROTTLED = "throttled"  # legacy transient marker (kept for API compat)
    EXPIRED = "expired"      # deadline passed before the task could run
    CANCELLED = "cancelled"  # cancelled while still pending
    PREEMPTED = "preempted"  # cancelled/deadline-expired while running


#: states a task never leaves
TERMINAL_STATES = frozenset({
    TaskState.SUCCEEDED, TaskState.FAILED, TaskState.DENIED,
    TaskState.EXPIRED, TaskState.CANCELLED, TaskState.PREEMPTED,
})


class TaskPreempted(Exception):
    """Raised at a cooperative checkpoint inside a preempted task body."""


class CancelToken:
    """Cooperative preemption flag threaded into running tasks.

    ``cancel()`` trips the token immediately; a ``deadline_at`` (executor
    clock) trips it lazily once time passes it.  The scheduler polls
    :meth:`tripped` between retry attempts, and task bodies may call
    :meth:`checkpoint` (or the module-level :func:`checkpoint`) at safe
    points to be preempted mid-run.
    """

    __slots__ = ("_clock", "_deadline_at", "_reason", "_lock")

    def __init__(
        self,
        clock: Callable[[], float],
        deadline_at: Optional[float] = None,
    ) -> None:
        self._clock = clock
        self._deadline_at = deadline_at
        self._reason: Optional[str] = None
        self._lock = threading.Lock()

    def cancel(self, reason: str = "cancelled while running") -> None:
        with self._lock:
            if self._reason is None:       # first cancellation reason wins
                self._reason = reason

    def tripped(self) -> Optional[str]:
        """The preemption reason, or None while the task may keep running."""
        with self._lock:
            if self._reason is not None:
                return self._reason
        if self._deadline_at is not None and self._clock() > self._deadline_at:
            return f"run deadline passed at t={self._deadline_at:.6f}"
        return None

    def checkpoint(self) -> None:
        reason = self.tripped()
        if reason is not None:
            raise TaskPreempted(reason)


_ACTIVE_TOKEN = threading.local()


def current_cancel_token() -> Optional[CancelToken]:
    """The token of the task executing on this thread/sim-worker, if any."""
    return getattr(_ACTIVE_TOKEN, "token", None)


def checkpoint() -> None:
    """Cooperative preemption point for task bodies.

    Also heartbeats the executing worker (when the scheduler judges
    liveness by heartbeat), so a long-running body that checkpoints
    regularly is never reaped as dead while it makes progress.  No-op
    outside a scheduled task (and for tasks nobody preempted), so
    library code can sprinkle checkpoints unconditionally.
    """
    beat = getattr(_ACTIVE_TOKEN, "beat", None)
    if beat is not None:
        beat()
    token = current_cancel_token()
    if token is not None:
        token.checkpoint()


@dataclass(frozen=True)
class TenantQuota:
    max_tasks_in_flight: int = 4
    flop_budget_per_task: Optional[float] = None
    byte_budget_per_task: Optional[float] = None
    #: deficit-round-robin share: a weight-3 tenant is offered three task
    #: dispatches for every one a weight-1 tenant gets while both queue
    weight: int = 1


@dataclass(frozen=True)
class TaskSpec:
    tenant: str
    fn: Callable
    args: Tuple = ()
    priority: int = 10          # lower = sooner (within the tenant)
    max_retries: int = 1
    name: str = ""
    #: seconds after submission by which the task must *start*; past it
    #: the task is EXPIRED at dispatch instead of run
    deadline_s: Optional[float] = None
    #: seconds after submission by which the task must *finish*; past it
    #: a running task is PREEMPTED at its next cooperative checkpoint
    run_deadline_s: Optional[float] = None


@dataclass
class TaskRecord:
    task_id: int
    spec: TaskSpec
    state: TaskState = TaskState.PENDING
    result: Optional[SandboxResult] = None
    error: Optional[str] = None
    attempts: int = 0
    submitted_at: float = field(default_factory=time.time)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    worker: Optional[str] = None       # worker that (last) ran the task
    death_requeues: int = 0            # times requeued after worker death
    token: Optional[CancelToken] = None  # cooperative preemption flag

    def history(self) -> Tuple:
        """Deterministic summary for replay comparison (sim mode).

        Everything here derives from the executor clock and the schedule,
        so two sim runs with the same seed produce identical histories.
        Wall-clock artifacts (``result.wall_s``) are deliberately absent.
        """
        return (
            self.task_id,
            self.spec.tenant,
            self.spec.name,
            self.state.value,
            self.attempts,
            self.worker,
            self.death_requeues,
            self.submitted_at,
            self.started_at,
            self.finished_at,
            self.error,
        )


class ServerlessScheduler:
    """Fair concurrent scheduler running sandboxed tasks for many tenants.

    With ``workers == 0`` (default) it behaves like the seed: a serial,
    deterministic ``run_pending()`` drain.  With ``workers > 0``, call
    :meth:`start` then :meth:`drain`/:meth:`shutdown`; dispatch order is
    weighted deficit round-robin across tenants and priority within one.
    """

    def __init__(
        self,
        sandbox_factory: Callable[[str, TenantQuota], Sandbox] | None = None,
        quotas: Optional[Dict[str, TenantQuota]] = None,
        *,
        admission: Optional[AdmissionController] = None,
        pool: Optional[SandboxPool] = None,
        telemetry: Optional[TelemetrySink] = None,
        refill_watermark: int = 0,
        workers: int = 0,
        executor: Optional[Executor] = None,
        affinity: Optional[Dict[str, Iterable[str]] | str] = None,
        steal: Optional[bool] = None,
    ) -> None:
        self.telemetry = resolve_sink(admission, telemetry)
        self.admission = admission or AdmissionController(sink=self.telemetry)
        self._factory = sandbox_factory or self._default_factory
        self._quotas = quotas or {}
        self.pool = pool or SandboxPool(
            factory=lambda tenant: self._factory(tenant, self.quota(tenant)),
            refill_watermark=refill_watermark,
            admission=self.admission,
            telemetry=self.telemetry,
        )
        self._exec = executor or ThreadExecutor()
        self._workers_n = max(0, int(workers))
        # one lock guards every queue/record/accounting structure below;
        # telemetry and the pool have their own locks and never call back
        # into the scheduler, so lock order is always scheduler -> them
        self._lock = threading.RLock()
        self._pending: Dict[str, List[Tuple[int, int, int]]] = {}
        self._ring: List[str] = []         # DRR rotation (first-seen order)
        self._rr_pos = 0
        self._deficit: Dict[str, float] = {}
        self._records: Dict[int, TaskRecord] = {}
        self._ids = itertools.count(1)
        self._in_flight: Dict[str, int] = {}
        self._trace: List[str] = []
        self._started = False
        self._stop = False
        self._worker_busy: Dict[str, float] = {}
        self._worker_tasks: Dict[str, int] = {}
        # work stealing: worker -> home tenants; workers absent from the
        # map serve every tenant (affinity=None keeps the affinity-free behavior and
        # byte-identical traces for affinity-free workloads).
        # affinity="auto" starts with an empty map (everyone serves
        # everyone) and derives homes from observed per-tenant load on
        # each rebalance_affinity() tick
        self._auto_affinity = affinity == "auto"
        if self._auto_affinity:
            affinity = None
        self._affinity: Dict[str, frozenset] = {
            w: frozenset(ts) for w, ts in (affinity or {}).items()
        }
        self._steal_enabled = (
            bool(self._affinity) or self._auto_affinity
            if steal is None else bool(steal)
        )
        # auto-rebalancing state: EWMA of per-tenant admission volume
        # (hits+misses+denials deltas from stats_by_tenant) per tick
        self._load_ewma: Dict[str, float] = {}
        self._load_seen: Dict[str, int] = {}
        self._rebalances = 0
        self._rebalancer: Optional[Tuple[threading.Thread, threading.Event]] = None
        # node-fault plane: which worker runs which task, which workers
        # were reaped (condemned), and which (task, worker) dispatches
        # were revoked by a reaper so zombie completions are discarded
        self._running_task: Dict[str, int] = {}
        self._condemned: Set[str] = set()
        self._revoked: Set[Tuple[int, str]] = set()
        self._hb_monitor: Optional["HeartbeatMonitor"] = None
        self._hb_replace = False
        self._hb_watchdog: Optional[Tuple[threading.Thread, threading.Event]] = None
        self._straggler: Optional["StragglerDetector"] = None
        self._steals = 0
        self._preempts = 0
        self._hb_deaths = 0
        self._straggler_evicts = 0

    def _default_factory(self, tenant: str, quota: TenantQuota) -> Sandbox:
        # all tenant sandboxes share the scheduler's admission controller,
        # so resubmission of a verified program is a warm admission
        return Sandbox(
            tenant=tenant,
            flop_budget=quota.flop_budget_per_task,
            byte_budget=quota.byte_budget_per_task,
            admission=self.admission,
            telemetry=self.telemetry,
        )

    def quota(self, tenant: str) -> TenantQuota:
        return self._quotas.get(tenant, TenantQuota())

    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        """Install or replace a tenant's quota (orchestrator class lanes)."""
        with self._lock:
            self._quotas[tenant] = quota

    def sandbox_for(self, tenant: str) -> Sandbox:
        """Borrow a warm sandbox (checkout + immediate checkin)."""
        sandbox = self.pool.checkout(tenant)
        self.pool.checkin(sandbox)
        return sandbox

    def prewarm(self, tenant: str, count: int = 1) -> int:
        return self.pool.prewarm(tenant, count)

    @property
    def executor(self) -> Executor:
        return self._exec

    # -------------------------------------------------------------- submit

    def submit(self, spec: TaskSpec) -> int:
        with self._lock:
            task_id = next(self._ids)
            rec = TaskRecord(task_id, spec, submitted_at=self._exec.now())
            rec.token = CancelToken(
                self._exec.now,
                deadline_at=(
                    rec.submitted_at + spec.run_deadline_s
                    if spec.run_deadline_s is not None else None
                ),
            )
            self._records[task_id] = rec
            # seq = task_id: global submission order breaks priority ties
            heapq.heappush(
                self._pending.setdefault(spec.tenant, []),
                (spec.priority, task_id, task_id),
            )
            if spec.tenant not in self._deficit:
                self._ring.append(spec.tenant)
                self._deficit[spec.tenant] = 0.0
            self._note("submit", task_id, spec.tenant, "")
        self._exec.notify()
        return task_id

    def cancel(self, task_id: int) -> bool:
        """Cancel a pending task, or cooperatively preempt a running one.

        A PENDING task is CANCELLED on the spot.  A RUNNING task has its
        :class:`CancelToken` tripped: it lands in
        :attr:`TaskState.PREEMPTED` at its next checkpoint — between
        retry attempts, or wherever its body calls :func:`checkpoint` —
        releasing its quota slot and sandbox.  Terminal tasks return
        False.
        """
        with self._lock:
            rec = self._records[task_id]
            if rec.state is TaskState.PENDING:
                rec.state = TaskState.CANCELLED
                rec.finished_at = self._exec.now()
                self._note("cancel", task_id, rec.spec.tenant, "")
                event = "scheduler.cancelled"
            elif rec.state is TaskState.RUNNING and rec.token is not None:
                rec.token.cancel("cancelled by cancel() while running")
                self._note(
                    "preempt_request", task_id, rec.spec.tenant,
                    rec.worker or "",
                )
                event = "scheduler.preempt_requested"
            else:
                return False
        self.telemetry.count(event)
        self._exec.notify()                # let workers sweep the heap entry
        return True

    # ------------------------------------------------------------ dispatch

    def _note(self, event: str, task_id: int, tenant: str, worker: str) -> None:
        # executor timestamps: virtual (deterministic) under SimExecutor
        self._trace.append(
            f"{self._exec.now():.6f} {event} task={task_id} "
            f"tenant={tenant} worker={worker}"
        )

    def _expire_locked(self, rec: TaskRecord) -> None:
        rec.state = TaskState.EXPIRED
        rec.finished_at = self._exec.now()
        rec.error = (
            f"deadline {rec.spec.deadline_s}s passed before dispatch"
        )
        self._note("expire", rec.task_id, rec.spec.tenant, "")
        self.telemetry.count("scheduler.expired")

    def _clean_head_locked(self, tenant: str) -> Optional[Tuple[int, int, int]]:
        """Drop cancelled/expired entries; return the live head, if any."""
        heap = self._pending.get(tenant)
        now = self._exec.now()
        while heap:
            _, _, task_id = heap[0]
            rec = self._records[task_id]
            if rec.state is TaskState.CANCELLED:
                heapq.heappop(heap)
                continue
            dl = rec.spec.deadline_s
            if dl is not None and now - rec.submitted_at > dl:
                heapq.heappop(heap)
                # EXPIRED without ever reserving a slot: the quota stays
                # free for the tenant's live work
                self._expire_locked(rec)
                continue
            return heap[0]
        return None

    def _reserve_locked(self, tenant: str, worker: str) -> int:
        """Pop the tenant's best task and take its in-flight slot."""
        _, _, task_id = heapq.heappop(self._pending[tenant])
        rec = self._records[task_id]
        now = self._exec.now()
        rec.state = TaskState.RUNNING
        rec.worker = worker
        rec.started_at = now
        self._in_flight[tenant] = self._in_flight.get(tenant, 0) + 1
        self._running_task[worker] = task_id
        # mirror the slot into the admission plane's double-entry ledger:
        # after a clean drain both accounts must agree (slot_balance == 0)
        self.admission.slot_acquired(tenant)
        if not self._pending[tenant]:
            self._deficit[tenant] = 0.0    # DRR: credit dies with the queue
        self.telemetry.observe(
            "scheduler.queue_wait_seconds", now - rec.submitted_at,
            tenant=tenant,
        )
        self._note("dispatch", task_id, tenant, worker)
        return task_id

    def _tenant_weight(self, tenant: str) -> float:
        return float(max(1, int(self.quota(tenant).weight)))

    def _saturated_locked(self, tenant: str) -> bool:
        return (
            self._in_flight.get(tenant, 0)
            >= self.quota(tenant).max_tasks_in_flight
        )

    def _pick_fair_locked(self, worker: str) -> Optional[int]:
        """DRR over the worker's home tenants, then steal if they're dry."""
        home = self._affinity.get(worker)
        task_id = self._pick_drr_locked(worker, home)
        if task_id is None and home is not None and self._steal_enabled:
            task_id = self._steal_locked(worker, home)
        return task_id

    def _pick_drr_locked(
        self, worker: str, home: Optional[frozenset] = None
    ) -> Optional[int]:
        """Weighted deficit round-robin across tenants (concurrent mode)."""
        for _replenished in (False, True):
            n = len(self._ring)
            if n == 0:
                return None
            eligible: List[str] = []
            for off in range(n):
                idx = (self._rr_pos + off) % n
                tenant = self._ring[idx]
                if home is not None and tenant not in home:
                    continue
                if self._clean_head_locked(tenant) is None:
                    self._deficit[tenant] = 0.0
                    continue
                if self._saturated_locked(tenant):
                    continue
                eligible.append(tenant)
                if self._deficit.get(tenant, 0.0) >= 1.0:
                    self._deficit[tenant] -= 1.0
                    self._rr_pos = (idx + 1) % n
                    return self._reserve_locked(tenant, worker)
            if not eligible:
                return None                # empty, or every tenant capped
            for tenant in eligible:        # everyone broke: new DRR round
                self._deficit[tenant] = self._tenant_weight(tenant)
        return None                        # unreachable (weight >= 1)

    def _backlog_locked(self, tenant: str) -> int:
        return sum(
            1 for (_, _, tid) in self._pending.get(tenant, ())
            if self._records[tid].state is TaskState.PENDING
        )

    def _steal_locked(self, worker: str, home: frozenset) -> Optional[int]:
        """Steal the best task from the most-backlogged foreign tenant.

        Reached only when every home tenant is capped or idle.  The
        victim must be *unthrottled* (below its in-flight cap), so the
        steal can never overshoot a quota; pop + slot reservation happen
        atomically under the scheduler lock.  Stolen dispatches debit the
        victim's DRR deficit, so weighted fairness across tenants holds.
        """
        best: Optional[str] = None
        best_key: Optional[Tuple[int, str]] = None
        best_head: Optional[Tuple[int, int, int]] = None
        for tenant in self._ring:
            if tenant in home:
                continue
            head = self._clean_head_locked(tenant)
            if head is None:
                continue
            if self._saturated_locked(tenant):
                continue
            key = (-self._backlog_locked(tenant), tenant)
            if best_key is None or key < best_key:
                best_key, best, best_head = key, tenant, head
        if best is None:
            return None
        if self._deficit.get(best, 0.0) >= 1.0:
            self._deficit[best] -= 1.0
        self._steals += 1
        self._note("steal", best_head[2], best, worker)
        self.telemetry.count("scheduler.steal")
        return self._reserve_locked(best, worker)

    def _pick_serial_locked(self, saturated: set) -> Optional[int]:
        """Global (priority, submission) order — the seed's drain rule."""
        best_tenant: Optional[str] = None
        best_key: Optional[Tuple[int, int]] = None
        for tenant in sorted(self._pending):
            if tenant in saturated:
                continue
            head = self._clean_head_locked(tenant)
            if head is None:
                continue
            if self._saturated_locked(tenant):
                # once saturated, skip the tenant for the rest of the
                # drain: re-checking every queued record just churns
                saturated.add(tenant)
                continue
            key = (head[0], head[1])
            if best_key is None or key < best_key:
                best_key, best_tenant = key, tenant
        if best_tenant is None:
            return None
        return self._reserve_locked(best_tenant, "serial")

    # ----------------------------------------------------------------- run

    def run_pending(self, max_tasks: Optional[int] = None) -> List[TaskRecord]:
        """Drain the queue serially (deterministic, global priority order)."""
        done: List[TaskRecord] = []
        saturated: set = set()   # tenants found throttled this drain pass
        while max_tasks is None or len(done) < max_tasks:
            with self._lock:
                task_id = self._pick_serial_locked(saturated)
            if task_id is None:
                break
            rec = self._records[task_id]
            self._execute(rec, worker="serial")
            done.append(rec)
        return done

    # ------------------------------------------------------ worker plane

    def start(self) -> "ServerlessScheduler":
        """Spawn the worker threads (idempotent; no-op when workers=0)."""
        with self._lock:
            if self._started or self._workers_n <= 0:
                return self
            self._started = True
            names = [f"w{i}" for i in range(self._workers_n)]
            for name in names:
                self._worker_busy.setdefault(name, 0.0)
                self._worker_tasks.setdefault(name, 0)
        for name in names:
            if self._hb_monitor is not None:
                self._hb_monitor.beat(name)
            self._exec.spawn(self._worker_loop, name, name=name)
        return self

    def spawn_worker(self) -> str:
        """Add one worker (e.g. to replace one lost to fault injection)."""
        with self._lock:
            name = f"w{len(self._worker_busy)}"
            self._worker_busy.setdefault(name, 0.0)
            self._worker_tasks.setdefault(name, 0)
            self._started = True
        if self._hb_monitor is not None:
            self._hb_monitor.beat(name)
        self._exec.spawn(self._worker_loop, name, name=name)
        return name

    def retire_worker(self, worker: Optional[str] = None) -> Optional[str]:
        """Gracefully shrink the fleet by one worker (autoscaler path).

        Unlike :meth:`_reap_worker` (node death: revoke + requeue), a
        retired worker keeps its current task: it is condemned *without*
        revocation, finishes whatever it is running, and exits at the top
        of its loop — no requeue, no discarded sandbox, no lost work.
        ``worker=None`` picks the highest-numbered live worker (LIFO, so
        scale-down unwinds scale-up).  Returns the retired name, or None
        when no eligible worker remains.
        """
        with self._lock:
            if worker is None:
                live = [w for w in self._worker_busy
                        if w not in self._condemned]
                if not live:
                    return None
                worker = max(live, key=lambda w: (len(w), w))
            elif worker in self._condemned or worker not in self._worker_busy:
                return None
            self._condemned.add(worker)
            self._note("retire", 0, "", worker)
        if self._hb_monitor is not None:
            self._hb_monitor.remove(worker)
        self.telemetry.count("scheduler.worker_retired")
        self._exec.notify()                # wake it if parked idle
        return worker

    def active_worker_count(self) -> int:
        """Workers serving the pool (spawned minus condemned/retired)."""
        with self._lock:
            return sum(
                1 for w in self._worker_busy if w not in self._condemned
            )

    def _worker_loop(self, worker: str) -> None:
        while True:
            self._exec.yield_point("loop")
            if self._hb_monitor is not None and worker not in self._condemned:
                self._hb_monitor.beat(worker)
            with self._lock:
                if self._stop or worker in self._condemned:
                    break
                task_id = self._pick_fair_locked(worker)
            if task_id is None:
                self._exec.idle_wait()
                continue
            rec = self._records[task_id]
            t0 = self._exec.now()
            try:
                self._execute(rec, worker=worker)
            except WorkerKilled:
                self._handle_worker_death(rec, worker)
                raise                      # the worker itself dies
            except Exception as e:
                # infrastructure failure (e.g. the sandbox factory raised
                # during checkout): the record was marked FAILED and its
                # slot released in _execute's finally — the worker itself
                # survives to serve other tenants' tasks
                self.telemetry.emit(
                    "scheduler", "worker_error", tenant=rec.spec.tenant,
                    detail=f"{type(e).__name__}: {e}",
                )
            finally:
                if self._straggler is not None:
                    self._straggler.record(worker, self._exec.now() - t0)
                with self._lock:
                    self._worker_busy[worker] = (
                        self._worker_busy.get(worker, 0.0)
                        + (self._exec.now() - t0)
                    )
                    self._worker_tasks[worker] = (
                        self._worker_tasks.get(worker, 0) + 1
                    )

    def _requeue_death_locked(self, rec: TaskRecord) -> None:
        """The exactly-once requeue shared by cooperative deaths and reaps."""
        if rec.death_requeues < 1:
            rec.death_requeues += 1
            rec.state = TaskState.PENDING
            rec.worker = None
            rec.started_at = None
            rec.finished_at = None
            heapq.heappush(
                self._pending.setdefault(rec.spec.tenant, []),
                (rec.spec.priority, rec.task_id, rec.task_id),
            )
            self._note("requeue", rec.task_id, rec.spec.tenant, "")
        else:
            rec.state = TaskState.FAILED
            rec.error = "worker died mid-task; requeue budget exhausted"
            rec.finished_at = self._exec.now()
            # abandoned tasks get a finish transition too, so the trace
            # always shows exactly one finish per finished task
            self._note("finish:failed", rec.task_id, rec.spec.tenant, "")

    def _handle_worker_death(self, rec: TaskRecord, worker: str) -> None:
        """A worker died mid-task: requeue the task exactly once."""
        with self._lock:
            self._note("worker_death", rec.task_id, rec.spec.tenant, worker)
            if (rec.task_id, worker) in self._revoked:
                # a reaper (heartbeat timeout / straggler eviction)
                # already released this dispatch's slot and requeued the
                # task; the kill is just the condemned worker being torn
                # down — requeueing again would run the task twice
                self._revoked.discard((rec.task_id, worker))
            else:
                self._requeue_death_locked(rec)
        self.telemetry.count("scheduler.worker_death")
        self._exec.notify()

    def drain(self, timeout: float = 60.0) -> None:
        """Block until every queued task reached a terminal state.

        Serial mode (workers=0) just calls :meth:`run_pending`.  Under a
        :class:`~repro.core.sim.SimExecutor` this *drives* the simulation.
        """
        if self._workers_n <= 0:
            self.run_pending()
            return
        self.start()
        self._exec.notify()
        self._exec.run_until(self._quiescent, timeout=timeout)

    def _quiescent(self) -> bool:
        with self._lock:
            if sum(self._in_flight.values()) > 0:
                return False
            return not any(
                self._records[tid].state is TaskState.PENDING
                for heap in self._pending.values()
                for (_, _, tid) in heap
            )

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop the workers and wait for them to exit."""
        self.stop_heartbeat_watchdog(timeout=timeout)
        self.stop_affinity_rebalancer(timeout=timeout)
        with self._lock:
            self._stop = True
        self._exec.notify()
        if self._started:
            self._exec.join(timeout=timeout)

    # ------------------------------------------------- node-fault plane

    def enable_heartbeats(
        self, timeout_s: float = 5.0, *, replace_dead: bool = False,
    ) -> "HeartbeatMonitor":
        """Judge worker liveness by heartbeat instead of trusting threads.

        Workers beat at every loop iteration and retry attempt; a worker
        silent for ``timeout_s`` (executor clock — virtual under sim) while
        it owns a RUNNING task is *reaped* by :meth:`check_heartbeats`:
        slot released, task requeued through the exactly-once death path,
        worker condemned.  ``replace_dead=True`` spawns a replacement per
        reaped worker so capacity survives node loss.
        """
        from repro_torch.runtime.fault import HeartbeatMonitor

        with self._lock:
            names = list(self._worker_busy)
        self._hb_monitor = HeartbeatMonitor(
            names, timeout_s=timeout_s, clock=self._exec.now,
        )
        self._hb_replace = replace_dead
        return self._hb_monitor

    def check_heartbeats(self) -> List[str]:
        """Reap workers that went dark mid-task; returns the reaped names.

        Deterministic under sim (drive it from ``sim.call_at`` timers);
        production runs it from :meth:`start_heartbeat_watchdog`.  Idle
        workers are never reaped — a parked worker owes no progress.
        """
        mon = self._hb_monitor
        if mon is None:
            return []
        reaped: List[str] = []
        for worker in mon.dead_workers():
            # only_if_busy re-checks under the reap lock: a worker that
            # finishes its task between this poll and the reap is
            # healthy-and-idle and must not be condemned
            if self._reap_worker(worker, "heartbeat_death",
                                 only_if_busy=True):
                reaped.append(worker)
        if reaped and self._hb_replace:
            for _ in reaped:
                self.spawn_worker()
        return reaped

    def _reap_worker(
        self, worker: str, reason: str, *, only_if_busy: bool = False,
    ) -> bool:
        """Declare ``worker`` dead: revoke its dispatch, requeue the task.

        The revocation marker makes any zombie completion of the old
        dispatch a no-op (its slot release, state write and sandbox
        checkin are all skipped or redirected to discard), so the task
        can never finish twice.  Under sim the stalled worker is also
        killed outright so virtual time does not wait for it.
        ``only_if_busy`` spares a worker that holds no task by the time
        the lock is taken (heartbeat reaps: idle workers owe no progress).
        """
        with self._lock:
            if worker in self._condemned or worker not in self._worker_busy:
                return False
            if only_if_busy and self._running_task.get(worker) is None:
                return False
            self._condemned.add(worker)
            task_id = self._running_task.pop(worker, None)
            rec = self._records.get(task_id) if task_id is not None else None
            if (
                rec is not None
                and rec.state is TaskState.RUNNING
                and rec.worker == worker
            ):
                self._revoked.add((task_id, worker))
                self._in_flight[rec.spec.tenant] -= 1
                self.admission.slot_released(rec.spec.tenant)
                self._note(reason, task_id, rec.spec.tenant, worker)
                self._requeue_death_locked(rec)
            else:
                self._note(reason, task_id or 0, "", worker)
            if reason == "heartbeat_death":
                self._hb_deaths += 1
            else:
                self._straggler_evicts += 1
        if self._hb_monitor is not None:
            self._hb_monitor.remove(worker)
        self.telemetry.count(f"scheduler.{reason}")
        kill = getattr(self._exec, "kill", None)
        if kill is not None:
            kill(worker)
        self._exec.notify()
        return True

    def start_heartbeat_watchdog(self, interval_s: float = 0.02) -> None:
        """Poll :meth:`check_heartbeats` from a daemon thread (production).

        This is the ThreadExecutor-side worker-death detector: a worker
        hung inside user code stops beating, the watchdog requeues its
        task onto a live worker, and any late completion by the zombie
        thread is discarded by the revocation marker.
        """
        if self._hb_monitor is None:
            raise RuntimeError("call enable_heartbeats() before the watchdog")
        with self._lock:
            if self._hb_watchdog is not None and self._hb_watchdog[0].is_alive():
                return
            stop = threading.Event()
            thread = threading.Thread(
                target=self._watchdog_loop,
                args=(max(1e-3, float(interval_s)), stop),
                name="scheduler-hb-watchdog",
                daemon=True,
            )
            self._hb_watchdog = (thread, stop)
        thread.start()

    def _watchdog_loop(self, interval_s: float, stop: threading.Event) -> None:
        while not stop.wait(interval_s):
            self.check_heartbeats()

    def stop_heartbeat_watchdog(self, timeout: float = 5.0) -> None:
        with self._lock:
            entry = self._hb_watchdog
            self._hb_watchdog = None
        if entry is not None:
            entry[1].set()
            entry[0].join(timeout=timeout)

    def enable_straggler_detection(
        self, *, window: int = 32, z_threshold: float = 4.0,
        min_steps: int = 8, patience: int = 3,
    ) -> "StragglerDetector":
        """Flag persistently slow workers (median/MAD z-score) for eviction."""
        from repro_torch.runtime.fault import StragglerDetector

        self._straggler = StragglerDetector(
            window=window, z_threshold=z_threshold,
            min_steps=min_steps, patience=patience,
        )
        return self._straggler

    def stragglers(self) -> List[str]:
        if self._straggler is None:
            return []
        return [w for w in self._straggler.stragglers()
                if w not in self._condemned]

    def evict_stragglers(self) -> List[str]:
        """Reap flagged stragglers (same revoke/requeue path as heartbeats)."""
        evicted = [
            worker for worker in self.stragglers()
            if self._reap_worker(worker, "straggler_evict")
        ]
        if evicted and self._hb_replace:
            for _ in evicted:
                self.spawn_worker()
        return evicted

    def condemned_workers(self) -> List[str]:
        with self._lock:
            return sorted(self._condemned)

    # -------------------------------------- auto-rebalancing affinity

    def affinity_map(self) -> Dict[str, List[str]]:
        """Current worker → home-tenant map (empty list = serves all)."""
        with self._lock:
            return {w: sorted(ts) for w, ts in self._affinity.items()}

    def rebalance_affinity(self, alpha: float = 0.5) -> Dict[str, List[str]]:
        """Derive affinity from observed per-tenant load (``affinity="auto"``).

        One tick of the auto-rebalancer: per-tenant admission volume
        (``stats_by_tenant()`` hits+misses+denials) since the last tick
        is folded into an EWMA, and workers are re-homed in proportion to
        each tenant's smoothed share — each worker takes the tenant with
        the most unserved demand, debiting one worker's worth of quantum
        per assignment.  Deterministic: ties break by tenant name, and
        under a SimExecutor ticks fire at virtual times.  Stealing stays
        on, so a mispredicted map degrades to a steal, never starvation.
        No-op unless the scheduler was built with ``affinity="auto"``.
        """
        if not self._auto_affinity:
            return self.affinity_map()
        by_tenant = self.admission.stats_by_tenant()
        with self._lock:
            tenants = sorted(self._deficit)
            workers = sorted(
                w for w in self._worker_busy if w not in self._condemned
            )
            for tenant in tenants:
                bucket = by_tenant.get(tenant, {})
                total = sum(bucket.values())
                delta = total - self._load_seen.get(tenant, 0)
                self._load_seen[tenant] = total
                self._load_ewma[tenant] = (
                    alpha * delta
                    + (1.0 - alpha) * self._load_ewma.get(tenant, 0.0)
                )
            demand = {
                t: self._load_ewma.get(t, 0.0) for t in tenants
            }
            total_demand = sum(demand.values())
            if not workers or not tenants or total_demand <= 0:
                # no signal yet: stay un-homed (everyone serves everyone)
                self._affinity = {}
                return {}
            quantum = total_demand / len(workers)
            assign: Dict[str, frozenset] = {}
            for worker in workers:
                home = min(tenants, key=lambda t: (-demand[t], t))
                assign[worker] = frozenset({home})
                demand[home] -= quantum
            self._affinity = assign
            self._rebalances += 1
            self._note(
                "rebalance", 0,
                ",".join(f"{w}:{next(iter(ts))}" for w, ts in
                         sorted(assign.items())),
                "",
            )
        self.telemetry.count("scheduler.rebalance")
        return self.affinity_map()

    @property
    def rebalance_count(self) -> int:
        return self._rebalances

    def start_affinity_rebalancer(self, interval_s: float = 0.5) -> None:
        """Run :meth:`rebalance_affinity` from a daemon thread (production).

        Sim tests drive ticks deterministically via ``sim.call_at``
        instead.  Requires ``affinity="auto"``.
        """
        if not self._auto_affinity:
            raise RuntimeError('rebalancer needs affinity="auto"')
        with self._lock:
            if self._rebalancer is not None and self._rebalancer[0].is_alive():
                return
            stop = threading.Event()
            thread = threading.Thread(
                target=self._rebalance_loop,
                args=(max(1e-3, float(interval_s)), stop),
                name="scheduler-affinity-rebalancer",
                daemon=True,
            )
            self._rebalancer = (thread, stop)
        thread.start()

    def _rebalance_loop(self, interval_s: float, stop: threading.Event) -> None:
        while not stop.wait(interval_s):
            self.rebalance_affinity()

    def stop_affinity_rebalancer(self, timeout: float = 5.0) -> None:
        with self._lock:
            entry = self._rebalancer
            self._rebalancer = None
        if entry is not None:
            entry[1].set()
            entry[0].join(timeout=timeout)

    # ------------------------------------------------------------- execute

    def _execute(self, rec: TaskRecord, worker: str = "serial") -> None:
        tenant = rec.spec.tenant
        token = rec.token
        poisoned = False
        died = False
        revoked = False
        preempted_here = False

        def dispatch_revoked() -> bool:
            with self._lock:
                return (rec.task_id, worker) in self._revoked

        def commit_outcome(state=None, error=None, result=None) -> bool:
            """Write an attempt outcome atomically w.r.t. the reapers.

            A reaper revokes a dispatch and requeues its record under
            the scheduler lock; committing under the same lock makes
            "was I revoked?" and "write my outcome" one step, so a
            zombie can never clobber a requeued record (which would let
            the task run — and finish — twice).  Returns False, writing
            nothing, when the dispatch was revoked.
            """
            with self._lock:
                if (rec.task_id, worker) in self._revoked:
                    return False
                if result is not None:
                    rec.result = result
                if error is not None:
                    rec.error = error
                if state is not None:
                    rec.state = state
                return True

        if self._hb_monitor is not None:
            def beat() -> None:
                if worker not in self._condemned:
                    self._hb_monitor.beat(worker)
        else:
            beat = None

        sandbox: Optional[Sandbox] = None
        try:
            # checkout inside the try: the caller already reserved the
            # in-flight slot, so a death or factory failure parked at
            # these yield points (e.g. killed mid slow cold build) must
            # still release the slot in the finally below
            self._exec.yield_point("checkout")
            sandbox = self.pool.checkout(tenant)
            self._exec.yield_point("checked-out")
            # retries reuse the same warm sandbox; the shared admission
            # cache makes every attempt after the first skip re-verification
            while True:
                if dispatch_revoked():
                    # a reaper requeued this task out from under us (the
                    # worker was declared dead); nothing here may touch
                    # the record anymore — it belongs to a new dispatch
                    revoked = True
                    break
                reason = token.tripped() if token is not None else None
                if reason is not None:
                    # preemption observed at an attempt boundary: the
                    # sandbox sits between attempts, hence clean
                    if not commit_outcome(TaskState.PREEMPTED, error=reason):
                        revoked = True
                        break
                    preempted_here = True
                    break
                rec.attempts += 1
                if beat is not None:
                    beat()
                _ACTIVE_TOKEN.token = token
                _ACTIVE_TOKEN.beat = beat
                try:
                    result = sandbox.run(rec.spec.fn, *rec.spec.args)
                except TaskPreempted as e:
                    # a body checkpoint fired mid-run: the sandbox's
                    # state is unknowable, so it is discarded
                    poisoned = True
                    if not commit_outcome(TaskState.PREEMPTED,
                                          error=str(e)):
                        revoked = True
                        break
                    preempted_here = True
                    break
                except (SandboxViolation, BudgetExceeded) as e:
                    # security/quota denials are terminal, never retried;
                    # the sandbox is poisoned and never returned to the pool
                    poisoned = True
                    if not commit_outcome(TaskState.DENIED, error=str(e)):
                        revoked = True
                    break
                except Exception as e:  # transient failure → bounded retry
                    terminal = rec.attempts > rec.spec.max_retries
                    if not commit_outcome(
                        TaskState.FAILED if terminal else None,
                        error=f"{type(e).__name__}: {e}",
                    ):
                        revoked = True
                        break
                    if terminal:
                        break
                else:
                    if not commit_outcome(TaskState.SUCCEEDED,
                                          result=result):
                        revoked = True
                    break
                finally:
                    _ACTIVE_TOKEN.token = None
                    _ACTIVE_TOKEN.beat = None
                self._exec.yield_point("retry")
        except WorkerKilled:
            # injected death mid-task: the sandbox's state is unknowable,
            # so it is discarded; the caller requeues the task
            died = True
            poisoned = True
            raise
        finally:
            if preempted_here:
                with self._lock:
                    self._preempts += 1
                self.telemetry.count("scheduler.preempted")
            with self._lock:
                if (rec.task_id, worker) in self._revoked:
                    revoked = True
                    # the reaper already released the slot and requeued
                    # the task; on the cooperative-death path the marker
                    # must survive for _handle_worker_death to consume
                    if not died:
                        self._revoked.discard((rec.task_id, worker))
                else:
                    self._in_flight[tenant] -= 1
                    self.admission.slot_released(tenant)
                if self._running_task.get(worker) == rec.task_id:
                    del self._running_task[worker]
            if sandbox is not None:
                # a revoked dispatch's sandbox was mid-flight when its
                # worker was reaped: treat it like a poisoned one
                self.pool.checkin(sandbox, discard=poisoned or revoked)
            if not died and not revoked:
                if rec.state is TaskState.RUNNING:
                    # a non-sandbox failure (e.g. the pool factory raised)
                    # escaped the retry loop: terminal, not silently RUNNING
                    rec.state = TaskState.FAILED
                    if rec.error is None:
                        rec.error = "execution aborted before first attempt"
                rec.finished_at = self._exec.now()
                with self._lock:
                    self._note(
                        f"finish:{rec.state.value}", rec.task_id, tenant,
                        worker,
                    )
                # end-to-end task latency (queue wait + all attempts), the
                # per-tenant histogram the /metrics endpoint exports
                self.telemetry.observe(
                    "scheduler.task_seconds",
                    rec.finished_at - rec.submitted_at,
                    tenant=tenant,
                )
            self._exec.notify()            # slot freed: wake idle workers

    # --------------------------------------------------------------- status

    def record(self, task_id: int) -> TaskRecord:
        return self._records[task_id]

    def records(self) -> List[TaskRecord]:
        with self._lock:
            return [self._records[tid] for tid in sorted(self._records)]

    def trace(self) -> List[str]:
        """Scheduling decisions in order; deterministic under SimExecutor."""
        with self._lock:
            return list(self._trace)

    def trace_text(self) -> str:
        return "\n".join(self.trace()) + "\n"

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for rec in self._records.values():
                out[rec.state.value] = out.get(rec.state.value, 0) + 1
            return out

    def queue_depths(self) -> Dict[str, int]:
        """Pending tasks per tenant (the ``/metrics`` queue-depth gauge)."""
        with self._lock:
            out: Dict[str, int] = {}
            for tenant, heap in self._pending.items():
                n = sum(
                    1 for (_, _, tid) in heap
                    if self._records[tid].state is TaskState.PENDING
                )
                if n:
                    out[tenant] = n
            return out

    def in_flight(self) -> Dict[str, int]:
        """Currently-running tasks per tenant."""
        with self._lock:
            return {t: n for t, n in self._in_flight.items() if n}

    @property
    def worker_count(self) -> int:
        return self._workers_n

    @property
    def steal_count(self) -> int:
        """Dispatches taken from a foreign tenant by an idle worker."""
        return self._steals

    @property
    def preempt_count(self) -> int:
        """Running tasks that landed in PREEMPTED."""
        return self._preempts

    @property
    def heartbeat_death_count(self) -> int:
        """Workers reaped after going dark mid-task."""
        return self._hb_deaths

    @property
    def straggler_evict_count(self) -> int:
        """Workers evicted by the straggler detector."""
        return self._straggler_evicts

    def worker_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-worker busy time and task count (utilization metrics)."""
        with self._lock:
            return {
                name: {
                    "busy_seconds": self._worker_busy[name],
                    "tasks": float(self._worker_tasks.get(name, 0)),
                }
                for name in sorted(self._worker_busy)
            }

    def metrics_registry(self, namespace: str = "seepp") -> "MetricsRegistry":
        """A registry covering this scheduler's whole control plane."""
        from .metrics import MetricsRegistry

        return (
            MetricsRegistry(namespace)
            .register_sink(self.telemetry)
            .register_admission(self.admission)
            .register_pool(self.pool)
            .register_scheduler(self)
        )
