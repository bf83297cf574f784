"""Unified workload orchestration: serving, training, batch on one pool.

The reference's ``repro/runtime/orchestrator.py`` over the port's host
substrate (``repro_torch.core.admission`` and ``repro_torch.core.tasks``);
the classes, their fields and their defaults are unchanged.  The lanes are
pure Python: what a step-task runs on the card is the engine's or the
stepper's business.

Before this layer, the three workload planes each owned a private drive
loop: :meth:`~repro_torch.runtime.serve_loop.ServingEngine.drain`
stepped decode, :meth:`~repro_torch.runtime.train_loop.Trainer.run` owned
a while-loop over optimizer steps, and sandbox/UDF batches went through
:class:`~repro_torch.core.tasks.ServerlessScheduler` directly.  Co-locating
them meant static partitioning — dedicated workers per plane, idle
capacity trapped in whichever plane was quiet.

The :class:`WorkloadOrchestrator` runs all three as *workload classes*
on one shared worker pool:

* each class is a scheduler tenant with its own
  :class:`~repro_torch.core.tasks.TenantQuota` weight and priority band —
  latency-sensitive decode gets the low (soonest) priority and the
  largest DRR weight, training sits in the middle, throughput batch at
  the back;
* serving and training are *serialized lanes*: the orchestrator keeps at
  most one step-task per source in flight (an engine cannot step
  concurrently with itself), resubmitting a fresh closure per step so
  admission-cache keys stay per-run and replays see identical cold/warm
  patterns;
* decode holds *preemption rights*: when its step-task is stuck PENDING
  behind a pool saturated with batch work, the orchestrator trips one
  running batch task's :class:`~repro_torch.core.tasks.CancelToken`; the
  victim lands PREEMPTED at its next cooperative checkpoint and is
  resubmitted.  Preemptions are bounded per job
  (``max_preemptions_per_job``), after which the job is non-preemptible
  — the no-starvation guarantee the chaos suite asserts;
* an optional :class:`~repro_torch.runtime.elastic.ElasticAutoscaler` is
  ticked on the same cadence, so fleet growth/shrink decisions read the
  same executor-clock metrics the placement decisions do.

Everything the orchestrator reads (queue depths, task records, worker
counts) derives from the executor clock, so a seeded
:class:`~repro_torch.core.sim.SimExecutor` run replays its trace and the
autoscaler's decision log byte-identically.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.admission import system_task
from repro_torch.core.tasks import (
    TERMINAL_STATES,
    TaskSpec,
    TaskState,
    TenantQuota,
    checkpoint,
)

__all__ = ["OrchestratorConfig", "BatchJob", "WorkloadOrchestrator"]


@dataclass
class OrchestratorConfig:
    #: tenant names for the three workload-class lanes
    serving_tenant: str = "svc:decode"
    train_tenant: str = "svc:train"
    batch_tenant: str = "svc:batch"
    #: priority bands (lower = dispatched sooner within a tenant; the
    #: cross-tenant share is set by the weights below)
    serving_priority: int = 0
    train_priority: int = 5
    batch_priority: int = 10
    #: DRR weights: decode is offered 4 dispatches for each 1 batch gets
    serving_weight: int = 4
    train_weight: int = 2
    batch_weight: int = 1
    #: in-flight caps per lane; step lanes are serialized by construction
    #: but the cap documents (and enforces) it at the quota layer too
    batch_in_flight: int = 4
    #: orchestrator tick cadence on the executor clock
    tick_interval_s: float = 0.01
    #: engine steps one decode step-task may run (while the engine has
    #: work) before releasing its worker.  1 re-contends the pool per
    #: step — decode then pays a queue wait per token under batch load;
    #: a short burst holds the lane while requests are live, which is
    #: what protects decode p50 (orchestrator_bench measures exactly
    #: this), while still yielding between bursts when decode idles
    serving_steps_per_task: int = 4
    #: a batch job preempted this many times becomes non-preemptible
    #: (the no-starvation bound)
    max_preemptions_per_job: int = 2
    #: tick the autoscaler every N orchestrator ticks (0 = never)
    autoscale_every: int = 1
    #: consecutive serving step-task failures tolerated before drain()
    #: raises instead of resubmitting forever
    max_step_failures: int = 5


@dataclass
class BatchJob:
    """Orchestrator-level record of one batch submission.

    The scheduler's :class:`~repro_torch.core.tasks.TaskRecord` is
    per-attempt (PREEMPTED is terminal there); the job survives across resubmissions
    and carries the preemption budget.
    """

    job_id: int
    name: str
    fn: Callable
    priority: int
    task_ids: List[int] = field(default_factory=list)
    preemptions: int = 0
    resubmits: int = 0
    state: str = "pending"      # pending | running | done | failed

    @property
    def task_id(self) -> Optional[int]:
        return self.task_ids[-1] if self.task_ids else None

    def preemptible(self, bound: int) -> bool:
        return self.state in ("pending", "running") and self.preemptions < bound


class WorkloadOrchestrator:
    """Run decode, training and batch tasks on one shared worker pool."""

    def __init__(
        self,
        scheduler,
        *,
        serving=None,
        stepper=None,
        autoscaler=None,
        cfg: Optional[OrchestratorConfig] = None,
    ) -> None:
        self.scheduler = scheduler
        self.serving = serving            # ServingEngine or ReplicaSet
        self.stepper = stepper            # TrainStepper (or duck-type)
        self.autoscaler = autoscaler
        self.cfg = cfg or OrchestratorConfig()
        if autoscaler is not None and hasattr(autoscaler, "bind_class_queues"):
            # per-class idle scale-down reads the orchestrator's lane
            # depths: a class whose queue drained can shrink its lane
            # while the other classes stay busy
            autoscaler.bind_class_queues(self.class_queue_depths)
        self._exec = scheduler.executor
        c = self.cfg
        scheduler.set_quota(c.serving_tenant, TenantQuota(
            max_tasks_in_flight=1, weight=c.serving_weight))
        scheduler.set_quota(c.train_tenant, TenantQuota(
            max_tasks_in_flight=1, weight=c.train_weight))
        scheduler.set_quota(c.batch_tenant, TenantQuota(
            max_tasks_in_flight=c.batch_in_flight, weight=c.batch_weight))
        self._jobs: Dict[int, BatchJob] = {}
        self._job_ids = 0
        self._serving_task: Optional[int] = None
        self._train_task: Optional[int] = None
        self.ticks = 0
        self.serving_steps = 0
        self.train_steps = 0
        self.serving_step_failures = 0
        self.train_step_failures = 0
        self._consecutive_step_failures = 0
        self.preemptions_total = 0
        self.batch_resubmits_total = 0
        self._tick_armed = False

    # ------------------------------------------------------------- submit

    def submit_batch(self, fn: Callable, *, name: str = "",
                     priority: Optional[int] = None) -> BatchJob:
        """Enqueue a throughput-batch task (sandbox/UDF work)."""
        self._job_ids += 1
        job = BatchJob(
            job_id=self._job_ids,
            name=name or f"batch{self._job_ids}",
            fn=fn,
            priority=(self.cfg.batch_priority if priority is None
                      else priority),
        )
        self._jobs[job.job_id] = job
        self._submit_job(job)
        return job

    def _submit_job(self, job: BatchJob) -> None:
        def _body(fn=job.fn):
            checkpoint()               # preemption point before user code
            return fn()

        tid = self.scheduler.submit(TaskSpec(
            tenant=self.cfg.batch_tenant,
            fn=_body,
            priority=job.priority,
            name=f"{job.name}/a{len(job.task_ids)}",
        ))
        job.task_ids.append(tid)

    # -------------------------------------------------------- lane pumping

    def _serving_has_work(self) -> bool:
        return self.serving is not None and self.serving.has_work()

    def _pump_serving(self) -> None:
        if self._serving_task is not None:
            rec = self.scheduler.record(self._serving_task)
            if rec.state not in TERMINAL_STATES:
                return
            if rec.state is TaskState.SUCCEEDED:
                self.serving_steps += 1
                self._consecutive_step_failures = 0
            else:
                self.serving_step_failures += 1
                self._consecutive_step_failures += 1
            self._serving_task = None
        if not self._serving_has_work():
            return

        serving = self.serving
        step_time = getattr(serving, "step_time_s", None)
        if step_time is None:
            step_time = serving.cfg.step_time_s
        sleep = self._exec.sleep

        @system_task
        def _step(engine=serving, dt=float(step_time),
                  burst=max(int(self.cfg.serving_steps_per_task), 1)):
            steps = 0
            for _ in range(burst):
                if steps and not engine.has_work():
                    break
                checkpoint()           # heartbeat + preemption point
                engine.step()
                steps += 1
                if dt > 0:
                    sleep(dt)          # decode latency accrues busy time
            return steps

        self._serving_task = self.scheduler.submit(TaskSpec(
            tenant=self.cfg.serving_tenant,
            fn=_step,
            priority=self.cfg.serving_priority,
            name=f"decode_step/{self.serving_steps + self.serving_step_failures}",
        ))

    def _train_has_work(self) -> bool:
        return self.stepper is not None and not self.stepper.done()

    def _pump_train(self) -> None:
        if self._train_task is not None:
            rec = self.scheduler.record(self._train_task)
            if rec.state not in TERMINAL_STATES:
                return
            if rec.state is TaskState.SUCCEEDED:
                self.train_steps += 1
            else:
                self.train_step_failures += 1
            self._train_task = None
        if not self._train_has_work():
            return

        @system_task
        def _step(stepper=self.stepper):
            # step_once checkpoints internally (preemption + heartbeat)
            return stepper.step_once()

        self._train_task = self.scheduler.submit(TaskSpec(
            tenant=self.cfg.train_tenant,
            fn=_step,
            priority=self.cfg.train_priority,
            name=f"train_step/{self.train_steps + self.train_step_failures}",
        ))

    # ----------------------------------------------------------- preemption

    def _pool_saturated(self) -> bool:
        running = sum(self.scheduler.in_flight().values())
        return running >= self.scheduler.active_worker_count()

    def _maybe_preempt_batch(self) -> None:
        """Give a stuck decode step-task a worker by preempting batch work.

        Fires only when the decode lane is PENDING *and* every active
        worker is occupied.  The victim is the most recently dispatched
        preemptible batch attempt (highest task id — LIFO, so long-running
        batch work near completion is preempted last), and only jobs
        under their preemption budget qualify.
        """
        if self._serving_task is None:
            return
        rec = self.scheduler.record(self._serving_task)
        if rec.state is not TaskState.PENDING or not self._pool_saturated():
            return
        victims = []
        for job in self._jobs.values():
            tid = job.task_id
            if tid is None or not job.preemptible(self.cfg.max_preemptions_per_job):
                continue
            if self.scheduler.record(tid).state is TaskState.RUNNING:
                victims.append((tid, job))
        if not victims:
            return
        tid, job = max(victims, key=lambda v: v[0])
        if self.scheduler.cancel(tid):
            job.preemptions += 1
            self.preemptions_total += 1

    def _harvest_batch(self) -> None:
        for job in self._jobs.values():
            if job.state in ("done", "failed"):
                continue
            tid = job.task_id
            rec = self.scheduler.record(tid)
            if rec.state is TaskState.RUNNING:
                job.state = "running"
                continue
            if rec.state not in TERMINAL_STATES:
                continue
            if rec.state is TaskState.SUCCEEDED:
                job.state = "done"
            elif rec.state in (TaskState.PREEMPTED, TaskState.CANCELLED):
                # preempted for decode (or swept by chaos): resubmit with
                # a fresh closure; the preemption budget caps how often
                job.state = "pending"
                job.resubmits += 1
                self.batch_resubmits_total += 1
                self._submit_job(job)
            else:                      # FAILED / DENIED / EXPIRED
                job.state = "failed"

    # ----------------------------------------------------------------- tick

    def tick(self) -> None:
        """One orchestration round: pump lanes, preempt, autoscale."""
        self.ticks += 1
        self._pump_serving()
        self._pump_train()
        self._harvest_batch()
        self._maybe_preempt_batch()
        if (
            self.autoscaler is not None
            and self.cfg.autoscale_every > 0
            and self.ticks % self.cfg.autoscale_every == 0
        ):
            self.autoscaler.tick()

    def has_work(self) -> bool:
        return (
            self._serving_has_work()
            or self._serving_task is not None
            or self._train_has_work()
            or self._train_task is not None
            or any(j.state in ("pending", "running") for j in self._jobs.values())
        )

    def start(self) -> "WorkloadOrchestrator":
        """Arm the periodic tick on the executor clock.

        Under a :class:`~repro_torch.core.sim.SimExecutor` ticks are
        controller timers (``call_later``), so they interleave
        deterministically with worker scheduling; the caller then drives the sim (e.g. via
        :meth:`drain` or ``run_until``).  The timer chain re-arms itself
        while any lane has work and lapses when quiescent — a later
        :meth:`drain`/``start`` re-arms it.
        """
        self.scheduler.start()
        call_later = getattr(self._exec, "call_later", None)
        if call_later is None or self._tick_armed:
            return self
        self._tick_armed = True

        def _tick_timer() -> None:
            self.tick()
            if self.has_work():
                call_later(self.cfg.tick_interval_s, _tick_timer)
            else:
                self._tick_armed = False

        _tick_timer()
        return self

    def drain(self, timeout: float = 300.0) -> None:
        """Tick until every lane is quiescent (wall-clock bounded)."""
        call_later = getattr(self._exec, "call_later", None)
        if call_later is not None:
            # sim mode: the executor drives workers; ticks are timers
            self.start()
            self._exec.run_until(lambda: not self.has_work(),
                                 timeout=timeout)
            self.tick()                # final harvest
            return
        self.scheduler.start()
        deadline = time.monotonic() + timeout
        while self.has_work():
            if self._consecutive_step_failures >= self.cfg.max_step_failures:
                raise RuntimeError(
                    f"decode step failed {self._consecutive_step_failures}"
                    " times in a row; refusing to spin"
                )
            self.tick()
            if self.cfg.tick_interval_s > 0:
                self._exec.sleep(self.cfg.tick_interval_s)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"orchestrator drain: work remaining after {timeout}s"
                )
        self.tick()                    # final harvest

    # --------------------------------------------------------------- status

    def jobs(self) -> List[BatchJob]:
        return [self._jobs[j] for j in sorted(self._jobs)]

    def class_queue_depths(self) -> Dict[str, int]:
        depths = self.scheduler.queue_depths()
        return {
            "serving": depths.get(self.cfg.serving_tenant, 0),
            "train": depths.get(self.cfg.train_tenant, 0),
            "batch": depths.get(self.cfg.batch_tenant, 0),
        }

    def orchestrator_stats(self) -> Dict[str, int]:
        """Snapshot for ``MetricsRegistry.register_orchestrator``."""
        jobs = self._jobs.values()
        return {
            "ticks": self.ticks,
            "serving_steps": self.serving_steps,
            "train_steps": self.train_steps,
            "serving_step_failures": self.serving_step_failures,
            "train_step_failures": self.train_step_failures,
            "batch_jobs_submitted": len(self._jobs),
            "batch_jobs_done": sum(1 for j in jobs if j.state == "done"),
            "batch_jobs_failed": sum(1 for j in jobs if j.state == "failed"),
            "preemptions_total": self.preemptions_total,
            "batch_resubmits_total": self.batch_resubmits_total,
            "workers_active": self.scheduler.active_worker_count(),
        }
