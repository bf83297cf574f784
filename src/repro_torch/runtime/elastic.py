"""Elastic scaling: mesh re-planning + the metrics-driven autoscaler.

A copy of the reference's ``repro/runtime/elastic.py``, which is pure
Python; the port keeps its own so that it imports nothing of the JAX
package.  Two layers:

* :func:`plan_mesh` / :class:`ElasticController` — given a healthy device
  *pool*, pick the best legal (pod, data, model) grid, returned as a shape
  and axis names (no mesh is built here).  Mesh choice: keep the ``model``
  axis (TP degree is a model property — it must divide d_ff etc.), shrink
  ``data``/``pod``; only when fewer devices survive than the TP degree
  does the model axis degrade (last resort).  The controller tracks the
  pool (``healthy``) separately from the devices the planned mesh actually
  uses (``in_use``): spares that do not fit the grid stay in the pool and
  are recommitted on the next ``gain``.
* :class:`ElasticAutoscaler` — grows/shrinks a
  :class:`~repro_torch.core.tasks.ServerlessScheduler` worker fleet (and
  optionally a :class:`~repro_torch.runtime.replica.ReplicaSet`) from live
  metrics: scheduler queue depth, the ``serving.admit_wait_seconds``
  histogram, and worker busy fractions.  Every decision reads only
  executor-clock state, so a seeded
  :class:`~repro_torch.core.sim.SimExecutor` run replays its decision log
  byte-identically — which is what lets the orchestration chaos suite
  seed-sweep scale events.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

__all__ = [
    "plan_mesh",
    "ElasticController",
    "ElasticEvent",
    "ElasticAutoscaler",
    "AutoscalerConfig",
    "ScaleDecision",
]


def plan_mesh(num_devices: int, *, model: int = 16,
              prefer_pods: int = 1) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest (pod, data, model) grid that fits ``num_devices``.

    ``model`` is held fixed; data is the largest power-of-two-ish divisor
    that fits.  Returns (shape, axis_names) for a device mesh.
    """
    if num_devices < model:
        # degrade TP too (last resort): largest divisor of model that fits
        m = model
        while m > 1 and m > num_devices:
            m //= 2
        model = max(m, 1)
    data = max(num_devices // model, 1)
    pods = 1
    if prefer_pods > 1 and data % prefer_pods == 0 and data // prefer_pods >= 1:
        pods = prefer_pods
        data //= pods
    if pods > 1:
        return (pods, data, model), ("pod", "data", "model")
    return (data, model), ("data", "model")


@dataclass
class ElasticEvent:
    step: int
    reason: str
    old_devices: int
    new_devices: int
    new_shape: Tuple[int, ...]
    #: devices the planned mesh actually occupies (shape product)
    in_use: int = 0
    #: pool devices left over that did not fit the grid
    spare: int = 0


def _prod(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


class ElasticController:
    """Tracks the healthy device pool and re-plans the mesh on change.

    ``healthy`` is the *pool* (every surviving device, floored at 0);
    ``in_use`` is what the current plan occupies.  Keeping them apart is
    what lets ``lose()`` reach the degrade-TP branch (the pool is not
    clamped at ``model_axis``) and a later ``gain`` recover spares that
    did not fit the grid (the pool is never overwritten with the mesh
    product).
    """

    def __init__(self, total_devices: int, *, model_axis: int = 16,
                 prefer_pods: int = 1):
        self.healthy = max(int(total_devices), 0)
        self.model_axis = model_axis
        self.prefer_pods = prefer_pods
        self.events: List[ElasticEvent] = []
        shape, _ = plan_mesh(max(self.healthy, 1), model=model_axis,
                             prefer_pods=prefer_pods)
        self.in_use = _prod(shape)

    @property
    def spare(self) -> int:
        """Pool devices the current mesh leaves idle."""
        return self.healthy - self.in_use

    def _replan(self, step: int, reason: str, old: int):
        # plan from the full pool; a pool of 0 still plans a 1-chip mesh
        # so restore tooling has a target shape once any device returns
        shape, axes = plan_mesh(max(self.healthy, 1), model=self.model_axis,
                                prefer_pods=self.prefer_pods)
        self.in_use = _prod(shape)
        ev = ElasticEvent(step, reason, old, self.healthy, shape,
                          in_use=self.in_use,
                          spare=max(self.healthy - self.in_use, 0))
        self.events.append(ev)
        return shape, axes, ev

    def lose(self, n: int, *, step: int, reason: str = "failure"):
        old = self.healthy
        self.healthy = max(self.healthy - int(n), 0)
        return self._replan(step, reason, old)

    def gain(self, n: int, *, step: int, reason: str = "scale-up"):
        old = self.healthy
        self.healthy += int(n)
        return self._replan(step, reason, old)


# ---------------------------------------------------------------------------
# metrics-driven autoscaling
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScaleDecision:
    """One autoscaler tick, fully determined by executor-clock state.

    The tuple form (:meth:`key`) is what the chaos suite compares across
    replays — everything in it derives from virtual time and the seeded
    schedule, never from wall time.
    """

    t: float
    action: str            # scale_up_worker | scale_down_worker |
    #                        scale_up_replica | scale_down_replica | hold
    reason: str
    queue_depth: int
    serving_depth: int
    busy_frac: float
    admit_wait_s: float
    workers: int
    replicas: int

    def key(self) -> Tuple:
        return (
            round(self.t, 9), self.action, self.reason, self.queue_depth,
            self.serving_depth, round(self.busy_frac, 6),
            round(self.admit_wait_s, 9), self.workers, self.replicas,
        )


@dataclass
class AutoscalerConfig:
    min_workers: int = 1
    max_workers: int = 16
    min_replicas: int = 1
    max_replicas: int = 4
    #: scheduler backlog (pending tasks, all tenants) that triggers a
    #: worker scale-up
    queue_high: int = 4
    #: serving admit-queue depth that triggers a replica scale-up
    serving_queue_high: int = 6
    #: mean admit wait (seconds, over the window since the last tick)
    #: that triggers a worker scale-up even with a shallow queue
    admit_wait_high_s: float = 0.08
    #: busy fraction below which idle capacity qualifies for scale-down
    busy_low: float = 0.25
    #: consecutive qualifying ticks before a scale-down fires
    idle_ticks: int = 3
    #: >0: per-class idle scale-down.  A workload class (e.g. "train",
    #: "batch") whose *own* queue has been empty this many consecutive
    #: ticks — after having shown demand at least once — retires one
    #: worker, without waiting for the whole pool to go quiet the way
    #: the global ``idle_ticks`` path does.  Needs a class-queue-depth
    #: source bound via :meth:`ElasticAutoscaler.bind_class_queues`
    #: (the orchestrator binds its own).  0 (default) = off
    class_idle_ticks: int = 0
    #: ticks of enforced hold after any scale action
    cooldown_ticks: int = 2
    #: device-pool devices each worker represents on the controller
    devices_per_worker: int = 1


class ElasticAutoscaler:
    """Grow/shrink a worker fleet (and replica set) from live metrics.

    Reads: scheduler queue depth, per-worker busy fractions, the serving
    plane's admit-queue depth and ``serving.admit_wait_seconds``
    histogram.  Actuates: ``scheduler.spawn_worker`` /
    ``scheduler.retire_worker`` and, when a ``replica_factory`` is
    provided, ``ReplicaSet.add_replica`` / ``retire_replica``.  Every
    action also lands on the :class:`ElasticController` device pool, so
    the mesh re-plan story and the fleet story share one event log.
    """

    def __init__(
        self,
        scheduler,
        *,
        serving=None,
        replica_factory: Optional[Callable[[], object]] = None,
        controller: Optional[ElasticController] = None,
        cfg: Optional[AutoscalerConfig] = None,
        telemetry=None,
        class_queues: Optional[Callable[[], dict]] = None,
    ) -> None:
        self.scheduler = scheduler
        self.serving = serving
        self.replica_factory = replica_factory
        self._class_queues = class_queues
        self.cfg = cfg or AutoscalerConfig()
        self.telemetry = telemetry or scheduler.telemetry
        self._exec = scheduler.executor
        n0 = len(self._active_workers())
        self.controller = controller or ElasticController(
            max(n0, 1) * self.cfg.devices_per_worker,
            model_axis=self.cfg.devices_per_worker,
        )
        self.decisions: List[ScaleDecision] = []
        self.scale_ups = 0
        self.scale_downs = 0
        self.class_scale_downs = 0
        self.replica_scale_ups = 0
        self.replica_scale_downs = 0
        self._cooldown = 0
        self._idle_streak = 0
        #: per-class consecutive-idle-tick streaks; a class only accrues
        #: one after it has *shown demand* (appeared with a non-zero
        #: queue), so classes that never ran can't trigger scale-downs
        self._class_idle: dict = {}
        self._class_seen: set = set()
        self._ticks = 0
        self._last_t = self._exec.now()
        self._last_busy = self._busy_total()
        self._last_wait = self._admit_wait_snapshot()

    # ------------------------------------------------------------- signals

    def _active_workers(self) -> List[str]:
        condemned = set(self.scheduler.condemned_workers())
        return [w for w in self.scheduler.worker_stats()
                if w not in condemned]

    def _busy_total(self) -> float:
        condemned = set(self.scheduler.condemned_workers())
        return sum(
            ws["busy_seconds"]
            for w, ws in self.scheduler.worker_stats().items()
            if w not in condemned
        )

    def _admit_wait_snapshot(self) -> Tuple[float, float]:
        if self.serving is None:
            return (0.0, 0.0)
        snap = getattr(self.serving, "admit_wait_snapshot", None)
        return snap() if snap is not None else (0.0, 0.0)

    def _serving_depth(self) -> int:
        if self.serving is None:
            return 0
        return int(self.serving.queue_depth())

    def _replica_count(self) -> int:
        replicas = getattr(self.serving, "alive", None)
        return len(replicas()) if replicas is not None else 0

    def bind_class_queues(self, fn: Callable[[], dict]) -> None:
        """Bind the per-class queue-depth source (class name -> depth).

        The orchestrator binds its ``class_queue_depths`` here so
        ``class_idle_ticks`` can shrink a workload class's lane when
        *that class's* queue idles, independent of the rest of the pool.
        """
        self._class_queues = fn

    def _update_class_streaks(self) -> None:
        if self.cfg.class_idle_ticks <= 0 or self._class_queues is None:
            return
        for cls, depth in sorted(self._class_queues().items()):
            if depth > 0:
                self._class_seen.add(cls)
                self._class_idle[cls] = 0
            elif cls in self._class_seen:
                self._class_idle[cls] = self._class_idle.get(cls, 0) + 1

    # ---------------------------------------------------------------- tick

    def tick(self) -> ScaleDecision:
        """One deterministic scaling decision off the current metrics."""
        now = self._exec.now()
        dt = now - self._last_t
        workers = self._active_workers()
        busy = self._busy_total()
        busy_frac = 0.0
        if dt > 0 and workers:
            busy_frac = min(
                max((busy - self._last_busy) / (dt * len(workers)), 0.0), 1.0
            )
        wait_n, wait_sum = self._admit_wait_snapshot()
        dn = wait_n - self._last_wait[0]
        wait_mean = (wait_sum - self._last_wait[1]) / dn if dn > 0 else 0.0
        qdepth = sum(self.scheduler.queue_depths().values())
        sdepth = self._serving_depth()
        self._last_t, self._last_busy = now, busy
        self._last_wait = (wait_n, wait_sum)
        self._ticks += 1
        self._update_class_streaks()

        decision = self._decide(
            now, qdepth, sdepth, busy_frac, wait_mean, workers,
        )
        self.decisions.append(decision)
        if self.telemetry is not None:
            self.telemetry.count(f"elastic.{decision.action}")
        return decision

    def _decide(self, now, qdepth, sdepth, busy_frac, wait_mean,
                workers) -> ScaleDecision:
        cfg = self.cfg
        n = len(workers)
        replicas = self._replica_count()

        def hold(reason: str) -> ScaleDecision:
            return ScaleDecision(now, "hold", reason, qdepth, sdepth,
                                 busy_frac, wait_mean, n, replicas)

        if self._cooldown > 0:
            self._cooldown -= 1
            return hold("cooldown")

        # -- scale up: backlog or latency pressure ----------------------
        pressured = qdepth >= cfg.queue_high or wait_mean > cfg.admit_wait_high_s
        if pressured and n < cfg.max_workers:
            name = self.scheduler.spawn_worker()
            self.controller.gain(
                cfg.devices_per_worker, step=self._ticks, reason="scale-up",
            )
            self.scale_ups += 1
            self._cooldown = cfg.cooldown_ticks
            self._idle_streak = 0
            why = ("queue_high" if qdepth >= cfg.queue_high
                   else "admit_wait_high")
            return ScaleDecision(now, "scale_up_worker", f"{why}:{name}",
                                 qdepth, sdepth, busy_frac, wait_mean,
                                 n + 1, replicas)
        if (
            sdepth >= cfg.serving_queue_high
            and self.replica_factory is not None
            and 0 < replicas < cfg.max_replicas
        ):
            engine = self.replica_factory()
            self.serving.add_replica(engine)
            self.replica_scale_ups += 1
            self._cooldown = cfg.cooldown_ticks
            self._idle_streak = 0
            return ScaleDecision(now, "scale_up_replica", "serving_queue_high",
                                 qdepth, sdepth, busy_frac, wait_mean,
                                 n, replicas + 1)

        # -- scale down: one workload class's lane went quiet -----------
        # fires without waiting for the *whole* pool to idle: a class
        # that showed demand and then drained for class_idle_ticks
        # consecutive ticks hands one worker back, even while other
        # classes are still busy.  The class must show demand again
        # before it can trigger another shrink
        if cfg.class_idle_ticks > 0 and n > cfg.min_workers:
            for cls in sorted(self._class_idle):
                if self._class_idle[cls] < cfg.class_idle_ticks:
                    continue
                name = self.scheduler.retire_worker()
                if name is None:
                    break
                self.controller.lose(
                    cfg.devices_per_worker, step=self._ticks,
                    reason=f"class-idle:{cls}",
                )
                self.scale_downs += 1
                self.class_scale_downs += 1
                self._class_idle[cls] = 0
                self._class_seen.discard(cls)
                self._cooldown = cfg.cooldown_ticks
                self._idle_streak = 0
                return ScaleDecision(
                    now, "scale_down_worker", f"class_idle:{cls}:{name}",
                    qdepth, sdepth, busy_frac, wait_mean, n - 1, replicas,
                )

        # -- scale down: sustained idle capacity ------------------------
        idle = qdepth == 0 and busy_frac < cfg.busy_low
        if idle and (n > cfg.min_workers or (
            self.replica_factory is not None and replicas > cfg.min_replicas
            and sdepth == 0
        )):
            self._idle_streak += 1
            if self._idle_streak >= cfg.idle_ticks:
                self._idle_streak = 0
                self._cooldown = cfg.cooldown_ticks
                if n > cfg.min_workers:
                    name = self.scheduler.retire_worker()
                    if name is not None:
                        self.controller.lose(
                            cfg.devices_per_worker, step=self._ticks,
                            reason="scale-down",
                        )
                        self.scale_downs += 1
                        return ScaleDecision(
                            now, "scale_down_worker", f"idle:{name}",
                            qdepth, sdepth, busy_frac, wait_mean,
                            n - 1, replicas,
                        )
                else:
                    idx = self.serving.retire_replica()
                    if idx is not None:
                        self.replica_scale_downs += 1
                        return ScaleDecision(
                            now, "scale_down_replica", f"idle:replica{idx}",
                            qdepth, sdepth, busy_frac, wait_mean,
                            n, replicas - 1,
                        )
            return hold("idle_streak")
        self._idle_streak = 0
        return hold("steady")

    # ------------------------------------------------------ chaos/ops plane

    def force_scale_up(self, n: int = 1, reason: str = "forced") -> int:
        """Ops-driven scale event (chaos plans): add ``n`` workers now."""
        added = 0
        for _ in range(n):
            if len(self._active_workers()) >= self.cfg.max_workers:
                break
            name = self.scheduler.spawn_worker()
            self.controller.gain(self.cfg.devices_per_worker,
                                 step=self._ticks, reason=reason)
            self.scale_ups += 1
            added += 1
            self.decisions.append(ScaleDecision(
                self._exec.now(), "scale_up_worker", f"{reason}:{name}",
                -1, -1, 0.0, 0.0, len(self._active_workers()),
                self._replica_count(),
            ))
        return added

    def force_scale_down(self, n: int = 1, reason: str = "forced") -> int:
        """Ops-driven scale event: gracefully retire up to ``n`` workers."""
        removed = 0
        for _ in range(n):
            if len(self._active_workers()) <= self.cfg.min_workers:
                break
            name = self.scheduler.retire_worker()
            if name is None:
                break
            self.controller.lose(self.cfg.devices_per_worker,
                                 step=self._ticks, reason=reason)
            self.scale_downs += 1
            removed += 1
            self.decisions.append(ScaleDecision(
                self._exec.now(), "scale_down_worker", f"{reason}:{name}",
                -1, -1, 0.0, 0.0, len(self._active_workers()),
                self._replica_count(),
            ))
        return removed

    # -------------------------------------------------------------- status

    def decision_log(self) -> List[Tuple]:
        """Replay-comparable tuples (byte-identical per sim seed)."""
        return [d.key() for d in self.decisions]

    def elastic_stats(self) -> dict:
        """Snapshot for ``MetricsRegistry.register_elastic``."""
        return {
            "workers_active": len(self._active_workers()),
            "replicas_alive": self._replica_count(),
            "scale_up_total": self.scale_ups,
            "scale_down_total": self.scale_downs,
            "class_scale_down_total": self.class_scale_downs,
            "replica_scale_up_total": self.replica_scale_ups,
            "replica_scale_down_total": self.replica_scale_downs,
            "decisions_total": len(self.decisions),
            "pool_healthy": self.controller.healthy,
            "pool_in_use": self.controller.in_use,
            "pool_spare": max(self.controller.spare, 0),
        }
