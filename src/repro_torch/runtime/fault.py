"""Fault tolerance: heartbeats, failure injection, straggler detection.

A copy of the reference's ``repro/runtime/fault.py``, which is pure
Python; the port keeps its own so that it imports nothing of the JAX
package.  The classes are unchanged:

* :class:`HeartbeatMonitor` — per-worker liveness with a miss threshold,
  on any clock (``clock=executor.now`` judges by virtual time under
  :class:`~repro_torch.core.sim.SimExecutor`); the scheduler's
  ``enable_heartbeats`` uses it.
* :class:`StragglerDetector` — robust (median/MAD) per-worker step-time
  z-scores; persistent outliers are flagged for eviction.
* :class:`FailureInjector` — deterministic chaos plans.  Its serving plane
  (:meth:`FailureInjector.arm_serving`) schedules batch kills and arena,
  shared-prefix and mid-prefill poisonings onto a ``SimExecutor`` against
  :class:`~repro_torch.runtime.serve_loop.ServingEngine`, and :meth:`arm`
  schedules node kills and slowdowns against
  :class:`~repro_torch.core.tasks.ServerlessScheduler` workers.  The
  replica plane (:meth:`arm_replicas`: loud replica kills and silent
  mesh-member deaths) drives
  :class:`~repro_torch.runtime.replica.ReplicaSet`, and the autoscaler
  plane (:meth:`arm_orchestrator`: ops-driven scale events) drives
  :class:`~repro_torch.runtime.elastic.ElasticAutoscaler`.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

__all__ = ["HeartbeatMonitor", "StragglerDetector", "FailureInjector",
           "WorkerFailure"]


class WorkerFailure(RuntimeError):
    def __init__(self, workers: List[str]):
        self.workers = workers
        super().__init__(f"workers failed: {workers}")


class HeartbeatMonitor:
    def __init__(self, workers: List[str], *, timeout_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        self._last: Dict[str, float] = {w: clock() for w in workers}
        self._lock = threading.Lock()

    def beat(self, worker: str) -> None:
        with self._lock:
            self._last[worker] = self.clock()

    def dead_workers(self) -> List[str]:
        now = self.clock()
        with self._lock:
            return sorted(
                w for w, t in self._last.items() if now - t > self.timeout_s
            )

    def remove(self, worker: str) -> None:
        with self._lock:
            self._last.pop(worker, None)

    def last(self, worker: str) -> Optional[float]:
        """Timestamp of the worker's last beat (None if never seen)."""
        with self._lock:
            return self._last.get(worker)

    def workers(self) -> List[str]:
        with self._lock:
            return sorted(self._last)


class StragglerDetector:
    """Median/MAD z-score over a sliding window of per-worker step times.

    Thread-safe: the scheduler records step times from every worker
    thread while a control thread polls ``stragglers()``.
    """

    def __init__(self, *, window: int = 32, z_threshold: float = 4.0,
                 min_steps: int = 8, patience: int = 3):
        self.window = window
        self.z_threshold = z_threshold
        self.min_steps = min_steps
        self.patience = patience
        self._times: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window)
        )
        self._strikes: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def record(self, worker: str, step_time_s: float) -> None:
        with self._lock:
            self._times[worker].append(step_time_s)

    def _medians_locked(self) -> Dict[str, float]:
        return {
            w: sorted(ts)[len(ts) // 2] for w, ts in self._times.items() if ts
        }

    def stragglers(self) -> List[str]:
        with self._lock:
            meds = self._medians_locked()
            if len(meds) < 2:
                return []
            vals = sorted(meds.values())
            global_med = vals[len(vals) // 2]
            mad = sorted(abs(v - global_med) for v in vals)[len(vals) // 2]
            scale = max(mad * 1.4826, global_med * 0.01, 1e-9)
            out = []
            for w, v in meds.items():
                if len(self._times[w]) < self.min_steps:
                    continue
                z = (v - global_med) / scale
                if z > self.z_threshold:
                    self._strikes[w] += 1
                else:
                    self._strikes[w] = 0
                if self._strikes[w] >= self.patience:
                    out.append(w)
            return sorted(out)

    def strikes(self) -> Dict[str, int]:
        """Current strike count per worker (observability/debugging)."""
        with self._lock:
            return dict(self._strikes)


@dataclass
class FailureInjector:
    """Deterministic chaos: fail worker W at step N, or slow it down.

    Two planes share this planner: the trainer's step-indexed hooks
    (``fail_at``/``slow_at`` + :meth:`check`/:meth:`step_time`), and the
    scheduler sim's *time*-indexed node faults (``kill_at_t``/
    ``slow_at_t`` + :meth:`arm`), where faults land at virtual times on a
    :class:`~repro.core.sim.SimExecutor`.
    """

    fail_at: Dict[int, List[str]] = field(default_factory=dict)
    slow_at: Dict[str, float] = field(default_factory=dict)  # worker→factor
    killed: Set[str] = field(default_factory=set)
    #: virtual time → workers to kill outright (direct node loss)
    kill_at_t: Dict[float, List[str]] = field(default_factory=dict)
    #: virtual time → {worker: slow factor} (node gets sick, stops
    #: beating fast enough — the heartbeat-timeout death path)
    slow_at_t: Dict[float, Dict[str, float]] = field(default_factory=dict)
    #: virtual times at which the serving engine's decode batch dies
    #: mid-flight (node loss under the batch); every live sequence is
    #: evicted back to the admit queue with its tokens intact.  In paged
    #: kv_mode the kill evicts the *slot only* — the sequence's KV pages
    #: survive, and re-admission resumes off them with a page-table edit
    #: (zero re-prefill); dense mode re-prefills prompt+tokens
    kill_batch_at_t: List[float] = field(default_factory=list)
    #: virtual time → live-slot index whose KV-arena pages get poisoned;
    #: the engine's next step detects it via ``kv.validate()`` and
    #: evicts the sequence instead of decoding garbage.  Unlike a batch
    #: kill, poison ALWAYS drops the pages and re-prefills on
    #: re-admission, in either kv_mode — the pages are corrupt by
    #: definition, so resuming off them would serve poisoned KV
    poison_arena_at_t: Dict[float, int] = field(default_factory=dict)
    #: virtual time → index (sorted order) of a sequence whose pages are
    #: *shared* with another sequence — a live slot or a parked prefix
    #: donor.  Poison propagates to every co-mapper of those pages, so
    #: the whole sharing clique evicts and re-prefills: the worst-case
    #: blast radius of cross-tenant prefix sharing.  A no-op when
    #: nothing is shared at that instant (the engine returns None)
    poison_shared_at_t: Dict[float, int] = field(default_factory=dict)
    #: virtual time → index (sorted order) of a sequence that is *mid
    #: chunked-prefill* — some but not all of its prompt rows are
    #: resident.  Poison drops the partial pages, so re-admission
    #: restarts the chunked prefill from zero; a no-op when nothing is
    #: mid-prefill at that instant (the engine returns None)
    poison_prefilling_at_t: Dict[float, int] = field(default_factory=dict)
    #: virtual time → replica indices whose process dies *loudly* (exit
    #: observed): the ReplicaSet evacuates and re-homes immediately
    kill_replica_at_t: Dict[float, List[int]] = field(default_factory=dict)
    #: virtual time → replica indices whose mesh member dies *silently*:
    #: the replica strands its requests until the heartbeat monitor
    #: times it out, then the set evacuates and re-homes (PR-4 reap path)
    kill_mesh_member_at_t: Dict[float, List[int]] = field(
        default_factory=dict)
    #: virtual time → workers to force-add (ops-driven scale event on an
    #: :class:`~repro.runtime.elastic.ElasticAutoscaler`); the chaos
    #: suite mixes these with node kills to stress the fleet plane
    scale_up_at_t: Dict[float, int] = field(default_factory=dict)
    #: virtual time → workers to force-retire (graceful scale-down: the
    #: victims finish their current task, then exit)
    scale_down_at_t: Dict[float, int] = field(default_factory=dict)

    def check(self, step: int) -> None:
        victims = [w for w in self.fail_at.get(step, []) if w not in self.killed]
        if victims:
            self.killed.update(victims)
            raise WorkerFailure(victims)

    def step_time(self, worker: str, base_s: float) -> float:
        return base_s * self.slow_at.get(worker, 1.0)

    def arm(self, sim) -> None:
        """Schedule the time-indexed plan onto a ``SimExecutor``.

        Kills use ``sim.kill`` (the worker dies at its next scheduling
        point); slowdowns use ``sim.slow`` (the worker lives but its
        sleeps stretch, so heartbeat monitors see it go dark).  The plan
        is sorted, so identical plans replay identically per sim seed.
        """
        for when in sorted(self.kill_at_t):
            def _kill(victims=tuple(self.kill_at_t[when])) -> None:
                for w in victims:
                    if sim.kill(w):
                        self.killed.add(w)
            sim.call_at(when, _kill)
        for when in sorted(self.slow_at_t):
            def _slow(pairs=tuple(sorted(self.slow_at_t[when].items()))) -> None:
                for w, factor in pairs:
                    sim.slow(w, factor)
            sim.call_at(when, _slow)

    def arm_serving(self, sim, engine) -> None:
        """Schedule the serving-plane chaos plan onto a ``SimExecutor``.

        ``kill_batch_at_t`` calls ``engine.kill_batch()`` (every live
        decode slot evicted, requests requeued with tokens intact; in
        paged kv_mode their pages survive and re-admission is a
        page-table edit) and ``poison_arena_at_t`` poisons the i-th live
        sequence's KV pages (``engine.poison_live(i)``; pages always
        dropped and the victim re-prefilled).  Timers fire during the
        engine's between-step ``executor.sleep``, so the plan lands at
        identical virtual times on every replay of a seed.
        """
        for when in sorted(self.kill_batch_at_t):
            sim.call_at(when, engine.kill_batch)
        for when in sorted(self.poison_arena_at_t):
            def _poison(idx=self.poison_arena_at_t[when]) -> None:
                engine.poison_live(idx)
            sim.call_at(when, _poison)
        for when in sorted(self.poison_shared_at_t):
            def _poison_shared(idx=self.poison_shared_at_t[when]) -> None:
                engine.poison_shared(idx)
            sim.call_at(when, _poison_shared)
        for when in sorted(self.poison_prefilling_at_t):
            def _poison_pref(idx=self.poison_prefilling_at_t[when]) -> None:
                engine.poison_prefilling(idx)
            sim.call_at(when, _poison_pref)

    def arm_replicas(self, sim, replica_set) -> None:
        """Schedule the replica-plane chaos plan onto a ``SimExecutor``.

        ``kill_replica_at_t`` fires ``ReplicaSet.kill_replica`` (loud
        death → instant evacuate + re-home); ``kill_mesh_member_at_t``
        fires ``kill_mesh_member`` (silent death → stranded until the
        heartbeat reap).  Timers land during the set's between-step
        sleep, so the plan replays identically per sim seed.
        """
        for when in sorted(self.kill_replica_at_t):
            def _kill(victims=tuple(self.kill_replica_at_t[when])) -> None:
                for i in victims:
                    replica_set.kill_replica(i)
            sim.call_at(when, _kill)
        for when in sorted(self.kill_mesh_member_at_t):
            def _kill_m(victims=tuple(
                    self.kill_mesh_member_at_t[when])) -> None:
                for i in victims:
                    replica_set.kill_mesh_member(i)
            sim.call_at(when, _kill_m)

    def arm_orchestrator(self, sim, autoscaler) -> None:
        """Schedule ops-driven scale events onto a ``SimExecutor``.

        ``scale_up_at_t`` / ``scale_down_at_t`` fire the autoscaler's
        ``force_scale_up`` / ``force_scale_down`` hooks, so chaos plans
        can mix fleet churn with node kills and the decisions still land
        in the same byte-replayable decision log.
        """
        for when in sorted(self.scale_up_at_t):
            def _up(n=int(self.scale_up_at_t[when])) -> None:
                autoscaler.force_scale_up(n, reason="chaos")
            sim.call_at(when, _up)
        for when in sorted(self.scale_down_at_t):
            def _down(n=int(self.scale_down_at_t[when])) -> None:
                autoscaler.force_scale_down(n, reason="chaos")
            sim.call_at(when, _down)
