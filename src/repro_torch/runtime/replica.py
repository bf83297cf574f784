"""Data-parallel serving replicas: tenant routing, mesh faults, re-homing.

The reference's ``repro/runtime/replica.py`` over the port's engine and
``HeartbeatMonitor``.  A :class:`ReplicaSet` fronts N independent
:class:`~repro_torch.runtime.serve_loop.ServingEngine` replicas, each a
whole-device engine or a tensor-parallel one on its own sub-mesh
(``make_serving_mesh(tp, offset=i * tp)``: DP x TP).
Engines may share one model: each holds only a reference to the weights
and has its own KV pool.  One routing decision: a tenant is *sticky* to
the first replica it lands on, so its requests share that replica's prefix
cache and admission state, and new tenants go to the least-loaded live
replica.  Routing reads only deterministic state (virtual clock, queue
depths at submit time), so a seeded workload routes identically on every
replay.

Two fault planes, mirroring the task scheduler's worker model:

* ``kill_replica(i)`` — the replica process dies *loudly* (its exit is
  observed): evacuate immediately and re-home the survivors' requests.
* ``kill_mesh_member(i)`` — a device backing replica i dies *silently*:
  the replica stops stepping and stops heartbeating, and its requests
  are stranded until the
  :class:`~repro_torch.runtime.fault.HeartbeatMonitor` (driven by the
  executor's virtual clock, the scheduler's reap path) times it
  out — only then does the set evacuate and re-home.  The gap between
  death and reap is exactly the heartbeat timeout, which the chaos suite
  asserts no request is lost or doubled across.

Re-homed requests resume from their prompt + generated-so-far tokens on
the new replica (full re-prefill — the pages died with the member's pool
shard); sampling is keyed by (request seed, token index), so the resumed
stream is byte-identical to an undisturbed run wherever the re-prefill's
logits equal the decode steps' (integer models; a float model's prefill
and decode round differently).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from .fault import HeartbeatMonitor
from .serve_loop import Request, ServingEngine

__all__ = ["ReplicaSet"]


class ReplicaSet:
    """N serving-engine replicas on one executor, behind tenant routing."""

    def __init__(self, replicas: List[ServingEngine], *,
                 heartbeat_timeout_s: float = 0.05):
        if not replicas:
            raise ValueError("ReplicaSet needs at least one replica")
        execs = {id(r._exec) for r in replicas}
        if len(execs) != 1:
            raise ValueError("replicas must share one executor (one clock)")
        self.replicas = list(replicas)
        self._exec = replicas[0]._exec
        self.step_time_s = max(
            (r.cfg.step_time_s for r in replicas), default=0.0
        )
        self.monitor = HeartbeatMonitor(
            [self._name(i) for i in range(len(replicas))],
            timeout_s=heartbeat_timeout_s, clock=self._exec.now,
        )
        self._home: Dict[str, int] = {}          # tenant → replica index
        self.mesh_dead: set = set()              # silent-death replica idxs
        self._orphans: List[Request] = []        # nowhere left to re-home
        self.rehomed_total = 0
        self.replica_kills = 0
        self.mesh_member_kills = 0
        self.heartbeat_reaps = 0
        self.replicas_added = 0                  # elastic scale-up events
        self.replicas_retired = 0                # elastic scale-down events

    @staticmethod
    def _name(i: int) -> str:
        return f"replica{i}"

    # ------------------------------------------------------------- routing

    def alive(self) -> List[int]:
        return [i for i, r in enumerate(self.replicas)
                if not r.dead and i not in self.mesh_dead]

    def _load(self, i: int) -> int:
        r = self.replicas[i]
        return r.active_count() + r.queue_depth()

    def route(self, tenant: str) -> int:
        """Replica index for a tenant: sticky home, else least loaded.

        Ties break to the lowest index, so routing is a pure function of
        (home map, per-replica load) — both deterministic under sim.
        """
        live = self.alive()
        if not live:
            raise RuntimeError("no live replicas")
        home = self._home.get(tenant)
        if home is not None and home in live:
            return home
        idx = min(live, key=lambda i: (self._load(i), i))
        self._home[tenant] = idx
        return idx

    def submit(self, r: Request) -> int:
        return self.replicas[self.route(r.tenant)].submit(r)

    # ------------------------------------------------------------ stepping

    def step(self) -> int:
        """Step every live replica, beat its heart, reap the silent.

        Replicas in ``mesh_dead`` neither step nor beat — that is the
        fault model — so after ``heartbeat_timeout_s`` of virtual time
        the monitor reports them dead and they are evacuated.
        """
        done = 0
        for i, r in enumerate(self.replicas):
            if r.dead or i in self.mesh_dead:
                continue
            done += r.step()
            self.monitor.beat(self._name(i))
        for name in self.monitor.dead_workers():
            idx = int(name[len("replica"):])
            self.heartbeat_reaps += 1
            self._reap(idx)
        return done

    def has_work(self) -> bool:
        # un-reaped mesh-dead replicas count: their stranded requests
        # still need the reap → re-home path to run
        return any(r.has_work() for r in self.replicas)

    def drain(self, timeout: float = 300.0) -> List[Request]:
        deadline = time.monotonic() + timeout
        while self.has_work():
            self.step()
            if self.step_time_s > 0:
                self._exec.sleep(self.step_time_s)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"ReplicaSet.drain: work remaining after {timeout}s"
                )
        for r in self.replicas:
            r.drain(timeout=max(deadline - time.monotonic(), 1.0))
        return self.completed

    # ------------------------------------------------------------- elastic

    def add_replica(self, engine: ServingEngine) -> int:
        """Grow the set by one replica (autoscaler scale-up).

        The new replica joins routing immediately: it starts least-loaded,
        so the next un-homed tenant lands on it.  Returns its index.
        """
        if engine._exec is not self._exec:
            raise ValueError("replica must share the set's executor")
        idx = len(self.replicas)
        self.replicas.append(engine)
        self.step_time_s = max(self.step_time_s, engine.cfg.step_time_s)
        self.monitor.beat(self._name(idx))     # registers + first beat
        self.replicas_added += 1
        return idx

    def retire_replica(self, i: Optional[int] = None) -> Optional[int]:
        """Gracefully shrink the set by one replica (scale-down).

        Unlike :meth:`kill_replica` this is an *ops* event, not a fault:
        the replica is drained via the same evacuate + re-home path (its
        in-flight requests resume elsewhere), but counted as a scale
        event.  ``i=None`` picks the live replica with the least load
        (ties to the highest index, so scale-down unwinds scale-up).
        Refuses (returns None) when it would leave no live replica.
        """
        live = self.alive()
        if len(live) <= 1:
            return None
        if i is None:
            i = min(live, key=lambda j: (self._load(j), -j))
        elif i not in live:
            return None
        self.replicas_retired += 1
        self.monitor.remove(self._name(i))
        self._reap(i)
        return i

    def queue_depth(self) -> int:
        """Aggregate admit-queue depth across live replicas."""
        return sum(r.queue_depth() for i, r in enumerate(self.replicas)
                   if not r.dead and i not in self.mesh_dead)

    def admit_wait_snapshot(self):
        """(count, sum) of admit-wait across the set's distinct sinks."""
        n = 0.0
        s = 0.0
        for sink in {id(r.telemetry): r.telemetry for r in self.replicas}.values():
            for (name, _tenant), hist in sink.histograms().items():
                if name == "serving.admit_wait_seconds":
                    n += hist.count
                    s += hist.sum
        return (n, s)

    # --------------------------------------------------------------- chaos

    def kill_replica(self, i: int) -> int:
        """The replica process dies loudly: evacuate + re-home now."""
        if self.replicas[i].dead:
            return 0
        self.replica_kills += 1
        self.monitor.remove(self._name(i))
        return self._reap(i)

    def kill_mesh_member(self, i: int) -> None:
        """A device under replica i dies silently: strand until reaped."""
        if self.replicas[i].dead or i in self.mesh_dead:
            return
        self.mesh_member_kills += 1
        self.mesh_dead.add(i)

    def _reap(self, idx: int) -> int:
        self.monitor.remove(self._name(idx))
        self.mesh_dead.discard(idx)
        evicted = self.replicas[idx].evacuate()
        # drop stale stickiness before re-routing the evacuees
        for tenant, home in list(self._home.items()):
            if home == idx:
                del self._home[tenant]
        for r in evicted:
            live = self.alive()
            if not live:
                r.error = "all replicas dead"
                r.done = True
                self._orphans.append(r)
                continue
            self.rehomed_total += 1
            self.replicas[self.route(r.tenant)].submit(r)
        return len(evicted)

    # --------------------------------------------------------- aggregation

    @property
    def completed(self) -> List[Request]:
        out: List[Request] = []
        for r in self.replicas:
            out.extend(r.completed)
        out.extend(self._orphans)
        return sorted(out, key=lambda r: r.request_id)

    def replica_stats(self) -> Dict[str, object]:
        per = []
        for i, r in enumerate(self.replicas):
            st = r.serving_stats()
            per.append({
                "alive": int(not r.dead and i not in self.mesh_dead),
                "tp_shards": st["tp_shards"],
                "completed": sum(st["completed_total"].values()),
                "active": r.active_count(),
                "queued": r.queue_depth(),
                "evictions": st["evicted_total"],
                "live_pages": r.kv.live_pages(),
            })
        return {
            "replicas_total": len(self.replicas),
            "replicas_alive": len(self.alive()),
            "mesh_members_dead": len(self.mesh_dead),
            "replica_kills": self.replica_kills,
            "mesh_member_kills": self.mesh_member_kills,
            "heartbeat_reaps": self.heartbeat_reaps,
            "rehomed_total": self.rehomed_total,
            "orphaned": len(self._orphans),
            "replicas_added": self.replicas_added,
            "replicas_retired": self.replicas_retired,
            "per_replica": per,
        }
