"""The scheduler and replica invariants of ``helpers/invariants.py`` for
the port.

:class:`AuditedPool` and :class:`WatchedScheduler` are the reference
helpers' twins over ``repro_torch.core``'s pool and scheduler, and
:func:`check_port_drain_invariants` runs the reference's own
``check_drain_invariants`` on a port scheduler, its task states read
through the reference's ``TaskState`` by value.
:func:`check_port_replica_invariants` is ``check_replica_invariants``'s
twin for the port's ``ReplicaSet``: the reference's checks (exactly-once
completion, exact token counts, empty planes, page and slot ledgers per
replica and per shard) plus each replica's ``tp_shards``: its mesh's size,
or 1 for a whole-device engine.
"""

from types import SimpleNamespace

from helpers.invariants import check_drain_invariants, check_replica_invariants

from repro.core import TaskState as JaxTaskState
from repro_torch.core import SandboxPool, ServerlessScheduler

__all__ = ["AuditedPool", "WatchedScheduler", "check_port_drain_invariants",
           "check_port_replica_invariants"]


class AuditedPool(SandboxPool):
    """SandboxPool asserting single ownership of every checkout."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.live = set()
        self.double_checkouts = []

    def checkout(self, tenant):
        sb = super().checkout(tenant)
        if id(sb) in self.live:
            self.double_checkouts.append((tenant, id(sb)))
        self.live.add(id(sb))
        return sb

    def checkin(self, sandbox, *, discard=False):
        self.live.discard(id(sandbox))
        super().checkin(sandbox, discard=discard)


class WatchedScheduler(ServerlessScheduler):
    """Scheduler recording the per-tenant in-flight high-water mark."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_in_flight = {}

    def _reserve_locked(self, tenant, worker):
        task_id = super()._reserve_locked(tenant, worker)
        n = self._in_flight.get(tenant, 0)
        if n > self.max_in_flight.get(tenant, 0):
            self.max_in_flight[tenant] = n
        return task_id


class _ReferenceView:
    """A port scheduler whose records answer in the reference's states."""

    def __init__(self, sched):
        self._sched = sched

    def __getattr__(self, name):
        return getattr(self._sched, name)

    def record(self, task_id):
        rec = self._sched.record(task_id)
        return SimpleNamespace(state=JaxTaskState(rec.state.value),
                               death_requeues=rec.death_requeues)


def check_port_drain_invariants(sched, ids, *, quotas=None, ctx=""):
    """The reference's drain invariants, on the port's scheduler."""
    check_drain_invariants(_ReferenceView(sched), ids, quotas=quotas, ctx=ctx)


def check_port_replica_invariants(replica_set, requests, *, ctx=""):
    """The reference's replica invariants, on the port's ``ReplicaSet``."""
    check_replica_invariants(replica_set, requests, ctx=ctx)
    shards = [p["tp_shards"] for p in replica_set.replica_stats()["per_replica"]]
    want = [e.mesh.size if e.mesh is not None else 1
            for e in replica_set.replicas]
    assert shards == want, (shards, want, ctx)
