"""Per-tenant quotas (the serving engine's slot caps).

Only :class:`TenantQuota` of the reference's ``core/tasks.py`` is ported
here; the serverless scheduler waits for the control-plane slice (see
ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["TenantQuota"]


@dataclass(frozen=True)
class TenantQuota:
    max_tasks_in_flight: int = 4
    flop_budget_per_task: Optional[float] = None
    byte_budget_per_task: Optional[float] = None
    #: deficit-round-robin share: a weight-3 tenant is offered three task
    #: dispatches for every one a weight-1 tenant gets while both queue
    weight: int = 1
