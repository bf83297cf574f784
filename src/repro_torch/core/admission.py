"""Admission control plane: the quota-slot ledger.

The serving engine uses the reference's ``AdmissionController`` only for
its slot ledger, so that ledger is all this module holds.  The jaxpr
verifier, the verification cache and the policy/budget/image-digest
stages wait for the control-plane slice (see ROADMAP.md, queue 1 item 6),
where the verified graph becomes a ``torch.export`` graph.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .telemetry import TelemetrySink

__all__ = ["AdmissionController"]


class AdmissionController:
    """Per-tenant ledger of in-flight quota slots, with a telemetry sink."""

    def __init__(self, *, sink: Optional[TelemetrySink] = None) -> None:
        self.sink = sink or TelemetrySink()
        # quota-slot ledger: tenant -> [acquired, released].  After a clean
        # drain the books must balance (slot_balance() == {}), so a leaked
        # slot on any release path is detectable
        self._slots: Dict[str, List[int]] = {}
        self._lock = threading.Lock()

    def slot_acquired(self, tenant: str) -> None:
        """Record one in-flight quota slot reserved for ``tenant``."""
        with self._lock:
            self._slots.setdefault(tenant, [0, 0])[0] += 1

    def slot_released(self, tenant: str) -> None:
        """Record one in-flight quota slot released for ``tenant``."""
        with self._lock:
            self._slots.setdefault(tenant, [0, 0])[1] += 1

    def slot_stats(self) -> Dict[str, Dict[str, int]]:
        """Acquired/released slot counts per tenant."""
        with self._lock:
            return {
                t: {"acquired": a, "released": r}
                for t, (a, r) in self._slots.items()
            }

    def slot_balance(self) -> Dict[str, int]:
        """Outstanding (acquired - released) slots per tenant.

        Empty after a clean drain; any surviving entry is a leaked slot.
        """
        with self._lock:
            return {
                t: a - r for t, (a, r) in sorted(self._slots.items())
                if a != r
            }
