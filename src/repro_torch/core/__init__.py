"""Host substrate of the port: the arena, executors, telemetry and the
admission slot ledger the serving engine needs.

``vma``, ``mm``, ``arena``, ``sim`` and ``telemetry`` are verbatim copies
of the reference's numpy-only modules (importing ``repro.core`` would pull
in jax through ``sentry``).  ``tasks`` and ``admission`` hold only the
pieces the serving engine uses; the rest waits for the control-plane
slice (see ROADMAP.md).
"""

from .admission import AdmissionController
from .arena import DeviceArena, PagedKVAllocator, PrefixIndex, SequencePages
from .mm import MemoryManager, MMConfig
from .sim import Executor, SimExecutor, ThreadExecutor
from .tasks import TenantQuota
from .telemetry import TelemetrySink, resolve_sink

__all__ = [
    "AdmissionController", "DeviceArena", "Executor", "MMConfig",
    "MemoryManager", "PagedKVAllocator", "PrefixIndex", "SequencePages",
    "SimExecutor", "TelemetrySink", "TenantQuota", "ThreadExecutor",
    "resolve_sink",
]
