"""SEE++ core of the port — the paper's contribution on PyTorch.

=================  =========================================================
``policy``         legacy allowlist vs modern Sentry-emulation policies over
                   aten-graph operator names
``sentry``         aten-graph interception, emulation, resource metering
``admission``      unified admission control plane: policy verification +
                   budget pre-check + image-digest check behind a
                   program-fingerprint verification cache (pay interception
                   cost once at load time), and the quota-slot ledger
``pool``           warm sandbox pool: per-tenant checkout/checkin,
                   pre-warming, background refill, LRU eviction
``telemetry``      structured audit/metrics events; one sink for every
                   admission layer (counters + latency histograms)
``metrics``        Prometheus text exposition of the whole control plane
``vma`` / ``mm``   §IV.A virtual-memory management
``arena``          device-memory arena / paged-KV allocator built on ``mm``
``image``          §III.B standardized base image
``gofer``          mediated (capability-checked) I/O
``sandbox``        per-tenant facade combining all of the above
``sim``            execution substrate: real threads + wall clock in
                   production, seeded cooperative interleaving + virtual
                   clock under test
``tasks``          §V.A serverless multi-tenant scheduler
``elf``            §IV.B SELF segmented artifact format
``loader``         SELF image loader: Linux vs legacy zero-fill semantics
``artifacts``      §V.B artifact repository: ops and SELF images, verified
                   at registration
=================  =========================================================

``vma``, ``mm``, ``arena``, ``sim``, ``telemetry``, ``metrics``,
``gofer``, ``elf`` and ``loader`` are copies of the reference's modules,
and ``pool``, ``tasks`` and ``artifacts`` are the reference's files with
their imports pointed here: the port imports nothing of ``repro``.  The
loader's zero-fill stays on the host ``bytearray``, as in the reference.
"""

from .admission import (
    AdmissionController,
    AdmissionTicket,
    ImageDigestError,
    default_controller,
)
from .arena import DeviceArena, PagedKVAllocator, PrefixIndex, SequencePages
from .artifacts import Artifact, ArtifactRepository, RegistrationReport
from .elf import (
    LANE_TILE,
    PAGE_SIZE,
    PT_DYNAMIC,
    PT_LOAD,
    BadImageError,
    SELFImage,
    SELFWriter,
    read_self,
)
from .gofer import Capability, CapabilityError, Gofer
from .image import DEFAULT_IMAGE, BaseImage, DtypePolicy, ImageSpec
from .loader import ImageLoader, LoadedImage, SegfaultError, ZeroStats
from .metrics import MetricsHTTPServer, MetricsRegistry
from .mm import MemoryManager, MMConfig
from .policy import (
    DANGEROUS_PRIMITIVES,
    LEGACY_ALLOWLIST,
    LegacyFilterPolicy,
    ModernEmulationPolicy,
    SandboxPolicy,
    SandboxViolation,
)
from .pool import PoolStats, SandboxPool
from .sandbox import Sandbox, SandboxResult
from .sentry import (
    BudgetExceeded,
    ResourceMeter,
    SentryInterpreter,
    sandboxed,
    static_verify,
)
from .sim import (
    Clock,
    Executor,
    RealClock,
    SimDeadlock,
    SimExecutor,
    ThreadExecutor,
    VirtualClock,
    WorkerKilled,
)
from .tasks import (
    CancelToken,
    ServerlessScheduler,
    TaskPreempted,
    TaskRecord,
    TaskSpec,
    TaskState,
    TenantQuota,
    checkpoint,
    current_cancel_token,
)
from .telemetry import Histogram, TelemetryEvent, TelemetrySink, resolve_sink
from .vma import (
    MAX_MAP_COUNT,
    AddrRange,
    Direction,
    FileRangeAllocator,
    HostMapping,
    VMA,
    VMAExhaustedError,
    VMASet,
    coalesce_host_mappings,
)

__all__ = [n for n in dir() if not n.startswith("_")]
