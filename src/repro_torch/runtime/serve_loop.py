"""Serving plane: continuous batching over the KV arena.

The counterpart of ``repro/runtime/serve_loop.py``'s :class:`ServingEngine`:
``submit(request)`` / ``step()`` / ``drain()`` on the
:mod:`repro_torch.core.sim` Clock/Executor substrate.  Tokens come from the
seeded host sampler (:mod:`repro_torch.runtime.sampling`), keyed by
``(request.seed, token index)``.

* Paged (``kv_mode="paged"``, and ``"auto"`` for a model with the paged
  interface): admitting a request prefills exactly that sequence and
  scatters its K/V rows into the pages
  :class:`~repro_torch.core.arena.PagedKVAllocator` allocated for it; every
  ``step()`` appends one row per live slot and decodes the batch through
  the paged-attention kernel, reading ``kv.page_table()`` directly.
* Dense (``kv_mode="dense"``, and ``"auto"`` otherwise: RWKV, and the
  transformers with windows or a softcap, gemma2/3): one batch decode
  state from ``model.init_decode_state(max_batch, max_seq)``; admitting a
  request prefills it alone and writes its state into its slot (the other
  slots are untouched), and every ``step()`` runs ``model.decode_step``
  over the whole batch.  The page ledger is kept as in the reference, one
  token appended per decode.  ``incremental=False`` is the rebatching
  baseline: every admission re-prefills the whole zero-padded batch.

As in the reference: per-tenant (priority, deadline, arrival) admit queues
with quota caps and the admission slot ledger; incremental monolithic or
chunked prefill (``prefill_chunk_tokens``: a per-step token budget, the
dense carry held outside the batch state until its last chunk);
cross-tenant prefix sharing with copy-on-write pages (on by default) and
parked prefix donors; the chaos hooks ``kill_batch`` (paged mode keeps the
pages: re-admission resumes), ``evacuate``, ``poison_live`` /
``poison_shared`` / ``poison_prefilling`` and arena-poison eviction;
``serving_stats`` and the decision trace.

A retired request's ``Request.postprocess`` runs on its token tensor
(int32, on the engine's device: on the card, user post-code runs on the
card) after its pages and slot are released: inline, through a sandbox
from the warm pool, or on the scheduler's workers (the concurrent plane,
joined in ``drain()``).  A denied or failing post-processor marks its own
request's ``error`` and never takes down the batch.  :class:`Server` is
the production wrapper that owns that pool, the scheduler and the
metrics, as in the reference.

Tensor-parallel serving (``mesh=``, a
:class:`~repro_torch.launch.mesh.ServingMesh`): in paged mode, a model
whose heads (or ``d``) divide the mesh is served by the mesh's shard
workers, each holding its head slice of the weights and of every page
(``tp_shards`` reports the width); the engine, the allocator, the sampler
and the clock stay in this process, which sends the workers each step's
host inputs and reads rank 0's logits.  As in the reference, dense mode
ignores the mesh, a model that does not divide it is served dense
(``auto``) or unsharded (``paged``), and either fallback is traced
(``tp_fallback``).

The model owns its weights (an ``nn.Module``), so the engine and
``Server`` take no ``params`` argument; the reference's jitted, donating
wrappers become direct calls that update the page pool and the slot state
in place.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.admission import AdmissionController
from repro_torch.core.arena import PagedKVAllocator
from repro_torch.core.metrics import MetricsHTTPServer, MetricsRegistry
from repro_torch.core.mm import MMConfig
from repro_torch.core.policy import SandboxViolation
from repro_torch.core.pool import SandboxPool
from repro_torch.core.sandbox import Sandbox
from repro_torch.core.sentry import BudgetExceeded
from repro_torch.core.sim import Executor, ThreadExecutor
from repro_torch.core.tasks import (
    ServerlessScheduler, TaskSpec, TaskState, TenantQuota,
)
from repro_torch.core.telemetry import TelemetrySink, resolve_sink
from repro_torch.runtime.sampling import sample_token

__all__ = ["Request", "ServerConfig", "Server", "ServingEngine"]


@dataclass
class Request:
    prompt: np.ndarray                   # (S,) int32
    max_new_tokens: int = 16
    request_id: int = 0
    postprocess: Optional[Callable] = None
    tenant: str = "serving"              # admission identity
    priority: int = 10                   # lower = admitted sooner
    #: seconds after arrival by which the request must be *admitted*;
    #: past it the request completes with an "expired" error instead
    deadline_s: Optional[float] = None
    #: sampling knobs: ``temperature <= 0`` is greedy (argmax); otherwise
    #: top_k > 0 / top_p < 1 truncate the distribution.  ``seed`` keys
    #: the draw together with the token index
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    # filled by the engine:
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    latency_s: float = 0.0               # from *arrival*, not server start
    error: Optional[str] = None          # denial/expiry/postprocess failure
    arrived_at: Optional[float] = None   # executor clock, stamped at submit
    admitted_at: Optional[float] = None  # first admission


@dataclass
class ServerConfig:
    max_batch: int = 4
    max_seq: int = 256
    tokens_per_page: int = 16
    mm_legacy: bool = False              # paper A/B: legacy vs modern arena
    pool_watermark: int = 0              # >0: refill postprocess pool async
    workers: int = 0                     # >0: concurrent postprocess plane
    #: >0: reap postprocess workers silent this long mid-task (their task
    #: requeues exactly once, a replacement worker is spawned).  Post-
    #: processors legitimately running longer than this must call
    #: ``repro_torch.core.checkpoint()`` periodically — it heartbeats the
    #: worker (and honors preemption), so live progress is never reaped
    heartbeat_timeout_s: float = 0.0
    #: per-slot incremental prefill; False = the rebatching baseline (every
    #: admission re-prefills the whole dense batch), for A/B
    incremental: bool = True
    #: virtual seconds one decode step occupies on the executor clock;
    #: >0 makes the engine sleep between steps
    step_time_s: float = 0.0
    #: cap on the engine decision log (0 = unbounded)
    trace_limit: int = 200_000
    #: per-tenant serving quotas: ``max_tasks_in_flight`` caps a tenant's
    #: concurrent decode slots (0 = denied outright); None = no caps.
    #: Tenants absent from a provided dict get the default TenantQuota()
    quotas: Optional[Dict[str, TenantQuota]] = None
    #: "paged": decode from the arena's page pool (the model must support
    #: it); "dense": one per-slot decode state (init_decode_state /
    #: decode_step); "auto": paged when the model supports it, dense
    #: otherwise
    kv_mode: str = "auto"
    #: size of the KV page pool in pages.  None = 4x the pages of a full
    #: (max_batch, max_seq) reservation
    kv_pool_pages: Optional[int] = None
    #: cross-tenant prefix sharing: admission maps a matching resident
    #: prompt prefix's pages read-only and prefills just the suffix; the
    #: first divergent write copy-on-writes the shared page
    prefix_sharing: bool = True
    #: >0: retired requests park their sequence (renamed ``~pfxN``) as a
    #: prefix donor instead of dropping it, up to this many, FIFO
    prefix_cache_seqs: int = 0
    #: chunked prefill: per-step budget of prompt tokens, shared across
    #: prefilling slots in slot order; a slot joins the decode batch once
    #: its prompt is resident.  Needs ``incremental`` and a model exposing
    #: ``paged_prefill_at`` (paged) or ``prefill_chunk`` (dense).  0 =
    #: monolithic prefill
    prefill_chunk_tokens: int = 0


class ServingEngine:
    """Incremental continuous-batching engine, paged or dense.

    ``submit()`` may be called from any thread; ``step()``/``drain()`` run
    the decode plane.  All bookkeeping is guarded by one lock; model math
    runs outside it.
    """

    def __init__(
        self,
        model,
        cfg: ServerConfig,
        *,
        executor: Optional[Executor] = None,
        kv: Optional[PagedKVAllocator] = None,
        admission: Optional[AdmissionController] = None,
        telemetry: Optional[TelemetrySink] = None,
        pool: Optional[SandboxPool] = None,
        scheduler: Optional[ServerlessScheduler] = None,
        postprocess_tenant: str = "serving",
        mesh=None,
    ) -> None:
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self._exec = executor or ThreadExecutor()
        self.telemetry = resolve_sink(admission, telemetry)
        self.admission = admission or AdmissionController(sink=self.telemetry)
        self.pool = pool
        self.scheduler = scheduler
        self._post_tenant = postprocess_tenant
        self.kv = kv if kv is not None else self._build_kv(model, cfg)
        self._lock = threading.RLock()
        self._chunked = cfg.prefill_chunk_tokens > 0
        if self._chunked and not cfg.incremental:
            raise ValueError(
                "prefill_chunk_tokens requires incremental=True (the "
                "rebatching baseline re-prefills whole dense batches)"
            )

        B = cfg.max_batch
        self._slots: List[Optional[Request]] = [None] * B
        #: per-tenant admit queues, each ordered by (priority,
        #: deadline-or-inf, arrival seq); the sweep admits the global
        #: minimum across unthrottled tenants
        self._queues: Dict[str, List[Tuple[int, float, int, Request]]] = {}
        #: queued deadline-bearing requests by absolute deadline
        self._deadlines: List[Tuple[float, int, Request]] = []
        self._live_ids: set = set()        # queued or slotted request ids
        self._seq = itertools.count()
        #: (task_id, request) pairs awaiting the concurrent postprocess join
        self._post_tasks: Deque[Tuple[int, Request]] = deque()
        self.completed: List[Request] = []
        self._trace: Deque[str] = deque(maxlen=cfg.trace_limit or None)

        self.kv_mode = self._resolve_kv_mode(model, cfg, mesh)
        self.mesh = mesh if (
            self.kv_mode == "paged" and self._tp_fits(model, mesh)
        ) else None
        self.tp_shards = self.mesh.size if self.mesh is not None else 1
        self.kv.tp_shards = self.tp_shards
        if mesh is not None and self.mesh is None:
            # mesh requested but unusable: dense mode runs on one device,
            # paged mode (explicit, non-dividing model) runs unsharded —
            # traced, as the reference traces the fallback
            self._trace.append(
                f"{self._exec.now():.6f} tp_fallback kv_mode={self.kv_mode}"
            )
        #: the model's paged interface: the model itself, or its shards on
        #: the mesh's workers (which hold the weights' and every page's
        #: head slices; the engine sends them host inputs only)
        self._paged = model
        self._input_device = self.device
        if self.kv_mode == "paged":
            if self.kv.pool_pages is None:
                raise ValueError(
                    "kv_mode='paged' needs a PagedKVAllocator with a "
                    "bounded pool (pool_pages) to size the device pages"
                )
            if self.mesh is not None:
                self._paged = self.mesh.bind(model)
                self._input_device = torch.device("cpu")
            # the arena *is* the backing store: the physical page tensors
            # are bound to the allocator and every prefill/decode updates
            # them in place, addressed by kv's page tables (under a mesh
            # the store is a handle to the workers' pool shards)
            self.kv.bind_store(self._paged.init_paged_state(
                self.kv.pool_pages, self.kv.tokens_per_page))
            self._state = None
            self._sharing = (
                cfg.prefix_sharing
                and hasattr(model, "paged_prefill_at")
                and hasattr(model, "paged_copy_page")
            )
            if self._chunked and not hasattr(model, "paged_prefill_at"):
                raise ValueError(
                    "prefill_chunk_tokens (paged) needs a model exposing "
                    "paged_prefill_at — later chunks attend through the "
                    "rows earlier chunks scattered"
                )
        else:
            self._sharing = False
            if self._chunked and not hasattr(model, "prefill_chunk"):
                raise ValueError(
                    "prefill_chunk_tokens (dense) needs a model exposing "
                    "prefill_chunk — later chunks continue the carry "
                    "earlier chunks built"
                )
            # decode state lives per slot: one persistent batch state whose
            # slot i is overwritten on admission (rebatching: replaced)
            self._state = model.init_decode_state(B, cfg.max_seq)
            self._batch_axes = self._find_batch_axes(model, cfg.max_seq)

        # counters (the reference's register_serving reads these)
        self._admitted: Dict[str, int] = {}
        self._denied: Dict[str, int] = {}
        self._expired: Dict[str, int] = {}
        self._completed_n: Dict[str, int] = {}
        self._tokens_n: Dict[str, int] = {}
        self._decode_steps = 0
        self._prefills = {"incremental": 0, "full": 0}
        self._prefill_tokens = {"incremental": 0, "full": 0}
        self._prefills_by_request: Dict[int, int] = {}
        self._batch_kills = 0
        self._arena_poisons = 0
        self._evictions = 0
        self._resumes = 0
        self._prefill_chunks = 0
        #: PREFILLING sequences: seq_id -> consumed-stream tokens made
        #: resident so far (the last chunk boundary).  An entry exists
        #: exactly while a sequence's prefill is incomplete — slotted, or
        #: evicted with its pages kept (paged batch kill), where it marks
        #: the point the resumed prefill continues from
        self._chunk_progress: Dict[str, int] = {}
        #: dense chunked prefill only: seq_id -> the batch-of-one carry
        #: state built so far, allocated at the sequence's first chunk and
        #: written in place by the later ones.  Held outside the batch
        #: state until the last chunk installs it, so intervening decode
        #: steps (which run the whole batch) cannot corrupt a half-built
        #: slot
        self._chunk_carry: Dict[str, Any] = {}
        #: executor timestamp of each live request's latest sampled token
        self._last_tok_t: Dict[int, float] = {}
        self._sampled = {"greedy": 0, "temperature": 0, "topk": 0, "topp": 0}
        self._prefix_hits = 0
        self._prefix_tokens_saved = 0
        #: parked prefix donors (renamed retired sequences), FIFO
        self._parked: Deque[str] = deque()
        self._park_seq = itertools.count()
        #: set by evacuate(): the engine is inert
        self.dead = False

    # ------------------------------------------------------------- helpers

    @staticmethod
    def _tp_fits(model, mesh) -> bool:
        """Whether the model can tensor-parallel over this mesh: the TP
        spec interface *and* exact divisibility (uneven head counts must
        not silently mis-slice)."""
        if mesh is None:
            return False
        return (
            hasattr(model, "tp_supported")
            and hasattr(model, "tp_param_specs")
            and hasattr(model, "tp_pool_specs")
            and bool(model.tp_supported(mesh.size))
        )

    @staticmethod
    def _resolve_kv_mode(model, cfg: ServerConfig, mesh=None) -> str:
        supports = bool(getattr(model, "supports_paged_decode", False))
        if cfg.kv_mode == "auto":
            if mesh is not None and supports and cfg.incremental \
                    and not ServingEngine._tp_fits(model, mesh):
                # a mesh was requested but the model's heads don't divide
                # it: fall back to dense serving rather than mis-sharding
                # the page pool
                return "dense"
            return "paged" if (supports and cfg.incremental) else "dense"
        if cfg.kv_mode == "paged":
            if not supports:
                raise ValueError(
                    f"kv_mode='paged' but {type(model).__name__} does not "
                    "support paged decode (no paged interface, or it uses "
                    "logit softcap / sliding windows)"
                )
            if not cfg.incremental:
                raise ValueError(
                    "kv_mode='paged' requires incremental=True (the "
                    "rebatching baseline re-prefills dense batches)"
                )
            return "paged"
        if cfg.kv_mode == "dense":
            return "dense"
        raise ValueError(f"unknown kv_mode {cfg.kv_mode!r}")

    @staticmethod
    def _find_batch_axes(model, max_seq: int) -> Dict[str, int]:
        """Per-leaf batch axis of the decode state, generic across models:
        the axis whose extent tracks ``batch_size``, found by diffing the
        shapes at batch 2 and 1 on the meta device (no memory)."""
        two = model.init_decode_state(2, max_seq, device="meta")
        one = model.init_decode_state(1, max_seq, device="meta")
        axes = {}
        for name, a in two.items():
            diff = [i for i, (x, y) in enumerate(zip(a.shape, one[name].shape))
                    if x != y]
            if not diff:
                raise ValueError(
                    f"decode-state leaf {name!r} has no batch axis: "
                    f"{tuple(a.shape)}")
            axes[name] = diff[0]
        return axes

    def _write_slot(self, sub: Dict[str, torch.Tensor], slot: int) -> None:
        """Write a one-sequence state into slot ``slot`` of the batch state,
        in place (the reference donated the state), cast to each leaf's
        dtype."""
        for name, dst in self._state.items():
            dst.narrow(self._batch_axes[name], slot, 1).copy_(
                sub[name].to(dst.dtype))

    @staticmethod
    def _build_kv(model, cfg: ServerConfig) -> PagedKVAllocator:
        mm_cfg = (MMConfig.legacy if cfg.mm_legacy else MMConfig.modern)(
            granule=4096
        )
        mcfg = getattr(model, "cfg", None)
        token_bytes = (
            2 * mcfg.num_kv_heads * mcfg.hd * 2 if mcfg is not None else 1
        )  # K+V bf16
        seq_pages = -(-cfg.max_seq // cfg.tokens_per_page)
        return PagedKVAllocator(
            mm_cfg, tokens_per_page=cfg.tokens_per_page,
            token_bytes=max(token_bytes, 1),
            max_seq_pages=seq_pages,
            pool_pages=cfg.kv_pool_pages or 4 * cfg.max_batch * seq_pages,
        )

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self._input_device)

    def _note(self, event: str, r: Optional[Request], detail: str = "") -> None:
        rid = r.request_id if r is not None else "-"
        tenant = r.tenant if r is not None else "-"
        self._trace.append(
            f"{self._exec.now():.6f} {event} req={rid} tenant={tenant}"
            + (f" {detail}" if detail else "")
        )

    def trace(self) -> List[str]:
        """Engine decisions in order; deterministic under SimExecutor."""
        with self._lock:
            return list(self._trace)

    def trace_text(self) -> str:
        return "\n".join(self.trace()) + "\n"

    def quota(self, tenant: str) -> TenantQuota:
        if self.cfg.quotas is None:
            # no quota config = no caps: every tenant may fill the batch
            return TenantQuota(max_tasks_in_flight=self.cfg.max_batch)
        return self.cfg.quotas.get(tenant, TenantQuota())

    def _seq_id(self, r: Request) -> str:
        return f"req{r.request_id}"

    def _enqueue_locked(self, r: Request) -> None:
        deadline_at = (
            r.arrived_at + r.deadline_s
            if r.deadline_s is not None else float("inf")
        )
        seq = next(self._seq)
        heapq.heappush(
            self._queues.setdefault(r.tenant, []),
            (r.priority, deadline_at, seq, r),
        )
        if r.deadline_s is not None and r.admitted_at is None:
            heapq.heappush(self._deadlines, (deadline_at, seq, r))

    def _deny_locked(self, r: Request, why: str) -> None:
        r.error = f"admission denied: {why}"
        self._denied[r.tenant] = self._denied.get(r.tenant, 0) + 1
        self._note("deny", r)
        # this request never owned its id: releasing it would strip the
        # guard entry of a live request with the same id
        self._finish_locked(r, release_id=False)
        self.telemetry.emit(
            "serving", "denied", tenant=r.tenant, detail=r.error,
        )

    # -------------------------------------------------------------- submit

    def submit(self, r: Request) -> int:
        """Queue a request for admission; returns its request id.

        Denied on the spot when the tenant's quota allows zero slots, the
        prompt is empty, the request can never fit, or its id is live.
        """
        with self._lock:
            if r.arrived_at is None:
                r.arrived_at = self._exec.now()
            if self.quota(r.tenant).max_tasks_in_flight <= 0:
                self._deny_locked(r, f"tenant {r.tenant!r} has no slots")
                return r.request_id
            if len(r.prompt) == 0:
                self._deny_locked(r, "empty prompt")
                return r.request_id
            if len(r.prompt) + r.max_new_tokens > self.cfg.max_seq:
                self._deny_locked(
                    r,
                    f"prompt+max_new_tokens "
                    f"({len(r.prompt)}+{r.max_new_tokens}) exceeds "
                    f"max_seq={self.cfg.max_seq}",
                )
                return r.request_id
            if r.request_id in self._live_ids:
                self._deny_locked(
                    r, f"request_id {r.request_id} is already live"
                )
                return r.request_id
            self._live_ids.add(r.request_id)
            self._enqueue_locked(r)
            self._note("submit", r)
        self._exec.notify()
        return r.request_id

    # --------------------------------------------------------------- admit

    def _active_by_tenant_locked(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self._slots:
            if r is not None:
                out[r.tenant] = out.get(r.tenant, 0) + 1
        return out

    def _expire_due_locked(self, now: float) -> None:
        """Complete-with-error every queued request whose admit deadline
        passed (stale entries of admitted requests are skipped)."""
        while self._deadlines and self._deadlines[0][0] < now:
            _, _, r = heapq.heappop(self._deadlines)
            if r.done or r.admitted_at is not None:
                continue
            r.error = f"deadline {r.deadline_s}s passed before admission"
            self._expired[r.tenant] = self._expired.get(r.tenant, 0) + 1
            self._note("expire", r)
            self._finish_locked(r)
            self.telemetry.count("serving.expired")

    def _clean_head_locked(
        self, tenant: str
    ) -> Optional[Tuple[int, float, int, Request]]:
        heap = self._queues.get(tenant)
        while heap:
            _, _, _, r = heap[0]
            if r.done:
                heapq.heappop(heap)        # expired
                continue
            return heap[0]
        return None

    def _admit_locked(self) -> List[Tuple[int, Request, bool, int]]:
        """Fill free slots from the queues; returns [(slot, request,
        needs_prefill, shared_prefix_tokens)] admitted.

        Each round admits the globally-best head — (priority, deadline,
        arrival) order — among tenants below their slot cap.  In paged mode
        a batch-killed request's pages survive its eviction, so its
        re-admission is a resume: no prefill, or the chunk pump continues
        from its last boundary.  With prefix sharing on, a fresh prompt
        whose prefix is already resident maps those pages read-only and
        prefills only the suffix.
        """
        admitted: List[Tuple[int, Request, bool, int]] = []
        active = self._active_by_tenant_locked()
        now = self._exec.now()
        self._expire_due_locked(now)
        while None in self._slots:
            best: Optional[Tuple[int, float, int, Request]] = None
            for tenant in sorted(self._queues):
                head = self._clean_head_locked(tenant)
                if head is None:
                    continue
                if active.get(tenant, 0) >= self.quota(tenant).max_tasks_in_flight:
                    continue               # throttled, not denied
                if best is None or head < best:
                    best = head
            if best is None:
                break
            r = best[3]
            heapq.heappop(self._queues[r.tenant])
            slot = self._slots.index(None)
            self._slots[slot] = r
            if r.admitted_at is None:
                r.admitted_at = now
                self.telemetry.observe(
                    "serving.admit_wait_seconds", now - r.arrived_at,
                    tenant=r.tenant,
                )
            active[r.tenant] = active.get(r.tenant, 0) + 1
            seq_id = self._seq_id(r)
            resume = self.kv_mode == "paged" and self.kv.has_sequence(seq_id)
            start = 0
            with self.telemetry.span("arena.admit", f"req={r.request_id}"):
                if resume:
                    if seq_id not in self._chunk_progress:
                        # pages survived the eviction: re-entry is a table
                        # edit (mid-prefill, the chunk pump continues)
                        self.kv.ensure_tokens(
                            seq_id, len(r.prompt) + len(r.tokens)
                        )
                    self._resumes += 1
                else:
                    self.kv.add_sequence(seq_id)
                    total = len(r.prompt) + len(r.tokens)
                    if self._sharing:
                        donor, match = self.kv.lookup_prefix(r.prompt)
                        # share whole pages covering the matched prompt
                        # prefix, but always prefill at least one token,
                        # and only bother for a full page
                        match = min(match, len(r.prompt), total - 1)
                        if donor is not None and \
                                match >= self.kv.tokens_per_page:
                            self.kv.share_prefix(seq_id, donor, match)
                            start = match
                            self._prefix_hits += 1
                            self._prefix_tokens_saved += match
                            self._note(
                                "prefix_share", r,
                                f"donor={donor} tokens={match}"
                            )
                    if self._chunked:
                        # PREFILLING: the pump allocates pages chunk by
                        # chunk, so a partial sequence holds exactly its
                        # scattered rows
                        self._chunk_progress[seq_id] = start
                    else:
                        self.kv.append_tokens(seq_id, total - start)
            self.admission.slot_acquired(r.tenant)
            self._admitted[r.tenant] = self._admitted.get(r.tenant, 0) + 1
            self._note("admit", r,
                       f"slot={slot}" + (" resume" if resume else ""))
            admitted.append((slot, r, not resume, start))
        return admitted

    # ------------------------------------------------------------- prefill

    def _sequence_tokens(self, r: Request) -> np.ndarray:
        """The token stream the model has *consumed* for this request.

        Decode feeds ``tokens[-1]`` (or ``prompt[-1]`` on the first step),
        so after k generated tokens the consumed stream is
        ``prompt + [prompt[-1]] + tokens[:k-1]``.
        """
        if r.tokens:
            seq = list(r.prompt) + [int(r.prompt[-1])] + r.tokens[:-1]
        else:
            seq = list(r.prompt)
        return np.asarray(seq, np.int32)

    def _bucketed_table(self, seq_ids) -> np.ndarray:
        """Page table padded with -1 to the next power-of-two width, as the
        reference buckets it for its jit cache."""
        table = self.kv.page_table(seq_ids=seq_ids)
        w = max(table.shape[1], 1)
        bucket = 1 << (w - 1).bit_length()
        if bucket > table.shape[1]:
            table = np.pad(
                table, ((0, 0), (0, bucket - table.shape[1])),
                constant_values=-1,
            )
        return table

    def _prefill_slot(self, slot: int, r: Request, start: int = 0) -> None:
        """Dense mode: prefill exactly this request and write its state
        into its slot; live slots are untouched."""
        with self._lock:
            if self._slots[slot] is not r:
                return                     # evicted before the prefill ran
            seq = self._sequence_tokens(r)
        span = self.telemetry.span
        with span("model.prefill", f"req={r.request_id}"):
            sub, _ = self.model.prefill(self._tensor(seq[None, :]),
                                        max_seq=self.cfg.max_seq)
            sub["pos"] = torch.full_like(sub["pos"], len(seq))
        with self._lock:
            if self._slots[slot] is not r:
                return                     # evicted mid-prefill: discard
            self._prefills["incremental"] += 1
            self._prefill_tokens["incremental"] += int(seq.size)
            self._prefills_by_request[r.request_id] = (
                self._prefills_by_request.get(r.request_id, 0) + 1
            )
            self._note("prefill", r, f"slot={slot} tokens={seq.size}")
        with span("model.write_slot", f"req={r.request_id}"):
            self._write_slot(sub, slot)

    def _cow_locked(self, seq_id: str, logical: int) -> None:
        """Copy-on-write one logical page if another sequence maps it."""
        if self.kv.page_writable(seq_id, logical):
            return
        src, dst = self.kv.cow_page(seq_id, logical)
        self.kv.swap_store(self._paged.paged_copy_page(self.kv.store, src, dst))
        self._note("cow", None, f"seq={seq_id} page {src}->{dst}")

    def _prefill_slot_paged(self, slot: int, r: Request,
                            start: int = 0) -> None:
        """Prefill this request's K/V rows straight into its arena pages.

        With ``start`` > 0 the first ``start`` positions are shared donor
        pages: only the suffix runs through the model (attending through
        the resident prefix rows), any shared page in the write range is
        COW'd, and the scatter lands on the suffix positions.
        """
        span = self.telemetry.span
        req = f"req={r.request_id}"
        with self._lock:
            if self._slots[slot] is not r:
                return                     # evicted before the prefill ran
            seq = self._sequence_tokens(r)
            seq_id = self._seq_id(r)
            if start:
                with span("arena.write_plan", req):
                    table = self._bucketed_table([seq_id])
        if start:
            with span("model.prefill_at", req):
                rows, _ = self._paged.paged_prefill_at(
                    self._tensor(seq[None, start:]), self.kv.store,
                    self._tensor(table), start,
                )
        else:
            with span("model.prefill", req):
                rows, _ = self._paged.paged_prefill(
                    self._tensor(seq[None, :]))
        with self._lock:
            if self._slots[slot] is not r:
                return                     # evicted mid-prefill: discard
            self._prefills["incremental"] += 1
            self._prefill_tokens["incremental"] += int(seq.size - start)
            self._prefills_by_request[r.request_id] = (
                self._prefills_by_request.get(r.request_id, 0) + 1
            )
            self._note(
                "prefill", r,
                f"slot={slot} tokens={seq.size - start}"
                + (f" shared={start}" if start else ""),
            )
            page = self.kv.tokens_per_page
            with span("arena.write_plan", req):
                for lp in range(start // page, -(-seq.size // page)):
                    # a divergent write into the trailing shared (partial)
                    # page triggers COW before the scatter lands
                    self._cow_locked(seq_id, lp)
                page_ids, offsets = self.kv.token_positions(
                    seq_id, start, seq.size - start
                )
            with span("model.write_prefill", req):
                self.kv.swap_store(self._paged.paged_write_prefill(
                    self.kv.store, rows, page_ids, offsets,
                ))
            if self._sharing:
                # rows are resident now: this prompt can donate
                with span("arena.write_plan", req):
                    self.kv.register_prefix(seq_id, r.prompt)

    # ----------------------------------------------------- chunked prefill

    def _pump_prefill_chunks(self) -> bool:
        """Advance PREFILLING slots by at most one token budget, in total,
        shared across them in slot order; returns whether a chunk ran."""
        budget = self.cfg.prefill_chunk_tokens
        with self._lock:
            pending = [
                (i, r, self._chunk_progress[self._seq_id(r)])
                for i, r in enumerate(self._slots)
                if r is not None and self._seq_id(r) in self._chunk_progress
            ]
        chunk_fn = (
            self._prefill_chunk_paged if self.kv_mode == "paged"
            else self._prefill_chunk_dense
        )
        worked = False
        for slot, r, p in pending:
            if budget <= 0:
                break
            n = min(budget, len(r.prompt) + len(r.tokens) - p)
            if n <= 0:
                continue
            with self.telemetry.span("engine.prefill", f"req={r.request_id}"):
                chunk_fn(slot, r, p, n)
            budget -= n
            worked = True
        return worked

    def _prefill_chunk_paged(self, slot: int, r: Request,
                             p: int, n: int) -> None:
        """One paged chunk: scatter consumed-stream rows [p, p+n) into the
        sequence's arena pages, allocated chunk by chunk.  Chunks after the
        first (and any chunk of a shared-prefix admission) attend through
        the resident rows via ``paged_prefill_at``; the progress entry,
        kept across page-preserving evictions, marks where a resumed
        prefill continues."""
        span = self.telemetry.span
        req = f"req={r.request_id}"
        with self._lock:
            if self._slots[slot] is not r:
                return                     # evicted before the chunk ran
            seq = self._sequence_tokens(r)
            seq_id = self._seq_id(r)
            with span("arena.write_plan", req):
                self.kv.ensure_tokens(seq_id, p + n)
                if p:
                    table = self._bucketed_table([seq_id])
        if p:
            with span("model.prefill_at", req):
                rows, _ = self._paged.paged_prefill_at(
                    self._tensor(seq[None, p:p + n]), self.kv.store,
                    self._tensor(table), p,
                )
        else:
            with span("model.prefill", req):
                rows, _ = self._paged.paged_prefill(
                    self._tensor(seq[None, :n]))
        with self._lock:
            if self._slots[slot] is not r:
                return                     # evicted mid-chunk: discard
            self._prefill_chunks += 1
            self._prefills["incremental"] += 1
            self._prefill_tokens["incremental"] += n
            self._prefills_by_request[r.request_id] = (
                self._prefills_by_request.get(r.request_id, 0) + 1
            )
            self._note("prefill_chunk", r, f"slot={slot} tokens={n} at={p}")
            page = self.kv.tokens_per_page
            with span("arena.write_plan", req):
                for lp in range(p // page, -(-(p + n) // page)):
                    # a write into a shared page (the trailing partial
                    # page of a shared prefix) triggers COW before the
                    # scatter
                    self._cow_locked(seq_id, lp)
                page_ids, offsets = self.kv.token_positions(seq_id, p, n)
            with span("model.write_prefill", req):
                self.kv.swap_store(self._paged.paged_write_prefill(
                    self.kv.store, rows, page_ids, offsets,
                ))
            if p + n >= seq.size:
                # fully resident: the slot joins the decode batch
                del self._chunk_progress[seq_id]
                if self._sharing:
                    with span("arena.write_plan", req):
                        self.kv.register_prefix(seq_id, r.prompt)
            else:
                self._chunk_progress[seq_id] = p + n

    def _prefill_chunk_dense(self, slot: int, r: Request,
                             p: int, n: int) -> None:
        """One dense chunk: fold consumed-stream rows [p, p+n) into the
        sequence's carry, which the last chunk installs into its slot with
        ``_write_slot``.  The carry is allocated once, at the sequence's
        first chunk (``model.prefill_chunk`` restarts at ``start == 0``)."""
        with self._lock:
            if self._slots[slot] is not r:
                return                     # evicted before the chunk ran
            seq = self._sequence_tokens(r)
            seq_id = self._seq_id(r)
            carry = self._chunk_carry.get(seq_id)
        span = self.telemetry.span
        req = f"req={r.request_id}"
        with span("model.prefill_chunk", req):
            if carry is None:
                carry = self.model.init_decode_state(1, self.cfg.max_seq)
            carry, _ = self.model.prefill_chunk(
                self._tensor(seq[None, p:p + n]), carry, p)
        with self._lock:
            if self._slots[slot] is not r:
                return                     # evicted mid-chunk: discard
            with span("arena.write_plan", req):
                self.kv.ensure_tokens(seq_id, p + n)
            self._prefill_chunks += 1
            self._prefills["incremental"] += 1
            self._prefill_tokens["incremental"] += n
            self._prefills_by_request[r.request_id] = (
                self._prefills_by_request.get(r.request_id, 0) + 1
            )
            self._note("prefill_chunk", r, f"slot={slot} tokens={n} at={p}")
            if p + n >= seq.size:
                del self._chunk_progress[seq_id]
                self._chunk_carry.pop(seq_id, None)
                done = True
            else:
                self._chunk_progress[seq_id] = p + n
                self._chunk_carry[seq_id] = carry
                done = False
        if done:
            with span("model.write_slot", req):
                self._write_slot(carry, slot)

    def _prefill_full(self) -> None:
        """Rebatching baseline: re-prefill every live slot as one
        zero-padded (B, S) batch and replace the batch state."""
        with self._lock:
            live = [
                (i, r) for i, r in enumerate(self._slots) if r is not None
            ]
            seqs = {i: self._sequence_tokens(r) for i, r in live}
        if not live:
            return
        B = self.cfg.max_batch
        S = max(max(s.size for s in seqs.values()), 1)
        toks = np.zeros((B, S), np.int32)
        lens = np.zeros((B,), np.int32)
        for i, _ in live:
            toks[i, : seqs[i].size] = seqs[i][:S]
            lens[i] = seqs[i].size
        with self.telemetry.span("model.prefill",
                                 f"step={self._decode_steps}"):
            state, _ = self.model.prefill(self._tensor(toks),
                                          max_seq=self.cfg.max_seq)
            state["pos"] = self._tensor(lens)
        self._state = state
        with self._lock:
            self._prefills["full"] += 1
            self._prefill_tokens["full"] += int(B * S)
            for i, r in live:
                if self._slots[i] is r:    # skip slots evicted mid-prefill
                    self._prefills_by_request[r.request_id] = (
                        self._prefills_by_request.get(r.request_id, 0) + 1
                    )
            self._note("prefill_full", None, f"live={len(live)} tokens={B*S}")

    # ---------------------------------------------------------------- step

    def step(self) -> int:
        """One engine tick: validate arena, admit, decode once, retire.

        Returns the number of requests retired this tick.  The tick is
        the ``engine.step`` span; inside it, ``engine.admit`` and one
        ``engine.prefill`` a prefill, chunk or rebatch group the leaves,
        and the leaves never nest: ``arena.*`` (the KV allocator's host
        work), ``model.*`` (each call into the model with the upload of
        its host arrays), ``engine.logits`` (the host waiting for the
        logits) and ``sampler``.  ``engine.step`` less the leaves is the
        engine's own host work.
        """
        with self.telemetry.span("engine.step",
                                 f"step={self._decode_steps}"):
            return self._step()

    def _step(self) -> int:
        if self.dead:
            return 0
        span = self.telemetry.span
        at = f"step={self._decode_steps}"
        self._evict_poisoned()
        with span("engine.admit", at), self._lock:
            admitted = self._admit_locked()
        paged = self.kv_mode == "paged"
        if self._chunked:
            # the pump runs every tick: a prompt larger than one budget
            # finishes over several steps
            if self._pump_prefill_chunks():
                with span("arena.vma_sample", at):
                    self.kv.arena.mm.host_vma_count()
        elif admitted:
            if self.cfg.incremental:
                prefill = (self._prefill_slot_paged if paged
                           else self._prefill_slot)
                for slot, r, need, start in admitted:
                    if need:
                        with span("engine.prefill", f"req={r.request_id}"):
                            prefill(slot, r, start)
            else:
                with span("engine.prefill", at):
                    self._prefill_full()
            # sample arena occupancy while sequences are live
            with span("arena.vma_sample", at):
                self.kv.arena.mm.host_vma_count()
        with self._lock:
            # PREFILLING slots join the decode batch only once their
            # prompt is fully resident
            live = [
                (i, r) for i, r in enumerate(self._slots)
                if r is not None and self._seq_id(r) not in self._chunk_progress
            ]
            if live and paged:
                # reserve this step's token row per live slot, then
                # snapshot the slot-ordered page table, its width bucketed
                # to the next power of two of the widest live sequence
                with span("arena.reserve", at):
                    pos = np.zeros((self.cfg.max_batch,), np.int32)
                    for i, r in live:
                        pos[i] = len(r.prompt) + len(r.tokens)
                        self.kv.ensure_tokens(self._seq_id(r),
                                              int(pos[i]) + 1)
                        if self._sharing:
                            # the append lands at pos: COW its page first
                            # if another sequence still maps it
                            self._cow_locked(
                                self._seq_id(r),
                                int(pos[i]) // self.kv.tokens_per_page,
                            )
                    # a PREFILLING slot maps to an all--1 table row like
                    # an empty one: its lane writes nothing
                    table = self._bucketed_table([
                        self._seq_id(r)
                        if r is not None
                        and self._seq_id(r) not in self._chunk_progress
                        else None
                        for r in self._slots
                    ])
        if not live:
            return 0

        last = np.zeros((self.cfg.max_batch,), np.int32)
        for i, r in live:
            last[i] = r.tokens[-1] if r.tokens else int(r.prompt[-1])
        with span("model.decode", at):
            if paged:
                store, logits = self._paged.paged_decode_step(
                    self.kv.store, self._tensor(last), self._tensor(table),
                    self._tensor(pos),
                )
                self.kv.swap_store(store)
            else:
                self._state, logits = self.model.decode_step(
                    self._state, self._tensor(last))
        with span("engine.logits", at):
            # bf16 -> fp32 -> float64 (in the sampler) is exact; integer
            # logits go to the sampler as they are
            if logits.is_floating_point():
                logits = logits.float()
            logits_np = logits.cpu().numpy()

        retiring: List[Request] = []
        now_t = self._exec.now()
        with self._lock:
            self._decode_steps += 1
            # draw every row's token first, then book them in row order:
            # the draws are pure, so the split changes no stream
            rows = [(i, r) for i, r in live if self._slots[i] is r]
            clock = time.perf_counter_ns
            reserve_ns = 0
            with span("sampler", at):
                drawn = [
                    sample_token(
                        logits_np[i],
                        temperature=r.temperature, top_k=r.top_k,
                        top_p=r.top_p, seed=r.seed, index=len(r.tokens),
                    )
                    for i, r in rows
                ]
            for (i, r), (tok, method) in zip(rows, drawn):
                self._sampled[method] += 1
                r.tokens.append(tok)
                if len(r.tokens) == 1:
                    # time-to-first-token from arrival: admit wait,
                    # queueing and the whole prefill are inside it
                    self.telemetry.observe(
                        "serving.ttft_seconds", now_t - r.arrived_at,
                        tenant=r.tenant,
                    )
                else:
                    prev = self._last_tok_t.get(r.request_id)
                    if prev is not None:
                        self.telemetry.observe(
                            "serving.intertoken_seconds", now_t - prev,
                            tenant=r.tenant,
                        )
                self._last_tok_t[r.request_id] = now_t
                t0 = clock()
                if paged:
                    # the row was reserved pre-step; make the count stick
                    self.kv.ensure_tokens(
                        self._seq_id(r), len(r.prompt) + len(r.tokens)
                    )
                else:
                    self.kv.append_tokens(self._seq_id(r), 1)
                reserve_ns += clock() - t0
                self._tokens_n[r.tenant] = self._tokens_n.get(r.tenant, 0) + 1
                if len(r.tokens) >= r.max_new_tokens:
                    # release the KV pages and the slot *before* any user
                    # post-code runs: a failing post-processor can never
                    # leak them, and the slot is immediately reusable
                    r.done = True
                    with span("arena.release", f"req={r.request_id}"):
                        if not self._park_locked(r):
                            self.kv.drop_sequence(self._seq_id(r))
                    self.admission.slot_released(r.tenant)
                    self._slots[i] = None
                    self._last_tok_t.pop(r.request_id, None)
                    self._note("retire", r, f"slot={i}")
                    retiring.append(r)
            # each row's count after its draw: timed a call at a time and
            # added once, too small to open a span each
            self.telemetry.add_span("arena.reserve", reserve_ns, len(rows))
        for r in retiring:
            # postprocess outside the engine lock: user code must never
            # gate submit(), metrics scrapes or the chaos hooks
            self._postprocess(r)
            with self._lock:
                self._finish_locked(r)
        if retiring:
            self._exec.notify()
        return len(retiring)

    def _park_locked(self, r: Request) -> bool:
        """Park a retiring request's sequence as a prefix-cache donor.

        Renamed to ``~pfxN`` so later prompts can share it; skipped when
        caching is off, the sequence is poisoned, its prompt never got
        indexed, or another donor already covers this prompt.
        """
        if not self._sharing or self.cfg.prefix_cache_seqs <= 0:
            return False
        seq_id = self._seq_id(r)
        if seq_id in self.kv.validate() or seq_id not in self.kv.prefix:
            return False
        donor, match = self.kv.lookup_prefix(r.prompt, exclude=(seq_id,))
        if donor is not None and match >= len(r.prompt) - 1:
            return False
        name = f"~pfx{next(self._park_seq)}"
        self.kv.rename_sequence(seq_id, name)
        self._parked.append(name)
        self._note("park", r, f"as={name}")
        while len(self._parked) > self.cfg.prefix_cache_seqs:
            old = self._parked.popleft()
            if self.kv.has_sequence(old):
                self.kv.drop_sequence(old)
        return True

    def flush_prefix_cache(self) -> int:
        """Drop every parked prefix donor; returns how many were freed."""
        with self._lock:
            n = 0
            while self._parked:
                name = self._parked.popleft()
                if self.kv.has_sequence(name):
                    self.kv.drop_sequence(name)
                    n += 1
            return n

    def _post_input(self, r: Request) -> torch.Tensor:
        """The token stream user post-code receives, on the engine's
        device."""
        return torch.tensor(r.tokens, dtype=torch.int32, device=self.device)

    def _postprocess(self, r: Request) -> None:
        """Dispatch or run the user post-processor for a retired request.

        A sandbox denial marks ``r.error`` (tenant isolation) instead of
        taking down the batch.
        """
        if r.postprocess is None:
            return
        if self.scheduler is not None:
            # concurrent plane: decode never blocks on user code;
            # results are joined in drain()
            self._post_tasks.append((
                self.scheduler.submit(TaskSpec(
                    self._post_tenant,
                    r.postprocess,
                    (self._post_input(r),),
                    name=f"post-req{r.request_id}",
                )),
                r,
            ))
        else:
            self._postprocess_inline(r)

    def _postprocess_inline(self, r: Request) -> None:
        if self.pool is None:
            try:
                out = r.postprocess(self._post_input(r))
                r.tokens = [int(t) for t in out.tolist()]
            except Exception as e:
                r.error = f"postprocess failed: {e}"
                self.telemetry.emit(
                    "serving", "postprocess_failed", tenant=r.tenant,
                    detail=r.error,
                )
            return
        sb = self.pool.checkout(self._post_tenant)
        discard = False
        try:
            out = sb.run(r.postprocess, self._post_input(r))
            r.tokens = [int(t) for t in out.value.tolist()]
        except Exception as e:
            # the serial plane isolates user post-code exactly like the
            # concurrent plane: the request carries the error, the
            # tainted sandbox is discarded, the engine keeps serving.
            # Sandbox.run re-raises arbitrary user exceptions, so this
            # must catch everything, not just SandboxViolation/Budget
            discard = True
            kind = (
                "denied"
                if isinstance(e, (SandboxViolation, BudgetExceeded))
                else "failed"
            )
            r.error = f"postprocess {kind}: {e}"
            self.telemetry.emit(
                "serving", "postprocess_failed", tenant=r.tenant,
                detail=r.error,
            )
        finally:
            self.pool.checkin(sb, discard=discard)

    def _finish_locked(self, r: Request, *, release_id: bool = True) -> None:
        r.done = True
        if release_id:
            self._live_ids.discard(r.request_id)
        arrived = (
            r.arrived_at if r.arrived_at is not None else self._exec.now()
        )
        r.latency_s = self._exec.now() - arrived
        self._completed_n[r.tenant] = self._completed_n.get(r.tenant, 0) + 1
        self.completed.append(r)
        if r.admitted_at is not None:
            self.telemetry.count("server.request")
            self.telemetry.observe(
                "server.request_seconds", r.latency_s, tenant=r.tenant,
            )

    # --------------------------------------------------------------- drain

    def has_work(self) -> bool:
        with self._lock:
            return any(self._queues.values()) or any(
                r is not None for r in self._slots
            )

    def drain(self, timeout: float = 300.0) -> List[Request]:
        """Run steps until queue and slots are empty; join postprocessors."""
        deadline = time.monotonic() + timeout
        while self.has_work():
            self.step()
            if self.cfg.step_time_s > 0:
                self._exec.sleep(self.cfg.step_time_s)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"drain: work remaining after {timeout}s wall time"
                )
        self._join_post_tasks()
        return self.completed

    def _join_post_tasks(self) -> None:
        if not self._post_tasks:
            return
        # join the concurrent postprocess plane: a denied/failed
        # post-processor marks its own request and never takes down
        # the batch (tenant isolation extends to user post-code)
        self.scheduler.drain()
        while self._post_tasks:
            task_id, r = self._post_tasks.popleft()
            rec = self.scheduler.record(task_id)
            if rec.state is TaskState.SUCCEEDED:
                r.tokens = [int(t) for t in rec.result.value.tolist()]
            else:
                r.error = f"postprocess {rec.state.value}: {rec.error}"
                self.telemetry.emit(
                    "serving", "postprocess_failed", tenant=r.tenant,
                    detail=r.error,
                )

    # --------------------------------------------------------------- chaos

    def _requeue_locked(self, slot: int, r: Request, why: str,
                        *, drop_pages: bool = True) -> None:
        """Evict a live sequence back to the admit queue; generated tokens
        survive, so the request resumes where it left off.  With
        ``drop_pages=False`` (paged batch kill) the sequence stays resident
        and re-admission is a page-table edit; otherwise its pages (and
        any partial chunked prefill) are released and re-admission
        prefills prompt+tokens from scratch."""
        if drop_pages:
            self.kv.drop_sequence(self._seq_id(r))
            self._chunk_progress.pop(self._seq_id(r), None)
            self._chunk_carry.pop(self._seq_id(r), None)
        self.admission.slot_released(r.tenant)
        self._slots[slot] = None
        self._evictions += 1
        self._enqueue_locked(r)
        self._note(f"evict:{why}", r, f"slot={slot}")
        self.telemetry.count(f"serving.evict_{why}")

    def kill_batch(self) -> int:
        """Chaos: the decode batch dies mid-flight.  Every live slot's
        request is requeued with its tokens intact; returns how many.
        Dense mode drops the KV pages (the state dies with the batch);
        paged mode keeps them, so the re-admitted sequence decodes on
        without a prefill."""
        with self._lock:
            live = [(i, r) for i, r in enumerate(self._slots) if r is not None]
            for i, r in live:
                self._requeue_locked(
                    i, r, "kill", drop_pages=self.kv_mode != "paged"
                )
            self._batch_kills += 1
            self._note("kill_batch", None, f"evicted={len(live)}")
        self.telemetry.count("serving.batch_kill")
        self._exec.notify()
        return len(live)

    def evacuate(self) -> List[Request]:
        """Tear this engine down: return every incomplete request, live
        slots first (slot order), then the queues ((priority, deadline,
        arrival) order), and drop every resident sequence, parked donors
        included.  After this the engine is inert (``step()`` returns 0)
        and the page ledger balances."""
        with self._lock:
            out: List[Request] = []
            for i, r in enumerate(self._slots):
                if r is None:
                    continue
                self.kv.drop_sequence(self._seq_id(r))
                self.admission.slot_released(r.tenant)
                self._slots[i] = None
                self._evictions += 1
                self._note("evict:evacuate", r, f"slot={i}")
                out.append(r)
            for tenant in sorted(self._queues):
                heap = self._queues[tenant]
                for _, _, _, r in sorted(heap):
                    if not r.done:
                        out.append(r)
                        self._note("evacuate_queued", r)
                heap.clear()
            self._deadlines.clear()
            self._parked.clear()
            self._chunk_progress.clear()
            self._chunk_carry.clear()
            self._last_tok_t.clear()
            for seq_id in self.kv.sequence_ids():
                if self.kv.has_sequence(seq_id):
                    self.kv.drop_sequence(seq_id)
            self._live_ids.clear()
            self.dead = True
        self._exec.notify()
        return out

    def poison_live(self, index: int = 0) -> Optional[str]:
        """Chaos: poison the ``index``-th live sequence's arena pages (live
        ids sorted); the next :meth:`step` evicts it."""
        with self._lock:
            live = sorted(
                self._seq_id(r) for r in self._slots if r is not None
            )
            if not live:
                return None
            victim = live[index % len(live)]
            self.kv.poison_sequence(victim)
            self._arena_poisons += 1
            self._trace.append(
                f"{self._exec.now():.6f} poison seq={victim}"
            )
        self.telemetry.count("serving.arena_poison")
        return victim

    def poison_shared(self, index: int = 0) -> Optional[str]:
        """Chaos: poison the ``index``-th sequence whose pages are shared
        (live slots and parked donors, sorted); the poison reaches every
        co-mapper, so the whole sharing clique evicts.  None when nothing
        is shared."""
        with self._lock:
            names = [
                self._seq_id(r) for r in self._slots if r is not None
            ] + [p for p in self._parked if self.kv.has_sequence(p)]
            shared = sorted(
                s for s in names if self.kv.sequence_shared(s)
            )
            if not shared:
                return None
            victim = shared[index % len(shared)]
            self.kv.poison_sequence(victim)
            self._arena_poisons += 1
            self._trace.append(
                f"{self._exec.now():.6f} poison_shared seq={victim}"
            )
        self.telemetry.count("serving.arena_poison")
        return victim

    def poison_prefilling(self, index: int = 0) -> Optional[str]:
        """Chaos: poison the ``index``-th mid-prefill sequence (sorted):
        its partial pages drop and the chunked prefill restarts from zero.
        None when nothing is mid-prefill."""
        with self._lock:
            prefilling = sorted(self._chunk_progress)
            if not prefilling:
                return None
            victim = prefilling[index % len(prefilling)]
            self.kv.poison_sequence(victim)
            self._arena_poisons += 1
            self._trace.append(
                f"{self._exec.now():.6f} poison_prefilling seq={victim}"
            )
        self.telemetry.count("serving.arena_poison")
        return victim

    def _evict_poisoned(self) -> None:
        """A poisoned arena sequence (``kv.poison_sequence``) is corrupt by
        definition: a slotted one is evicted and re-prefilled (its pages
        dropped, in paged mode too), and an evicted-but-resident or
        parked one is dropped."""
        with self._lock:
            bad = self.kv.validate()
            if not bad:
                return
            slotted = {
                self._seq_id(r) for r in self._slots if r is not None
            }
            for i, r in enumerate(self._slots):
                if r is not None and self._seq_id(r) in bad:
                    self._requeue_locked(i, r, "poison")
            for seq_id in bad:
                if seq_id not in slotted and self.kv.has_sequence(seq_id):
                    self.kv.drop_sequence(seq_id)
                    self._chunk_progress.pop(seq_id, None)
                    self._chunk_carry.pop(seq_id, None)
                    self._trace.append(
                        f"{self._exec.now():.6f} drop_resident seq={seq_id}"
                    )
        self._exec.notify()

    # --------------------------------------------------------------- stats

    def active_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._slots if r is not None)

    def _queue_depths_locked(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for tenant, heap in self._queues.items():
            n = sum(1 for (_, _, _, r) in heap if not r.done)
            if n:
                out[tenant] = n
        return out

    def queue_depth(self) -> int:
        with self._lock:
            return sum(self._queue_depths_locked().values())

    def serving_stats(self) -> Dict[str, Any]:
        """Snapshot with the reference's keys, and ``spans``."""
        with self._lock:
            return {
                "queue_depth": self._queue_depths_locked(),
                "active_slots": self._active_by_tenant_locked(),
                "admitted_total": dict(self._admitted),
                "denied_total": dict(self._denied),
                "expired_total": dict(self._expired),
                "completed_total": dict(self._completed_n),
                "tokens_total": dict(self._tokens_n),
                "decode_steps_total": self._decode_steps,
                "tp_shards": self.tp_shards,
                "prefill_sequences_total": dict(self._prefills),
                "prefill_tokens_total": dict(self._prefill_tokens),
                "batch_kill_total": self._batch_kills,
                "arena_poison_total": self._arena_poisons,
                "evicted_total": self._evictions,
                "kv_mode": self.kv_mode,
                "resumed_total": self._resumes,
                "prefill_chunks_total": self._prefill_chunks,
                "sampled_tokens_total": dict(self._sampled),
                "kv_pages_allocated_total": self.kv.pages_allocated,
                "kv_pages_freed_total": self.kv.pages_freed,
                "prefix_hits_total": self._prefix_hits,
                "prefix_shared_pages_total": self.kv.shared_pages_total,
                "prefix_cow_copies_total": self.kv.cow_copies_total,
                "prefix_prefill_tokens_saved_total": self._prefix_tokens_saved,
                # the port's own: host seconds by span, {name: [n, s]}
                "spans": self.telemetry.spans(),
            }

    def admit_wait_snapshot(self) -> Tuple[float, float]:
        """(count, sum) of ``serving.admit_wait_seconds`` across tenants.

        An autoscaler differentiates this between ticks to get the mean
        admit wait over its window; the histogram is fed from executor
        timestamps, so the snapshot is deterministic under sim.
        """
        n = 0.0
        s = 0.0
        for (name, _tenant), hist in self.telemetry.histograms().items():
            if name == "serving.admit_wait_seconds":
                n += hist.count
                s += hist.sum
        return (n, s)

    def prefill_counts(self) -> Dict[int, int]:
        """Times each request was prefilled (regression probe for tests)."""
        with self._lock:
            return dict(self._prefills_by_request)

    def reset_history(self) -> None:
        """Release per-request history (completed, trace, prefill counts)."""
        with self._lock:
            self.completed.clear()
            self._trace.clear()
            self._prefills_by_request.clear()

    def arena_report(self) -> Dict[str, Any]:
        return {
            "total_contiguous_runs": self.kv.total_runs(),
            "host_vmas": self.kv.arena.mm.host_vma_count(),
            "host_vma_high_water": self.kv.arena.mm.host_vma_high_water,
            "mm_stats": self.kv.arena.mm.stats(),
        }


class Server:
    """Production wrapper: pool + scheduler + metrics around the engine."""

    def __init__(self, model, cfg: ServerConfig,
                 sandbox: Optional[Sandbox] = None,
                 *,
                 pool: Optional[SandboxPool] = None,
                 admission: Optional[AdmissionController] = None,
                 telemetry: Optional[TelemetrySink] = None,
                 executor: Optional[Executor] = None):
        self.model = model
        self.cfg = cfg
        self.telemetry = resolve_sink(admission, telemetry)
        self.admission = admission or AdmissionController(sink=self.telemetry)
        # postprocess sandboxes come from a warm pool; an explicit sandbox
        # is adopted as the pool's first warm entry
        self.pool = pool or SandboxPool(
            admission=self.admission,
            telemetry=self.telemetry,
            refill_watermark=cfg.pool_watermark,
        )
        self.sandbox = sandbox
        if sandbox is not None:
            self._postprocess_tenant = sandbox.tenant
            self.pool.seed(sandbox)
        else:
            self._postprocess_tenant = "serving"
            self.pool.prewarm("serving", 1)
        if cfg.pool_watermark > 0:
            self.pool.set_watermark(self._postprocess_tenant, cfg.pool_watermark)
            self.pool.start_refiller()
        # concurrent postprocess plane: user post-processors dispatch to N
        # scheduler workers instead of running inline on the decode loop
        self.scheduler: Optional[ServerlessScheduler] = None
        if cfg.workers > 0:
            self.scheduler = ServerlessScheduler(
                quotas={
                    self._postprocess_tenant: TenantQuota(
                        max_tasks_in_flight=cfg.workers
                    )
                },
                admission=self.admission,
                pool=self.pool,
                workers=cfg.workers,
            ).start()
            if cfg.heartbeat_timeout_s > 0:
                # node-fault tolerance for user post-code: a worker hung
                # inside a post-processor is reaped, its request's task
                # requeued once, and a fresh worker keeps the plane full
                self.scheduler.enable_heartbeats(
                    cfg.heartbeat_timeout_s, replace_dead=True,
                )
                self.scheduler.start_heartbeat_watchdog(
                    interval_s=max(1e-3, cfg.heartbeat_timeout_s / 4),
                )
        self.engine = ServingEngine(
            model, cfg,
            executor=executor,
            admission=self.admission,
            telemetry=self.telemetry,
            pool=self.pool,
            scheduler=self.scheduler,
            postprocess_tenant=self._postprocess_tenant,
        )
        self.metrics = (
            MetricsRegistry()
            .register_sink(self.telemetry)
            .register_admission(self.admission)
            .register_pool(self.pool)
            .register_serving(self.engine)
        )
        if self.scheduler is not None:
            self.metrics.register_scheduler(self.scheduler)
        self._metrics_server: Optional[MetricsHTTPServer] = None
        self.metrics.register_arena(self.kv)   # §IV.A occupancy gauges

    # ------------------------------------------------------------- engine

    @property
    def kv(self) -> PagedKVAllocator:
        return self.engine.kv

    @property
    def completed(self) -> List[Request]:
        return self.engine.completed

    def submit(self, r: Request) -> int:
        return self.engine.submit(r)

    def step(self) -> int:
        return self.engine.step()

    def drain(self, timeout: float = 300.0) -> List[Request]:
        return self.engine.drain(timeout=timeout)

    def run(self, requests: List[Request]) -> List[Request]:
        """Process all requests to completion with continuous batching."""
        for r in requests:
            self.engine.submit(r)
        return self.engine.drain()

    # ------------------------------------------------------------ metrics

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1") -> MetricsHTTPServer:
        """Expose ``GET /metrics`` (Prometheus text format) over HTTP.

        Idempotent: returns the already-running endpoint if one exists.
        ``port=0`` binds an ephemeral port; read it from ``.port``.
        """
        if self._metrics_server is None:
            self._metrics_server = MetricsHTTPServer(
                self.metrics, port=port, host=host
            )
        return self._metrics_server

    def dump_metrics(self) -> Dict[str, Any]:
        """Snapshot of every exported sample (tests/tooling; no HTTP)."""
        return self.metrics.dump()

    def close(self) -> None:
        """Stop metrics, the postprocess workers and the pool refiller."""
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        if self.scheduler is not None:
            self.scheduler.shutdown()
        self.pool.stop_refiller()

    # ------------------------------------------------------------- report

    def admission_report(self) -> Dict[str, Any]:
        return {
            "admission": self.admission.stats(),
            "pool": self.pool.stats.as_dict(),
        }

    def arena_report(self) -> Dict[str, Any]:
        return self.engine.arena_report()
