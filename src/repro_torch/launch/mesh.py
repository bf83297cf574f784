"""Meshes: training meshes over the ``torch.distributed`` world, and serving
meshes of shard worker processes joined in one group.

The counterpart of ``repro/launch/mesh.py``.

**Training** is SPMD: every rank of the world runs the trainer, as JAX's
one program runs on every device.  :func:`make_host_mesh` lays the world
out as a ``(data, model)`` :class:`TrainMesh` (a 2-D ``DeviceMesh`` with
one process group per axis), and :func:`make_production_mesh` as the
reference's pod, ``(data=16, model=16)``, or two pods, ``(pod=2, data=16,
model=16)``, refusing any other world.  Under ``torchrun`` (a
``WORLD_SIZE`` in the environment and no group yet) the mesh starts the
group itself: NCCL where each rank has a GPU of its own, gloo otherwise
(NCCL refuses two ranks on one GPU).  With no group and no ``torchrun``
it is a 1 x 1 mesh of the one device, as the reference's mesh is built
from the devices it sees.  The mesh's collectives (``all_gather``,
``all_reduce``, ``reduce_scatter``, ``all_to_all``) are those the
training step and the MoE block run over one axis's group (``send`` and
``recv``, between two ranks, carry a checkpoint's shards); on a gloo
group a CUDA tensor goes through host memory, and the bytes it moves
there are counted in ``staged_bytes``.

**Serving**: the reference is single-controller: one process holds the engine, the
allocator, the sampler and the virtual clock, and ``shard_map`` sends only
the model's step to N devices.  Here a :class:`ServingMesh` is N **shard
worker processes** (started with ``spawn``, so no worker inherits a CUDA
context or a thread), joined in one process group with a one-dimensional
``DeviceMesh`` named ``("model",)`` on top.  The calling process stays the
controller: it sends each worker only a step's small host inputs and reads
the logits from rank 0.

Each worker holds, for every model bound to the mesh (:meth:`bind`), a
shard-local module built from the model's ``tp_local(n)`` (its heads, or
its ``d``, divided by ``n``) on ``meta``, whose weights are its slices of
the controller's by the model's ``tp_param_specs()``: views received as
CUDA IPC handles (shared memory on the host), so the card holds the
weights once.  It also holds its own slice of every physical page (the
pool is allocated in the worker, at the local head count: the controller
never holds it).  Every model call runs under
:func:`~repro_torch.parallel.collectives.bind_axis`, so the model body's
``maybe_psum`` after a row-sharded product sums over the group.  K1 and K2
run in the workers over local heads: on a CUDA member they launch the
kernels, which the controller builds before it starts the workers (two
workers building one library at once would race).

A worker that raises sends its traceback; the controller then ends every
worker of the mesh and raises :class:`MeshError`, as it does when a worker
dies.  ``close()`` ends the workers, and a mesh not closed is closed when
it is garbage or at exit, so no worker outlives its mesh.

Members are host slots ``cpu:0`` .. ``cpu:{n-1}`` (how many exist is set by
:func:`simulate_host_devices`, as the reference splits the host into XLA
devices) or CUDA devices listed explicitly, so that two ranks may share
``cuda:0``.  The backend is gloo on the CPU and wherever two ranks share a
device (NCCL refuses two ranks on one GPU); NCCL where every rank has its
own CUDA device.

"""

from __future__ import annotations

import datetime
import itertools
import math
import multiprocessing as mp
import os
import shutil
import sys
import tempfile
import threading
import traceback
import weakref
from multiprocessing.connection import wait
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..parallel.collectives import bind_axis
from ..parallel.sharding import AbstractMesh, gather_shards, serving_tp_shards

__all__ = ["MESH_AXES", "PRODUCTION_AXES", "SERVING_AXIS", "MeshError",
           "MeshModel", "ServingMesh", "TrainMesh", "host_devices",
           "make_host_mesh", "make_production_mesh", "make_serving_mesh",
           "simulate_host_devices"]

MESH_AXES = ("data", "model")

#: the multi-pod production mesh's axes (the pod is pure data parallelism)
PRODUCTION_AXES = ("pod", "data", "model")

#: the tensor-parallel axis sharded serving decodes over (1-D mesh)
SERVING_AXIS = "model"

#: how many host slots ``make_serving_mesh`` may hand out
HOST_DEVICES_ENV = "REPRO_TORCH_HOST_DEVICES"

#: seconds a collective may wait for its peers before it raises
COLLECTIVE_TIMEOUT_S = 120


# ------------------------------------------------------------ training


class TrainMesh(AbstractMesh):
    """A training mesh over the ``torch.distributed`` world: axis names and
    sizes (row-major over the ranks, as ``DeviceMesh`` lays them out),
    this rank's ``coords`` on each axis, its ``device``, and one process
    group per axis.  Every rank calls each collective, in the same order.
    """

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 device, *, owns_group: bool = False) -> None:
        import torch.distributed as dist

        super().__init__(axis_sizes, axis_names)
        self.device = torch.device(device)
        live = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if live else 1
        if world != self.size:
            raise ValueError(f"a {self.shape} mesh needs {self.size} ranks; "
                             f"the world has {world}")
        self.rank = dist.get_rank() if live else 0
        self.backend = dist.get_backend() if live else None
        self.coords: Dict[str, int] = dict(zip(self.axis_names, map(
            int, np.unravel_index(self.rank, tuple(self.shape.values())))))
        self.staged_bytes = 0
        self._owns_group = owns_group
        self._groups: Dict[str, Any] = {}
        self.device_mesh = None
        if self.size > 1:
            from torch.distributed.device_mesh import DeviceMesh

            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self.device_mesh = DeviceMesh(
                self.device.type,
                np.arange(world).reshape(tuple(self.shape.values())),
                mesh_dim_names=self.axis_names)
            self._groups = {a: self.device_mesh.get_group(a)
                            for a in self.axis_names}

    def __repr__(self) -> str:
        return (f"TrainMesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.device}, {self.backend})")

    def close(self) -> None:
        """Ends the process group if this mesh started it."""
        import torch.distributed as dist

        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False

    # --------------------------------------------------- collectives

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the group can take it: host memory for a CUDA
        tensor on gloo (counted)."""
        if self.backend == "gloo" and t.is_cuda:
            self.staged_bytes += t.numel() * t.element_size()
            return t.cpu()
        return t

    def _back(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if like.is_cuda and not t.is_cuda:
            self.staged_bytes += t.numel() * t.element_size()
            return t.to(like.device)
        return t

    def _group(self, axis: str):
        return self._groups[axis]

    def all_gather(self, t: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        """The chunks of ``axis``'s ranks joined along ``dim``, rank
        order."""
        import torch.distributed as dist

        n = self.shape[axis]
        if n == 1:
            return t
        x = self._out(t.contiguous())
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self._group(axis))
        return self._back(torch.cat(parts, dim=dim), t)

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str]
                   ) -> torch.Tensor:
        """The sum of ``t`` over the ranks of ``axes``, in a new tensor."""
        import torch.distributed as dist

        axes = [a for a in axes if self.shape.get(a, 1) > 1]
        if not axes:
            return t.clone()
        x = self._out(t)
        x = x.clone() if x is t else x
        x = x.contiguous()
        for a in axes:
            dist.all_reduce(x, group=self._group(a))
        return self._back(x, t)

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int
                       ) -> torch.Tensor:
        """The sum of ``t`` over ``axis``'s ranks, this rank's chunk of it
        along ``dim``."""
        import torch.distributed as dist

        n = self.shape[axis]
        if n == 1:
            return t
        x = self._out(t.movedim(dim, 0).contiguous())
        out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=self._group(axis))
        return self._back(out, t).movedim(0, dim)

    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """``jax.lax.all_to_all(tiled=True)``: ``t`` cut into ``n`` chunks
        along ``split_dim``, chunk j sent to rank j, and the chunks
        received joined along ``concat_dim`` in rank order."""
        import torch.distributed as dist

        n = self.shape[axis]
        if n == 1:
            return t
        x = self._out(t.movedim(split_dim, 0).contiguous())
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self._group(axis))
        out = torch.cat([b.movedim(0, split_dim) for b in out.chunk(n)],
                        dim=concat_dim)
        return self._back(out, t)

    def send(self, t: torch.Tensor, dst: int) -> None:
        """``t`` to rank ``dst``, which calls :meth:`recv`."""
        import torch.distributed as dist

        dist.send(self._out(t.contiguous()), dst)

    def recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        """A tensor of ``like``'s shape and dtype from rank ``src``; on gloo
        it stays in host memory."""
        import torch.distributed as dist

        dev = "cpu" if self.backend == "gloo" else like.device
        out = torch.empty(like.shape, dtype=like.dtype, device=dev)
        dist.recv(out, src)
        return out

    def barrier(self) -> None:
        import torch.distributed as dist

        if self.size > 1:
            dist.barrier()


def _train_device(device) -> torch.device:
    """This rank's device: for CUDA, its local rank's card (modulo the
    cards there are, so ranks may share one)."""
    from ..models.common import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def _join_world(dev: torch.device) -> bool:
    """Starts the process group from ``torchrun``'s environment if there is
    one and no group yet; True if it started it."""
    import torch.distributed as dist

    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ["WORLD_SIZE"]))
    own_cards = (dev.type == "cuda"
                 and local_world <= torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if own_cards else "gloo",
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return True


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_host_mesh(data: Optional[int] = None, model: int = 1, *,
                   device="cuda") -> TrainMesh:
    """A ``(data, model)`` mesh over the world (``data`` = world / model by
    default); 1 x 1 with no process group.  On ``device`` (CUDA unless
    the caller asks for the CPU; CUDA asked for and absent raises)."""
    dev = _train_device(device)
    world = _world_size()
    data = world // model if data is None else data
    if data < 1 or data * model != world:
        raise ValueError(f"a (data={data}, model={model}) mesh needs "
                         f"{data * model} ranks; the world has {world}")
    owns = _join_world(dev)
    return TrainMesh((data, model), MESH_AXES, dev, owns_group=owns)


def make_production_mesh(*, multi_pod: bool = False) -> TrainMesh:
    """The reference's production mesh: one pod ``(data=16, model=16)`` or
    two ``(pod=2, data=16, model=16)``, each rank on its card; any other
    world raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = PRODUCTION_AXES if multi_pod else MESH_AXES
    world = _world_size()
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs {math.prod(shape)} ranks; the world has "
                         f"{world}")
    dev = _train_device("cuda")
    owns = _join_world(dev)
    return TrainMesh(shape, axes, dev, owns_group=owns)


# ------------------------------------------------------------- serving


def simulate_host_devices(n: int = 4) -> None:
    """Make ``n`` host slots available to :func:`make_serving_mesh`.

    As the reference's (which splits the host CPU into XLA devices), a
    count set before is respected, so nested harnesses never fight over
    it.  Slots are labels: each member of a mesh is its own process.
    """
    os.environ.setdefault(HOST_DEVICES_ENV, str(n))


def host_devices() -> int:
    """How many host slots exist (1 unless :func:`simulate_host_devices`
    set another count)."""
    return int(os.environ.get(HOST_DEVICES_ENV, "1"))


def make_serving_mesh(devices=None, *, offset: int = 0) -> "ServingMesh":
    """1-D ``("model",)`` mesh for tensor-parallel serving.

    ``devices`` is a count of host slots, starting at ``offset`` (replicas
    carve disjoint sub-meshes out of the host: replica 0 on slots 0-1,
    replica 1 on 2-3, ...; None takes them all), or a list of devices
    (``["cuda:0", "cuda:0"]``: two ranks on one card).  The workers start
    at the mesh's first use.
    """
    if devices is None or isinstance(devices, int):
        avail = host_devices()
        n = devices if devices is not None else avail
        if n < 1:
            raise ValueError(f"serving mesh needs at least 1 device, got {n}")
        if offset + n > avail:
            raise ValueError(
                f"need devices [{offset}, {offset + n}) but only {avail} "
                "exist — call simulate_host_devices() before building the "
                "mesh")
        return ServingMesh([f"cpu:{i}" for i in range(offset, offset + n)])
    members = [_member(d) for d in devices]
    if not members:
        raise ValueError("serving mesh needs at least 1 device, got 0")
    if offset:
        raise ValueError("offset counts host slots; list the devices instead")
    return ServingMesh(members)


def _member(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda":
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise ValueError(f"no CUDA device {index}: "
                             f"{torch.cuda.device_count()} exist")
        return f"cuda:{index}"
    if dev.type == "cpu":
        return "cpu:0"
    raise ValueError(f"a serving mesh takes CPU or CUDA devices, got {dev}")


def _torch_device(member: str) -> torch.device:
    """A member's torch device (host slots are all the CPU)."""
    dev = torch.device(member)
    return torch.device("cpu") if dev.type == "cpu" else dev


class MeshError(RuntimeError):
    """A shard worker raised or died; the mesh is closed."""


class ServingMesh:
    """A serving mesh: its members, and their worker processes once
    started."""

    axis_names = (SERVING_AXIS,)

    def __init__(self, members: Sequence[str]) -> None:
        self.devices = tuple(members)
        self.size = len(self.devices)
        cuda = [m for m in self.devices if m.startswith("cuda")]
        self.backend = ("nccl" if len(cuda) == self.size
                        and len(set(cuda)) == self.size else "gloo")
        self._lock = threading.RLock()
        self._procs: List[Any] = []
        self._conns: List[Any] = []
        self._drops: List[int] = []
        self._state: Dict[str, Any] = {"dir": None}
        self.closed = False
        self._finalizer = weakref.finalize(
            self, _shutdown, self._procs, self._conns, self._state)

    def __repr__(self) -> str:
        state = ("closed" if self.closed else
                 "running" if self._procs else "not started")
        return (f"ServingMesh({list(self.devices)}, {self.backend}, "
                f"{state})")

    # ------------------------------------------------------ processes

    @property
    def processes(self) -> List[Any]:
        """The workers' ``multiprocessing.Process`` objects (rank order)."""
        return list(self._procs)

    def start(self) -> None:
        """Start the workers (a no-op once they run)."""
        with self._lock:
            if self.closed:
                raise MeshError(f"{self!r} is closed")
            if self._procs:
                return
            if any(m.startswith("cuda") for m in self.devices):
                # every worker loads the one kernel library: build it here,
                # once, before any of them can race to build it
                from ..kernels import _build
                _build.build()
            ctx = mp.get_context("spawn")
            tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
            self._state["dir"] = tmp
            init = f"file://{os.path.join(tmp, 'store')}"
            for rank, member in enumerate(self.devices):
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_worker_main, name=f"repro-torch-shard-{rank}",
                    args=(rank, self.size, member, init, self.backend, child),
                    daemon=True)
                proc.start()
                child.close()
                self._procs.append(proc)
                self._conns.append(parent)
            self._gather("start")

    def close(self) -> None:
        """End the workers (idempotent)."""
        with self._lock:
            self.closed = True
            self._finalizer()

    def _fail(self) -> None:
        self.closed = True
        self._finalizer.detach()
        _shutdown(self._procs, self._conns, self._state, graceful=False)

    # ------------------------------------------------------- commands

    def run(self, op: str, per_rank: Optional[List[tuple]] = None,
            *args) -> List[Any]:
        """Run worker op ``op`` on every rank (with ``per_rank[r]`` as rank
        r's arguments, or ``args`` on all) and return the ranks' replies."""
        with self._lock:
            self.start()
            if self._drops:
                keys, self._drops = self._drops, []
                self._exchange("drop", [(keys,)] * self.size)
            return self._exchange(op, per_rank or [args] * self.size)

    def _exchange(self, op: str, per_rank: List[tuple]) -> List[Any]:
        try:
            for conn, args in zip(self._conns, per_rank):
                conn.send((op, args))
        except (OSError, EOFError) as e:
            self._fail()
            raise MeshError(f"{self!r}: sending {op!r} failed: {e}") from e
        return self._gather(op)

    def _gather(self, op) -> List[Any]:
        """Every rank's reply; the first error or death fails the mesh."""
        replies: Dict[int, Any] = {}
        pending = {conn: r for r, conn in enumerate(self._conns)}
        while pending:
            sentinels = {self._procs[r].sentinel: r for r in pending.values()}
            ready = wait(list(pending) + list(sentinels))
            for obj in ready:
                if obj in pending:
                    r = pending.pop(obj)
                    try:
                        status, value = obj.recv()
                    except (OSError, EOFError):
                        status, value = "err", "the worker's pipe closed"
                    if status == "err":
                        self._fail()
                        raise MeshError(
                            f"shard worker {r} ({self.devices[r]}) failed "
                            f"in {op!r}:\n{value}")
                    replies[r] = value
            for obj in ready:
                r = sentinels.get(obj)
                if r is not None and r in pending.values() and \
                        not self._conns[r].poll():
                    self._procs[r].join(timeout=5)
                    code = self._procs[r].exitcode
                    self._fail()
                    raise MeshError(f"shard worker {r} ({self.devices[r]}) "
                                    f"exited with code {code} in {op!r}")
        return [replies[r] for r in range(self.size)]

    def _drop_later(self, key: int) -> None:
        """A bound model is garbage: its shards go at the next command."""
        self._drops.append(key)

    # --------------------------------------------------------- models

    def bind(self, model) -> "MeshModel":
        """``model``'s paged interface served on this mesh's shards."""
        return MeshModel(self, model)

    def counters(self) -> List[Dict[str, int]]:
        """Per rank, each kernel's launch count in that worker."""
        return self.run("counters")

    def reset_counters(self) -> None:
        self.run("reset_counters")

    def memory(self, reset: bool = False) -> List[Any]:
        """Per CUDA rank, (bytes allocated, peak bytes) in its worker, the
        peak then reset if ``reset``; None for a host slot."""
        return self.run("memory", None, reset)

    def probe(self) -> List[Dict[str, Any]]:
        """Per rank: pid, device, backend, world size, and whether the
        worker has imported jax (it must not)."""
        return self.run("probe")


_KEYS = itertools.count()


class _Handle:
    """An opaque reference to state that lives in the workers."""

    def __init__(self, key: int, rows: int = -1) -> None:
        self.key, self.rows = key, rows


def _host(x):
    """Step inputs travel as host numpy arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class MeshModel:
    """A model's paged serving interface over a mesh's shard workers.

    The engine calls it as it calls the model.  The pool it returns from
    ``init_paged_state`` and the rows from the prefills are opaque handles
    to the workers' shards; ``paged_decode_step`` returns rank 0's logits
    (summed over the group inside the step) on the host.
    """

    def __init__(self, mesh: ServingMesh, model) -> None:
        n = mesh.size
        if not model.tp_supported(n):
            raise ValueError(f"{type(model).__name__} cannot shard over "
                             f"{n} ranks")
        self.mesh, self.model, self.key = mesh, model, next(_KEYS)
        factory, kwargs = model.tp_local(n)
        params = {name: t.detach() for name, t in model.named_parameters()}
        shards = serving_tp_shards(model.tp_param_specs(), params, n)
        mesh.run("load", [(self.key, factory, kwargs, s) for s in shards])
        self._rows = itertools.count()
        weakref.finalize(self, mesh._drop_later, self.key)

    def _check(self, pool) -> None:
        if not isinstance(pool, _Handle) or pool.key != self.key:
            raise ValueError("not this mesh model's pool")

    def init_paged_state(self, num_pages: int, page_size: int, dtype=None):
        self.mesh.run("init_pool", None, self.key, num_pages, page_size,
                      dtype)
        return _Handle(self.key)

    def paged_prefill(self, tokens):
        rows = next(self._rows)
        self.mesh.run("prefill", None, self.key, rows, _host(tokens))
        return _Handle(self.key, rows), None

    def paged_prefill_at(self, tokens, pool, page_table, start: int):
        self._check(pool)
        rows = next(self._rows)
        self.mesh.run("prefill_at", None, self.key, rows, _host(tokens),
                      _host(page_table), int(start))
        return _Handle(self.key, rows), None

    def paged_write_prefill(self, pool, rows, page_ids, offsets):
        self._check(pool)
        self.mesh.run("write", None, self.key, rows.rows, _host(page_ids),
                      _host(offsets))
        return pool

    def paged_copy_page(self, pool, src: int, dst: int):
        self._check(pool)
        self.mesh.run("copy_page", None, self.key, int(src), int(dst))
        return pool

    def paged_decode_step(self, pool, tokens, page_table, pos):
        self._check(pool)
        logits = self.mesh.run("decode", None, self.key, _host(tokens),
                               _host(page_table), _host(pos))[0]
        return pool, torch.from_numpy(logits)

    def gather_pool(self, pool) -> Dict[str, torch.Tensor]:
        """The whole pool on the host, its shards joined by the model's
        ``tp_pool_specs`` (for checks; it copies every page)."""
        self._check(pool)
        shards = self.mesh.run("pool", None, self.key)
        specs = self.model.tp_pool_specs(shards[0])
        return {name: gather_shards([s[name] for s in shards], specs[name])
                for name in shards[0]}


# ------------------------------------------------------------ workers


def _shutdown(procs, conns, state, graceful: bool = True) -> None:
    """End the workers: an exit message, then terminate what lingers."""
    if graceful:
        for conn in conns:
            try:
                conn.send(("exit", ()))
            except (OSError, EOFError):
                pass
    for proc in procs:
        proc.join(timeout=10 if graceful else 0.1)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=10)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)
    for conn in conns:
        conn.close()
    if state.get("dir"):
        shutil.rmtree(state["dir"], ignore_errors=True)
        state["dir"] = None


class _Shard:
    """One worker's state: its rank's module and pool per bound model."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 backend: str) -> None:
        self.rank, self.size, self.device = rank, size, device
        self.backend = backend
        self.models: Dict[int, Any] = {}
        self.pools: Dict[int, Dict[str, torch.Tensor]] = {}
        #: per model, (rows id, rows) of the latest prefill: the engine
        #: scatters each prefill's rows before it runs the next one
        self.rows: Dict[int, tuple] = {}

    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def load(self, key, factory, kwargs, state):
        """Build the rank's module on ``meta`` and make the received
        tensors its weights: they are views of the controller's (CUDA IPC
        handles, or shared memory on the host), so the worker allocates
        no weight of its own."""
        local = factory(**kwargs, device="meta")
        params = dict(local.named_parameters())
        if set(params) != set(state):
            raise ValueError(f"shards and the local module differ: "
                             f"{sorted(set(params) ^ set(state))}")
        for name, t in state.items():
            want = params[name]
            if (want.shape, want.dtype, self.device) != (t.shape, t.dtype,
                                                         t.device):
                raise ValueError(
                    f"{name}: shard {tuple(t.shape)} {t.dtype} on "
                    f"{t.device} for a local {tuple(want.shape)} "
                    f"{want.dtype} on {self.device}")
            *path, leaf = name.split(".")
            owner = local
            for part in path:
                owner = getattr(owner, part)
            setattr(owner, leaf, nn.Parameter(t, requires_grad=False)
                    if isinstance(want, nn.Parameter) else t)
        local.device = self.device
        self.models[key] = local

    def drop(self, keys):
        for key in keys:
            self.models.pop(key, None)
            self.pools.pop(key, None)
            self.rows.pop(key, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def init_pool(self, key, num_pages, page_size, dtype):
        self.pools[key] = self.models[key].init_paged_state(
            num_pages, page_size, dtype)

    def prefill(self, key, rows_id, tokens):
        rows, _ = self.models[key].paged_prefill(self._t(tokens))
        self.rows[key] = (rows_id, rows)

    def prefill_at(self, key, rows_id, tokens, table, start):
        rows, _ = self.models[key].paged_prefill_at(
            self._t(tokens), self.pools[key], self._t(table), start)
        self.rows[key] = (rows_id, rows)

    def write(self, key, rows_id, page_ids, offsets):
        held, rows = self.rows.pop(key, (None, None))
        if held != rows_id:
            raise RuntimeError(f"rows {rows_id} asked for, {held} held")
        self.models[key].paged_write_prefill(
            self.pools[key], rows, self._t(page_ids), self._t(offsets))

    def copy_page(self, key, src, dst):
        self.models[key].paged_copy_page(self.pools[key], src, dst)

    def decode(self, key, tokens, table, pos):
        _, logits = self.models[key].paged_decode_step(
            self.pools[key], self._t(tokens), self._t(table), self._t(pos))
        if self.rank:
            return None
        if logits.is_floating_point():
            logits = logits.float()
        return logits.cpu().numpy()

    def pool(self, key):
        return {name: t.cpu() for name, t in self.pools[key].items()}

    def attention(self, q, k_pages, v_pages, page_table, lens, scale):
        from ..kernels.paged_attention.ops import paged_attention

        q, k_pages, v_pages = (t.to(self.device).contiguous()
                               for t in (q, k_pages, v_pages))
        return paged_attention(q, k_pages, v_pages, self._t(page_table),
                               self._t(lens), scale=scale)

    def flash(self, q, k, v, window, scale, logit_cap):
        """K2 on this rank's device at its local head counts (q (B, S, K,
        G, hd), causal), as ``attention`` runs K1."""
        from ..kernels.flash_attention.ops import flash_attention

        q, k, v = (t.to(self.device).contiguous() for t in (q, k, v))
        return flash_attention(q, k, v, window=window, scale=scale,
                               logit_cap=logit_cap, causal=True)

    def counters(self):
        return {name: fn.launches for name, fn in _launch_counters().items()}

    def reset_counters(self):
        for fn in _launch_counters().values():
            fn.launches = 0

    def memory(self, reset):
        """(bytes allocated, peak since the last reset) on a CUDA member."""
        if self.device.type != "cuda":
            return None
        out = (torch.cuda.memory_allocated(self.device),
               torch.cuda.max_memory_allocated(self.device))
        if reset:
            torch.cuda.reset_peak_memory_stats(self.device)
        return out

    def probe(self):
        return {"rank": self.rank, "size": self.size, "pid": os.getpid(),
                "device": str(self.device), "backend": self.backend,
                "jax_imported": "jax" in sys.modules}


def _launch_counters():
    from ..kernels.flash_attention import ops as fa_ops
    from ..kernels.paged_attention import ops as pa_ops
    from ..kernels.segment_zero import ops as sz_ops
    from ..kernels.wkv6 import ops as wkv_ops

    return {"paged_attention": pa_ops.paged_attention,
            "flash_attention": fa_ops.flash_attention,
            "wkv6": wkv_ops.wkv6, "segment_zero": sz_ops.segment_zero}


def _worker_main(rank: int, size: int, member: str, init_method: str,
                 backend: str, conn) -> None:
    """A shard worker: join the group, then serve the controller's ops
    until it says exit or its pipe closes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    try:
        device = _torch_device(member)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            # the mesh's ranks share the host's cores
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        mesh = DeviceMesh(device.type, list(range(size)),
                          mesh_dim_names=(SERVING_AXIS,))
        group = mesh.get_group(SERVING_AXIS)
        shard = _Shard(rank, size, device, backend)
    except Exception:
        conn.send(("err", traceback.format_exc()))
        return
    conn.send(("ok", None))
    try:
        while True:
            try:
                op, args = conn.recv()
            except (EOFError, OSError):
                break                       # the controller is gone
            if op == "exit":
                break
            try:
                with torch.no_grad(), bind_axis(SERVING_AXIS, group):
                    out = getattr(shard, op)(*args)
            except Exception:
                conn.send(("err", traceback.format_exc()))
            else:
                conn.send(("ok", out))
    finally:
        dist.destroy_process_group()
