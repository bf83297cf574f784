"""Execution substrate — real threads in production, simulation under test.

The concurrent :class:`~repro.core.tasks.ServerlessScheduler` needs two
contradictory things: true parallel dispatch (the paper's Serverless Tasks
run many tenants' workloads concurrently on warehouse nodes) and the
reproducible-by-construction testing story the seed valued.  This module
resolves the tension with one abstraction, :class:`Executor`, and two
implementations:

* :class:`ThreadExecutor` — production: OS threads, wall-clock time,
  ``yield_point`` is a no-op.  Concurrency is real and timing is whatever
  the machine gives you.
* :class:`SimExecutor` — test: every "thread" is a cooperatively-scheduled
  worker driven by a controller loop on the calling thread.  Exactly one
  worker runs at a time; at every :meth:`~Executor.yield_point` /
  :meth:`~Executor.sleep` / :meth:`~Executor.idle_wait` the worker parks
  and a **seeded** RNG picks who runs next.  Time is a
  :class:`VirtualClock` that only advances when every runnable worker is
  blocked, so a test exploring thousands of interleavings finishes in
  milliseconds and the same seed replays the same schedule byte for byte.

Worker code is identical under both executors: it calls
``executor.yield_point()`` at interesting interleave points (free under
threads), ``executor.sleep()`` instead of ``time.sleep()``, and
``executor.now()`` instead of ``time.time()``.

Fault injection (sim only): :meth:`SimExecutor.kill` raises
:class:`WorkerKilled` inside a worker at its next scheduling point —
including in the middle of a task's ``sleep`` — and
:meth:`SimExecutor.call_later` schedules arbitrary callbacks (kills,
submissions, cancellations) at virtual times.  ``WorkerKilled`` derives
from ``BaseException`` so task code's ``except Exception`` can never
swallow an injected death.  :meth:`SimExecutor.slow` stretches one
worker's subsequent ``sleep`` durations by a factor — the node-level
"sick host" fault: a slowed worker keeps running but stops making
progress (and stops heartbeating) fast enough, so chaos tests can
exercise heartbeat-timeout death and straggler eviction instead of
only direct kills.
"""

from __future__ import annotations

import heapq
import itertools
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "Clock",
    "Executor",
    "RealClock",
    "SimDeadlock",
    "SimExecutor",
    "ThreadExecutor",
    "VirtualClock",
    "WorkerKilled",
]


class WorkerKilled(BaseException):
    """Injected worker death (fault injection).

    A ``BaseException`` on purpose: task code and the scheduler's retry
    loop catch ``Exception`` for transient failures, and an injected death
    must tear the worker down rather than count as a retryable error.
    """


class SimDeadlock(RuntimeError):
    """Nothing is runnable, nothing is sleeping, and the goal isn't met.

    Usually a missed ``notify()``: a worker parked in ``idle_wait`` that
    no event will ever wake.  The message carries the parked-worker state
    so the lost wakeup is findable.
    """


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------


class Clock:
    """Time source: wall time in production, virtual time in simulation."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class RealClock(Clock):
    def now(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class VirtualClock(Clock):
    """Deterministic clock: advances only when told to.

    ``sleep`` here advances immediately (non-cooperative fallback for code
    holding the clock directly); inside a :class:`SimExecutor` worker,
    ``executor.sleep`` parks the worker instead and the controller
    advances this clock when no worker is runnable.
    """

    def __init__(self, start: float = 0.0) -> None:
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance a clock backwards ({dt})")
        self._now += float(dt)
        return self._now

    def advance_to(self, when: float) -> float:
        if when > self._now:
            self._now = float(when)
        return self._now

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)


# ---------------------------------------------------------------------------
# executor interface
# ---------------------------------------------------------------------------


class Executor:
    """What concurrent scheduler code is written against.

    ``spawn`` starts a worker; ``yield_point``/``sleep``/``idle_wait``
    are the only places a sim worker can lose the CPU, so they double as
    the interleaving-exploration points; ``notify`` wakes idle workers;
    ``run_until`` drives execution from the controlling thread until a
    predicate holds; ``join`` waits for every worker to finish.
    """

    clock: Clock

    def now(self) -> float:
        return self.clock.now()

    def spawn(self, fn: Callable, *args: Any, name: Optional[str] = None):
        raise NotImplementedError

    def yield_point(self, tag: str = "") -> None:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    def idle_wait(self) -> None:
        raise NotImplementedError

    def notify(self) -> None:
        raise NotImplementedError

    def run_until(
        self, predicate: Optional[Callable[[], bool]] = None,
        timeout: float = 60.0,
    ) -> bool:
        raise NotImplementedError

    def join(self, timeout: float = 10.0) -> None:
        raise NotImplementedError


class ThreadExecutor(Executor):
    """Production executor: real OS threads and wall-clock time."""

    deterministic = False

    def __init__(self, clock: Optional[Clock] = None) -> None:
        self.clock = clock or RealClock()
        self._threads: List[threading.Thread] = []
        self._cond = threading.Condition()

    def spawn(self, fn: Callable, *args: Any, name: Optional[str] = None):
        thread = threading.Thread(
            target=fn, args=args, name=name, daemon=True
        )
        self._threads.append(thread)
        thread.start()
        return thread

    def yield_point(self, tag: str = "") -> None:
        pass                               # threads preempt for free

    def sleep(self, seconds: float) -> None:
        self.clock.sleep(seconds)

    def idle_wait(self) -> None:
        # bounded wait: a notify can race the re-check, so never park
        # unboundedly on the condition alone
        with self._cond:
            self._cond.wait(timeout=0.005)

    def notify(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def run_until(
        self, predicate: Optional[Callable[[], bool]] = None,
        timeout: float = 60.0,
    ) -> bool:
        deadline = time.monotonic() + timeout
        while True:
            if predicate is None or predicate():
                return True
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"run_until: predicate still false after {timeout}s"
                )
            with self._cond:
                self._cond.wait(timeout=0.005)

    def join(self, timeout: float = 10.0) -> None:
        for thread in self._threads:
            thread.join(timeout=timeout)
        self._threads = [t for t in self._threads if t.is_alive()]


# ---------------------------------------------------------------------------
# deterministic simulation executor
# ---------------------------------------------------------------------------

_NEW, _READY, _RUNNING, _SLEEPING, _IDLE, _DONE = (
    "new", "ready", "running", "sleeping", "idle", "done"
)


class _SimWorker:
    __slots__ = (
        "name", "thread", "event", "state", "wake_at", "die", "error",
        "killed", "slow_factor",
    )

    def __init__(self, name: str) -> None:
        self.name = name
        self.thread: Optional[threading.Thread] = None
        self.event = threading.Event()     # set => this worker may run
        self.state = _NEW
        self.wake_at: Optional[float] = None
        self.die = False
        self.error: Optional[BaseException] = None
        self.killed = False
        self.slow_factor = 1.0             # straggler fault: sleeps stretch


class SimExecutor(Executor):
    """Seeded cooperative scheduler over a virtual clock.

    Workers are real threads for stack fidelity, but a baton protocol
    guarantees exactly one ever runs at a time: the controller (the thread
    calling :meth:`run_until`) resumes one parked worker, waits for it to
    park again, then picks the next runnable worker with
    ``random.Random(seed)``.  The pick sequence — and therefore every
    lock-free interleaving of the code under test — is a pure function of
    the seed.
    """

    deterministic = True

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self.clock = VirtualClock()
        self._rng = random.Random(seed)
        self._workers: Dict[str, _SimWorker] = {}
        self._by_ident: Dict[int, _SimWorker] = {}
        self._resume = threading.Event()   # worker -> controller baton
        self._timers: List[Tuple[float, int, Callable[[], None]]] = []
        self._timer_seq = itertools.count()
        self._names = itertools.count()
        self.trace: List[str] = []         # deterministic schedule log
        self.steps = 0

    # ------------------------------------------------------------- workers

    def spawn(self, fn: Callable, *args: Any, name: Optional[str] = None):
        name = name or f"sim{next(self._names)}"
        if name in self._workers:
            raise ValueError(f"worker {name!r} already exists")
        worker = _SimWorker(name)

        def body() -> None:
            self._by_ident[threading.get_ident()] = worker
            worker.event.wait()            # first schedule
            try:
                if worker.die:
                    worker.die = False
                    raise WorkerKilled(worker.name)
                fn(*args)
            except WorkerKilled:
                worker.killed = True
                self.trace.append(f"{self.now():.6f} kill {worker.name}")
            except BaseException as e:     # surfaced by the controller
                worker.error = e
            finally:
                worker.state = _DONE
                self._resume.set()

        worker.thread = threading.Thread(target=body, name=name, daemon=True)
        worker.state = _READY
        self._workers[name] = worker
        worker.thread.start()
        return worker

    def _current(self) -> Optional[_SimWorker]:
        return self._by_ident.get(threading.get_ident())

    def _park(self, worker: _SimWorker, state: str) -> None:
        worker.state = state
        worker.event.clear()
        self._resume.set()                 # hand the baton back
        worker.event.wait()                # until scheduled again
        if worker.die:
            worker.die = False
            raise WorkerKilled(worker.name)

    # ------------------------------------------------- worker-facing calls

    def yield_point(self, tag: str = "") -> None:
        worker = self._current()
        if worker is None:
            return                         # controller/main thread: no-op
        self._park(worker, _READY)

    def sleep(self, seconds: float) -> None:
        worker = self._current()
        if worker is None:                 # non-worker context: just advance
            self.clock.advance(seconds)
            self._fire_due_timers()
            return
        worker.wake_at = self.clock.now() + float(seconds) * worker.slow_factor
        self._park(worker, _SLEEPING)

    def idle_wait(self) -> None:
        worker = self._current()
        if worker is None:
            return
        self._park(worker, _IDLE)

    def notify(self) -> None:
        """Wake every idle worker (pure state flip — deterministic)."""
        for worker in self._workers.values():
            if worker.state == _IDLE:
                worker.state = _READY

    # --------------------------------------------------- fault injection

    def kill(self, name: str) -> bool:
        """Raise :class:`WorkerKilled` in ``name`` at its next scheduling
        point (including mid-``sleep``).  Returns False if already done."""
        worker = self._workers[name]
        if worker.state == _DONE:
            return False
        worker.die = True
        if worker.state in (_SLEEPING, _IDLE):
            worker.wake_at = None
            worker.state = _READY          # schedulable so it can die now
        return True

    def slow(self, name: str, factor: float) -> bool:
        """Stretch ``name``'s future ``sleep`` durations by ``factor``.

        The "sick node" fault: the worker stays alive and keeps its state,
        but a 0.01s sleep now burns ``0.01 * factor`` virtual seconds — long
        enough and a heartbeat monitor declares it dead, or a straggler
        detector flags it for eviction.  ``factor=1.0`` heals the worker.
        Returns False if the worker has already exited.
        """
        if factor <= 0:
            raise ValueError(f"slow factor must be positive ({factor})")
        worker = self._workers[name]
        if worker.state == _DONE:
            return False
        worker.slow_factor = float(factor)
        return True

    def call_at(self, when: float, fn: Callable[[], None]) -> None:
        """Run ``fn`` in the controller at virtual time ``when``."""
        heapq.heappush(self._timers, (float(when), next(self._timer_seq), fn))

    def call_later(self, delay: float, fn: Callable[[], None]) -> None:
        self.call_at(self.clock.now() + delay, fn)

    # ---------------------------------------------------------- controller

    def _fire_due_timers(self) -> None:
        while self._timers and self._timers[0][0] <= self.clock.now():
            _, _, fn = heapq.heappop(self._timers)
            fn()

    def _step(self, worker: _SimWorker) -> None:
        self.trace.append(f"{self.now():.6f} run {worker.name}")
        self.steps += 1
        self._resume.clear()
        worker.state = _RUNNING
        worker.event.set()
        self._resume.wait()                # worker parked again (or done)
        if worker.error is not None:
            error, worker.error = worker.error, None
            raise error

    def run_until(
        self, predicate: Optional[Callable[[], bool]] = None,
        timeout: float = 60.0,
        max_steps: Optional[int] = None,
    ) -> bool:
        """Drive the simulation until ``predicate()`` holds.

        With no predicate, runs until nothing is runnable or scheduled
        (all workers done or idle).  Raises :class:`SimDeadlock` when the
        predicate is unmet but no worker can ever run again.  ``timeout``
        bounds *wall-clock* controller time (matching
        :meth:`ThreadExecutor.run_until`); ``max_steps`` bounds
        scheduling steps (the deterministic livelock backstop).
        """
        budget = max_steps if max_steps is not None else 1_000_000
        start_steps = self.steps
        deadline = time.monotonic() + timeout
        while True:
            self._fire_due_timers()
            if predicate is not None and predicate():
                return True
            ready = sorted(
                (w for w in self._workers.values() if w.state == _READY),
                key=lambda w: w.name,
            )
            if not ready:
                wake_times = [
                    w.wake_at for w in self._workers.values()
                    if w.state == _SLEEPING and w.wake_at is not None
                ]
                if self._timers:
                    wake_times.append(self._timers[0][0])
                if wake_times:
                    self.clock.advance_to(min(wake_times))
                    for w in self._workers.values():
                        if (
                            w.state == _SLEEPING
                            and w.wake_at is not None
                            and w.wake_at <= self.clock.now()
                        ):
                            w.wake_at = None
                            w.state = _READY
                    continue
                if predicate is None:
                    return True            # quiescent: done or idle
                if all(
                    w.state in (_DONE, _IDLE)
                    for w in self._workers.values()
                ) and any(
                    w.state == _IDLE for w in self._workers.values()
                ):
                    states = {
                        w.name: w.state for w in self._workers.values()
                    }
                    raise SimDeadlock(
                        f"predicate unmet and no wakeup pending: {states}"
                    )
                return False               # all workers done, goal unmet
            worker = self._rng.choice(ready)
            self._step(worker)
            if self.steps - start_steps > budget:
                raise RuntimeError(
                    f"run_until exceeded {budget} scheduling steps"
                )
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"run_until: predicate still false after {timeout}s "
                    f"of wall time ({self.steps - start_steps} steps)"
                )

    def run(self) -> None:
        """Run to quiescence (every worker done or idle)."""
        self.run_until(None)

    def join(self, timeout: float = 10.0) -> None:
        """Drive the sim until every worker has exited."""
        self.run_until(
            lambda: all(w.state == _DONE for w in self._workers.values())
        )

    # -------------------------------------------------------------- status

    def worker_states(self) -> Dict[str, str]:
        return {name: w.state for name, w in self._workers.items()}

    def killed_workers(self) -> List[str]:
        return sorted(
            name for name, w in self._workers.items() if w.killed
        )
