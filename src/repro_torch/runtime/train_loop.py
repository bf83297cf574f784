"""Training driver: the step, grad accumulation, checkpoints, faults.

The counterpart of ``repro/runtime/train_loop.py``, eager PyTorch.  The
loop composes every substrate: data pipeline (sandboxed transforms),
AdamW + schedule, async SELF checkpoints, heartbeat/straggler monitoring
with restart-from-checkpoint, and optional microbatch gradient
accumulation (``accum_steps`` > 1 runs the microbatches one after another
into fp32 gradient accumulators and applies one optimizer update — the
standard way to hold global batch while shrinking activation memory).

Parameters and optimizer state are the reference's trees: ``params`` is
the nested dict the model's ``loss`` takes
(:func:`~repro_torch.models.common.param_tree`), the optimizer state is
``{"mu", "nu", "step"}``, and a checkpoint holds
``{"params": ..., "opt": ...}`` under the reference's keys.  A step reads
the learning rate at the optimizer's step before it increments, as the
reference's does.  Batches arrive as numpy arrays and move to the model's
device.

**On a training mesh** (``Trainer(..., mesh=)``, a ``launch.mesh.TrainMesh``
of more than one rank) every rank runs the trainer (SPMD).  The
parameters and AdamW moments are stored split by the reference's rules
(``parallel.sharding.param_shardings(mode="train")``): ``init_state``
draws the one-device initialisation from the same seed, keeps this rank's
shard of each leaf and frees the module's weights (its parameters move to
``meta``; the loss reads only the tree it is given).  The step is
``launch.steps.make_train_step``'s: the reference's GSPMD layout, each
layer's weights gathered where it runs and its gradients reduced as the
backward leaves it, the loss on this rank's rows (and, for
``TransformerLM``, its chunk of the sequence), and AdamW on the local
shards.  Checkpoints are saved from the gathered
leaves by rank 0 and restored onto the mesh by slicing
(``CheckpointManager(..., shardings=)``), so a checkpoint moves between
mesh shapes and to one device.  The global batch must split over the
batch axes (after ``accum_steps``).  A mesh of one rank is one device.

Recovery is the reference's: a :class:`WorkerFailure` restores the latest
checkpoint (its leaves moved to the model's device) and resumes the loop
at the checkpoint's step with the loader's next batch, or, before the
first checkpoint, restarts from ``init_state(0)`` at step 0.  So a run
that fails at step ``c + 1`` after a checkpoint at ``c`` replays step
``c`` on the batch it would have read at ``c + 1``, and ends where an
uninterrupted run one step longer ends.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch.steps import backward, make_train_step
from repro_torch.models.common import param_tree
from repro_torch.optim import AdamWConfig, ScheduleConfig, adamw_init
from repro_torch.parallel.sharding import (
    opt_state_shardings,
    param_shardings,
    shard_tree,
)
from repro_torch.runtime.fault import (
    FailureInjector,
    HeartbeatMonitor,
    StragglerDetector,
    WorkerFailure,
)
from repro_torch.tree import tree_map

__all__ = ["TrainerConfig", "Trainer", "TrainStepper", "backward"]


@dataclass
class TrainerConfig:
    total_steps: int = 100
    accum_steps: int = 1
    log_every: int = 10
    ckpt_every: int = 50
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)
    opt: AdamWConfig = field(default_factory=AdamWConfig)


class Trainer:
    """Runs ``model.loss`` and AdamW over ``loader``'s batches.

    ``donate=True`` (the default, as the reference's) gives the step the
    parameter and optimizer tensors to overwrite: the update is written in
    place, where the reference donated the buffers to its jitted step, so
    the caller's tensors hold the new state afterwards.  ``donate=False``
    leaves them as they were and returns new ones.  There is no
    ``torch.compile``: the step runs eagerly.  ``mesh``: a training mesh
    (the module docstring).
    """

    def __init__(
        self,
        model,
        loader,
        cfg: TrainerConfig,
        *,
        ckpt: Optional[CheckpointManager] = None,
        monitor: Optional[HeartbeatMonitor] = None,
        stragglers: Optional[StragglerDetector] = None,
        injector: Optional[FailureInjector] = None,
        donate: bool = True,
        mesh=None,
    ) -> None:
        self.model = model
        self.loader = loader
        self.cfg = cfg
        self.ckpt = ckpt
        self.monitor = monitor
        self.stragglers = stragglers
        self.injector = injector
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = model.device
        #: ``{"params": ..., "opt": ...}`` NamedSharding trees on the mesh
        self.shardings = None
        if self.mesh is not None:
            if (self.device.type, self.device.index or 0) != (
                    self.mesh.device.type, self.mesh.device.index or 0):
                raise ValueError(f"the model is on {self.device}, this "
                                 f"rank's mesh device {self.mesh.device}")
            shapes = param_tree(model)
            # as the reference's dry run lays out its training cells
            hd_div = model.cfg.num_heads % self.mesh.shape.get("model", 1) == 0
            step = torch.empty((), dtype=torch.int32, device="meta")
            self.shardings = {
                "params": param_shardings(shapes, self.mesh,
                                          heads_divisible=hd_div),
                "opt": opt_state_shardings(
                    {"mu": shapes, "nu": shapes, "step": step}, self.mesh,
                    heads_divisible=hd_div)}
        self.metrics_log: List[Dict[str, float]] = []
        self.restarts = 0
        self._step_fn = self._build_step(donate)

    # ------------------------------------------------------------- step fn

    def _build_step(self, donate: bool) -> Callable:
        return make_train_step(
            self.model, self.cfg.schedule, self.cfg.opt,
            accum_steps=self.cfg.accum_steps, donate=donate,
            shardings=None if self.mesh is None
            else self.shardings["params"])

    def _on_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    # ---------------------------------------------------------------- run

    def init_state(self, rng):
        """(params, optimizer state) from ``model.init``: ``rng`` is a
        seed or a ``torch.Generator`` on the model's device.  The params
        are views of the module's weights (:func:`param_tree`); on a mesh,
        this rank's shards of them, and the module's weights are freed."""
        if not isinstance(rng, torch.Generator):
            rng = torch.Generator(self.device).manual_seed(int(rng))
        model = self.model
        if self.mesh is not None and any(t.is_meta
                                         for t in model.parameters()):
            model.to_empty(device=self.device)      # freed by an earlier call
        model.init(rng)
        params = param_tree(model)
        if self.mesh is not None:
            params = tree_map(torch.clone,
                              shard_tree(params, self.shardings["params"]))
            model.to_empty(device="meta")
        return params, adamw_init(params)

    def _save(self, step: int, params, opt_state, **kw) -> None:
        self.ckpt.save(step, {"params": params, "opt": opt_state},
                       shardings=self.shardings, **kw)

    def run(self, params, opt_state, *, start_step: int = 0):
        step = start_step
        it = iter(self.loader)
        while step < self.cfg.total_steps:
            t0 = time.perf_counter()
            try:
                if self.injector is not None:
                    self.injector.check(step)
                batch = next(it)
                params, opt_state, metrics = self._step_fn(
                    params, opt_state, self._on_device(batch)
                )
                if self.monitor is not None:
                    for w in self.monitor.workers():
                        self.monitor.beat(w)
            except WorkerFailure as e:
                params, opt_state, step = self._recover(e, params, opt_state)
                continue
            dt = time.perf_counter() - t0
            if self.stragglers is not None:
                self.stragglers.record("host0", dt)
            if step % self.cfg.log_every == 0 or step == self.cfg.total_steps - 1:
                row = {k: float(v) for k, v in metrics.items()}
                row.update(step=step, secs=dt)
                self.metrics_log.append(row)
            if self.ckpt is not None and step and step % self.cfg.ckpt_every == 0:
                self._save(step, params, opt_state)
            step += 1
        if self.ckpt is not None:
            self._save(step, params, opt_state, blocking=True)
        return params, opt_state

    # ------------------------------------------------------------ stepping

    def stepper(self, params, opt_state, *, start_step: int = 0
                ) -> "TrainStepper":
        """A one-step-at-a-time driver for orchestrated training.

        :meth:`run` owns its own while-loop, which makes training a
        monolith no scheduler can interleave with other workload classes.
        The stepper exposes the same step body (the step, checkpoint
        cadence, injector/recovery path) as an incremental API —
        ``step_once()`` per call — so the orchestrator can run each step
        as one task on the shared worker pool, with a cooperative
        preemption point between steps.
        """
        return TrainStepper(self, params, opt_state, start_step)

    # ------------------------------------------------------------ recovery

    def _recover(self, failure: WorkerFailure, params, opt_state):
        """Restart-from-checkpoint after a worker failure."""
        self.restarts += 1
        if self.monitor is not None:
            for w in failure.workers:
                self.monitor.remove(w)
        if self.ckpt is None:
            raise failure
        self.ckpt.wait()
        restored = self.ckpt.restore_latest(
            {"params": params, "opt": opt_state}, device=self.device,
            shardings=self.shardings)
        if restored is None:
            # failure before the first checkpoint: restart from scratch
            # (what a production job does on step-0 loss), deterministic
            # because data is step-keyed.
            fresh_p, fresh_o = self.init_state(0)
            return fresh_p, fresh_o, 0
        step, tree, manifest = restored
        return tree["params"], tree["opt"], int(manifest["step"])


class TrainStepper:
    """Incremental view of :meth:`Trainer.run`: one optimizer step per call.

    Holds the loop state (params, opt state, loader iterator, step index)
    so the orchestrator can schedule ``step_once`` invocations as tasks
    on a shared worker pool.  Each call starts with a
    :func:`repro_torch.core.tasks.checkpoint` — the cooperative preemption
    point and worker heartbeat the task plane relies on — and ends with
    the same checkpoint/injector/recovery bookkeeping as ``run()``.
    """

    def __init__(self, trainer: Trainer, params, opt_state,
                 start_step: int = 0) -> None:
        self.trainer = trainer
        self.params = params
        self.opt_state = opt_state
        self.step = start_step
        self._it = iter(trainer.loader)

    def done(self) -> bool:
        return self.step >= self.trainer.cfg.total_steps

    def remaining(self) -> int:
        return max(self.trainer.cfg.total_steps - self.step, 0)

    def step_once(self) -> Optional[Dict[str, float]]:
        """Run one training step; returns its metrics row (None if done)."""
        from repro_torch.core.tasks import checkpoint

        tr = self.trainer
        if self.done():
            return None
        checkpoint()                       # preemption point + heartbeat
        t0 = time.perf_counter()
        try:
            if tr.injector is not None:
                tr.injector.check(self.step)
            batch = next(self._it)
            self.params, self.opt_state, metrics = tr._step_fn(
                self.params, self.opt_state, tr._on_device(batch)
            )
            if tr.monitor is not None:
                for w in tr.monitor.workers():
                    tr.monitor.beat(w)
        except WorkerFailure as e:
            self.params, self.opt_state, self.step = tr._recover(
                e, self.params, self.opt_state
            )
            self._it = iter(tr.loader)
            return {"recovered": 1.0, "step": float(self.step)}
        dt = time.perf_counter() - t0
        if tr.stragglers is not None:
            tr.stragglers.record("host0", dt)
        row = {k: float(v) for k, v in metrics.items()}
        row.update(step=self.step, secs=dt)
        if (self.step % tr.cfg.log_every == 0
                or self.step == tr.cfg.total_steps - 1):
            tr.metrics_log.append(row)
        if (tr.ckpt is not None and self.step
                and self.step % tr.cfg.ckpt_every == 0):
            tr._save(self.step, self.params, self.opt_state)
        self.step += 1
        if tr.ckpt is not None and self.done():
            tr._save(self.step, self.params, self.opt_state, blocking=True)
        return row
