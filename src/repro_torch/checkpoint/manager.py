"""Fault-tolerant checkpoint manager: async save, retention, restore.

The counterpart of ``repro/checkpoint/manager.py``:

* saves run on a background thread (training never blocks on I/O), one
  save in flight at most; the device → host snapshot is taken
  synchronously inside :meth:`CheckpointManager.save`, so a step that
  updates the parameters in place right after cannot reach the write,
* publishes are atomic (Gofer tmp+rename) and recorded in a manifest —
  a crash mid-save can never corrupt the latest restorable step,
* ``restore`` / ``restore_latest`` move the tree onto ``device`` (the
  reference's ``shardings=`` is a ``device_put`` onto a mesh, which waits
  for training on a mesh, ROADMAP.md queue 1, item 9c: a restore targets
  one device),
* retention keeps the newest K checkpoints plus every multiple of
  ``keep_every``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.gofer import Gofer
from repro_torch.tree import tree_map

from .ckpt import load_tree, records_to_tree, save_tree

__all__ = ["CheckpointManager"]


def _host_copy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class CheckpointManager:
    def __init__(
        self,
        gofer: Gofer,
        cap: str = "ckpt",
        *,
        keep: int = 3,
        keep_every: int = 0,
    ) -> None:
        self.gofer = gofer
        self.cap = cap
        self.keep = keep
        self.keep_every = keep_every
        self._lock = threading.Lock()
        self._inflight: Optional[threading.Thread] = None
        self.save_log: List[Dict[str, Any]] = []

    # ------------------------------------------------------------- saving

    def save(self, step: int, tree, *, extra: Optional[dict] = None,
             blocking: bool = False) -> None:
        """Snapshot to host memory synchronously, write asynchronously."""
        host_tree = tree_map(_host_copy, tree)        # device → host copy now
        self.wait()                                   # one save in flight max

        def _write():
            t0 = time.time()
            blob = save_tree(host_tree, step=step, extra=extra)
            self.gofer.write_bytes(self.cap, f"step_{step:08d}.self", blob)
            self._publish(step)
            self._retain()
            self.save_log.append(
                {"step": step, "bytes": len(blob), "secs": time.time() - t0}
            )

        if blocking:
            _write()
        else:
            self._inflight = threading.Thread(target=_write, daemon=True)
            self._inflight.start()

    def wait(self) -> None:
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None

    def _publish(self, step: int) -> None:
        with self._lock:
            manifest = {"latest": step, "published_at": time.time()}
            self.gofer.write_bytes(
                self.cap, "LATEST.json", json.dumps(manifest).encode()
            )

    def _retain(self) -> None:
        steps = self.all_steps()
        drop = steps[:-self.keep] if self.keep else []
        for s in drop:
            if self.keep_every and s % self.keep_every == 0:
                continue
            self.gofer.delete(self.cap, f"step_{s:08d}.self")

    # ------------------------------------------------------------ restore

    def all_steps(self) -> List[int]:
        out = []
        for name in self.gofer.listdir(self.cap):
            if name.startswith("step_") and name.endswith(".self"):
                out.append(int(name[5:13]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        if self.gofer.exists(self.cap, "LATEST.json"):
            meta = json.loads(self.gofer.read_bytes(self.cap, "LATEST.json"))
            if self.gofer.exists(self.cap, f"step_{meta['latest']:08d}.self"):
                return int(meta["latest"])
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, *, device=None):
        """The tree saved at ``step`` in ``like``'s structure, its leaves
        CPU tensors or, with ``device``, tensors moved there."""
        blob = self.gofer.read_bytes(self.cap, f"step_{step:08d}.self")
        records, manifest = load_tree(blob)
        tree = records_to_tree(records, like)
        if device is not None:
            tree = tree_map(lambda t: t.to(device), tree)
        return tree, manifest

    def restore_latest(self, like, *, device=None):
        step = self.latest_step()
        if step is None:
            return None
        tree, manifest = self.restore(step, like, device=device)
        return step, tree, manifest
