"""Fault-tolerant checkpoint manager: async save, retention, restore.

The counterpart of ``repro/checkpoint/manager.py``:

* saves run on a background thread (training never blocks on I/O), one
  save in flight at most; the device → host snapshot is taken
  synchronously inside :meth:`CheckpointManager.save`, so a step that
  updates the parameters in place right after cannot reach the write,
* publishes are atomic (Gofer tmp+rename) and recorded in a manifest —
  a crash mid-save can never corrupt the latest restorable step,
* ``restore`` / ``restore_latest`` move the tree onto ``device``, or with
  ``shardings=`` (a tree of ``parallel.sharding.NamedSharding`` on a
  training mesh, as the reference's ``device_put``) cut each leaf to this
  rank's shard, on the mesh's device: a checkpoint saved on one mesh
  shape restores onto another, or onto one device,
* a save with ``shardings=`` is collective: each leaf's distinct shards
  go to rank 0 alone, which assembles the leaf in host memory, writes the
  image (byte-identical to a one-device save of the same values) and
  keeps the retention, and the ranks meet at
  a barrier once the write is done (at the save if blocking, else at the
  next ``wait``), so every rank reads a finished file,
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
from repro_torch.parallel.sharding import gather_leaf_to_host0, shard_tree
from repro_torch.tree import (
    tree_flatten_with_path,
    tree_leaves,
    tree_map,
    tree_unflatten_like,
)

from .ckpt import load_tree, records_to_tree, save_tree

__all__ = ["CheckpointManager"]


def _key(path) -> str:
    return "/".join(map(str, path))


def _mesh_of(shardings):
    """The training mesh of a sharding tree (None without one, or for a
    mesh of one rank)."""
    if shardings is None:
        return None
    mesh = tree_leaves(shardings)[0].mesh
    return mesh if mesh.size > 1 else None


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
        #: the mesh whose ranks meet once the write in flight is done
        self._pending_mesh = None
        self.save_log: List[Dict[str, Any]] = []

    # ------------------------------------------------------------- saving

    def save(self, step: int, tree, *, extra: Optional[dict] = None,
             blocking: bool = False, shardings=None) -> None:
        """Snapshot to host memory synchronously, write asynchronously;
        with ``shardings``, ``tree`` holds this rank's shards (every rank
        calls this)."""
        mesh = _mesh_of(shardings)
        if mesh is None:
            host_tree = tree_map(_host_copy, tree)    # device → host copy now
        else:
            # a leaf at a time, into rank 0's host memory alone
            host_tree = tree_unflatten_like(tree, [
                gather_leaf_to_host0(t, s) for t, s in
                zip(tree_leaves(tree), tree_leaves(shardings))])
        self.wait()                                   # one save in flight max
        if mesh is not None and mesh.rank:
            self._pending_mesh = mesh
            if blocking:
                self.wait()
            return

        def _write():
            t0 = time.time()
            blob = save_tree(host_tree, step=step, extra=extra)
            self.gofer.write_bytes(self.cap, f"step_{step:08d}.self", blob)
            self._publish(step)
            self._retain()
            self.save_log.append(
                {"step": step, "bytes": len(blob), "secs": time.time() - t0}
            )

        self._pending_mesh = mesh
        if blocking:
            _write()
            self.wait()
        else:
            self._inflight = threading.Thread(target=_write, daemon=True)
            self._inflight.start()

    def wait(self) -> None:
        """Until the save in flight is written (on a mesh: on rank 0, and
        every rank has met the others)."""
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
        mesh, self._pending_mesh = self._pending_mesh, None
        if mesh is not None:
            mesh.barrier()

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

    def restore(self, step: int, like, *, device=None, shardings=None):
        """The tree saved at ``step`` in ``like``'s structure, its leaves
        CPU tensors or, with ``device``, tensors moved there; with
        ``shardings``, each leaf cut to this rank's shard (``like`` holds
        shards, or anything of the structure) on the mesh's device."""
        blob = self.gofer.read_bytes(self.cap, f"step_{step:08d}.self")
        records, manifest = load_tree(blob)
        del blob
        mesh = _mesh_of(shardings)
        if mesh is None:
            tree = records_to_tree(records, like)
            if device is not None:
                tree = tree_map(lambda t: t.to(device), tree)
            return tree, manifest
        keys = [_key(path) for path, _ in tree_flatten_with_path(shardings)]
        missing = [k for k in keys if k not in records]
        if missing:
            raise KeyError(f"checkpoint missing tensors {missing[:4]}")
        whole = tree_unflatten_like(shardings, [records.pop(k) for k in keys])
        shards = tree_leaves(shard_tree(whole, shardings))
        del whole
        dev = mesh.device if device is None else device
        local = {k: t.clone().to(dev) for k, t in zip(keys, shards)}
        return records_to_tree(local, like), manifest

    def restore_latest(self, like, *, device=None, shardings=None):
        step = self.latest_step()
        if step is None:
            return None
        tree, manifest = self.restore(step, like, device=device,
                                      shardings=shardings)
        return step, tree, manifest
