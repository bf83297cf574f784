"""Tokenized data pipeline: deterministic synthetic + file-backed sources.

The counterpart of ``repro/data/pipeline.py``.  Batches are numpy arrays,
byte-identical to the reference's for the same ``(seed, step, host)``;
the trainer moves them onto its device.

Every host loads only its shard of the global batch (``host_index`` /
``num_hosts``), with a background prefetch thread keeping ``prefetch``
batches ahead of the training loop.  File-backed datasets read through the
:class:`~repro_torch.core.gofer.Gofer` — sandboxed code never opens dataset
files directly (DESIGN.md §2).

User-defined transforms run **inside the sandbox**: ``with_transform``
admits the fn through the Sentry (on a probe of CPU tensors) and applies
it per batch through ``Sandbox.run`` on CPU tensors — this is the Snowpark
pattern of user code executing next to the data.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.gofer import Gofer
from repro_torch.core.sandbox import Sandbox

__all__ = ["DataConfig", "SyntheticLM", "FileBackedLM", "Loader"]


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    host_index: int = 0
    num_hosts: int = 1
    prefetch: int = 2

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


class SyntheticLM:
    """Deterministic synthetic LM stream (seeded per step + host).

    Emits a structured sequence (a noisy autoregressive walk over the
    vocab) rather than iid noise so smoke-training shows a falling loss.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 977 + cfg.host_index
        )
        B, S = cfg.host_batch, cfg.seq_len
        start = rng.integers(0, cfg.vocab_size, (B, 1))
        drift = rng.integers(1, 7, (B, S))
        tokens = (start + np.cumsum(drift, axis=1)) % cfg.vocab_size
        tokens = tokens.astype(np.int32)
        targets = np.roll(tokens, -1, axis=1)
        targets[:, -1] = tokens[:, 0]
        return {
            "tokens": tokens,
            "targets": targets.astype(np.int32),
            "loss_mask": np.ones((B, S), np.float32),
        }


class FileBackedLM:
    """Flat binary token file (uint16/uint32), windowed per step.

    Reads via a Gofer capability; the file is the whole corpus and each
    (step, host) pair maps to a disjoint strided window.
    """

    def __init__(self, cfg: DataConfig, gofer: Gofer, cap: str, rel: str,
                 dtype=np.uint16):
        self.cfg = cfg
        raw = gofer.read_bytes(cap, rel)
        self.tokens = np.frombuffer(raw, dtype=dtype).astype(np.int32)
        if len(self.tokens) < cfg.seq_len + 1:
            raise ValueError("corpus smaller than one sequence")

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        B, S = cfg.host_batch, cfg.seq_len
        n = len(self.tokens) - S - 1
        rng = np.random.default_rng(cfg.seed * 7919 + step * 31 + cfg.host_index)
        offs = rng.integers(0, n, (B,))
        tok = np.stack([self.tokens[o:o + S] for o in offs])
        tgt = np.stack([self.tokens[o + 1:o + S + 1] for o in offs])
        return {
            "tokens": tok % cfg.vocab_size,
            "targets": tgt % cfg.vocab_size,
            "loss_mask": np.ones((B, S), np.float32),
        }


class Loader:
    """Prefetching iterator over a dataset, with sandboxed user transforms."""

    def __init__(self, dataset, cfg: DataConfig, start_step: int = 0):
        self.dataset = dataset
        self.cfg = cfg
        self._step = start_step
        self._transform: Optional[Callable] = None
        self._sandbox: Optional[Sandbox] = None
        self._q: "queue.Queue" = queue.Queue(maxsize=max(cfg.prefetch, 1))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def with_transform(self, fn: Callable, sandbox: Sandbox) -> "Loader":
        """Register a per-batch user transform, admitted via the Sentry."""
        probe = {
            k: torch.from_numpy(v[:1]) for k, v in
            self.dataset.batch_at(0).items()
        }
        sandbox.verify_only(fn, probe)   # load-time admission (paper §III)
        self._transform = fn
        self._sandbox = sandbox
        return self

    def _produce(self):
        while not self._stop.is_set():
            batch = self.dataset.batch_at(self._step)
            self._step += 1
            if self._transform is not None:
                tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
                result = self._sandbox.run(self._transform, tbatch)
                batch = {k: v.detach().cpu().numpy()
                         for k, v in result.value.items()}
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()
        try:
            while True:
                yield self._q.get()
        finally:
            self.stop()

    def stop(self):
        self._stop.set()

    @property
    def step(self) -> int:
        return self._step
