"""The closed loop of clients around ``Server``, and the probes a traced
run puts around the program's calls.

Each client holds one request at a time and sends its next one as soon
as the step that finished the last returns.  ``Server.step()`` ends with
the logits on the host (the sampler reads them there), so a token's time
is the host clock when the step that made it returned.

``Probe`` is installed only in a traced run: it wraps the engine's calls
into the model (decode step, the two prefills, the page scatter), the
prefill attention kernel's entry and the host sampler in
``record_function`` ranges named ``bench.*``, times the sampler on the
host clock, and while ``recording`` is on notes each call's shapes for
the operation and byte counts.  A decode step's lengths are read from the
host arrays the engine made its input tensors from, so the probe adds no
copy from the card.  An untraced run installs nothing.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["Probe", "ClosedLoop", "Record"]


def _range(name: str):
    return torch.autograd.profiler.record_function(name)


class Probe:
    """Ranges, the sampler's host time and the shapes of every call."""

    def __init__(self, model, engine, page_size: int) -> None:
        import repro_torch.runtime.serve_loop as serve_loop
        from repro_torch.kernels.flash_attention import ops as fa_ops

        self.page_size = page_size
        self.recording = False
        self.decode_lens: List[List[int]] = []   # live lanes' rows, a step
        self.prefills: List[tuple] = []          # (tokens, start)
        self.k2_calls: List[tuple] = []          # (sq, sk, offset, causal, window)
        self.sampler_s = 0.0
        self._host: Dict[int, object] = {}      # id(tensor) -> its array
        self._undo: List[Callable] = []

        def patch(owner, name, wrapper):
            orig = getattr(owner, name)
            wrapped = functools.wraps(orig)(wrapper(orig))
            own = name in vars(owner)       # not a method of its class

            def undo():
                # a counter kept on the function (``launches``) carries on
                vars(orig).update(vars(wrapped))
                vars(orig).pop("__wrapped__", None)
                if own:
                    setattr(owner, name, orig)
                else:
                    delattr(owner, name)

            setattr(owner, name, wrapped)
            self._undo.append(undo)

        def to_device(orig):
            def run(arr):
                out = orig(arr)
                if self.recording:
                    self._host[id(out)] = arr
                return out
            return run

        def decode(orig):
            def run(pool, tokens, table, pos):
                t, p = self._host.get(id(table)), self._host.get(id(pos))
                self._host.clear()
                if self.recording and t is not None and p is not None:
                    W = t.shape[1]
                    self.decode_lens.append([
                        int(p[b]) + 1 for b in range(t.shape[0])
                        if t[b, 0] >= 0 and p[b] < W * self.page_size])
                with _range("bench.decode"):
                    return orig(pool, tokens, table, pos)
            return run

        def prefill(orig):
            def run(tokens):
                if self.recording:
                    self.prefills.append((int(tokens.shape[1]), 0))
                with _range("bench.prefill"):
                    return orig(tokens)
            return run

        def prefill_at(orig):
            def run(tokens, pool, table, start):
                if self.recording:
                    self.prefills.append((int(tokens.shape[1]), int(start)))
                with _range("bench.prefill_at"):
                    return orig(tokens, pool, table, start)
            return run

        def scatter(orig):
            def run(*args):
                with _range("bench.write_prefill"):
                    return orig(*args)
            return run

        def flash(orig):
            def run(qg, k, v, **kw):
                if self.recording:
                    self.k2_calls.append((
                        int(qg.shape[1]), int(k.shape[1]),
                        int(kw.get("q_offset", 0)), bool(kw.get("causal", True)),
                        int(kw.get("window", 0))))
                return orig(qg, k, v, **kw)
            return run

        def sampler(orig):
            def run(*args, **kw):
                t = time.perf_counter()
                with _range("bench.sample"):
                    out = orig(*args, **kw)
                if self.recording:
                    self.sampler_s += time.perf_counter() - t
                return out
            return run

        patch(engine, "_tensor", to_device)
        patch(model, "paged_decode_step", decode)
        patch(model, "paged_prefill", prefill)
        patch(model, "paged_prefill_at", prefill_at)
        patch(model, "paged_write_prefill", scatter)
        patch(fa_ops, "flash_attention", flash)
        patch(serve_loop, "sample_token", sampler)

    def close(self) -> None:
        while self._undo:
            self._undo.pop()()


@dataclass
class Record:
    """What one client saw of one request."""
    client: int
    request: object
    sent: float
    token_times: List[float] = field(default_factory=list)
    done: Optional[float] = None


class ClosedLoop:
    """``clients`` clients over one ``Server``, fed from a ``Traffic``."""

    def __init__(self, server, traffic, request_cls, *, ranges: bool = False,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        self.server = server
        self.traffic = traffic
        self.request_cls = request_cls
        self.ranges = ranges
        self.clock = clock
        self.inflight: Dict[int, Record] = {}
        self.records: List[Record] = []
        self.sending = True
        self.steps = 0

    def _send(self, client: int) -> None:
        spec = self.traffic.next(client)
        r = self.request_cls(
            prompt=spec.prompt, max_new_tokens=spec.max_new_tokens,
            request_id=spec.index)
        rec = Record(client, r, sent=self.clock())
        self.records.append(rec)
        self.inflight[spec.index] = rec
        self.server.submit(r)
        if r.done:                         # denied on the spot
            rec.done = self.clock()
            del self.inflight[spec.index]

    def start(self) -> None:
        for c in range(self.traffic.clients):
            self._send(c)

    def step(self) -> None:
        if self.ranges:
            with _range("bench.step"):
                self.server.step()
        else:
            self.server.step()
        t = self.clock()
        self.steps += 1
        finished = []
        for rid, rec in self.inflight.items():
            r = rec.request
            n = len(r.tokens)
            while len(rec.token_times) < n:
                rec.token_times.append(t)
            if r.done:
                rec.done = t
                finished.append(rid)
        for rid in finished:
            rec = self.inflight.pop(rid)
            if self.sending:
                self._send(rec.client)

    def run(self, *, steps: Optional[int] = None,
            until: Optional[float] = None) -> None:
        """``steps`` steps, or steps until the clock passes ``until``."""
        if steps is not None:
            for _ in range(steps):
                self.step()
            return
        while self.clock() < until:
            self.step()

    def finished_in(self, w0: float, w1: float) -> List[Record]:
        return [r for r in self.records
                if r.done is not None and w0 <= r.done < w1]
