"""Reduce one ``torch.profiler`` window to what the metric readers read.

Kept in memory: the profile is never written out.  Device time is taken
from the device-side events (kernels, copies, sets) by their own
intervals; a ``bench.*`` range's device time is the time of the kernels
that the ops inside it launched, as the profiler links them.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import torch

__all__ = ["kernel_seconds", "reduce_profile"]

_CPU = torch.autograd.DeviceType.CPU


def _range_kernels_us(event) -> float:
    total = sum(k.duration for k in event.kernels)
    for child in event.cpu_children:
        total += _range_kernels_us(child)
    return total


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_profile(prof, top: int = 10) -> Dict:
    """Busy and window seconds, device seconds by kernel name, device
    seconds and count of every ``bench.*`` range (its kernels' time), and
    the longest idle gaps by the innermost ``bench.*`` range the host was
    in."""
    events = prof.events()
    device: List[Tuple[float, float]] = []
    by_kernel: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    ranges: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    spans: List[Tuple[float, float, str]] = []
    window = None
    for e in events:
        if e.device_type != _CPU:
            if getattr(e, "is_user_annotation", False) or \
                    e.name.startswith("bench."):
                continue            # a range's shadow on the device: no work
            a, b = e.time_range.start, e.time_range.end
            if b > a:
                device.append((a, b))
                k = by_kernel[e.name]
                k[0] += (b - a) * 1e-6
                k[1] += 1
            continue
        if not e.name.startswith("bench."):
            continue
        if e.name == "bench.window":
            window = (e.time_range.start, e.time_range.end)
            continue
        r = ranges[e.name]
        r[0] += _range_kernels_us(e) * 1e-6
        r[1] += 1
        spans.append((e.time_range.start, e.time_range.end, e.name))
    if window is None:
        raise RuntimeError("profile has no bench.window range")
    w0, w1 = window
    busy = _union([(max(a, w0), min(b, w1)) for a, b in device
                   if b > w0 and a < w1])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    # idle gaps inside the window, named by the innermost host range
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    spans.sort()
    active: List[Tuple[float, float, str]] = []
    i = 0
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        while i < len(spans) and spans[i][0] <= mid:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] >= mid]
        name = (min(active, key=lambda s: s[1] - s[0])[2] if active
                else "host outside bench ranges")
        gaps[name] += (g1 - g0) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_s,
        "kernels": {k: (v[0], int(v[1])) for k, v in by_kernel.items()},
        "ranges": {k: (v[0], int(v[1])) for k, v in ranges.items()},
        "device_ops": sorted(([k, v[0]] for k, v in by_kernel.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:top],
    }


def kernel_seconds(profile: Dict, *substrings: str) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds any of
    ``substrings``."""
    s, n = 0.0, 0
    for name, (sec, count) in profile["kernels"].items():
        if any(x in name for x in substrings):
            s += sec
            n += count
    return s, n

