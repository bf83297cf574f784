"""Where a traced benchmark run's host time goes, by the serving engine's
spans.

    python3 experiments/engine_spans.py --workload <cell> --seed <n> \
        [--seconds 51] [--out experiments/engine_spans_out]

One traced run of a cell of ``BENCHMARK.json`` (``perfbench.bench``'s
``run_cell``, on the card), and beside its result line:

* ``spans``: each span's count and host ms a decode step over the window,
  from ``serving_stats()["spans"]`` at the window's two ends, and
  ``step_cover``: ``engine.step``'s seconds over the window's;
* ``idle_by_span``: the profiled stretch's idle device seconds, each gap
  named by the innermost program span the host was in at its middle
  (``host outside the engine`` when none), with ``stretch_cover``:
  ``engine.step``'s share of the stretch;
* ``shadows``: device-side events that carry a program span's name, and
  how many of them the profiler marks as a user annotation (the
  benchmark's trace reduction skips those).

The result line goes to standard output, the whole record to
``<out>/<cell>-<seed>.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PREFIXES = ("engine.", "arena.", "model.", "sampler")


def _is_span(name: str) -> bool:
    return name.startswith(PREFIXES)


def idle_by_span(prof) -> dict:
    """The stretch's idle device time named by the innermost program
    span, read off the same events ``perfbench.trace`` reduces."""
    import torch
    from perfbench.trace import _union

    cpu = torch.autograd.DeviceType.CPU
    device, spans, shadows = [], [], defaultdict(lambda: [0, 0])
    window = None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type != cpu:
            flagged = bool(getattr(e, "is_user_annotation", False))
            if _is_span(e.name):
                shadows[e.name][0] += 1
                shadows[e.name][1] += flagged
            if flagged or e.name.startswith("bench."):
                continue
            if b > a:
                device.append((a, b))
        elif e.name == "bench.window":
            window = (a, b)
        elif _is_span(e.name):
            spans.append((a, b, e.name))
    w0, w1 = window
    busy = _union([(max(a, w0), min(b, w1)) for a, b in device
                   if b > w0 and a < w1])
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = defaultdict(float)
    spans.sort()
    active, i = [], 0
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        while i < len(spans) and spans[i][0] <= mid:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] >= mid]
        name = (min(active, key=lambda s: s[1] - s[0])[2] if active
                else "host outside the engine")
        gaps[name] += (g1 - g0) * 1e-6
    steps = _union([(max(a, w0), min(b, w1)) for a, b, n in spans
                    if n == "engine.step" and b > w0 and a < w1])
    return {
        "stretch_s": (w1 - w0) * 1e-6,
        "idle_s": sum(gaps.values()),
        "stretch_cover": sum(b - a for a, b in steps) / (w1 - w0),
        "idle_by_span": dict(sorted(gaps.items(), key=lambda kv: -kv[1])),
        "shadows": {k: {"events": v[0], "user_annotation": v[1]}
                    for k, v in shadows.items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default=str(ROOT / "experiments/engine_spans_out"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose BENCHMARK.json names the cell")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import perfbench.run

    perfbench.run._environment()
    import perfbench.trace
    from perfbench.bench import run_cell
    from repro_torch.runtime.serve_loop import ServingEngine

    extra = {}
    reduce = perfbench.trace.reduce_profile

    def reduce_and_name(prof, top=10):
        extra.update(idle_by_span(prof))
        return reduce(prof, top)

    snapshots = []
    stats = ServingEngine.serving_stats

    def snapshot(self):
        snapshots.append(stats(self))
        return snapshots[-1]

    perfbench.trace.reduce_profile = reduce_and_name
    ServingEngine.serving_stats = snapshot
    result = run_cell(Path(args.root), args.workload, args.seed,
                      args.seconds, True, device=args.device)
    s0, s1 = snapshots[0], snapshots[-1]
    steps = s1["decode_steps_total"] - s0["decode_steps_total"]
    per_step = {}
    for name, (n, sec) in sorted(s1["spans"].items()):
        n0, sec0 = s0["spans"].get(name, (0, 0.0))
        per_step[name] = {"count": (n - n0) / steps,
                          "ms": (sec - sec0) / steps * 1e3}
    step_s = s1["spans"]["engine.step"][1] - s0["spans"]["engine.step"][1]
    record = {"workload": args.workload, "seed": args.seed,
              "seconds": args.seconds, "decode_steps": steps,
              "step_cover": step_s / args.seconds, "spans": per_step,
              **extra, "result": result}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{args.workload}-{args.seed}.json").write_text(
        json.dumps(record, indent=1))
    print(json.dumps({k: record[k] for k in (
        "workload", "seed", "decode_steps", "step_cover", "stretch_cover",
        "idle_s", "idle_by_span", "shadows")}), file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
