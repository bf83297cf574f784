"""One run of one cell: set-up, the measured window, the per-layer
readings of a traced run, and the comparison that decides ``correct``.

``run_cell`` returns the result line as a dict.  ``perfbench/run.py`` is
the command; tests call ``run_cell`` on the CPU with small files of their
own.
"""

from __future__ import annotations

import gc
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict

__all__ = ["FORBIDDEN", "PAGE", "PROFILE_SECONDS", "NoChip",
           "ForbiddenModules", "forbidden_modules", "cpu_seconds",
           "seconds_since_start", "run_cell"]

#: top-level module names no process of the benchmark may hold: JAX and
#: the JAX package the port was made from (compared whole: ``repro_torch``
#: is not ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: tokens a KV page holds: the engine's default
PAGE = 16

#: the traced run profiles the last this many seconds of its window (at
#: most half of it), so the profiler's stop falls after the window
PROFILE_SECONDS = 6.0


class NoChip(RuntimeError):
    """The cell asks for more CUDA devices than this machine has."""


class ForbiddenModules(RuntimeError):
    """JAX or the JAX package was loaded."""


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def seconds_since_start() -> float:
    """Seconds since this process started (from ``/proc``; the clock of
    boot time, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def cpu_seconds() -> float:
    """This process's CPU seconds, all threads.  Over the window, beside
    its steps, it tells a run that did more host work from one whose
    host ran the same work slower."""
    t = os.times()
    return t.user + t.system


def _start_profiler_once(device: str) -> None:
    """The first profiler of a process spends seconds starting its device
    tracing: pay that in set-up, not inside the profiled stretch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts):
        torch.ones(8, device=device).sum().item()


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda", control: bool = False,
             log: Callable[[str], None] = _log) -> Dict:
    """One run of ``workload``; ``control``: also read the control (the
    reference in fp8 put in the program's place) on the same streams, for
    setting the limit (``perfbench/calibrate.py``); the benchmark's own
    runs never do."""
    import torch

    from perfbench import correct, costs, weights
    from perfbench.loop import ClosedLoop, Probe
    from perfbench.manifest import Manifest
    from perfbench.stats import summarize
    from perfbench.trace import reduce_profile
    from perfbench.traffic import Traffic, pool_pages

    man = Manifest(root)
    cell = man.cell(workload)
    cfgfile, mix, checks = man.config(cell), man.traffic(cell), man.checks(cell)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoChip("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell["chips"]:
            raise NoChip(f"{cell['name']} needs {cell['chips']} CUDA devices, "
                         f"{torch.cuda.device_count()} present")
        torch.cuda.reset_peak_memory_stats()

    from repro_torch.models import build_model
    from repro_torch.models.common import ArchConfig, torch_dtype
    from repro_torch.runtime.serve_loop import Request, Server, ServerConfig

    port = cfgfile["port"]
    arch = ArchConfig(**port)
    refmod = man.reference(cfgfile)
    specs = refmod.leaf_specs(port)
    served = torch_dtype(arch.dtype)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    model = build_model(arch, device=device)
    weights.fill(dict(model.named_parameters()), specs, seed, arch.num_layers)
    traffic = Traffic(mix, seed, arch.vocab_size)
    longest = traffic.max_prompt + traffic.max_output
    server = Server(model, ServerConfig(
        max_batch=traffic.clients, max_seq=longest, tokens_per_page=PAGE,
        kv_mode="paged",
        kv_pool_pages=pool_pages(traffic.clients, longest, PAGE)))
    engine = server.engine
    probe = Probe(model, engine, PAGE) if trace else None
    loop = ClosedLoop(server, traffic, Request, ranges=trace)

    if trace:
        _start_profiler_once(device)
    loop.start()
    loop.run(steps=int(mix["warmup_steps"]))
    sync()
    w0 = loop.clock()
    setup_s = seconds_since_start()
    cpu0 = cpu_seconds()
    w1 = w0 + seconds
    p0 = w1                 # where the profiled stretch starts
    stats0 = engine.serving_stats()
    prof_summary = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        loop.run(until=w1 - min(PROFILE_SECONDS, 0.5 * seconds))
        p0 = loop.clock()
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function("bench.window"):
                sync()
                probe.recording = True
                stretch0 = engine.admit_wait_snapshot()
                # the stretch starts once the profiler runs: starting it
                # takes the host a while
                loop.run(until=w1)
                cpu1 = cpu_seconds()
                sync()
                probe.recording = False
                stretch1 = engine.admit_wait_snapshot()
        t_red = time.perf_counter()
        prof_summary = reduce_profile(prof)
        del prof
        log(f"[trace] profiled {prof_summary['window_s']:.3f} s, reduced in "
            f"{time.perf_counter() - t_red:.1f} s")
    else:
        loop.run(until=w1)
        cpu1 = cpu_seconds()
    loop.sending = False
    stats1 = engine.serving_stats()
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"modules loaded: {', '.join(found)}")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    e2e = summarize(((r.sent, r.token_times) for r in loop.records), w0, w1)
    # what the clients saw before the profiler started, for the readers
    unprofiled = summarize(((r.sent, r.token_times) for r in loop.records),
                           w0, p0)
    done = loop.finished_in(w0, w1)
    attempted = len(done)
    failed = sum(r.request.error is not None for r in done)
    metrics: Dict[str, Dict] = {}
    wanted = man.metrics_for(cell, traced=trace)
    if not trace:
        values = dict(e2e, setup_s=setup_s)
        for m in wanted:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx = {
            "config": port, "mix": mix, "cell": cell, "page_size": PAGE,
            "window_s": seconds, "e2e": unprofiled, "stats0": stats0,
            "stats1": stats1, "admit0": stretch0, "admit1": stretch1,
            "profile": prof_summary, "costs": costs,
            "decode_lens": probe.decode_lens, "prefills": probe.prefills,
            "k2_calls": probe.k2_calls, "sampler_s": probe.sampler_s,
        }
        for m in wanted:
            v = man.reader(m).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    log(f"[window] {cell['name']} seed {seed}: {seconds} s, "
        f"{e2e['tokens']} tokens, {e2e['ttft_samples']} first tokens, "
        f"{e2e['itl_samples']} gaps, {attempted} requests finished, "
        f"{failed} failed, {loop.steps} steps in all; setup {setup_s:.3f} s; "
        f"output_tok_s {e2e['output_tok_s']}, ttft_p90_ms "
        f"{e2e['ttft_p90_ms']}, itl_p95_ms {e2e['itl_p95_ms']}"
        + ("" if p0 >= w1 else f" (before the profiled stretch: "
           f"{p0 - w0:.3f} s, itl_p95_ms {unprofiled['itl_p95_ms']})"))
    log(f"[host] in the window: cpu {cpu1 - cpu0:.3f} s")

    # ------------------------------------------------ the comparison
    picked = correct.sample(done, seed, int(mix["check_requests"]))
    if probe is not None:
        probe.close()
    server.close()
    loop.server = engine = server = model = probe = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        log(f"[check] {torch.cuda.memory_allocated() / 2**30:.2f} GiB held "
            "by the process once the program is freed")
    t_ref = time.perf_counter()
    gap = control_gap = None
    if picked:
        def draw(name, layer):
            return weights.draw(seed, name, layer, specs[name], device, served)

        toks, rows, served_toks = correct.streams(
            [r.request for r in picked], device)
        ref_logits = refmod.Reference(port, draw, device).logits(toks, rows)
        gap = float(correct.gaps_of_tokens(ref_logits, served_toks).max())
        if control:
            fp8 = refmod.Reference(port, draw, device, precision="fp8")
            control_gap = float(correct.gaps_of_argmax(
                ref_logits, fp8.logits(toks, rows)).max())
        del ref_logits
    limit = float(checks["token_gap"]["limit"])
    ok = gap is not None and gap <= limit and failed == 0
    log(f"[check] {len(picked)} requests, "
        f"{sum(len(r.request.tokens) for r in picked)} served tokens, "
        f"reference {time.perf_counter() - t_ref:.1f} s")
    result = {
        "correct": bool(ok),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device == "cuda" else device,
            "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                     else "cpu"),
            "count": cell["chips"] if device == "cuda" else 0,
            "memory_peak_bytes": int(peak),
        },
    }
    if prof_summary is not None:
        result["device"]["busy_s"] = prof_summary["busy_s"]
        result["device"]["window_s"] = prof_summary["window_s"]
        result["breakdown"] = {"device_ops": prof_summary["device_ops"],
                               "idle_gaps": prof_summary["idle_gaps"]}
    if control:
        result["control"] = {"token_gap": control_gap}
    result["checks"] = {"token_gap": {
        "value": gap, "limit": limit,
        "requests": len(picked),
        "tokens": sum(len(r.request.tokens) for r in picked)}}
    return result
