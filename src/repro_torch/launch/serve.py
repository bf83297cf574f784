"""Serving launcher: continuous batching over the KV arena, in PyTorch.

The counterpart of ``repro.launch.serve``: it serves through
:class:`~repro_torch.runtime.Server` (warm postprocess sandbox pool,
optional concurrent postprocess workers, ``/metrics``), with the
reference's flags plus ``--device`` (default ``cuda``; CUDA asked for and
absent is an error, never a silent CPU run).  Weights are random,
drawn on the device from ``torch.Generator(device).manual_seed(0)``.  By
default (``--kv-mode auto``) the engine picks its mode: paged for the
dense and MoE transformers that can decode from pages (``--arch
qwen3-moe-235b-a22b``), dense per-slot state for those with sliding
windows or a softcap (``--arch gemma2-9b``, ``--arch
llama4-scout-17b-a16e``), for RWKV (``--arch rwkv6-3b``) and for the
hybrid (``--arch hymba-1.5b``); the VLM serves text in paged mode
(``--arch llava-next-34b``: the engine passes no patch embeddings, as the
reference's passes none), and the enc-dec model fails on its first
prefill, since the engine passes it no frames (``--arch whisper-tiny``,
as the reference's launcher fails); ``--no-incremental`` runs the
rebatching baseline (dense).

Examples (full size on the card; ``--reduced --device cpu`` for the smoke
config on the CPU; ``--workers 2 --pool-watermark 1 --metrics-port 0``
for the concurrent postprocess plane, its warm pool and an ephemeral
``/metrics`` endpoint)::

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen2.5-32b --requests 8 --max-seq 256 --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch gemma2-9b --requests 8 --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch rwkv6-3b --requests 8 --device cuda
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core.tasks import TenantQuota
from repro_torch.models import build_model
from repro_torch.models.common import resolve_device
from repro_torch.runtime import Request, Server, ServerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2.5-32b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--legacy-arena", action="store_true",
                    help="A/B: run the KV arena under the paper's buggy "
                         "legacy allocator")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve Prometheus text metrics on "
                         "http://127.0.0.1:PORT/metrics (0 = ephemeral)")
    ap.add_argument("--pool-watermark", type=int, default=0,
                    help="keep this many warm postprocess sandboxes via "
                         "the background refiller (0 = off)")
    ap.add_argument("--workers", type=int, default=0,
                    help="run request post-processors on this many "
                         "concurrent scheduler workers (0 = inline)")
    ap.add_argument("--heartbeat-timeout", type=float, default=0.0,
                    metavar="SECONDS",
                    help="reap postprocess workers silent this long "
                         "mid-task; their task requeues exactly once and "
                         "a replacement worker is spawned (0 = off; "
                         "needs --workers > 0)")
    ap.add_argument("--hold", type=float, default=0.0, metavar="SECONDS",
                    help="keep the process (and /metrics) alive after the "
                         "batch completes, e.g. to scrape it")
    ap.add_argument("--tenant", default="serving", metavar="NAMES",
                    help="comma-separated tenant names assigned to the "
                         "requests round-robin")
    ap.add_argument("--quota", type=int, default=0, metavar="SLOTS",
                    help="cap each tenant at this many concurrent decode "
                         "slots (0 = uncapped)")
    ap.add_argument("--deadline", type=float, default=None, metavar="SECONDS",
                    help="admit deadline per request")
    ap.add_argument("--no-incremental", action="store_true",
                    help="A/B: run the old rebatching baseline (every "
                         "admit re-prefills the whole batch) instead of "
                         "per-slot incremental prefill")
    ap.add_argument("--kv-mode", default="auto",
                    choices=("auto", "paged", "dense"),
                    help="KV backing store: 'paged' routes decode through "
                         "the paged-attention kernel over the arena's page "
                         "pool; 'dense' keeps the per-slot (batch, max_seq) "
                         "reservation; 'auto' picks paged when the model "
                         "supports it")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="sample from the top K tokens (0 = no cap)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = off)")
    ap.add_argument("--seed", type=int, default=0,
                    help="base sampling seed; request i draws with seed "
                         "base+i")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, device=device)
    model.init(torch.Generator(device).manual_seed(0))
    tenants = [t.strip() for t in args.tenant.split(",") if t.strip()] \
        or ["serving"]
    quotas = (
        {t: TenantQuota(max_tasks_in_flight=args.quota) for t in tenants}
        if args.quota > 0 else None
    )
    srv = Server(model, ServerConfig(
        max_batch=args.max_batch, max_seq=args.max_seq,
        mm_legacy=args.legacy_arena, pool_watermark=args.pool_watermark,
        workers=args.workers, heartbeat_timeout_s=args.heartbeat_timeout,
        incremental=not args.no_incremental, quotas=quotas,
        kv_mode=args.kv_mode,
    ))
    print(f"[serve] device: {device} kv_mode: {srv.engine.kv_mode}")
    if args.metrics_port is not None:
        endpoint = srv.serve_metrics(port=args.metrics_port)
        print(f"[serve] metrics: {endpoint.url}")
    rng = np.random.default_rng(0)
    reqs = [
        Request(
            prompt=rng.integers(0, cfg.vocab_size,
                                (int(rng.integers(4, 12)),)).astype(np.int32),
            max_new_tokens=args.new_tokens, request_id=i,
            tenant=tenants[i % len(tenants)], deadline_s=args.deadline,
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, seed=args.seed + i,
        )
        for i in range(args.requests)
    ]
    try:
        done = srv.run(reqs)
    except BaseException:
        srv.close()
        raise
    for r in sorted(done, key=lambda r: r.request_id):
        status = f"ERROR: {r.error}" if r.error else (
            f"{len(r.tokens)} tokens "
            f"{r.tokens[:8]}{'...' if len(r.tokens) > 8 else ''}"
        )
        print(f"[serve] req {r.request_id} [{r.tenant}]: {status} "
              f"latency {r.latency_s*1e3:.0f}ms")
    print(f"[serve] arena ({'legacy' if args.legacy_arena else 'modern'}): "
          f"{json.dumps(srv.arena_report()['mm_stats'])}")
    stats = srv.engine.serving_stats()
    print(f"[serve] kv pages: allocated={stats['kv_pages_allocated_total']} "
          f"freed={stats['kv_pages_freed_total']} "
          f"sampled={json.dumps(stats['sampled_tokens_total'])} "
          f"prefills={json.dumps(stats['prefill_sequences_total'])}")
    if args.metrics_port is not None:
        pool = {k: v for k, v in srv.dump_metrics().items()
                if k.startswith("seepp_pool")}
        print(f"[serve] pool metrics: {json.dumps(pool)}")
        if args.hold > 0:
            print(f"[serve] holding /metrics open for {args.hold:.0f}s ...")
            time.sleep(args.hold)
    srv.close()


if __name__ == "__main__":
    main()
