"""Sharded serving on the PyTorch port: tensor-parallel decode +
data-parallel replicas.

The twin of ``examples/serve_sharded.py``, over ``repro_torch``.  A
serving mesh is N shard worker processes in one process group
(``repro_torch.launch.mesh``): on the CPU, host slots; on the card, N
ranks on ``cuda:0`` over gloo (one card: the ranks time-share it, so
this shows the path, not a parallel speed).

1. **Tensor parallel**: one engine whose attention weights and KV page
   pool are split over a 4-rank ``("model",)`` mesh; every decode step
   runs the paged-attention kernel on each rank's heads and sums the wo
   products.
2. **DP x TP**: a ``ReplicaSet`` of two engines, each TP-2 over its own
   mesh, behind tenant-sticky routing.  Mid-run a mesh member under
   replica 0 dies silently; the heartbeat monitor reaps it on the
   executor's virtual clock and every stranded request re-homes to
   replica 1 and completes.

    PYTHONPATH=src python examples/torch/serve_sharded.py
    PYTHONPATH=src python examples/torch/serve_sharded.py --reduced --device cpu

The model: qwen2.5-32b's reduced config with 4 q over 4 kv heads of 16
(the stock reduced config has one kv head, which no mesh splits) with
``--reduced``; its published widths (40 q / 8 kv heads of 128, which 2
and 4 ranks divide), 2 of 64 layers, by default.  Workers are spawned
and import this file again: the ``__main__`` guard below is required.
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core import SimExecutor
from repro_torch.launch.mesh import make_serving_mesh, simulate_host_devices
from repro_torch.models import build_model
from repro_torch.runtime import Request, ServingEngine
from repro_torch.runtime.replica import ReplicaSet
from repro_torch.runtime.serve_loop import ServerConfig


def tp_model(args):
    if args.reduced:
        cfg = dataclasses.replace(get_reduced("qwen2.5-32b"), num_heads=4,
                                  num_kv_heads=4, head_dim=16)
    else:
        cfg = dataclasses.replace(get_config("qwen2.5-32b"), num_layers=2)
    model = build_model(cfg, device=args.device)
    model.init(torch.Generator(model.device).manual_seed(0))
    return cfg, model


def mesh(args, n, offset=0):
    """``n`` ranks: host slots from ``offset`` on the CPU, else ``n``
    ranks on the model's card."""
    if torch.device(args.device).type == "cpu":
        return make_serving_mesh(n, offset=offset)
    return make_serving_mesh([args.device] * n)


def requests(vocab, n, *, tenants=("alice",), seed=0, base_id=0):
    rng = np.random.default_rng(seed)
    return [Request(
        prompt=rng.integers(0, vocab, (8,)).astype(np.int32),
        max_new_tokens=6, request_id=base_id + i,
        tenant=tenants[i % len(tenants)],
    ) for i in range(n)]


def demo_tensor_parallel(args):
    cfg, model = tp_model(args)
    m = mesh(args, 4)
    try:
        engine = ServingEngine(
            model, ServerConfig(max_batch=2, max_seq=48, kv_mode="paged"),
            mesh=m)
        reqs = requests(cfg.vocab_size, 4)
        for r in reqs:
            engine.submit(r)
        engine.drain()
        stats = engine.serving_stats()
        print(f"[tp] {len(reqs)} requests over {stats['tp_shards']} shards "
              f"({cfg.arch_id} on {model.device}): "
              f"{sum(stats['completed_total'].values())} completed, "
              f"0 errors = {all(r.error is None for r in reqs)}")
        assert engine.kv.shard_stats()["live_pages_per_shard"] == 0
    finally:
        m.close()


def demo_dp_times_tp(args):
    cfg, model = tp_model(args)
    sim = SimExecutor(seed=0)
    meshes = [mesh(args, 2, offset=i * 2) for i in range(2)]
    try:
        replicas = [ServingEngine(
            model, ServerConfig(max_batch=2, max_seq=48, kv_mode="paged",
                                step_time_s=0.01),
            executor=sim, mesh=m) for m in meshes]
        rs = ReplicaSet(replicas, heartbeat_timeout_s=0.05)

        reqs = requests(cfg.vocab_size, 8,
                        tenants=("alice", "bob", "carol"), seed=1)
        for r in reqs:
            rs.submit(r)
        homes = {t: rs.route(t) for t in ("alice", "bob", "carol")}
        print(f"[dp] tenant homes: {homes}")

        for _ in range(3):                         # a few steps of progress
            rs.step()
            sim.sleep(rs.step_time_s)
        rs.kill_mesh_member(0)                     # silent device death
        rs.drain()

        st = rs.replica_stats()
        print(f"[dp] mesh member died: heartbeat reaps="
              f"{st['heartbeat_reaps']}, re-homed={st['rehomed_total']}, "
              f"orphaned={st['orphaned']}")
        print(f"[dp] all {len(reqs)} requests completed: "
              f"{all(r.done and r.error is None for r in reqs)}")
        for i, p in enumerate(st["per_replica"]):
            print(f"     replica {i}: alive={p['alive']} "
                  f"tp_shards={p['tp_shards']} completed={p['completed']} "
                  f"live_pages={p['live_pages']}")
    finally:
        for m in meshes:
            m.close()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    simulate_host_devices(4)
    demo_tensor_parallel(args)
    demo_dp_times_tp(args)
