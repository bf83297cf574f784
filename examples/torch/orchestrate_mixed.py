"""Unified orchestration on the PyTorch port: decode + training + batch on
one worker pool, with metrics-driven elastic autoscaling.

The twin of ``examples/orchestrate_mixed.py``, over ``repro_torch``.  One
:class:`~repro_torch.core.sim.SimExecutor` clock drives a
``ServingEngine`` decoding a stream of requests, a ``TrainStepper``
running optimizer steps as pool tasks and a bag of sandbox-batch jobs,
while an ``ElasticAutoscaler`` scales the fleet through a load spike at
t=0.25 and a node death at t=0.45.  The decisions and task transitions
follow the virtual clock.

    PYTHONPATH=src python examples/torch/orchestrate_mixed.py
    PYTHONPATH=src python examples/torch/orchestrate_mixed.py --reduced --device cpu

On the card by default: gemma2-9b at its published widths, 2 of 42
layers, serves and trains; ``--reduced`` takes its reduced config.
"""

import argparse
import dataclasses
import random

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core import ServerlessScheduler, SimExecutor
from repro_torch.core.tasks import checkpoint
from repro_torch.data import DataConfig, Loader, SyntheticLM
from repro_torch.models import build_model
from repro_torch.runtime import (ElasticAutoscaler, Request, ServingEngine,
                                 Trainer, TrainerConfig, WorkloadOrchestrator)
from repro_torch.runtime.elastic import AutoscalerConfig
from repro_torch.runtime.serve_loop import ServerConfig


def config(arch: str, reduced: bool):
    """The reduced config, or the published widths at 2 layers."""
    if reduced:
        return get_reduced(arch)
    return dataclasses.replace(get_config(arch), num_layers=2)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    sim = SimExecutor(seed=42)
    rng = random.Random(7)

    # --- serving plane: a model decoding on the shared pool ---------------
    scfg = config("gemma2-9b", args.reduced)
    smodel = build_model(scfg, device=args.device)
    smodel.init(torch.Generator(smodel.device).manual_seed(0))
    engine = ServingEngine(
        smodel, ServerConfig(max_batch=3, max_seq=48, step_time_s=0.01),
        executor=sim)

    def req(i, n=4):
        prompt = np.asarray([rng.randrange(scfg.vocab_size)
                             for _ in range(4)], np.int32)
        return Request(prompt=prompt, max_new_tokens=n, request_id=i)

    # --- training plane: a real TrainStepper as pool tasks -----------------
    tcfg = config("gemma2-9b", args.reduced)
    dc = DataConfig(global_batch=4, seq_len=16, vocab_size=tcfg.vocab_size)
    trainer = Trainer(build_model(tcfg, device=args.device),
                      Loader(SyntheticLM(dc), dc),
                      TrainerConfig(total_steps=6, log_every=2,
                                    ckpt_every=100))
    params, opt = trainer.init_state(0)
    stepper = trainer.stepper(params, opt)

    # --- the shared pool + autoscaler + orchestrator -----------------------
    sched = ServerlessScheduler(workers=2, executor=sim)
    sched.enable_heartbeats(timeout_s=0.3, replace_dead=True)
    sched.start()
    auto = ElasticAutoscaler(sched, serving=engine, cfg=AutoscalerConfig(
        min_workers=1, max_workers=6, queue_high=3, idle_ticks=4,
        cooldown_ticks=2))
    orch = WorkloadOrchestrator(sched, serving=engine, stepper=stepper,
                                autoscaler=auto)

    def batch_body(sleeps=4):
        def body():
            for _ in range(sleeps):
                checkpoint()            # cooperative preemption point
                sim.sleep(0.01)
            return sleeps

        return body

    for i in range(4):
        engine.submit(req(i))
    jobs = [orch.submit_batch(batch_body(), name=f"steady{i}")
            for i in range(2)]

    def spike():
        print(f"[t={sim.now():.2f}] LOAD SPIKE: +6 requests, +4 jobs")
        for i in range(100, 106):
            engine.submit(req(i))
        for i in range(4):
            jobs.append(orch.submit_batch(batch_body(6), name=f"spike{i}"))

    sim.call_at(0.25, spike)

    def node_death():
        print(f"[t={sim.now():.2f}] NODE DEATH: killing w0")
        sim.kill("w0")

    sim.call_at(0.45, node_death)

    for k in range(200):
        sim.call_at(0.02 * k + 0.005, orch.tick)
    for k in range(1, 80):
        sim.call_at(0.05 * k, sched.check_heartbeats)
    sim.run()
    orch.tick()
    sched.drain(timeout=120)
    sim.run()

    # --- report -------------------------------------------------------------
    print(f"\n[t={sim.now():.2f}] drained ({scfg.arch_id}, "
          f"{scfg.num_layers} layers, on {smodel.device})")
    print(f"  decode   : {len(engine.completed)} requests completed")
    print(f"  training : {stepper.step} steps"
          f" (loss {trainer.metrics_log[-1]['loss']:.4f})")
    print(f"  batch    : {sum(1 for j in jobs if j.state == 'done')}"
          f"/{len(jobs)} jobs done,"
          f" {orch.preemptions_total} preemptions for decode")
    print("\nautoscaler decisions (scale events only):")
    for d in auto.decisions:
        if d.action != "hold":
            print(f"  t={d.t:5.2f}  {d.action:18s} {d.reason:22s}"
                  f" queue={d.queue_depth:3d} workers={d.workers}")
    st = auto.elastic_stats()
    print(f"\nfleet: {st['workers_active']} active workers"
          f" (scaled up {st['scale_up_total']}x,"
          f" down {st['scale_down_total']}x);"
          f" pool healthy={st['pool_healthy']}")
    assert all(j.state == "done" for j in jobs)
    assert stepper.done()
    trainer.loader.stop()


if __name__ == "__main__":
    main()
