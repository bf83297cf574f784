"""Training launcher, in PyTorch.

The counterpart of ``repro.launch.train``: the fault-tolerant trainer with
SELF checkpoints on a synthetic LM stream, with the reference's flags plus
``--device`` (default ``cuda``; CUDA asked for and absent is an error,
never a silent CPU run).  The mesh is ``make_host_mesh()`` over the world
that starts the launcher: under ``torchrun`` a ``(data=world, model=1)``
mesh, each rank training on its rows with its shards of the parameters and
moments (``Trainer(mesh=)``); without it, 1 x 1, one device.  Weights are
random, drawn on the device from ``torch.Generator(device).manual_seed(0)``
(every rank draws the same).  Checkpoints go to ``--ckpt-dir`` (by default
``repro_torch_ckpt`` under the temporary directory), written by rank 0;
``--resume`` restarts from the newest one, whatever mesh saved it.  Rank 0
prints the log.  The enc-dec model fails on its first step: the synthetic
stream carries no encoder frames, as in the reference.

Examples (``--reduced --device cpu`` for the smoke config on the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch gemma2-9b --reduced --device cpu --steps 3 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch gemma2-9b --reduced --steps 100 --global-batch 8 --seq 64
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --arch gemma2-9b --reduced \
        --device cpu --steps 3 --seq 32
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core.gofer import Gofer
from repro_torch.data import DataConfig, Loader, SyntheticLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.optim import ScheduleConfig
from repro_torch.runtime import (
    HeartbeatMonitor,
    StragglerDetector,
    Trainer,
    TrainerConfig,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma2-9b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    mesh = make_host_mesh(device=args.device)
    try:
        _train(args, mesh)
    finally:
        mesh.close()


def _train(args, mesh) -> None:
    device = mesh.device
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, device=device)
    say(f"[train] arch={cfg.arch_id} params≈{cfg.param_count():,} "
        f"device={device} mesh={mesh.shape}")

    dc = DataConfig(global_batch=args.global_batch, seq_len=args.seq,
                    vocab_size=cfg.vocab_size)
    loader = Loader(SyntheticLM(dc), dc)
    ckpt = CheckpointManager(
        Gofer.for_root("ckpt", args.ckpt_dir, write=True), keep=3)
    trainer = Trainer(
        model, loader,
        TrainerConfig(
            total_steps=args.steps, accum_steps=args.accum,
            ckpt_every=args.ckpt_every, log_every=10,
            schedule=ScheduleConfig(peak_lr=args.lr, warmup_steps=20,
                                    decay_steps=args.steps),
        ),
        ckpt=ckpt,
        monitor=HeartbeatMonitor(["host0"]),
        stragglers=StragglerDetector(),
        mesh=mesh,
    )

    params, opt = trainer.init_state(torch.Generator(device).manual_seed(0))
    start = 0
    if args.resume:
        restored = ckpt.restore_latest({"params": params, "opt": opt},
                                       device=device,
                                       shardings=trainer.shardings)
        if restored is not None:
            start, tree, _ = restored
            params, opt = tree["params"], tree["opt"]
            say(f"[train] resumed from step {start}")
    params, opt = trainer.run(params, opt, start_step=start)

    loader.stop()
    for row in trainer.metrics_log:
        say(f"[train] step {row['step']:5d} loss {row['loss']:.4f} "
            f"gnorm {row['gnorm']:.3f} lr {row['lr']:.2e} "
            f"({row['secs']:.2f}s)")
    say(f"[train] done; checkpoints: {ckpt.all_steps()}")


if __name__ == "__main__":
    main()
