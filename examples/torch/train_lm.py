"""Training on the PyTorch port with fault injection: a worker dies
mid-run and the trainer restarts from the latest SELF checkpoint.

The twin of ``examples/train_lm.py``, over ``repro_torch``.

    PYTHONPATH=src python examples/torch/train_lm.py [--arch rwkv6-3b]
    PYTHONPATH=src python examples/torch/train_lm.py --reduced --device cpu

On the card by default: the arch at its published widths, 2 layers;
``--reduced`` takes its reduced config and 20 steps (60 by default).
"""

import argparse
import dataclasses
import tempfile

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core.gofer import Gofer
from repro_torch.data import DataConfig, Loader, SyntheticLM
from repro_torch.models import build_model
from repro_torch.optim import ScheduleConfig
from repro_torch.runtime import (FailureInjector, HeartbeatMonitor,
                                 StragglerDetector, Trainer, TrainerConfig)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="hymba-1.5b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    steps = args.steps or (20 if args.reduced else 60)

    cfg = get_reduced(args.arch) if args.reduced else dataclasses.replace(
        get_config(args.arch), num_layers=2)
    model = build_model(cfg, device=args.device)
    dc = DataConfig(global_batch=8, seq_len=32, vocab_size=cfg.vocab_size)
    loader = Loader(SyntheticLM(dc), dc)
    ckpt = CheckpointManager(
        Gofer.for_root("ckpt", tempfile.mkdtemp(), write=True))
    trainer = Trainer(
        model, loader,
        TrainerConfig(total_steps=steps, log_every=10,
                      ckpt_every=max(steps // 3, 1),
                      schedule=ScheduleConfig(peak_lr=3e-3, warmup_steps=10)),
        ckpt=ckpt,
        monitor=HeartbeatMonitor([f"host{i}" for i in range(4)]),
        stragglers=StragglerDetector(),
        injector=FailureInjector(fail_at={steps // 2: ["host2"]}),
    )
    params, opt = trainer.init_state(0)
    params, opt = trainer.run(params, opt)
    loader.stop()
    for m in trainer.metrics_log:
        print(f"  step {m['step']:3d}  loss {m['loss']:.4f}")
    print(f"{cfg.arch_id} ({cfg.num_layers} layers) on {model.device}: "
          f"worker failure at step {steps // 2} -> "
          f"{trainer.restarts} restart(s) from checkpoint; "
          f"final checkpoints: {ckpt.all_steps()}")


if __name__ == "__main__":
    main()
