"""Quickstart on the PyTorch port: build an architecture, train,
checkpoint, restore, decode.

The twin of ``examples/quickstart.py``, over ``repro_torch``.

    PYTHONPATH=src python examples/torch/quickstart.py
    PYTHONPATH=src python examples/torch/quickstart.py --reduced --device cpu

On the card by default: gemma2-9b at its published widths, 2 of 42
layers; ``--reduced`` takes its reduced config.
"""

import argparse
import dataclasses
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.gofer import Gofer
from repro_torch.data import DataConfig, Loader, SyntheticLM
from repro_torch.models import build_model
from repro_torch.optim import ScheduleConfig
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma2-9b")   # any of the 10
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    cfg = get_reduced(args.arch) if args.reduced else dataclasses.replace(
        get_config(args.arch), num_layers=2)
    model = build_model(cfg, device=args.device)
    print(f"arch={cfg.arch_id}  params={cfg.param_count():,}  "
          f"layers={cfg.num_layers}  device={model.device}")

    # --- train a few steps on the synthetic pipeline -----------------------
    dc = DataConfig(global_batch=8, seq_len=32, vocab_size=cfg.vocab_size)
    loader = Loader(SyntheticLM(dc), dc)
    ckpt = CheckpointManager(
        Gofer.for_root("ckpt", tempfile.mkdtemp(), write=True))
    trainer = Trainer(
        model, loader,
        TrainerConfig(total_steps=30, log_every=10, ckpt_every=15,
                      schedule=ScheduleConfig(peak_lr=3e-3, warmup_steps=5)),
        ckpt=ckpt,
    )
    params, opt = trainer.init_state(0)
    params, opt = trainer.run(params, opt)
    loader.stop()
    for m in trainer.metrics_log:
        print(f"  step {m['step']:3d}  loss {m['loss']:.4f}")

    # --- restore from the SELF checkpoint (paper §IV.B loader) -------------
    step, tree, _ = ckpt.restore_latest({"params": params, "opt": opt},
                                        device=model.device)
    print(f"restored step {step} from SELF checkpoint")

    # --- greedy decode with the restored weights ---------------------------
    # (``params`` are views of the module's weights: the model serves them)
    with torch.no_grad():
        for t, saved in zip(tree_leaves(params), tree_leaves(tree["params"])):
            t.copy_(saved)
    prompt = torch.tensor([[5, 17, 40, 2]], dtype=torch.int32,
                          device=model.device)
    state, logits = model.prefill(prompt, max_seq=16)
    out = []
    tok = torch.argmax(logits, -1).to(torch.int32)
    for _ in range(8):
        state, logits = model.decode_step(state, tok)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out.append(int(tok[0]))
    print("decoded:", out)


if __name__ == "__main__":
    main()
