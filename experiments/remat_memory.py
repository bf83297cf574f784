#!/usr/bin/env python3
"""A training step's memory under each remat policy, on the card beside
the cost model's count of the same step.

gemma2-9b at its published widths (``chip_smoke.py`` phase 15's cell:
bf16, global batch 4 of 1024 tokens) cut to ``--layers`` depths, each
policy of ``build_model(cfg, remat=)`` stepped once by
``launch.steps.make_train_step`` from seeded weights.  Per (depth,
policy) it prints ``[remat-memory]`` with the card's allocated bytes when
the forward ends (the loss computed, the backward not begun), its peak
over the step (``max_memory_allocated``), the bytes autograd saved for
the backward outside any checkpoint (``saved_tensors_hooks``, distinct
storages), and the cost model's peak of the same step traced on fake CUDA
tensors (``launch.hlo_cost.analyze_graph``).  A depth whose step runs out
of memory says so and the script goes on.  Run from the repository root
on a machine with one NVIDIA GPU::

    python3 experiments/remat_memory.py [--layers 1,2,4] [--policies full,dots,none]
"""

import argparse
import dataclasses
import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

B, S = 4, 1024


def _step(cfg, policy, fake: bool):
    from repro_torch.launch import steps
    from repro_torch.launch.hlo_cost import analyze_graph
    from repro_torch.models import build_model
    from repro_torch.models.common import param_tree
    from repro_torch.optim import ScheduleConfig, adamw_init

    model = build_model(cfg, device="cuda", remat=policy)
    if not fake:
        model.init(torch.Generator("cuda").manual_seed(0))
    params = param_tree(model)
    opt = adamw_init(params)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                              dtype=torch.int32).cuda()
             for k in ("tokens", "targets")}
    step = steps.make_train_step(model, ScheduleConfig(
        peak_lr=3e-3, warmup_steps=1, decay_steps=100))
    if fake:
        cost, _ = analyze_graph(step, (params, opt, batch))
        return {"traced_peak": cost.peak_bytes}
    seen, stores = {}, {}
    real = steps.backward

    def backward(loss, leaves):
        torch.cuda.synchronize()
        seen["forward_end"] = torch.cuda.memory_allocated()
        return real(loss, leaves)

    def pack(t):
        st = t.untyped_storage()
        stores[st._cdata] = st.nbytes()
        return t

    steps.backward = backward
    torch.cuda.reset_peak_memory_stats()
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            step(params, opt, batch)
        torch.cuda.synchronize()
    finally:
        steps.backward = real
    seen["peak"] = torch.cuda.max_memory_allocated()
    seen["saved"] = sum(stores.values())
    return seen


def main(argv=None) -> int:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--layers", default="1,2,4")
    ap.add_argument("--policies", default="full,dots,none")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("remat_memory: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[remat-memory] {torch.cuda.get_device_name(0)}", flush=True)
    for L in map(int, args.layers.split(",")):
        cfg = dataclasses.replace(get_config("gemma2-9b"), num_layers=L)
        for policy in args.policies.split(","):
            with FakeTensorMode(allow_non_fake_inputs=True):
                traced = _step(cfg, policy, fake=True)["traced_peak"]
            try:
                got = _step(cfg, policy, fake=False)
                text = (f"forward end {got['forward_end'] / 1e9:.2f} GB, "
                        f"step peak {got['peak'] / 1e9:.2f} GB, saved "
                        f"outside checkpoints {got['saved'] / 1e9:.2f} GB")
            except torch.OutOfMemoryError:
                text = "out of memory"
            gc.collect()
            torch.cuda.empty_cache()
            print(f"[remat-memory] gemma2-9b x{L} B={B} S={S} bf16 "
                  f"remat={policy}: {text}; traced peak "
                  f"{traced / 1e9:.2f} GB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
