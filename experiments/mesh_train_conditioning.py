#!/usr/bin/env python3
"""How well-conditioned phase 18 (f)'s hymba comparison is, on one card.

``chip_smoke.py`` phase 18 (f) (``[mesh-train-split]``) holds hymba-1.5b at
its published widths, 1 of 32 layers, trained on a (data=1, model=2) mesh
of gloo ranks against one device, batch 2 of 1024 tokens, 3 steps.  This
script runs that comparison several ways, each one device against a
mesh from the same seeded weights and batches:

1. fp32 on (1, 2) at peak lr 3e-3: the split over ``model`` with no bf16
   rounding, which should agree to fp32 noise;
2. bf16 on (2, 1) at 3e-3 and at 1e-3: only the batch split over
   ``data``, no split over ``model``: how far bf16 rounding alone moves
   the curve there (the control);
3. bf16 on (1, 2) at 3e-3 and at 1e-3, the split, phase 18 (f)'s layout
   (1e-3 is the learning rate it runs at);
4. the same with the ``model`` sums (``TrainMesh.all_reduce`` and
   ``reduce_scatter``) taken in fp32 and rounded once: on two ranks the
   sum of two bf16 partials rounds once either way, so these read as 3.

Each prints ``[conditioning]`` with both curves (loss, gradient norm) and
the largest relative drift of each, and for a bf16 run its drift from
one device's fp32 curve too; ``[conditioning-bf16]`` gives one device's
bf16 curve against its fp32 one at each learning rate.  Run
from the repository root on a machine with one NVIDIA GPU::

    python3 experiments/mesh_train_conditioning.py
"""

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

#: (arch, dtype, (data, model), peak lr, model sums in fp32)
RUNS = [("hymba-1.5b", "float32", (1, 2), 3e-3, False),
        ("hymba-1.5b", "bfloat16", (2, 1), 3e-3, False),
        ("hymba-1.5b", "bfloat16", (1, 2), 3e-3, False),
        ("hymba-1.5b", "bfloat16", (1, 2), 3e-3, True),
        ("hymba-1.5b", "bfloat16", (2, 1), 1e-3, False),
        ("hymba-1.5b", "bfloat16", (1, 2), 1e-3, False),
        ("hymba-1.5b", "bfloat16", (1, 2), 1e-3, True)]


def _fp32_sums() -> None:
    """Make this process's ``TrainMesh`` sum a bf16 tensor in fp32 and
    round the sum once."""
    from repro_torch.launch.mesh import TrainMesh

    def wide(op):
        def run(self, t, *args, **kw):
            if t.dtype != torch.bfloat16:
                return op(self, t, *args, **kw)
            return op(self, t.float(), *args, **kw).to(torch.bfloat16)
        return run

    TrainMesh.all_reduce = wide(TrainMesh.all_reduce)
    TrainMesh.reduce_scatter = wide(TrainMesh.reduce_scatter)


def curve(arch: str, dtype: str, shape, lr: float,
          fp32_sums: bool = False) -> list:
    """(loss, gnorm) of 3 steps of ``arch``'s 1-layer cut in ``dtype`` on
    the mesh ``shape`` (one device if None), from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model

    if fp32_sums:
        _fp32_sums()
    cfg = dataclasses.replace(get_config(arch), num_layers=1, dtype=dtype)
    mesh = make_host_mesh(*shape, device="cuda") if shape else None
    model = build_model(cfg, device="cuda")
    tr, loader = cs._mesh_trainer(model, mesh, 3, 2, 1024, peak_lr=lr)
    params, opt = tr.init_state(torch.Generator("cuda").manual_seed(0))
    tr.run(params, opt)
    loader.stop()
    return cs._curve(tr)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    ones = {}

    def one(arch, dtype, lr):
        if (arch, dtype, lr) not in ones:
            ones[arch, dtype, lr] = curve(arch, dtype, None, lr)
            torch.cuda.empty_cache()
        return ones[arch, dtype, lr]

    for arch, dtype, shape, lr, fp32_sums in RUNS:
        t0 = time.perf_counter()
        want = one(arch, dtype, lr)
        mesh = cs._run_mesh(curve, shape[0] * shape[1], arch, dtype, shape,
                            lr, fp32_sums)[0]
        loss, gnorm = cs._curve_drift(mesh, want)
        sums = ", model sums in fp32" if fp32_sums else ""
        exact = ""
        if dtype != "float32":
            fl, fg = cs._curve_drift(mesh, one(arch, "float32", lr))
            exact = (f"; against one device in fp32: loss max rel {fl:.3g},"
                     f" gnorm max rel {fg:.3g}")
        print(f"[conditioning] {arch} x1 {dtype} on {shape} at peak lr "
              f"{lr:g}{sums}: one device {want}, mesh {mesh}: loss max rel "
              f"{loss:.3g}, gnorm max rel {gnorm:.3g}{exact} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    for arch, dtype, lr in list(ones):
        if dtype == "float32":
            continue
        loss, gnorm = cs._curve_drift(ones[arch, dtype, lr],
                                      one(arch, "float32", lr))
        print(f"[conditioning-bf16] {arch} x1 one device at peak lr {lr:g}:"
              f" {dtype} against fp32: loss max rel {loss:.3g}, gnorm max "
              f"rel {gnorm:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
