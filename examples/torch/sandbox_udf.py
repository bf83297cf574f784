"""SEE++ feature tour on the PyTorch port: policies, budgets, serverless
tasks, artifacts, and the two paper bug reproductions, in one script.

The twin of ``examples/sandbox_udf.py``, over ``repro_torch``: user
functions are traced to aten graphs (fake tensors) and checked by the
Sentry before they run.

    PYTHONPATH=src python examples/torch/sandbox_udf.py
    PYTHONPATH=src python examples/torch/sandbox_udf.py --reduced --device cpu

The tensors live on the card by default (``--device``); ``--reduced``
runs the same tour (it has no model to cut).
"""

import argparse

import torch
from torch._higher_order_ops.scan import scan

from repro_torch.core import (
    AdmissionController, ArtifactRepository, BudgetExceeded,
    LegacyFilterPolicy, ModernEmulationPolicy, Sandbox, SandboxPool,
    SandboxViolation, ServerlessScheduler, TaskSpec, TenantQuota,
)
from repro_torch.core.elf import build_prophet_like
from repro_torch.core.loader import ImageLoader, SegfaultError
from repro_torch.core.mm import MemoryManager, MMConfig


def udf(x):
    return scan(lambda c, t: (c + torch.tanh(t), c.clone()),
                torch.zeros((), device=x.device), x)[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    xs = torch.arange(8.0, device=dev)

    # 1. legacy filtering vs modern emulation (paper §II vs §III)
    try:
        Sandbox(policy=LegacyFilterPolicy()).run(udf, xs)
    except SandboxViolation as e:
        print("legacy filter:", e)
    r = Sandbox(policy=ModernEmulationPolicy()).run(udf, xs)
    print(f"modern sentry: value={float(r.value):.3f} flops={r.flops:.0f}")

    # 2. resource isolation
    ones = torch.ones((64, 64), device=dev)
    try:
        Sandbox(flop_budget=100.0).run(lambda a, b: a @ b, ones, ones)
    except BudgetExceeded as e:
        print("budget:", e)

    # 3. serverless tasks (§V.A)
    sched = ServerlessScheduler(
        quotas={"tenant-a": TenantQuota(flop_budget_per_task=1e9)})
    t1 = sched.submit(TaskSpec("tenant-a", udf, (xs[:4],)))
    sched.run_pending()
    print("task:", sched.record(t1).state)

    # 4. artifact repository (§V.B): no allowlist churn
    repo = ArtifactRepository(ModernEmulationPolicy())
    rep = repo.register_op("fancy", "1.0", lambda x: torch.erf(x).sum(),
                           (torch.ones(3, device=dev),))
    print("artifact admitted:", rep.admitted, rep.artifact.digest)

    # 4b. unified admission: repeat submissions skip trace+verify, and
    # warm sandboxes come from the pool (the startup-latency story)
    ctl = AdmissionController()
    pool = SandboxPool(admission=ctl)
    sb = pool.checkout("tenant-a")
    cold = sb.run(udf, xs)
    warm = sb.run(udf, xs)
    pool.checkin(sb)
    print(f"admission: cold cache_hit={cold.cache_hit} "
          f"warm cache_hit={warm.cache_hit} stats={ctl.stats()}")

    # 5. §IV.A: the VMA blow-up and the fix
    for name, cfg in (("legacy", MMConfig.legacy()),
                      ("modern", MMConfig.modern())):
        mm = MemoryManager(cfg)
        for _ in range(500):
            ar = mm.mmap(64 * 1024)
            mm.touch(ar.start, 64 * 1024)
        print(f"§IV.A {name}: host VMAs = {mm.host_vma_count()}")

    # 6. §IV.B: the prophet segfault and the fix
    blob = build_prophet_like()
    try:
        ImageLoader("legacy").load(blob)
    except SegfaultError as e:
        print("§IV.B legacy:", e)
    ImageLoader("linux").load(blob)
    print("§IV.B linux semantics: loads cleanly")


if __name__ == "__main__":
    main()
