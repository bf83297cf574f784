"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA devices the cell
asks for.  The last line of standard output is one JSON object; the
numbers compared for ``correct`` close standard error, each beside its
limit.  Exits non-zero and prints no result when there is no card, when
JAX or the JAX package got loaded, or when anything fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no library loads JAX."""
    cache = ROOT / ".perfbench_cache"
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR",
                          str(ROOT / "src" / "repro_torch" / "_build"))
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from perfbench.bench import ForbiddenModules, NoChip, run_cell

    try:
        result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except NoChip as e:
        print(f"perfbench: no result: {e}", file=sys.stderr)
        return 2
    except ForbiddenModules as e:
        print(f"perfbench: no result: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
