"""Readings that set a cell's limit: the program's widest token gap on
many seeds and the control's (the reference in fp8 in the program's
place) on some, all in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 11,12,13 \
        --control-seeds 11,12,13 --seconds 51 [--out FILE]

Each seed is a whole run of the cell (its own weights, traffic, window
and sample) at the cell's own size and load; one JSON line per seed goes
to standard output and, with ``--out``, to that file.  The benchmark's
own runs never read the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench.bench import run_cell

    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(ROOT, args.workload, seed, args.seconds, False,
                     control=seed in controls)
        line = {"workload": args.workload, "seed": seed,
                "correct": r["correct"], "program": r["checks"]["token_gap"],
                "control": r.get("control"), "device": r["device"],
                "metrics": r["metrics"]}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
