"""A checkout of the benchmark with one small cell of its own, for the
CPU tests: the real ``BENCHMARK.json`` and ``perfbench/`` copied under a
temporary root, a small configuration, a mix and a limit added as new
files, and the cell added to the manifest."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_PORT = {
    "arch_id": "tiny-dense", "family": "dense", "num_layers": 2,
    "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "d_ff": 128,
    "vocab_size": 512, "qkv_bias": True, "rope_base": 10000.0,
    "tie_embeddings": False, "activation": "silu", "gated": True,
    "norm_eps": 1e-6, "dtype": "bfloat16",
}

TINY_MIX = {
    "why": "a small closed loop for the CPU tests",
    "clients": 4,
    "prompt": {"dist": "lognormal", "median": 32, "sigma": 0.4,
               "min": 20, "max": 64},
    "shared_prefix_tokens": 16,
    "output": {"dist": "uniform", "min": 12, "max": 24},
    "warmup_steps": 3,
    "check_requests": 6,
}

#: set from CPU readings of this cell over twelve seeds: the program's
#: widest gap 0 to 0.0352, the fp8 control's 0.2405 to 0.6926
TINY_LIMIT = 0.1

#: the metrics the small cell reports: a run on the CPU has no device trace
REPORTED = {"output_tok_s", "ttft_p90_ms", "itl_p95_ms", "admit_wait_ms",
            "prefix_hit_token_pct", "batch_rows_mean", "sampler_ms_per_step"}


def make_root(tmp: Path, port=None, mix=None, limit: float = TINY_LIMIT,
              name: str = "tiny-rows") -> Path:
    """A copy of the benchmark under ``tmp`` with the cell ``name`` added
    from new files only; returns the copy's root."""
    root = Path(tmp) / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = {"name": "tiny-dense", "source": "a test's own", "reference": "dense",
           "port": dict(port or TINY_PORT)}
    (root / "perfbench/configs/tiny-dense.json").write_text(json.dumps(cfg))
    (root / "perfbench/traffic/tiny_rows.json").write_text(
        json.dumps(mix or TINY_MIX))
    (root / f"perfbench/checks/{name}.json").write_text(
        json.dumps({"token_gap": {"limit": limit}}))
    manifest["configs"].append({
        "name": "tiny-dense", "source": "a test's own",
        "file": "perfbench/configs/tiny-dense.json", "reduced": [],
        "why": "small widths for the CPU"})
    manifest["workloads"].append({
        "name": name, "config": "tiny-dense", "traffic": "tiny_rows",
        "chips": 1, "why": "the CPU tests' own cell"})
    for metric in manifest["end_to_end"] + manifest["per_layer"]:
        if metric["name"] in REPORTED and "workloads" in metric:
            metric["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return root
