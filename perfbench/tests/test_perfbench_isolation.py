"""No process of the benchmark holds JAX or the JAX package; the command
prints no result without a card or without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench.bench import FORBIDDEN, forbidden_modules
from perfbench.tests.perfbench_tiny import ROOT


@pytest.mark.parametrize("name,flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("repro", True), ("repro.core.sandbox", True),
    ("repro_torch", False), ("repro_torch.runtime", False),
    ("jaxtyping", False), ("reprolib", False),
])
def test_top_level_names_compared_whole(monkeypatch, name, flagged):
    for m in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, object())
    assert (forbidden_modules() != []) == flagged


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_no_card_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "qwen25-rows-extract", "--seed", str(2**33 + 3), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=_env())
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    """A directory with BENCHMARK.json and perfbench/ only: no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "starcoder2-fim-complete", "--seed", "7", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=_env())
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_run_loads_no_jax(tmp_path):
    """A whole run of a small cell (on the CPU) in a fresh process ends
    with no JAX, jaxlib, flax or repro module loaded."""
    code = (
        "import json, sys\n"
        "from pathlib import Path\n"
        "from perfbench.tests.perfbench_tiny import make_root\n"
        "from perfbench.bench import run_cell, forbidden_modules\n"
        f"root = make_root(Path({str(tmp_path)!r}))\n"
        "import torch; torch.set_num_threads(1)\n"
        "r = run_cell(root, 'tiny-rows', 2**33 + 9, 3.0, False, "
        "device='cpu', log=lambda m: None)\n"
        "print(json.dumps({'correct': r['correct'], "
        "'forbidden': forbidden_modules()}))\n")
    env = _env()
    env["PYTHONPATH"] = f"{ROOT / 'src'}:{ROOT}"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"correct": True, "forbidden": []}
