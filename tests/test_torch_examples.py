"""The seven example twins under ``examples/torch/`` run to their end on
the CPU (``--reduced --device cpu``), each in its own process, and import
nothing of the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ["orchestrate_mixed", "quickstart", "train_lm", "serve_paged",
            "serve_shared_prefix", "serve_sharded", "sandbox_udf"]

#: a line each twin prints once its run has gone through
DONE = {
    "orchestrate_mixed": "pool healthy=1",
    "quickstart": "decoded:",
    "train_lm": "1 restart(s) from checkpoint",
    "serve_paged": "seeded streams identical to the un-killed run: True",
    "serve_shared_prefix": "streams identical with and without sharing: True",
    "serve_sharded": "all 8 requests completed: True",
    "sandbox_udf": "§IV.B linux semantics: loads cleanly",
}


@pytest.fixture(scope="module")
def runs():
    """Every twin started at once, each on one thread (they are small), so
    the file takes about as long as the slowest twin."""
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin:/usr/local/bin",
           "OMP_NUM_THREADS": "1"}
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py"),
         "--reduced", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env=env) for name in EXAMPLES}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=240)
            out[name] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_twin_runs_on_cpu(runs, name):
    path = ROOT / "examples" / "torch" / f"{name}.py"
    tree = ast.parse(path.read_text())
    mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    assert not any(m.split(".")[0] in ("jax", "repro") for m in mods), mods
    rc, stdout, stderr = runs[name]
    assert rc == 0, stdout[-2000:] + stderr[-4000:]
    assert DONE[name] in stdout, stdout[-2000:]
