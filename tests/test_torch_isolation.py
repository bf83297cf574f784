"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither jax nor anything of the reference package ``repro``.

Checked twice: by importing every submodule in a fresh interpreter and
looking at ``sys.modules``, and by scanning the source's import
statements (which also covers imports inside functions, e.g. the kernel
build, that an import alone never runs).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def test_importing_every_submodule_pulls_in_no_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 30
    assert bad == "[]"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES,
                         ids=[p.relative_to(ROOT).as_posix() for p in SOURCES])
def test_source_imports_no_jax_or_repro(path):
    roots = {name.split(".")[0] for name in _imports(path)}
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(roots)


def test_chip_smoke_refuses_to_run_without_a_card():
    """The chip smoke script exits non-zero and prints no result line
    where ``torch.cuda.is_available()`` is false."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal path is not taken")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
