"""The benchmark's CPU tests, and the marker of the few that need a card.

A test marked ``chip`` takes the ``cuda_card`` fixture, which skips it
where ``torch.cuda.is_available()`` is false: the decision is made while
the test runs, never while its module is imported.
"""

import sys
from pathlib import Path

import pytest

# the program and the benchmark, as ``perfbench/run.py`` puts them on the
# path
for _p in (Path(__file__).resolve().parents[2] / "src",
           Path(__file__).resolve().parents[2]):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one); run on the "
        "card with python -m pytest -m chip perfbench/tests")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")
