"""On the card: each cell at its own size, with the control read beside
the program.  The program stays within the cell's limit and the control
(the reference in fp8 in the program's place) does not.  Skips without a
card; run on the card with ``python -m pytest -m chip perfbench/tests``."""

import json

import pytest

from perfbench.bench import run_cell
from perfbench.tests.perfbench_tiny import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_program_passes(cuda_card, cell):
    r = run_cell(ROOT, cell, 2**33 + 101, MANIFEST["run_seconds"], False,
                 control=True)
    limit = r["checks"]["token_gap"]["limit"]
    assert r["checks"]["token_gap"]["value"] <= limit
    assert r["control"]["token_gap"] > limit
