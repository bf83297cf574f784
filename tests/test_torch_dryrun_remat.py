"""The dry run under each remat policy (``python -m
repro_torch.launch.dryrun --remat full|dots|none``): the model is built
with the policy, the JSON records it, and the counts follow what the step
runs and keeps.

gemma2-9b ``train_4k`` on 16 x 16: ``"full"`` reruns each layer's
forward in the backward, ``"dots"`` only its batched products (attention)
and the collectives, ``"none"`` nothing, so the FLOPs fall in that order;
the peak rises in it, as each keeps more of a layer's activations.
whisper-tiny ``train_4k``: its decoder layers are checkpointed whatever
the policy says, as the reference's, so the three cells count the same.
The cells run in subprocesses (each its own fake world), side by side.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
ENV = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin:/usr/local/bin"}
POLICIES = ["full", "dots", "none"]
ARCHS = ["gemma2-9b", "whisper-tiny"]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """{(arch, policy): the cell's JSON}, every cell run at once."""
    out = tmp_path_factory.mktemp("dryrun_remat")
    procs = {}
    for arch in ARCHS:
        for policy in POLICIES:
            procs[arch, policy] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", "train_4k", "--device", "cpu", "--remat",
                 policy, "--tag", policy, "--out", str(out)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=ENV, cwd=ROOT)
    results = {}
    for (arch, policy), proc in procs.items():
        text, _ = proc.communicate(timeout=400)
        assert proc.returncode == 0, text
        assert "[ok]" in text and "n/a" not in text, text
        path = out / f"{arch}__train_4k__16x16__{policy}.json"
        results[arch, policy] = json.loads(path.read_text())
    return results


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("policy", POLICIES)
def test_cell_records_its_policy(cells, arch, policy):
    d = cells[arch, policy]
    assert d["ok"] and d["remat"] == policy and d["kind"] == "train"


def test_dense_flops_fall_and_peak_rises_from_full_to_none(cells):
    full, dots, none = (cells["gemma2-9b", p] for p in POLICIES)
    flops = [d["hlo_flops_per_chip"] for d in (full, dots, none)]
    peaks = [d["memory"]["peak_bytes"] for d in (full, dots, none)]
    assert flops[0] > flops[1] > flops[2]
    assert peaks[2] >= peaks[1] >= peaks[0]
    # the model's FLOPs are the policy's no more than the counts are
    assert full["model_flops"] == dots["model_flops"] == none["model_flops"]
    ratios = [d["roofline"]["useful_flop_ratio"] for d in (full, dots, none)]
    assert ratios[0] < ratios[1] < ratios[2]


def test_dense_dots_keeps_the_collectives_of_full(cells):
    """``"dots"`` recomputes every collective (the layer's gathers among
    them) as ``"full"`` does; ``"none"`` gathers a saved leaf again in the
    backward and runs no other collective twice."""
    full, dots, none = (cells["gemma2-9b", p] for p in POLICIES)
    wire = [d["collective_wire_bytes_per_chip"] for d in (full, dots, none)]
    assert wire[1] == pytest.approx(wire[0])
    assert wire[2] < wire[0]
    assert none["collectives"]["all-gather"]["count"] > 0


def test_whisper_counts_alike_under_every_policy(cells):
    full = cells["whisper-tiny", "full"]
    for policy in ("dots", "none"):
        d = cells["whisper-tiny", policy]
        assert d["hlo_flops_per_chip"] == full["hlo_flops_per_chip"]
        assert d["memory"]["peak_bytes"] == full["memory"]["peak_bytes"]
