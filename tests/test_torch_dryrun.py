"""The port's dry run (``repro_torch.launch.dryrun``): one production cell
end to end in a subprocess as rank 0 of a fake world of 256, a dense and
whisper's ``train_4k`` cell's and a dense ``decode_32k`` cell's peak and
useful-FLOP ratio, the remat policy and the decode layout it takes as
options, and one cell beside the reference's own dry-run JSON."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
ENV = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin:/usr/local/bin"}


def _run(module, *args, timeout):
    return subprocess.run(
        [sys.executable, "-m", module, *args], capture_output=True,
        text=True, timeout=timeout, env=ENV, cwd=ROOT)


def _port_cell(tmp_path, *flags, arch="whisper-tiny", shape="decode_32k"):
    proc = _run("repro_torch.launch.dryrun", "--arch", arch, "--shape",
                shape, "--device", "cpu", "--out", str(tmp_path), *flags,
                timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[ok]" in proc.stdout, proc.stdout
    mesh = "2x16x16" if "--multi-pod" in flags else "16x16"
    out = tmp_path / f"{arch}__{shape}__{mesh}.json"
    assert out.exists(), proc.stdout
    return json.loads(out.read_text())


@pytest.mark.parametrize("mesh_flag,chips", [([], 256),
                                             (["--multi-pod"], 512)])
def test_dryrun_cell_subprocess(tmp_path, mesh_flag, chips):
    """The reference test's assertions (``tests/test_dryrun_driver.py``)
    on the port's JSON, and the port's own keys."""
    d = _port_cell(tmp_path, *mesh_flag)
    assert d["ok"] and d["chips"] == chips
    r = d["roofline"]
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["step_s_lower_bound"] > 0
    assert d["hlo_flops_per_chip"] > 0
    assert "all-gather" in d["collectives"] or "all-reduce" in d["collectives"]
    assert 0 < d["hlo_bytes_per_chip"] <= d["hlo_bytes_eager_per_chip"]
    assert d["memory"]["peak_bytes"] >= d["memory"]["argument_bytes"] > 0
    assert d["memory"]["fits"] is True
    # the batch of 128 is split over pod x data: 8 rows a rank on 16 x 16
    assert d["rank_rows"] == 128 // (chips // 16)
    assert r["useful_flop_ratio"] == pytest.approx(
        d["model_flops"] / (d["hlo_flops_per_chip"] * chips))


def test_dryrun_dense_train_cell_fits_and_splits_the_work(tmp_path):
    """gemma2-9b ``train_4k`` on 16 x 16: with the weights gathered layer
    by layer and the work split over ``model`` (``launch/steps.py``), a
    rank's peak fits one H100's 80 GB and its FLOPs are within 2x of its
    share of 6·N·tokens (a rank that repeated the step read 0.042)."""
    d = _port_cell(tmp_path, arch="gemma2-9b", shape="train_4k")
    assert d["kind"] == "train" and d["chips"] == 256
    assert d["memory"]["fits"] is True
    assert d["memory"]["peak_bytes"] <= 80e9
    assert d["roofline"]["useful_flop_ratio"] >= 0.5
    assert "reduce-scatter" in d["collectives"]


def test_dryrun_whisper_train_cell_splits_the_work(tmp_path):
    """whisper-tiny ``train_4k`` on 16 x 16: with its encoder and decoder
    split over ``model`` (each sequence chunked, attention by query rows,
    its 6 heads not dividing 16, the MLP by ``d_ff``), a rank's peak is
    5.7 GB and its useful-FLOP ratio 0.581, where a rank that repeated the
    step read 79.1 GB and 0.042."""
    d = _port_cell(tmp_path, arch="whisper-tiny", shape="train_4k")
    assert d["kind"] == "train" and d["chips"] == 256
    assert d["memory"]["peak_bytes"] <= 12e9
    assert d["roofline"]["useful_flop_ratio"] >= 4 * 0.042
    assert "reduce-scatter" in d["collectives"]


def test_dryrun_skips_ineligible_cell(tmp_path):
    proc = _run("repro_torch.launch.dryrun", "--arch", "qwen2.5-32b",
                "--shape", "long_500k", "--out", str(tmp_path),
                timeout=120)
    assert proc.returncode == 0
    assert "n/a" in proc.stdout
    assert not list(tmp_path.glob("*.json"))


@pytest.mark.parametrize("flags,why", [
    (["--remat", "dots"], "remat"),
    (["--decode-layout", "heads"], None),
])
def test_dryrun_port_declines_options(tmp_path, flags, why):
    """The options the reference's dry run takes, each run by the port (in
    a subprocess, whose fake world stays out of this one).  ``--remat
    dots``: whisper-tiny ``train_4k`` runs with the model built under that
    policy and the JSON records it; whisper's decoder layers are
    checkpointed whatever the policy says, as the reference's, so the
    rank's peak is the ``full`` cell's.  ``--decode-layout heads``:
    gemma2-9b ``decode_32k`` runs with the cache split by kv heads where
    they divide ``model``; its 8 kv heads do not divide 16, so each rank
    holds its 8 lanes of the cache whole (90.2 GB), as the reference's
    layout leaves them, and the cell does not fit."""
    if why is None:
        d = _port_cell(tmp_path, *flags, arch="gemma2-9b",
                       shape="decode_32k")
        assert d["ok"] and d["decode_layout"] == "heads"
        assert d["memory"]["argument_bytes"] > 90e9
        assert d["memory"]["fits"] is False
        return
    d = _port_cell(tmp_path, *flags, arch="whisper-tiny", shape="train_4k")
    assert d["ok"] and d[why] == "dots"
    assert d["kind"] == "train"
    assert d["memory"]["peak_bytes"] <= 12e9


def test_dryrun_dense_decode_cell_fits_with_its_cache_split(tmp_path):
    """gemma2-9b ``decode_32k`` on 16 x 16 in ``seq``: the weights rest in
    their shards, and each rank holds 2048 of the 32768 rows of its 8
    lanes' cache (5.6 GB, not 90.2), so it fits one H100's 80 GB; with the
    attention split over the rows and the products over heads, ``d_ff``
    and the vocabulary, its useful-FLOP ratio is at least 4x the 0.028 of
    a rank that repeated the step on whole weights and rows."""
    d = _port_cell(tmp_path, arch="gemma2-9b", shape="decode_32k")
    assert d["decode_layout"] == "seq"
    assert d["memory"]["fits"] is True
    assert d["memory"]["argument_bytes"] < 10e9
    assert d["roofline"]["useful_flop_ratio"] >= 4 * 0.028
    assert "all-reduce" in d["collectives"]


def test_dryrun_beside_reference_json(tmp_path):
    """whisper-tiny ``decode_32k`` on 16 x 16 beside the reference's own
    dry run of the cell.  The analytic counts are the same functions of
    the same config, so they agree exactly.  The port's per-rank FLOPs are
    1.23x the reference's per-chip FLOPs (2.20e8 against 1.79e8; band
    1.1-1.4).  Each rank of the port holds 2048 of the 32768 rows of its 8
    lanes' cache and attends over them alone (the softmax taken over
    ``model``), splits the MLP by ``d_ff`` and scores a sixteenth of the
    vocabulary.  What it repeats on every ``model`` rank: whisper's 6 heads
    do not divide 16, so each rank projects the new token's k and v for all
    of them and runs cross-attention of all 6 heads over the 1500 frames
    (the cross K/V whole, as ``decode_state_shardings`` leaves it; 74e6 of
    its 2.20e8 FLOPs).  Before the serving layout, every rank repeated the
    whole step on whole weights and rows: 11.9x."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    proc = _run("repro.launch.dryrun", "--arch", "whisper-tiny", "--shape",
                "decode_32k", "--out", str(ref_dir), timeout=420)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ref = json.loads(
        (ref_dir / "whisper-tiny__decode_32k__16x16.json").read_text())
    port = _port_cell(port_dir)
    for key in ("params", "active_params", "model_flops", "chips", "mesh",
                "arch", "shape", "kind"):
        assert port[key] == ref[key], key
    assert set(ref) <= set(port)
    assert set(ref["roofline"]) <= set(port["roofline"])
    assert set(ref["memory"]) <= set(port["memory"])
    ratio = port["hlo_flops_per_chip"] / ref["hlo_flops_per_chip"]
    assert 1.1 < ratio < 1.4, ratio
