"""BENCHMARK.json against the benchmark's contract, and a cell, a mix and
a per-layer metric added from new files only."""

import copy
import json
import re

import pytest

from perfbench.manifest import Manifest, ManifestError, validate
from perfbench.tests.perfbench_tiny import ROOT, make_root

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_manifest_validates():
    m = Manifest(ROOT)
    assert set(m.cells) == {w["name"] for w in MANIFEST["workloads"]}


def _names():
    out = []
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        out += [e["name"] for e in MANIFEST[sec]]
    for w in MANIFEST["workloads"]:
        out += [w["config"], w["traffic"]]
    for c in MANIFEST["configs"]:
        out += c["reduced"]
    return out


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name_character_set(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_unit_and_better(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_files_exist(cell):
    cfg = next(c for c in MANIFEST["configs"] if c["name"] == cell["config"])
    assert (ROOT / cfg["file"]).is_file()
    assert (ROOT / "perfbench/traffic" / f"{cell['traffic']}.json").is_file()
    assert (ROOT / "perfbench/checks" / f"{cell['name']}.json").is_file()
    assert cell["chips"] == 1


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_by_each_cell(metric):
    e2e = {e["name"]: e for e in MANIFEST["end_to_end"]}
    assert metric["moves"] in e2e
    cells = {w["name"] for w in MANIFEST["workloads"]}
    reporting = set(e2e[metric["moves"]].get("workloads", cells))
    assert set(metric.get("workloads", reporting)) <= reporting
    assert (ROOT / "perfbench/metrics" / f"{metric['name']}.py").is_file()


def test_every_cell_reports_setup_and_a_layer():
    m = Manifest(ROOT)
    for cell in m.cells.values():
        e2e = {e["name"] for e in m.metrics_for(cell, traced=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert m.metrics_for(cell, traced=True)


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_file_matches_its_port_block(config):
    cfg = json.loads((ROOT / config["file"]).read_text())
    port = cfg["port"]
    assert cfg["hidden_size"] == port["d_model"]
    assert cfg["intermediate_size"] == port["d_ff"]
    assert cfg["num_attention_heads"] == port["num_heads"]
    assert cfg["num_key_value_heads"] == port["num_kv_heads"]
    assert cfg["num_hidden_layers"] == port["num_layers"]
    assert cfg["vocab_size"] == port["vocab_size"]
    assert float(cfg["rope_theta"]) == port["rope_base"]
    assert sorted(cfg["reduced"]) == sorted(config["reduced"])
    assert set(cfg["reduced"]) <= set(cfg["published"])


def _broken(edit):
    m = copy.deepcopy(MANIFEST)
    edit(m)
    return m


BROKEN = {
    "space in a name": lambda m: m["workloads"][0].update(name="a b"),
    "slash in a unit": lambda m: m["end_to_end"][0].update(unit="tokens per s"),
    "bound over 0.25": lambda m: m["end_to_end"][0].update(bound=0.3),
    "moves no e2e metric": lambda m: m["per_layer"][0].update(moves="nope"),
    "extra key on a metric": lambda m: m["per_layer"][0].update(why="x"),
    "no setup_s": lambda m: m["end_to_end"].pop(),
    "run_seconds over 51": lambda m: m.update(run_seconds=52),
    "missing traffic file": lambda m: m["workloads"][0].update(traffic="nope"),
    "three chips": lambda m: m["workloads"][0].update(chips=3),
    "unknown config": lambda m: m["workloads"][0].update(config="nope"),
}


@pytest.mark.parametrize("what", sorted(BROKEN))
def test_validate_refuses(what):
    with pytest.raises(ManifestError):
        validate(_broken(BROKEN[what]), ROOT)


def test_new_cell_mix_and_metric_from_new_files_only(tmp_path):
    """A cell, a mix and a per-layer metric added as new files and
    entries: the harness finds them, validates them and runs the reader;
    no file of the benchmark changes."""
    before = {p: p.read_bytes() for p in (ROOT / "perfbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    root = make_root(tmp_path)
    (root / "perfbench/metrics/tiny_rows_seen.py").write_text(
        "def read(ctx):\n    return ctx['e2e']['tokens'] or None\n")
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["per_layer"].append({
        "name": "tiny_rows_seen", "unit": "tokens", "better": "higher",
        "source": "host_clock", "layer": "engine", "moves": "output_tok_s",
        "workloads": ["tiny-rows"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    m = Manifest(root)
    cell = m.cell("tiny-rows")
    names = [e["name"] for e in m.metrics_for(cell, traced=True)]
    assert "tiny_rows_seen" in names
    reader = m.reader(next(e for e in data["per_layer"]
                           if e["name"] == "tiny_rows_seen"))
    assert reader.read({"e2e": {"tokens": 7}}) == 7
    from perfbench.traffic import Traffic
    t = Traffic(m.traffic(cell), 3, m.config(cell)["port"]["vocab_size"])
    assert t.clients == 4 and len(t.next(0).prompt) >= 20
    after = {p: p.read_bytes() for p in (ROOT / "perfbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert before == after
