"""``BENCHMARK.json`` and the files it names, found by name and checked.

Everything that belongs to one cell lives in files of its own, found
from the names in the manifest:

* a configuration: ``perfbench/configs/<config>.json`` (the sizes as run,
  the source's key names, and a ``port`` block: the arguments of the
  program's ``ArchConfig``);
* a traffic mix: ``perfbench/traffic/<traffic>.json``;
* a per-layer metric's reader: ``perfbench/metrics/<metric>.py``, whose
  ``read(ctx)`` returns a number or None;
* a model family's plain reference: ``perfbench/reference/<family>.py``;
* a cell's correctness limits: ``perfbench/checks/<workload>.json``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Mapping

__all__ = ["Manifest", "ManifestError", "load_module", "validate"]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
PKG = "perfbench"


class ManifestError(ValueError):
    pass


def _line(text: Any, what: str) -> None:
    if not isinstance(text, str) or not 1 <= len(text) <= 200 \
            or "\n" in text or "\t" in text:
        raise ManifestError(f"{what}: 1 to 200 characters on one line")


def _name(text: Any, what: str) -> None:
    if not isinstance(text, str) or not NAME.match(text):
        raise ManifestError(f"{what}: {text!r} is not a valid name")


def load_module(path: Path, name: str):
    """Import a file by its path (metric readers and references are
    named by data, not imported by the harness's code)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ManifestError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def validate(m: Mapping, root: Path) -> None:
    """Raise ManifestError where ``m`` breaks the benchmark's contract or
    names a file that is not there."""
    if set(m) != TOP_KEYS:
        raise ManifestError(f"top-level keys {sorted(m)} != {sorted(TOP_KEYS)}")
    cmd, paths = m["command"], m["paths"]
    if not isinstance(cmd, list) or not 1 <= len(cmd) <= 32:
        raise ManifestError("command: a list of 1 to 32 strings")
    for word in cmd:
        _line(word, "command word")
        if word.startswith("/") or ".." in word.split("/"):
            raise ManifestError(f"command word {word!r} leaves the checkout")
    if not isinstance(paths, list) or not 1 <= len(paths) <= 16:
        raise ManifestError("paths: 1 to 16 directories")
    for p in paths:
        if not isinstance(p, str) or not PATH.match(p) or p.startswith("/") \
                or ".." in p.split("/"):
            raise ManifestError(f"path {p!r}")
    rs = m["run_seconds"]
    if not isinstance(rs, int) or isinstance(rs, bool) or not 1 <= rs <= 51:
        raise ManifestError("run_seconds: a whole number from 1 to 51")

    configs = {}
    for c in m["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            raise ManifestError(f"config keys {sorted(c)}")
        _name(c["name"], "config name")
        _line(c["source"], "config source")
        _line(c["why"], "config why")
        if c["name"] in configs:
            raise ManifestError(f"config {c['name']} twice")
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            raise ManifestError(f"config file {c['file']} is not under paths")
        if len(c["reduced"]) > 16:
            raise ManifestError("reduced: at most 16 keys")
        for k in c["reduced"]:
            _name(k, "reduced key")
        if not (root / c["file"]).is_file():
            raise ManifestError(f"config file {c['file']} missing")
        configs[c["name"]] = c
    if not 1 <= len(configs) <= 24:
        raise ManifestError("configs: 1 to 24")
    files = [c["file"] for c in configs.values()]
    if len(set(files)) != len(files):
        raise ManifestError("two configurations share a file")

    cells: Dict[str, Mapping] = {}
    pairs = set()
    for w in m["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            raise ManifestError(f"workload keys {sorted(w)}")
        for k in ("name", "config", "traffic"):
            _name(w[k], f"workload {k}")
        _line(w["why"], "workload why")
        if w["name"] in cells:
            raise ManifestError(f"workload {w['name']} twice")
        if w["config"] not in configs:
            raise ManifestError(f"workload {w['name']}: no config {w['config']}")
        if w["chips"] not in (1, 4):
            raise ManifestError("chips: 1 or 4")
        if (w["config"], w["traffic"]) in pairs:
            raise ManifestError(f"{w['config']} x {w['traffic']} twice")
        pairs.add((w["config"], w["traffic"]))
        for rel in (f"{PKG}/traffic/{w['traffic']}.json",
                    f"{PKG}/checks/{w['name']}.json"):
            if not (root / rel).is_file():
                raise ManifestError(f"workload {w['name']}: {rel} missing")
        cells[w["name"]] = w
    if not 1 <= len(cells) <= 24:
        raise ManifestError("workloads: 1 to 24")
    if sum(w["chips"] == 4 for w in cells.values()) > max(1, len(cells) // 4):
        raise ManifestError("too many four-chip cells")
    unused = set(configs) - {w["config"] for w in cells.values()}
    if unused:
        raise ManifestError(f"configs used by no cell: {sorted(unused)}")
    for c in configs.values():
        cfg = json.loads((root / c["file"]).read_text())
        fam = cfg.get("reference")
        if not fam or not (root / PKG / "reference" / f"{fam}.py").is_file():
            raise ManifestError(f"config {c['name']}: no reference {fam!r}")
        if "port" not in cfg:
            raise ManifestError(f"config {c['name']}: no port block")

    names = set()
    reports: Dict[str, set] = {}
    e2e = m["end_to_end"]
    if not 1 <= len(e2e) <= 16:
        raise ManifestError("end_to_end: 1 to 16")
    for e in e2e:
        _metric(e, names, cells, per_layer=False)
        if e["source"] not in ("host_clock", "device_trace"):
            raise ManifestError(f"{e['name']}: end-to-end source")
        b = e["bound"]
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            raise ManifestError(f"{e['name']}: bound from 0.01 to 0.25")
        reports[e["name"]] = set(e.get("workloads", cells))
    if "setup_s" not in reports or reports["setup_s"] != set(cells):
        raise ManifestError("every cell reports setup_s")
    for w in cells:
        if sum(w in s for n, s in reports.items() if n != "setup_s") < 1:
            raise ManifestError(f"{w}: no end-to-end metric besides setup_s")
    pl = m["per_layer"]
    if not 1 <= len(pl) <= 128:
        raise ManifestError("per_layer: 1 to 128")
    layered = set()
    for e in pl:
        _metric(e, names, cells, per_layer=True)
        _line(e["layer"], f"{e['name']} layer")
        if e["moves"] not in reports:
            raise ManifestError(f"{e['name']}: moves {e['moves']!r}, not an "
                                "end-to-end metric")
        its = set(e.get("workloads", reports[e["moves"]]))
        if not its <= reports[e["moves"]]:
            raise ManifestError(f"{e['name']}: a cell of it does not report "
                                f"{e['moves']}")
        if not (root / PKG / "metrics" / f"{e['name']}.py").is_file():
            raise ManifestError(f"{e['name']}: no reader metrics/{e['name']}.py")
        layered |= its
    if layered != set(cells):
        raise ManifestError(f"cells with no per-layer metric: "
                            f"{sorted(set(cells) - layered)}")
    if len(json.dumps(m).encode()) > 64 * 1024:
        raise ManifestError("BENCHMARK.json over 64 KiB")


def _metric(e: Mapping, names: set, cells: Mapping, per_layer: bool) -> None:
    keys = ({"name", "unit", "better", "source", "layer", "moves"}
            if per_layer else {"name", "unit", "better", "bound", "source"})
    if set(e) - {"workloads"} != keys:
        raise ManifestError(f"metric keys {sorted(e)}")
    _name(e["name"], "metric name")
    if e["name"] in names:
        raise ManifestError(f"metric {e['name']} twice")
    names.add(e["name"])
    if not isinstance(e["unit"], str) or not UNIT.match(e["unit"]):
        raise ManifestError(f"{e['name']}: unit {e['unit']!r}")
    if e["better"] not in ("lower", "higher"):
        raise ManifestError(f"{e['name']}: better")
    if e["source"] not in SOURCES:
        raise ManifestError(f"{e['name']}: source")
    for w in e.get("workloads", []):
        if w not in cells:
            raise ManifestError(f"{e['name']}: no workload {w}")


class Manifest:
    """The manifest of a checkout at ``root`` and the files of a cell."""

    def __init__(self, root: Path) -> None:
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        if not path.is_file():
            raise ManifestError(f"{path} missing")
        self.data = json.loads(path.read_text())
        validate(self.data, self.root)
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def cell(self, name: str) -> Mapping:
        if name not in self.cells:
            raise ManifestError(f"no workload {name!r}; cells: "
                                f"{sorted(self.cells)}")
        return self.cells[name]

    def config(self, cell: Mapping) -> Dict:
        return json.loads((self.root / self.configs[cell["config"]]["file"])
                          .read_text())

    def traffic(self, cell: Mapping) -> Dict:
        return json.loads((self.root / PKG / "traffic" /
                           f"{cell['traffic']}.json").read_text())

    def checks(self, cell: Mapping) -> Dict:
        return json.loads((self.root / PKG / "checks" /
                           f"{cell['name']}.json").read_text())

    def reference(self, config: Mapping):
        fam = config["reference"]
        return load_module(self.root / PKG / "reference" / f"{fam}.py",
                           f"perfbench_reference_{fam}")

    def metrics_for(self, cell: Mapping, traced: bool) -> List[Mapping]:
        """The cell's end-to-end metrics (untraced) or per-layer ones."""
        e2e = {e["name"]: e for e in self.data["end_to_end"]}
        if not traced:
            return [e for e in e2e.values()
                    if cell["name"] in e.get("workloads", self.cells)]
        out = []
        for e in self.data["per_layer"]:
            its = e.get("workloads", e2e[e["moves"]].get("workloads",
                                                          self.cells))
            if cell["name"] in its:
                out.append(e)
        return out

    def reader(self, metric: Mapping):
        safe = re.sub(r"[^A-Za-z0-9_]", "_", metric["name"])
        return load_module(self.root / PKG / "metrics" /
                           f"{metric['name']}.py", f"perfbench_metric_{safe}")
