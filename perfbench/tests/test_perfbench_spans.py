"""The five readings of the engine's spans on a traced CPU run: each
reported, none negative, and together the engine's whole step."""

import json

import pytest
import torch

from perfbench.bench import run_cell
from perfbench.tests.perfbench_tiny import make_root

SPAN_METRICS = ("engine_host_ms_per_step", "arena_host_ms_per_step",
                "model_host_ms_per_step", "logits_wait_ms_per_step",
                "sampler_span_ms_per_step")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_span_metrics_add_up_to_the_engine_step(tmp_path, one_thread,
                                                 monkeypatch):
    import perfbench.bench
    from repro_torch.runtime.serve_loop import ServingEngine

    # the suite's JAX tests share this worker; ``test_perfbench_isolation``
    # checks that a run loads no JAX in a process of its own
    monkeypatch.setattr(perfbench.bench, "forbidden_modules", lambda: [])
    root = make_root(tmp_path)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    for m in manifest["per_layer"]:
        if m["name"] in SPAN_METRICS:
            m["workloads"].append("tiny-rows")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))

    snapshots = []
    real = ServingEngine.serving_stats

    def spy(self):
        snapshots.append(real(self))
        return snapshots[-1]

    monkeypatch.setattr(ServingEngine, "serving_stats", spy)
    r = run_cell(root, "tiny-rows", 2**33 + 77, 3.0, True, device="cpu",
                 log=lambda _: None)
    assert r["correct"] is True
    got = {m: r["metrics"][m]["value"] for m in SPAN_METRICS}
    assert all(v >= 0 for v in got.values()), got
    assert all(r["metrics"][m]["unit"] == "ms" for m in SPAN_METRICS)
    # the window's two snapshots: the engine's step a decode step
    s0, s1 = snapshots[0], snapshots[-1]
    steps = s1["decode_steps_total"] - s0["decode_steps_total"]
    step_ms = (s1["spans"]["engine.step"][1]
               - s0["spans"]["engine.step"][1]) / steps * 1e3
    assert sum(got.values()) == pytest.approx(step_ms, rel=0.01)
