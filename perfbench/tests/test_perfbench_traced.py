"""The traced run on the CPU: its probes read the decode step's lengths
from the host arrays the engine made its inputs from, and the profiled
stretch closes the window."""

import numpy as np
import pytest
import torch

from perfbench.bench import PROFILE_SECONDS, run_cell
from perfbench.loop import Probe
from perfbench.tests.perfbench_tiny import make_root


class _Model(torch.nn.Module):
    def paged_decode_step(self, pool, tokens, table, pos):
        return pool, tokens

    def paged_prefill(self, tokens):
        return tokens, None

    def paged_prefill_at(self, tokens, pool, table, start):
        return tokens, None

    def paged_write_prefill(self, *args):
        return None


class _Engine:
    def _tensor(self, arr):
        # a tensor that cannot be read back: the probe must not try
        return torch.from_numpy(np.ascontiguousarray(arr)).to("meta")


def test_decode_lengths_come_from_host_arrays():
    model, engine = _Model(), _Engine()
    probe = Probe(model, engine, 16)
    try:
        table = engine._tensor(np.array([[3, 4], [-1, -1], [5, 6]], np.int32))
        pos = engine._tensor(np.array([20, 0, 31], np.int32))
        model.paged_decode_step(None, None, table, pos)      # not recording
        probe.recording = True
        table = engine._tensor(np.array([[3, 4], [-1, -1], [5, 6]], np.int32))
        pos = engine._tensor(np.array([20, 0, 31], np.int32))
        model.paged_decode_step(None, None, table, pos)
    finally:
        probe.close()
    assert probe.decode_lens == [[21, 32]]
    assert "paged_decode_step" not in vars(model)
    assert "_tensor" not in vars(engine)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_traced_run_profiles_the_end_of_its_window(tmp_path, one_thread,
                                                    monkeypatch):
    import perfbench.bench

    # the suite's JAX tests share this worker; ``test_perfbench_isolation``
    # checks that a run loads no JAX in a process of its own
    monkeypatch.setattr(perfbench.bench, "forbidden_modules", lambda: [])
    lines = []
    seconds = 3.0
    r = run_cell(make_root(tmp_path), "tiny-rows", 2**33 + 31, seconds, True,
                 device="cpu", log=lines.append)
    assert r["correct"] is True
    assert {"batch_rows_mean", "sampler_ms_per_step"} <= set(r["metrics"])
    span = min(PROFILE_SECONDS, 0.5 * seconds)
    assert 0 < r["device"]["window_s"] <= span + 0.5
    window = next(x for x in lines if x.startswith("[window]"))
    assert "before the profiled stretch" in window
    assert any(x.startswith("[host] in the window: cpu ") for x in lines)
