"""A whole run of a small cell on the CPU (past the harness's look for a
card), with the timed path broken underneath: ``correct`` comes out
false for each fault a served model can have, and true unbroken."""

import pytest
import torch

from perfbench.bench import run_cell
from perfbench.tests.perfbench_tiny import make_root

SEED = 2**33 + 21


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the machine's cores,
    and the window has to see requests finish."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def shared_worker(monkeypatch):
    """These runs share a test worker with the suite's JAX tests, whose
    modules stay loaded; the check that a run loads no JAX has its own
    test in a fresh process (``test_perfbench_isolation.py``)."""
    import perfbench.bench

    monkeypatch.setattr(perfbench.bench, "forbidden_modules", lambda: [])


def _run(tmp_path):
    root = make_root(tmp_path)
    return run_cell(root, "tiny-rows", SEED, 3.0, False, device="cpu",
                    log=lambda m: None)


def test_unbroken_is_correct(tmp_path):
    r = _run(tmp_path)
    assert r["correct"] is True
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    c = r["checks"]["token_gap"]
    assert c["value"] <= c["limit"] and c["tokens"] > 0


def _token_altered(monkeypatch):
    """A token altered where it is produced: every third served token."""
    import repro_torch.runtime.serve_loop as serve_loop

    orig = serve_loop.sample_token

    def sample(logits, **kw):
        tok, method = orig(logits, **kw)
        if kw.get("index", 0) % 3 == 2:
            tok = (tok + 1) % len(logits)
        return tok, method

    monkeypatch.setattr(serve_loop, "sample_token", sample)


def _decode_state_unchanged(monkeypatch):
    """A decode step that returns its state unchanged: its K/V rows are
    never written to the pages."""
    from repro_torch.models.transformer import TransformerLM

    orig = TransformerLM.paged_decode_step

    def step(self, pool, tokens, table, pos):
        scratch = {k: v.clone() for k, v in pool.items()}
        _, logits = orig(self, scratch, tokens, table, pos)
        return pool, logits

    monkeypatch.setattr(TransformerLM, "paged_decode_step", step)


def _prefill_pages_unwritten(monkeypatch):
    """The prompt's K/V rows never reach the pages."""
    from repro_torch.models.transformer import TransformerLM

    monkeypatch.setattr(TransformerLM, "paged_write_prefill",
                        lambda self, pool, rows, page_ids, offsets: pool)


def _logits_of_another_lane(monkeypatch):
    """Half of the batch's logits swapped with the other half's."""
    from repro_torch.models.transformer import TransformerLM

    orig = TransformerLM.paged_decode_step

    def step(self, pool, tokens, table, pos):
        pool, logits = orig(self, pool, tokens, table, pos)
        return pool, torch.roll(logits, 1, dims=0)

    monkeypatch.setattr(TransformerLM, "paged_decode_step", step)


@pytest.mark.parametrize("fault", [_token_altered, _decode_state_unchanged,
                                   _prefill_pages_unwritten,
                                   _logits_of_another_lane],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(tmp_path)
    assert r["correct"] is False, r["checks"]
    assert r["checks"]["token_gap"]["value"] > r["checks"]["token_gap"]["limit"]
