"""The port's serving launcher (``python -m repro_torch.launch.serve``) on
the CPU: the reduced gemma2, llama4-scout and hymba configs serve in dense
mode under the default ``--kv-mode auto`` and the reduced qwen2.5,
qwen3-moe and llava (text) ones in paged mode, whisper fails on its first
prefill as the reference's launcher does, and the reference's
``--no-incremental`` and ``--kv-mode`` flags reach the engine."""

import json
import re

import pytest

from repro_torch.launch.serve import main


def _serve(capsys, *flags):
    main(["--reduced", "--device", "cpu", "--requests", "3",
          "--new-tokens", "4", *flags])
    out = capsys.readouterr().out
    mode = re.search(r"kv_mode: (\w+)", out).group(1)
    prefills = json.loads(re.search(r"prefills=(\{.*\})", out).group(1))
    done = re.findall(r"\[serve\] req \d+ \[\w+\]: 4 tokens", out)
    assert len(done) == 3, out
    return mode, prefills


@pytest.mark.parametrize("flags,mode,full", [
    (("--arch", "gemma2-9b"), "dense", False),
    (("--arch", "gemma2-9b", "--no-incremental"), "dense", True),
    (("--arch", "qwen2.5-32b", "--kv-mode", "dense"), "dense", False),
    (("--arch", "qwen2.5-32b"), "paged", False),
    (("--arch", "qwen3-moe-235b-a22b"), "paged", False),
    (("--arch", "llama4-scout-17b-a16e"), "dense", False),
    (("--arch", "hymba-1.5b"), "dense", False),
    (("--arch", "llava-next-34b"), "paged", False),
])
def test_launcher_serves_in_the_requested_mode(capsys, flags, mode, full):
    got, prefills = _serve(capsys, *flags)
    assert got == mode
    assert (prefills["full"] > 0) == full
    assert (prefills["incremental"] > 0) == (not full)


def test_launcher_fails_whisper_on_its_first_prefill():
    """The engine passes no encoder frames: the port's prefill names them
    (the reference's launcher fails there with an AttributeError)."""
    with pytest.raises(ValueError, match="needs frames"):
        main(["--arch", "whisper-tiny", "--reduced", "--device", "cpu",
              "--requests", "2", "--new-tokens", "2"])


def test_launcher_refuses_paged_mode_for_gemma2():
    with pytest.raises(ValueError, match="does not support paged decode"):
        main(["--arch", "gemma2-9b", "--reduced", "--device", "cpu",
              "--kv-mode", "paged"])


def test_launcher_serves_through_server_with_its_flags(capsys):
    """``--workers``, ``--pool-watermark``, ``--heartbeat-timeout``,
    ``--metrics-port`` and ``--hold`` reach the port's ``Server``."""
    main(["--reduced", "--device", "cpu", "--requests", "3",
          "--new-tokens", "4", "--workers", "2", "--pool-watermark", "1",
          "--heartbeat-timeout", "30", "--metrics-port", "0",
          "--hold", "0.05"])
    out = capsys.readouterr().out
    assert re.search(r"\[serve\] metrics: http://127\.0\.0\.1:\d+/metrics",
                     out), out
    assert len(re.findall(r"\[serve\] req \d+ \[\w+\]: 4 tokens", out)) == 3
    pool = json.loads(re.search(r"pool metrics: (\{.*\})", out).group(1))
    assert pool["seepp_pool_prewarm_total"][""] == 1
    assert pool["seepp_pool_idle_sandboxes"]['{tenant="serving"}'] >= 1
    assert "holding /metrics open" in out
