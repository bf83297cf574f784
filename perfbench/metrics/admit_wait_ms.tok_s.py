"""``admit_wait_ms`` in a cell that reports ``output_tok_s`` and no
``ttft_p90_ms``: in a closed loop each request's wait for a slot adds to
the cycle of its client."""

from pathlib import Path

from perfbench.manifest import load_module

read = load_module(Path(__file__).with_name("admit_wait_ms.py"),
                   "perfbench_metric_admit_wait_ms").read
