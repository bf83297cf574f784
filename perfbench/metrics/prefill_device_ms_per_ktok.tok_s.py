"""``prefill_device_ms_per_ktok`` in a cell that reports ``output_tok_s``
and no ``ttft_p90_ms``: in a closed loop every request's prefill adds to
the cycle of its client."""

from pathlib import Path

from perfbench.manifest import load_module

read = load_module(Path(__file__).with_name("prefill_device_ms_per_ktok.py"),
                   "perfbench_metric_prefill_device_ms_per_ktok").read
