"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  See ``perfbench/README.md``.
"""
