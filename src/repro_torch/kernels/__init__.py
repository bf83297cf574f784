"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each package keeps the reference's three files: ``ref.py`` (the plain
PyTorch version), ``ops.py`` (the dispatching wrapper, with its
``launches`` count) and ``<kernel>.py`` (the binding of the CUDA kernel in
``src/repro_torch/csrc``).  ``_build`` compiles and loads those sources at
first use.
"""
