"""SEE++ reproduction, PyTorch/CUDA port.

A second package beside the JAX reference ``repro``: the same module names
and paths, PyTorch idiom inside, and hand-written CUDA kernels for NVIDIA
Hopper (``sm_90a``) where the reference had Pallas TPU kernels.  This
package imports ``torch`` and never ``jax`` or anything of ``repro``: the
numpy-only modules it needs are kept as copies of their own.

Entry points run on CUDA unless the caller passes ``device="cpu"``; on a
CPU tensor every kernel wrapper runs its plain PyTorch version instead.
"""
