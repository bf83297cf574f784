"""Binding of the CUDA segment zero-fill kernel.

The kernel itself is ``src/repro_torch/csrc/segment_zero.cu``; it replaces
the reference's Pallas TPU kernel ``segment_zero_pallas``.  This module
checks what the kernel takes, allocates the output and launches on
PyTorch's current stream; it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["segment_zero_cuda"]

#: element width of each dtype the kernel takes
_ELEM_BYTES = {torch.float32: 4, torch.int32: 4, torch.bfloat16: 2}
_ARGS = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [
    ctypes.c_int, ctypes.c_void_p]
#: device type the kernel runs on (a module constant, so a test can point
#: the dispatch at another device type with the loader mocked)
KERNEL_DEVICE = "cuda"


def segment_zero_cuda(x, lo: int, hi: int):
    """x: (N,) float32, int32 or bfloat16 on a CUDA device, contiguous."""
    if x.device.type != KERNEL_DEVICE:
        raise ValueError(
            f"segment_zero kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _ELEM_BYTES:
        raise ValueError(
            "segment_zero kernel takes float32, int32 or bfloat16, got "
            f"{x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(
            "segment_zero kernel takes a contiguous flat buffer, got shape "
            f"{tuple(x.shape)}")
    out = torch.empty_like(x)
    fn = _build.kernel("repro_segment_zero", _ARGS)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), x.numel(), int(lo), int(hi),
                _ELEM_BYTES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "repro_segment_zero")
    return out
