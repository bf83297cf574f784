"""Binding of the CUDA prefill flash-attention kernel.

The kernel itself is ``src/repro_torch/csrc/flash_attention.cu``; it
replaces the reference's Pallas TPU kernel ``flash_attention_pallas``.
This module checks what the kernel takes, allocates the output and
launches on PyTorch's current stream; it never falls back to the plain
version.  The kernel has instances at head dims 64, 128 and 256; a smaller
head dim is zero-padded up to the next one and the output sliced back
(:func:`head_dim_instance`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

__all__ = ["flash_attention_cuda", "head_dim_instance"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]
#: device type the kernel runs on (a module constant, so a test can point
#: the dispatch at another device type with the loader mocked)
KERNEL_DEVICE = "cuda"
#: head dims the kernel has an instance for
INSTANCES = (64, 128, 256)


def head_dim_instance(hd: int, instances=INSTANCES) -> int:
    """The smallest instance that holds head dim ``hd``; raises past the
    largest.  Zero columns of q, k and v add exact zeros to every fp32 dot
    product and give zero output columns, and ``scale`` is passed in from
    the real head dim, so the padded call computes the same function."""
    for inst in instances:
        if hd <= inst:
            return inst
    raise ValueError(
        f"the kernel takes head dims up to {instances[-1]} (instances "
        f"{', '.join(map(str, instances))}), got head dim {hd}: a config "
        f"with head_dim above {instances[-1]} needs a new instance")


def flash_attention_cuda(q, k, v, window, *, scale, logit_cap=0.0,
                         causal=True, q_offset=0):
    """q: (B, Sq, K*G, hd); k/v: (B, Sk, K, hd) — one CUDA device,
    contiguous; ``window`` an int, 0 = global; query row i at position
    ``q_offset + i``, key j at j."""
    B, Sq, KG, hd = q.shape
    Bk, Sk, K, hd_k = k.shape
    dev = q.device
    if dev.type != KERNEL_DEVICE or k.device != dev or v.device != dev:
        raise ValueError(
            f"flash_attention kernel needs q/k/v on one CUDA device, got "
            f"{q.device}/{k.device}/{v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            "flash_attention kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if hd_k != hd or Bk != B or v.shape != k.shape or KG % K:
        raise ValueError(
            f"flash_attention kernel takes GQA shapes, got q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hd > INSTANCES[-1]:
        # no config reaches this: gemma2/gemma3's 256 is the largest
        raise ValueError(
            f"flash_attention kernel takes head dims up to {INSTANCES[-1]} "
            f"(instances {', '.join(map(str, INSTANCES))}), got head dim "
            f"{hd}: a config with head_dim above {INSTANCES[-1]} needs a "
            "new instance of csrc/flash_attention.cu")
    if int(q_offset) < 0:
        raise ValueError(f"flash_attention kernel takes a query offset >= 0, "
                         f"got {q_offset}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous tensors")
    inst = head_dim_instance(hd)
    if inst != hd:
        # only the reduced configs reach this (no published config has a
        # head dim under 64): three padded copies per call
        q, k, v = (F.pad(t, (0, inst - hd)) for t in (q, k, v))
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, v)):
        # the bf16 route loads by TMA: 16-byte aligned bases (rows of 64,
        # 128 or 256 bf16 are always multiples of 16 bytes); the entry point
        # checks it for every bf16 call
        raise ValueError("flash_attention bf16 kernel takes 16-byte aligned "
                         "q/k/v")
    out = torch.empty_like(q)
    fn = _build.kernel("repro_flash_attention", _ARGS)
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Sq, Sk, K, KG // K, inst, int(window), float(scale),
                float(logit_cap), int(bool(causal)), int(q_offset),
                _DTYPES[q.dtype],
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "repro_flash_attention")
    return out if inst == hd else out[..., :hd].contiguous()
