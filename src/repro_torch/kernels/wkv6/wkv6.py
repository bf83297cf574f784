"""Binding of the CUDA WKV6 recurrence kernels.

The kernels are ``src/repro_torch/csrc/wkv6.cu``; they replace the
reference's Pallas TPU kernel ``wkv6_pallas``.  bf16 r/k/v take the chunked
form on the tensor cores (three launches: chunk states, the scan over
chunks, the outputs); float32 r/k/v take the exact per-token kernel.  This
module checks what the kernels take, allocates the outputs and the chunked
route's scratch and launches on PyTorch's current stream; it never falls
back to the plain version.  The kernels have instances at head sizes 16,
32, 64 and 128; a head size between them is padded up to the next one and
the outputs sliced back (:func:`head_size_instance`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

__all__ = ["chunk_scratch", "head_size_instance", "wkv6_cuda"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
#: tokens of a chunk of the bf16 route
CHUNK = 64
#: device type the kernel runs on (a module constant, so a test can point
#: the dispatch at another device type with the loader mocked)
KERNEL_DEVICE = "cuda"


def head_size_instance(hd: int) -> int:
    """The smallest instance that holds head size ``hd``; raises past the
    largest, which a config's ``rwkv_head_size`` would need a new instance
    of ``csrc/wkv6.cu`` to pass."""
    for inst in _HEAD_DIMS:
        if hd <= inst:
            return inst
    raise ValueError(
        f"wkv6 kernel takes head sizes up to {_HEAD_DIMS[-1]} (instances "
        f"{', '.join(map(str, _HEAD_DIMS))}), got head size {hd}: a config "
        f"with rwkv_head_size above {_HEAD_DIMS[-1]} needs a new instance")


def wkv6_cuda(r, k, v, w, u, state0):
    """r/k/v: (B, T, H, hd) float32 or bfloat16; w: (B, T, H, hd) float32;
    u: (H, hd) float32; state0: (B, H, hd, hd) float32 — one CUDA device,
    contiguous.  Returns (state fp32, y in r's dtype).

    A head size without an instance is padded: r, k, v, u and state0 with
    zeros, w with ones.  A padded key channel i then keeps row i of the
    state at w_i * 0 + k_i v = 0 and a padded value channel j column j at
    w * 0 + k v_j = 0, and r_i = 0 takes row i out of every output, so the
    real channels compute the same function (log2 1 = 0 never meets the
    kernel's log2 clamp at -126)."""
    B, T, H, hd = r.shape
    dev = r.device
    tensors = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
               ("state0", state0))
    if dev.type != KERNEL_DEVICE or any(t.device != dev for _, t in tensors):
        raise ValueError(
            "wkv6 kernel needs every input on one CUDA device, got "
            + ", ".join(f"{n} {t.device}" for n, t in tensors))
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(
            "wkv6 kernel takes float32 or bfloat16 r/k/v of one dtype, got "
            f"{r.dtype}/{k.dtype}/{v.dtype}")
    if not (w.dtype == u.dtype == state0.dtype == torch.float32):
        raise ValueError(
            f"wkv6 kernel takes float32 w, u and state0, got {w.dtype}, "
            f"{u.dtype}, {state0.dtype}")
    if k.shape != r.shape or v.shape != r.shape \
            or w.shape != r.shape or u.shape != (H, hd) \
            or state0.shape != (B, H, hd, hd):
        raise ValueError(
            "wkv6 kernel takes matching shapes, "
            f"got r/k/v/w {tuple(r.shape)}/{tuple(k.shape)}/{tuple(v.shape)}"
            f"/{tuple(w.shape)}, u {tuple(u.shape)}, "
            f"state0 {tuple(state0.shape)}")
    if not all(t.is_contiguous() for _, t in tensors):
        raise ValueError("wkv6 kernel takes contiguous tensors")
    inst = head_size_instance(hd)
    if inst != hd:
        # only reduced or hand-made shapes reach this (rwkv6-3b's head
        # size is 64): six padded copies per call
        pad = (0, inst - hd)
        state, y = wkv6_cuda(*(F.pad(t, pad) for t in (r, k, v)),
                             F.pad(w, pad, value=1.0), F.pad(u, pad),
                             F.pad(state0, pad + pad))
        return (state[..., :hd, :hd].contiguous(),
                y[..., :hd].contiguous())
    if r.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for _, t in tensors):
        # the chunked route loads 16 bytes at a time (rows of hd elements
        # keep that alignment)
        raise ValueError("wkv6 bf16 kernel takes 16-byte aligned inputs")
    y = torch.empty_like(r)
    state = torch.empty_like(state0)
    states, dec = chunk_scratch(B, T, H, hd, r.dtype, dev)
    fn = _build.kernel("repro_wkv6", _ARGS)
    with torch.cuda.device(dev):
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), state0.data_ptr(), y.data_ptr(),
                state.data_ptr(), states.data_ptr(), dec.data_ptr(), B, T,
                H, hd, _DTYPES[r.dtype],
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "repro_wkv6")
    return state, y


def chunk_scratch(B, T, H, hd, dtype, device):
    """The bf16 route's fp32 scratch: each chunk's state change, then its
    incoming state (B, H, chunks, hd, hd), and its decay (B, H, chunks,
    hd); empty for the float32 route, which needs none."""
    nc = -(-T // CHUNK) if dtype == torch.bfloat16 else 0
    return (torch.empty((B, H, nc, hd, hd), dtype=torch.float32,
                        device=device),
            torch.empty((B, H, nc, hd), dtype=torch.float32, device=device))
