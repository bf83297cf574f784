"""Binding of the CUDA paged decode attention kernel.

The kernel itself is ``src/repro_torch/csrc/paged_attention.cu``; it
replaces the reference's Pallas TPU kernel ``paged_attention_pallas``.
This module checks what the kernel takes, allocates the output and the
split-KV scratch and launches on PyTorch's current stream; it never falls
back to the plain version.  The kernel has instances at head dims 64 and
128; a smaller head dim is zero-padded up to the next one and the output
sliced back (``head_dim_instance`` of the flash binding).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from ..flash_attention.flash_attention import head_dim_instance

__all__ = ["paged_attention_cuda", "scratch_shape", "split_pages"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
MAX_G = 16
#: rows of logical pages one split covers (``kSplitRows`` in the source):
#: a constant, so the split partition never depends on the table width
SPLIT_ROWS = 256
#: device type the kernel runs on (a module constant, so a test can point
#: the dispatch at another device type with the loader mocked)
KERNEL_DEVICE = "cuda"
#: head dims the kernel has an instance for
INSTANCES = (64, 128)


def split_pages(page_size: int) -> int:
    """Pages of one split at this page size."""
    return max(1, SPLIT_ROWS // page_size)


def scratch_shape(B: int, K: int, G: int, hd: int, page_size: int,
                  W: int) -> tuple:
    """Shape of the fp32 split scratch: each split's (acc, m, l) per head."""
    return (B, K, -(-W // split_pages(page_size)), G, hd + 2)


def paged_attention_cuda(q, k_pages, v_pages, page_table, lens, *, scale):
    """q: (B, K*G, hd); pages: (P, page, K, hd); table: (B, W) int32;
    lens: (B,) int32 — all on one CUDA device, contiguous."""
    B, KG, hd = q.shape
    _, page_size, K, hd_k = k_pages.shape
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lens", lens)):
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} on {t.device}, q on {dev}")
    if dev.type != KERNEL_DEVICE:
        raise ValueError(f"paged_attention kernel needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(
            "paged_attention kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if hd_k != hd or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"paged_attention kernel takes matching pages, got q "
            f"{tuple(q.shape)}, pages {tuple(k_pages.shape)}")
    if hd > INSTANCES[-1]:
        # no config reaches this: the head dims above 128 (gemma2/gemma3's
        # 256) serve through the dense cache
        raise ValueError(
            f"paged_attention kernel takes head dims up to {INSTANCES[-1]} "
            f"(instances {', '.join(map(str, INSTANCES))}), got head dim "
            f"{hd}: a config with head_dim above {INSTANCES[-1]} needs a "
            "new instance of csrc/paged_attention.cu to serve in "
            "kv_mode='paged'")
    if KG % K or not 1 <= KG // K <= MAX_G:
        raise ValueError(
            f"paged_attention kernel takes 1..{MAX_G} query heads per kv "
            f"head, got {KG} q heads over {K} kv heads")
    if page_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError("paged_attention: page_table and lens must be int32")
    if page_table.shape[0] != B or lens.shape != (B,):
        raise ValueError("paged_attention: table/lens batch does not match q")
    if not all(t.is_contiguous()
               for t in (q, k_pages, v_pages, page_table, lens)):
        raise ValueError("paged_attention kernel takes contiguous tensors")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        # the kernel reads each lane's slice of a row as one vector load
        raise ValueError("paged_attention kernel takes 16-byte aligned pages")
    inst = head_dim_instance(hd, INSTANCES)
    if inst != hd:
        # only the reduced configs reach this (no published config has a
        # head dim under 64): the whole page pool is copied on every call
        q, k_pages, v_pages = (F.pad(t, (0, inst - hd))
                               for t in (q, k_pages, v_pages))
    W = page_table.shape[1]
    out = torch.empty_like(q)
    part = torch.empty(scratch_shape(B, K, KG // K, inst, page_size, W),
                       dtype=torch.float32, device=dev)
    fn = _build.kernel("repro_paged_attention", _ARGS)
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                page_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
                part.data_ptr(), B, K, KG // K, inst, page_size, W,
                part.shape[2], float(scale), _DTYPES[q.dtype],
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "repro_paged_attention")
    return out if inst == hd else out[..., :hd].contiguous()
