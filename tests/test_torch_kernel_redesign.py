"""CPU rehearsal of the arithmetic of the redesigned CUDA kernels.

The flash-prefill kernel's bf16 route (tensor cores) and the split-KV paged
decode kernel run only on the card.  Their designs are emulated here in
plain PyTorch (``helpers/torch_kernel_emul.py``) and held, on numpy-seeded
inputs, to the reference's Pallas kernels in interpret mode and to the
port's plain versions:

* flash: bf16 Q K^T summed in fp32, the scale on fp32 S, and P V as
  P_hi V + P_lo V, within the bf16 limit that ``chip_smoke.py`` holds the
  kernel to (``TOL``: one bf16 ulp, as each side rounds its fp32 result
  once);
* paged: the split partition and the in-order combine give a live row that
  is bitwise equal at table widths W and 2W, a dead row that is exactly 0,
  and fp32 values within ``atol = rtol = 1e-5`` of the reference (only the
  order of the fp32 sums differs).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_kernel_emul import (SPLIT_ROWS, flash_tc_emul,
                                       paged_split_emul)
from helpers.torch_port import to_torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.paged_attention.paged_attention import \
    paged_attention_pallas
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import paged_attention as pa_bind

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import TOL  # noqa: E402

FP32 = dict(rtol=1e-5, atol=1e-5)


def _within_tol(out, ref, dtype=torch.bfloat16):
    atol, rtol = TOL[dtype]
    out, ref = out.float(), ref.float()
    share = ((out - ref).abs() / (atol + rtol * ref.abs())).max().item()
    assert share <= 1.0, share


# ------------------------------------------------------------ flash (K2)


@pytest.mark.parametrize("S,hd,window,cap", [
    (64, 64, 0, 0.0),
    (64, 128, 16, 0.0),
    (200, 64, 0, 30.0),
    (200, 128, 0, 0.0),
    (200, 128, 48, 50.0),
])
def test_flash_tensor_core_arithmetic_matches_reference(S, hd, window, cap):
    """Tiles of 64 rows (S=200 leaves a ragged tail), bf16 in and out."""
    rng = np.random.default_rng(S * hd + window)
    K, G = 2, 3
    q = rng.standard_normal((1, S, K * G, hd)).astype(np.float32)
    k = rng.standard_normal((1, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((1, S, K, hd)).astype(np.float32)
    qb, kb, vb = (to_torch(x).bfloat16() for x in (q, k, v))
    scale = hd ** -0.5
    out = flash_tc_emul(qb, kb, vb, window, scale=scale, logit_cap=cap)
    assert out.dtype == torch.bfloat16 and out.shape == qb.shape
    pallas = flash_attention_pallas(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), window, scale=scale, logit_cap=cap,
        interpret=True)
    _within_tol(out, to_torch(np.asarray(pallas, np.float32)))
    plain = flash_attention_ref(qb, kb, vb, window, scale=scale,
                                logit_cap=cap)
    _within_tol(out, plain)


def test_flash_single_rounded_p_misses_the_bf16_limit():
    """Why P goes in as two bf16 terms: rounded once, p's error reaches
    the outputs that cancel towards 0 and breaks the limit; split, the
    fp32 result before its rounding stays far inside it."""
    rng = np.random.default_rng(3)
    S, hd = 200, 128
    mk = lambda *shape: to_torch(
        rng.standard_normal(shape).astype(np.float32)).bfloat16()
    q, k, v = mk(1, S, 4, hd), mk(1, S, 2, hd), mk(1, S, 2, hd)
    ref = flash_attention_ref(q.float(), k.float(), v.float(), 0,
                              scale=hd ** -0.5)
    atol, rtol = TOL[torch.bfloat16]
    shares = {}
    for split in (True, False):
        out = flash_tc_emul(q, k, v, 0, scale=hd ** -0.5, split_p=split,
                            out_fp32=True)
        shares[split] = ((out - ref).abs() / (atol + rtol * ref.abs())
                         ).max().item()
    assert shares[True] < 0.5 < 1.0 < shares[False], shares


# ------------------------------------------------------------ paged (K1)


def _paged_case(seed, page, lens, K=2, G=2, hd=32):
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int32)
    need = [-(-int(n) // page) for n in lens]
    W = max(need)
    P = sum(need) + 5
    perm = rng.permutation(P)
    table = np.full((len(lens), W), -1, np.int32)
    at = 0
    for b, n in enumerate(need):
        table[b, :n] = perm[at:at + n]
        at += n
    q = rng.standard_normal((len(lens), K * G, hd)).astype(np.float32)
    kp = rng.standard_normal((P, page, K, hd)).astype(np.float32)
    vp = rng.standard_normal((P, page, K, hd)).astype(np.float32)
    return q, kp, vp, table, lens


@pytest.mark.parametrize("page", [16, 8])
@pytest.mark.parametrize("rows", [4, 8])
def test_paged_split_partition_and_combine(page, rows):
    """lens crossing a split boundary (255, 256, 257 rows), a short row and
    a dead row: W vs 2W bitwise, dead row 0, the reference within 1e-5."""
    assert 256 % SPLIT_ROWS == 0
    lens = [255, 256, 257, 37, 0]
    q, kp, vp, table, lens = _paged_case(page + rows, page, lens)
    scale = 32 ** -0.5
    args = (to_torch(q), to_torch(kp), to_torch(vp))
    out = paged_split_emul(*args, to_torch(table), to_torch(lens),
                           scale=scale, rows=rows)
    wide = np.pad(table, ((0, 0), (0, table.shape[1])), constant_values=-1)
    out2 = paged_split_emul(*args, to_torch(wide), to_torch(lens),
                            scale=scale, rows=rows)
    assert torch.equal(out, out2)
    assert torch.equal(out[4], torch.zeros_like(out[4]))
    ref = paged_attention_pallas(q, kp, vp, table, lens, scale=scale,
                                 interpret=True)
    np.testing.assert_allclose(out[:4].numpy(), np.asarray(ref)[:4], **FP32)


def test_paged_split_scratch_shape_follows_pages_not_lengths():
    """The scratch the wrapper allocates: one (acc, m, l) row per head and
    split, the split axis ceil(W / pages per split) long."""
    assert pa_bind.SPLIT_ROWS == SPLIT_ROWS
    assert pa_bind.split_pages(16) == 16 and pa_bind.split_pages(8) == 32
    assert pa_bind.split_pages(512) == 1
    assert pa_bind.scratch_shape(4, 8, 5, 128, 16, 256) == (4, 8, 16, 5, 130)
    assert pa_bind.scratch_shape(4, 8, 5, 128, 16, 257) == (4, 8, 17, 5, 130)
    assert pa_bind.scratch_shape(2, 1, 1, 64, 8, 0) == (2, 1, 0, 1, 66)
