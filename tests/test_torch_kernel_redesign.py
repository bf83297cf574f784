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
  order of the fp32 sums differs);
* wkv6: the chunked form (64-token chunks, 16-token sub-chunks, log2 decays
  clamped, every decay factor 2^x of a sum x <= 0 taken from 0, the
  diagonal sub-blocks pairwise, 3xTF32 products, the chunk-state scan)
  within ``TOL`` of the reference's Pallas kernel where its chunk divides T
  and of its per-token oracle at every T: y against the bf16 limit, the
  fp32 state against the fp32 one, on RWKV6's own decay law (down to
  w = 0) and on strong decays followed by weak ones inside a chunk.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_kernel_emul import (LOG2_DECAY_FLOOR, SPLIT_ROWS,
                                       WKV_CHUNK, WKV_SUB, flash_tc_emul,
                                       paged_split_emul, tf32, wkv6_chunk_emul,
                                       wkv6_decay)
from helpers.torch_port import to_torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.paged_attention.paged_attention import \
    paged_attention_pallas
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.kernels.wkv6.wkv6 import wkv6_pallas
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import paged_attention as pa_bind
from repro_torch.kernels.wkv6 import wkv6 as wkv_bind
from repro_torch.kernels.wkv6.ref import wkv6_ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import TOL, wkv6_fp64  # noqa: E402

FP32 = dict(rtol=1e-5, atol=1e-5)


def _share(out, ref, dtype=torch.bfloat16):
    atol, rtol = TOL[dtype]
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() / (atol + rtol * ref.abs())).max().item()


def _within_tol(out, ref, dtype=torch.bfloat16):
    share = _share(out, ref, dtype)
    assert share <= 1.0, share


# ------------------------------------------------------------ flash (K2)


@pytest.mark.parametrize("S,hd,window,cap", [
    (64, 64, 0, 0.0),
    (64, 128, 16, 0.0),
    (200, 64, 0, 30.0),
    (200, 128, 0, 0.0),
    (200, 128, 48, 50.0),
    (200, 256, 0, 0.0),
    (200, 256, 48, 50.0),
    (197, 256, 130, 30.0),
])
def test_flash_tensor_core_arithmetic_matches_reference(S, hd, window, cap):
    """Tiles of 64 rows at every head dim, gemma's 256 included (S=200 and
    197 leave a ragged tail; a window of 130 spans three tiles), bf16 in
    and out."""
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


# ------------------------------------------------------------ wkv6 (K3)


def _wkv_case(seed, B, T, H, hd, decay):
    """numpy-seeded inputs, the reference sweep's scales (k * 0.3, u * 0.2,
    state0 * 0.1), r/k/v rounded to bf16 once: (jax bf16 r/k/v, torch bf16
    r/k/v, fp32 w, u, state0 as numpy)."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    rkv = [n(B, T, H, hd), n(B, T, H, hd) * 0.3, n(B, T, H, hd)]
    w = wkv6_decay(decay, (B, T, H, hd), rng)
    jx = [jnp.asarray(x, jnp.bfloat16) for x in rkv]
    tx = [to_torch(np.asarray(x, np.float32)).bfloat16() for x in jx]
    return jx, tx, w, n(H, hd) * 0.2, n(B, H, hd, hd) * 0.1


@pytest.mark.parametrize("B,T,H,hd,decay", [
    (1, 64, 2, 64, "law"),
    (1, 128, 2, 16, "runs"),
    (4, 128, 2, 16, "law"),
    (1, 256, 2, 64, "runs"),
    (2, 64, 3, 16, "sigmoid"),
])
def test_wkv6_chunked_arithmetic_matches_reference_kernel(B, T, H, hd, decay):
    """Lengths the Pallas kernel's chunk divides: the emulation within
    TOL of ``wkv6_pallas(interpret=True)`` and of the per-token oracle."""
    (jr, jk, jv), (tr, tk, tv), w, u, s0 = _wkv_case(T + hd, B, T, H, hd,
                                                     decay)
    S, y = wkv6_chunk_emul(tr, tk, tv, to_torch(w), to_torch(u),
                           to_torch(s0))
    assert y.dtype == torch.bfloat16 and y.shape == (B, T, H, hd)
    assert S.dtype == torch.float32 and S.shape == (B, H, hd, hd)
    S_k, y_k = wkv6_pallas(jr, jk, jv, w, u, s0, interpret=True)
    S_r, y_r = jax_wkv6_ref(jr, jk, jv, w, u, s0)
    for S_ref, y_ref in ((S_k, y_k), (S_r, y_r)):
        _within_tol(y, to_torch(np.asarray(y_ref, np.float32)))
        _within_tol(S, to_torch(np.asarray(S_ref)), torch.float32)


@pytest.mark.parametrize("B,T,H,hd,decay", [
    (1, 1, 2, 64, "law"),
    (2, 17, 2, 16, "runs"),
    (1, 63, 2, 64, "law"),
    (4, 65, 2, 16, "runs"),
    (1, 300, 2, 64, "runs"),
    (1, 300, 2, 16, "law"),
    (4, 17, 2, 64, "sigmoid"),
])
def test_wkv6_chunked_arithmetic_ragged_matches_reference_oracle(
        B, T, H, hd, decay):
    """Lengths the Pallas kernel refuses (its chunk must divide T): the
    emulation, whose last chunk is padded with w = 1 and k = 0, within TOL
    of the reference's per-token oracle and of the port's plain version."""
    (jr, jk, jv), (tr, tk, tv), w, u, s0 = _wkv_case(T * 7 + hd, B, T, H,
                                                     hd, decay)
    args = [to_torch(x) for x in (w, u, s0)]
    S, y = wkv6_chunk_emul(tr, tk, tv, *args)
    assert y.shape == (B, T, H, hd)
    S_r, y_r = jax_wkv6_ref(jr, jk, jv, w, u, s0)
    _within_tol(y, to_torch(np.asarray(y_r, np.float32)))
    _within_tol(S, to_torch(np.asarray(S_r)), torch.float32)
    S_p, y_p = wkv6_ref(tr, tk, tv, *args)
    _within_tol(y, y_p)
    _within_tol(S, S_p, torch.float32)


@pytest.mark.parametrize("decay", ["law", "runs"])
def test_wkv6_single_rounded_operands_miss_the_bf16_limit(decay):
    """Why the tensor-core products take fp32 operands as two TF32 terms:
    rounded to TF32 once, the decay-scaled operands and the state carry
    their 2^-11 error into the outputs that cancel towards 0 and break the
    bf16 limit; split, the fp32 output before its rounding stays far
    inside it."""
    (_, _, _), (tr, tk, tv), w, u, s0 = _wkv_case(5, 1, 256, 2, 64, decay)
    args = [to_torch(x) for x in (w, u, s0)]
    _, ref = wkv6_ref(tr.float(), tk.float(), tv.float(), *args)
    shares = {split: _share(wkv6_chunk_emul(tr, tk, tv, *args, split=split,
                                            out_fp32=True)[1], ref)
              for split in (True, False)}
    assert shares[True] < 0.5 < 1.0 < shares[False], shares


def test_wkv6_long_memory_as_close_to_fp64_as_the_exact_recurrence():
    """w ~ 1 - 3e-4 on every token: a memory that crosses every chunk
    boundary through the scan.  There no fp32 order of evaluation, the
    exact per-token one included, meets TOL on the outputs that cancel
    towards 0, so the emulation's fp32 y is held to lie no farther from
    the float64 recurrence than twice the exact fp32 recurrence does, and
    its state within the fp32 limit of it."""
    (_, _, _), (tr, tk, tv), w, u, s0 = _wkv_case(9, 1, 512, 2, 64, "long")
    args = [to_torch(x) for x in (w, u, s0)]
    S, y = wkv6_chunk_emul(tr, tk, tv, *args, out_fp32=True)
    S64, y64 = wkv6_fp64(tr, tk, tv, *args)
    _, y_exact = wkv6_ref(tr.float(), tk.float(), tv.float(), *args)
    err = (y.double() - y64).abs().max().item()
    assert err <= 2 * (y_exact.double() - y64).abs().max().item(), err
    _within_tol(S, S64.float(), torch.float32)


def test_wkv6_decay_laws_reach_the_hazards():
    """The decay cases are what the chunked form risks: RWKV6's law gives
    w = 0 exactly and w within 4e-4 of 1; the runs turn from w = 0 to weak
    decays inside a chunk, at another place in each channel; log2 0 is
    held at the floor, where 2^floor times any fp32 state is far below the
    fp32 limit."""
    rng = np.random.default_rng(0)
    law = wkv6_decay("law", (1, 4096, 1, 64), rng)
    assert (law == 0).any() and law.max() > 1 - 4e-4 and law.max() < 1
    runs = wkv6_decay("runs", (1, 128, 1, 64), rng)
    strong = runs[0, :64, 0] < 1e-37          # 0, or below fp32's normals
    assert strong[:, 1:].any(axis=0).all() and not strong[:, 0].any()
    assert (runs[0, 63, 0] > 0.9).all() and (runs[0, 64:71, 0, 1] < 1e-37).all()
    assert LOG2_DECAY_FLOOR == -126.0 and 2.0 ** LOG2_DECAY_FLOOR * 1e32 < 1e-5
    assert WKV_CHUNK == wkv_bind.CHUNK == 4 * WKV_SUB


def test_tf32_rounds_to_nearest_ties_away():
    """The emulated cvt.rna.tf32.f32: 10 mantissa bits kept, ties away from
    zero, bf16 values (8 bits) unchanged."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 4,
                      1 + 3 * one_ulp / 4, 3.0e-3])
    out = tf32(x)
    assert out[0] == 1 + one_ulp and out[1] == -(1 + one_ulp)
    assert out[2] == 1 and out[3] == 1 + one_ulp
    assert (out.view(torch.int32) & 0x1FFF == 0).all()
    b = torch.randn(1000).bfloat16().float()
    assert torch.equal(tf32(b), b)


def test_wkv6_binding_allocates_the_chunk_scratch():
    """The bf16 route's scratch: one fp32 state per chunk and its decay row;
    the fp32 route needs none."""
    states, dec = wkv_bind.chunk_scratch(2, 130, 3, 64, torch.bfloat16,
                                         "cpu")
    assert states.shape == (2, 3, 3, 64, 64) and dec.shape == (2, 3, 3, 64)
    assert states.dtype == dec.dtype == torch.float32
    states, dec = wkv_bind.chunk_scratch(2, 130, 3, 64, torch.float32, "cpu")
    assert states.numel() == dec.numel() == 0
