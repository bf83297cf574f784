"""Port parity: the plain WKV6 (K3) and segment zero-fill (K4) against the
reference kernels.

The port's wrappers run their plain PyTorch versions on CPU tensors; here
they are held against the reference's Pallas kernels in interpret mode and
its jnp oracles, on the same numpy-seeded inputs (the shapes of the
reference's own ``tests/test_kernels.py`` sweeps).

Tolerances.  WKV6 in fp32: ``atol = rtol = 1e-5`` on y and on the final
state — every side runs the exact recurrence in fp32, and only the order
of the sums over the head dimension (at most 16 here) differs; the decay
(< 0.95) keeps the carried rounding from growing with T.  WKV6 with bf16
r/k/v: the inputs are the same bf16 values on both sides and the
arithmetic is fp32, so the final state keeps the fp32 tolerance, and y,
rounded once to bf16 on each side, may differ by one bf16 ulp
(``rtol = 2**-7``, ``atol = 1e-5``) from the reference kernel and by half
an ulp from its fp32 oracle.  segment_zero is exact: bitwise equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_kernel_emul import wkv6_decay
from helpers.torch_port import to_torch

from repro.kernels.segment_zero.ops import segment_zero as jax_segment_zero
from repro.kernels.segment_zero.ref import segment_zero_ref as jax_seg_ref
from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.models.rwkv import wkv6_scan as jax_wkv6_scan
from repro_torch.kernels.segment_zero import ops as sz_ops
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import wkv6_ref
from repro_torch.models.rwkv import wkv6_scan

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16_ULP = dict(rtol=2.0 ** -7, atol=1e-5)
BF16_HALF_ULP = dict(rtol=2.0 ** -8, atol=1e-5)


def _wkv_inputs(seed, B, T, H, hd):
    """The reference sweep's distributions: k * 0.3, decay in (0.35, 0.95),
    u * 0.2, state0 * 0.1."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = n(B, T, H, hd), n(B, T, H, hd) * 0.3, n(B, T, H, hd)
    w = (1 / (1 + np.exp(-n(B, T, H, hd))) * 0.6 + 0.35).astype(np.float32)
    u, s0 = n(H, hd) * 0.2, n(B, H, hd, hd) * 0.1
    return r, k, v, w, u, s0


def _bf16(x):
    """fp32 numpy → (the bf16 jax array, the same values as a torch bf16
    tensor)."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, to_torch(np.asarray(j, np.float32)).bfloat16()


@pytest.mark.parametrize("B,T,H,hd", [(1, 32, 1, 8), (2, 128, 3, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_plain_matches_reference_kernel(B, T, H, hd, dtype):
    r, k, v, w, u, s0 = _wkv_inputs(B * T + hd, B, T, H, hd)
    if dtype == "float32":
        jr, jk, jv = r, k, v
        tr, tk, tv = to_torch(r), to_torch(k), to_torch(v)
    else:
        (jr, tr), (jk, tk), (jv, tv) = _bf16(r), _bf16(k), _bf16(v)
    S_k, y_k = jax_wkv6(jr, jk, jv, w, u, s0, interpret=True)
    S_r, y_r = jax_wkv6_ref(jr, jk, jv, w, u, s0)
    S, y = wkv_ops.wkv6(tr, tk, tv, to_torch(w), to_torch(u), to_torch(s0))
    assert S.dtype == torch.float32 and y.dtype == tr.dtype
    assert y.shape == (B, T, H, hd) and S.shape == (B, H, hd, hd)
    y32 = y.float().numpy()
    np.testing.assert_allclose(S.numpy(), np.asarray(S_k), **FP32)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_r), **FP32)
    if dtype == "float32":
        np.testing.assert_allclose(y32, np.asarray(y_k), **FP32)
        np.testing.assert_allclose(y32, np.asarray(y_r), **FP32)
    else:
        np.testing.assert_allclose(y32, np.asarray(y_k, np.float32),
                                   **BF16_ULP)
        np.testing.assert_allclose(y32, np.asarray(y_r, np.float32),
                                   **BF16_HALF_ULP)


@pytest.mark.parametrize("decay", ["law", "runs"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_plain_matches_reference_on_rwkv_decays(decay, dtype):
    """RWKV6's own decay law (w = exp(-exp(dec)), dec over [-8, 5]: w from
    ~1 - 3e-4 down to exactly 0) and strong decays followed by weak ones
    inside a chunk: the plain version against the reference's Pallas
    kernel and oracle, at the tolerances above."""
    B, T, H, hd = 2, 128, 2, 16
    r, k, v, w, u, s0 = _wkv_inputs(T + len(decay), B, T, H, hd)
    w = wkv6_decay(decay, (B, T, H, hd), np.random.default_rng(T))
    if dtype == "float32":
        jr, jk, jv = r, k, v
        tr, tk, tv = to_torch(r), to_torch(k), to_torch(v)
    else:
        (jr, tr), (jk, tk), (jv, tv) = _bf16(r), _bf16(k), _bf16(v)
    S_k, y_k = jax_wkv6(jr, jk, jv, w, u, s0, interpret=True)
    S_r, y_r = jax_wkv6_ref(jr, jk, jv, w, u, s0)
    S, y = wkv_ops.wkv6(tr, tk, tv, to_torch(w), to_torch(u), to_torch(s0))
    y32 = y.float().numpy()
    for S_ref, y_ref in ((S_k, y_k), (S_r, y_r)):
        np.testing.assert_allclose(S.numpy(), np.asarray(S_ref), **FP32)
        np.testing.assert_allclose(
            y32, np.asarray(y_ref, np.float32),
            **(FP32 if dtype == "float32" else BF16_ULP))


@pytest.mark.parametrize("T", [1, 37, 300])
def test_wkv6_plain_ragged_length_matches_reference_oracle(T):
    """Lengths the reference's chunked kernel refuses (its chunk must
    divide T); the per-token oracle defines the function there."""
    r, k, v, w, u, s0 = _wkv_inputs(T, 2, T, 2, 16)
    S_r, y_r = jax_wkv6_ref(r, k, v, w, u, s0)
    args = [to_torch(x) for x in (r, k, v, w, u, s0)]
    for S, y in (wkv_ops.wkv6(*args), wkv6_scan(*args)):
        np.testing.assert_allclose(S.numpy(), np.asarray(S_r), **FP32)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **FP32)


def test_wkv6_model_scan_matches_reference_scan():
    """The model-level scan (a loop of ``wkv6_step``) against the
    reference's chunked XLA scan, at its own test's shapes."""
    B, T, H, hd = 2, 64, 2, 16
    rng = np.random.default_rng(64)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    w = np.asarray(jax.nn.sigmoid(rng.standard_normal((B, T, H, hd))) * 0.5
                   + 0.4, np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    s0 = np.zeros((B, H, hd, hd), np.float32)
    S_m, y_m = jax_wkv6_scan(r, k, v, w, u, s0, chunk=16)
    S, y = wkv6_scan(*(to_torch(x) for x in (r, k, v, w, u, s0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_m), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_m), rtol=1e-4,
                               atol=1e-5)
    S2, y2 = wkv6_ref(*(to_torch(x) for x in (r, k, v, w, u, s0)))
    np.testing.assert_allclose(y2.numpy(), y.numpy(), **FP32)


# ------------------------------------------------------------ segment_zero


def _bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


@pytest.mark.parametrize("n,lo,hi", [
    (1000, 100, 900), (1024, 0, 0), (4096, 4000, 4096), (777, 0, 777),
    (777, -5, 3), (100, 90, 1000),
])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_segment_zero_plain_matches_reference_bitwise(n, lo, hi, dtype):
    # scaled so that the int32 buffer is not mostly 0 and +-1
    x = np.random.default_rng(n + lo).standard_normal(n) * 1000
    jx = jnp.asarray(x, dtype)
    kernel = jax_segment_zero(jx, lo, hi, interpret=True)
    oracle = jax_seg_ref(jx, lo, hi)
    bits = _bits(jx)
    tx = torch.from_numpy(bits.copy())
    if dtype != "int32":
        tx = tx.view(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    out = sz_ops.segment_zero(tx, lo, hi)
    assert out.dtype == tx.dtype and out.shape == (n,)
    got = _bits(out.view(torch.int16 if dtype == "bfloat16"
                         else torch.int32).numpy())
    np.testing.assert_array_equal(got, _bits(oracle))
    np.testing.assert_array_equal(got, _bits(kernel))
    assert not got[max(lo, 0):max(min(hi, n), 0)].any()
