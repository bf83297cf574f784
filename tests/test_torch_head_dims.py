"""K1, K2 and K3 at the head dims their CUDA kernels have no instance for.

K2's kernel has instances at head dims 64, 128 and 256, K1's at 64 and 128.
The bindings zero-pad a smaller head dim (or one between two instances) up
to the next instance, launch, and slice the output back; ``scale`` comes
from the real head dim, so zero columns add exact zeros to every fp32 dot
product and the padded call computes the same function.  Every reduced
config the port serves has a head dim under 64 (qwen2.5, gemma2, gemma3:
16; starcoder2: 12; llava-next: 8), where the bindings refused before.

The kernels cannot run here, so the padded arithmetic is checked through
the emulations of their designs (``helpers/torch_kernel_emul.py``) and the
plain versions, on numpy-seeded inputs, against the plain version and the
reference's Pallas kernel (interpret mode) at the real head dim, within
``chip_smoke.TOL`` (bf16: one ulp; fp32: 1e-5 + 1e-4 |ref|).  The bindings
themselves run with the kernel loader replaced by a recorder: what they
pass on (the instance's head dim, the padded scratch) and what they return
(the real head dim).

K3 (WKV6) has instances at head sizes 16, 32, 64 and 128; its binding pads
r, k, v, u and state0 with zeros and w with ones up to the next one, and
slices y and the state back.  Its binding runs end to end here through an
emulated loader: the entry point reads the binding's CPU tensors through
the pointers it is given, runs the bf16 route's emulation (or, for fp32,
the per-token recurrence) at the instance's head size and writes y and the
state back through theirs.  Past each kernel's largest instance the
bindings refuse, naming the limit and the config field that would need a
new instance (no config reaches any of them).
"""

import contextlib
import ctypes
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from helpers.torch_kernel_emul import (flash_tc_emul, paged_split_emul,
                                       wkv6_chunk_emul)
from helpers.torch_port import to_torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.paged_attention.paged_attention import \
    paged_attention_pallas
from repro.kernels.wkv6.wkv6 import wkv6_pallas
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa_bind
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import paged_attention as pa_bind
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.wkv6 import wkv6 as wkv_bind
from repro_torch.kernels.wkv6.ref import wkv6_ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import TOL  # noqa: E402

SMALL = [8, 12, 16]


def _within_tol(out, ref, dtype):
    atol, rtol = TOL[dtype]
    out, ref = out.float(), ref.float()
    share = ((out - ref).abs() / (atol + rtol * ref.abs())).max().item()
    assert share <= 1.0, share


def _pad(t, inst):
    return F.pad(t, (0, inst - t.shape[-1]))


@pytest.mark.parametrize("hd,flash,paged", [
    (8, 64, 64), (12, 64, 64), (16, 64, 64), (64, 64, 64), (96, 128, 128),
    (128, 128, 128), (200, 256, None), (256, 256, None), (320, None, None)])
def test_head_dim_instance_is_the_next_one_up(hd, flash, paged):
    for want, instances in ((flash, fa_bind.INSTANCES),
                            (paged, pa_bind.INSTANCES)):
        if want is None:
            with pytest.raises(ValueError, match="head dim"):
                fa_bind.head_dim_instance(hd, instances)
        else:
            assert fa_bind.head_dim_instance(hd, instances) == want


# ------------------------------------------------------------ flash (K2)


def _flash_inputs(seed, S, K, G, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((1, S, K * G, hd), (1, S, K, hd), (1, S, K, hd))]


@pytest.mark.parametrize("hd", SMALL)
@pytest.mark.parametrize("K,G,window,cap", [(1, 5, 0, 0.0), (2, 3, 8, 50.0)])
def test_flash_padded_tensor_core_route_matches_plain(hd, K, G, window, cap):
    """bf16: the tensor-core route's arithmetic at the padded head dim 64,
    sliced back, against the plain version and the reference's Pallas
    kernel at the real head dim (S=100: a ragged tail)."""
    q, k, v = _flash_inputs(hd * 10 + G, 100, K, G, hd)
    qb, kb, vb = (to_torch(x).bfloat16() for x in (q, k, v))
    scale = hd ** -0.5
    inst = fa_bind.head_dim_instance(hd)
    out = flash_tc_emul(*(_pad(t, inst) for t in (qb, kb, vb)), window,
                        scale=scale, logit_cap=cap)[..., :hd]
    assert out.shape == qb.shape
    plain = flash_attention_ref(qb, kb, vb, window, scale=scale,
                                logit_cap=cap)
    _within_tol(out, plain, torch.bfloat16)
    pallas = flash_attention_pallas(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), window, scale=scale, logit_cap=cap,
        interpret=True)
    _within_tol(out, to_torch(np.asarray(pallas, np.float32)), torch.bfloat16)


@pytest.mark.parametrize("hd", SMALL)
def test_flash_padded_fp32_matches_plain(hd):
    """fp32 (the CUDA-core route): the plain version at the padded head dim,
    sliced back, against itself at the real one."""
    q, k, v = (to_torch(x) for x in _flash_inputs(hd, 77, 2, 3, hd))
    kw = dict(scale=hd ** -0.5, logit_cap=30.0)
    out = flash_attention_ref(*(_pad(t, 64) for t in (q, k, v)), 16,
                              **kw)[..., :hd]
    _within_tol(out, flash_attention_ref(q, k, v, 16, **kw), torch.float32)


# ------------------------------------------------------------ paged (K1)


def _paged_inputs(seed, hd, K, G, page=8, lens=(37, 0, 64, 5)):
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int32)
    need = [-(-int(n) // page) for n in lens]
    P = sum(need) + 3
    perm = rng.permutation(P)
    table = np.full((len(lens), max(need)), -1, np.int32)
    at = 0
    for b, n in enumerate(need):
        table[b, :n] = perm[at:at + n]
        at += n
    q = rng.standard_normal((len(lens), K * G, hd)).astype(np.float32)
    kp = rng.standard_normal((P, page, K, hd)).astype(np.float32)
    vp = rng.standard_normal((P, page, K, hd)).astype(np.float32)
    return q, kp, vp, table, lens


@pytest.mark.parametrize("hd", SMALL)
@pytest.mark.parametrize("K,G", [(1, 5), (2, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_padded_split_route_matches_plain(hd, K, G, dtype):
    """The split-KV kernel's arithmetic at the padded head dim 64, sliced
    back, against the plain version at the real head dim (and, in fp32, the
    reference's Pallas kernel); a dead row stays exactly 0."""
    q, kp, vp, table, lens = _paged_inputs(hd + G, hd, K, G)
    args = [to_torch(x).to(dtype) for x in (q, kp, vp)]
    tl = (to_torch(table), to_torch(lens))
    scale = hd ** -0.5
    inst = fa_bind.head_dim_instance(hd, pa_bind.INSTANCES)
    out = paged_split_emul(*(_pad(t, inst) for t in args), *tl,
                           scale=scale)[..., :hd]
    assert out.shape == args[0].shape
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    _within_tol(out, paged_attention_ref(*args, *tl, scale=scale), dtype)
    if dtype == torch.float32:
        pallas = paged_attention_pallas(q, kp, vp, table, lens, scale=scale,
                                        interpret=True)
        live = to_torch(lens > 0)
        _within_tol(out[live], to_torch(np.asarray(pallas))[live], dtype)


# ------------------------------------------------------------ the bindings


@pytest.fixture
def recorded(monkeypatch):
    """The kernel loader replaced by one whose entry points record their
    arguments and return 0; both bindings pointed at the CPU."""
    calls = []

    def fake_kernel(name, argtypes):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    monkeypatch.setattr(_build, "kernel", fake_kernel)
    monkeypatch.setattr(fa_bind, "KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(pa_bind, "KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("hd", SMALL + [96])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_binding_pads_to_the_next_instance(hd, dtype, recorded):
    q = torch.zeros((1, 9, 6, hd), dtype=dtype)
    k = torch.zeros((1, 9, 2, hd), dtype=dtype)
    out = fa_bind.flash_attention_cuda(q, k, k, 8, scale=hd ** -0.5,
                                       logit_cap=50.0)
    ((name, args),) = recorded
    assert name == "repro_flash_attention" and len(args) == len(fa_bind._ARGS)
    assert args[9] == fa_bind.head_dim_instance(hd)
    assert args[11] == pytest.approx(hd ** -0.5)     # the real head dim's
    assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()


@pytest.mark.parametrize("hd", SMALL + [96])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_binding_pads_to_the_next_instance(hd, dtype, recorded):
    q = torch.zeros((2, 10, hd), dtype=dtype)
    kp = torch.zeros((6, 16, 2, hd), dtype=dtype)
    table = torch.zeros((2, 3), dtype=torch.int32)
    lens = torch.ones((2,), dtype=torch.int32)
    out = pa_bind.paged_attention_cuda(q, kp, kp, table, lens, scale=0.1)
    ((name, args),) = recorded
    assert name == "repro_paged_attention" and len(args) == len(pa_bind._ARGS)
    inst = fa_bind.head_dim_instance(hd, pa_bind.INSTANCES)
    assert args[10] == inst
    assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()


@pytest.mark.parametrize("hd", [257, 320])
def test_flash_binding_refuses_past_head_dim_256(hd, recorded):
    q = torch.zeros((1, 9, 4, hd), dtype=torch.bfloat16)
    k = torch.zeros((1, 9, 2, hd), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"up to 256 .*got head dim {hd}: "
                       "a config with head_dim above 256 needs a new "
                       "instance"):
        fa_bind.flash_attention_cuda(q, k, k, 0, scale=0.1)
    assert not recorded


@pytest.mark.parametrize("hd", [129, 256])
def test_paged_binding_refuses_past_head_dim_128(hd, recorded):
    q = torch.zeros((2, 4, hd))
    kp = torch.zeros((6, 16, 2, hd))
    with pytest.raises(ValueError, match=f"up to 128 .*got head dim {hd}: "
                       "a config with head_dim above 128 needs a new "
                       "instance .*kv_mode='paged'"):
        pa_bind.paged_attention_cuda(q, kp, kp,
                                     torch.zeros((2, 3), dtype=torch.int32),
                                     torch.ones((2,), dtype=torch.int32),
                                     scale=0.1)
    assert not recorded


# ------------------------------------------------------------ wkv6 (K3)

WKV_SIZES = [8, 24, 48, 96]


def _at(ptr, shape, dtype):
    """The tensor of ``shape`` and ``dtype`` at host address ``ptr``
    (writes go through to the tensor that lives there)."""
    n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_uint8 * n).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).view(shape)


@pytest.fixture
def emulated(monkeypatch):
    """The kernel loader replaced by one whose ``repro_wkv6`` computes on
    the binding's CPU tensors: bf16 through the chunked route's emulation,
    fp32 through the per-token recurrence (the exact kernel's order), at
    the head size it is given.  Records each launch's head size."""
    sizes = []

    def fake_kernel(name, argtypes):
        assert name == "repro_wkv6" and len(argtypes) == len(wkv_bind._ARGS)

        def fn(r, k, v, w, u, s0, y, state, states, dec, B, T, H, hd,
               dtype, stream):
            sizes.append(hd)
            dt = torch.bfloat16 if dtype == 1 else torch.float32
            seq = (B, T, H, hd)
            ins = (_at(r, seq, dt), _at(k, seq, dt), _at(v, seq, dt),
                   _at(w, seq, torch.float32), _at(u, (H, hd), torch.float32),
                   _at(s0, (B, H, hd, hd), torch.float32))
            run = wkv6_chunk_emul if dt == torch.bfloat16 else wkv6_ref
            S, out = run(*ins)
            _at(y, seq, dt).copy_(out)
            _at(state, (B, H, hd, hd), torch.float32).copy_(S)
            return 0
        return fn

    monkeypatch.setattr(_build, "kernel", fake_kernel)
    monkeypatch.setattr(wkv_bind, "KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    return sizes


def _wkv_inputs(seed, B, T, H, hd):
    """The reference sweep's scales (k * 0.3, decays in (0.35, 0.95),
    u * 0.2, state0 * 0.1), numpy-seeded."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = n(B, T, H, hd), n(B, T, H, hd) * 0.3, n(B, T, H, hd)
    w = (1 / (1 + np.exp(-n(B, T, H, hd))) * 0.6 + 0.35).astype(np.float32)
    return r, k, v, w, n(H, hd) * 0.2, n(B, H, hd, hd) * 0.1


@pytest.mark.parametrize("hd,inst", [(8, 16), (16, 16), (24, 32), (48, 64),
                                     (64, 64), (96, 128), (128, 128)])
def test_wkv6_head_size_instance_is_the_next_one_up(hd, inst):
    assert wkv_bind.head_size_instance(hd) == inst


@pytest.mark.parametrize("hd", WKV_SIZES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wkv6_binding_pads_to_the_next_instance(hd, dtype, emulated):
    """The binding at a head size without an instance: one launch at the
    next instance, y and the state sliced back to the real size, within
    TOL (bf16: one ulp of y; the fp32 state: 1e-5 + 1e-4 |ref|) of the
    plain version and of the reference's Pallas kernel (interpret mode) at
    the real size; T = 64, one chunk of the bf16 route and of the Pallas
    kernel."""
    B, T, H = 2, 64, 2
    r, k, v, w, u, s0 = _wkv_inputs(hd * 3 + (dtype == torch.float32),
                                    B, T, H, hd)
    jr, jk, jv = (jnp.asarray(x, jnp.dtype(str(dtype).split(".")[1]))
                  for x in (r, k, v))
    tr, tk, tv = (to_torch(np.asarray(x, np.float32)).to(dtype)
                  for x in (jr, jk, jv))
    tw, tu, ts0 = to_torch(w), to_torch(u), to_torch(s0)
    S, y = wkv_bind.wkv6_cuda(tr, tk, tv, tw, tu, ts0)
    assert emulated == [wkv_bind.head_size_instance(hd)]
    assert y.shape == (B, T, H, hd) and y.dtype == dtype and y.is_contiguous()
    assert S.shape == (B, H, hd, hd) and S.dtype == torch.float32
    S_p, y_p = wkv6_ref(tr, tk, tv, tw, tu, ts0)
    S_k, y_k = wkv6_pallas(jr, jk, jv, w, u, s0, interpret=True)
    for S_ref, y_ref in ((S_p, y_p), (to_torch(np.asarray(S_k)),
                                      to_torch(np.asarray(y_k, np.float32)))):
        _within_tol(y, y_ref, dtype)
        _within_tol(S, S_ref, torch.float32)


@pytest.mark.parametrize("hd", [129, 192])
def test_wkv6_binding_refuses_past_head_size_128(hd, emulated):
    r = torch.zeros((1, 4, 1, hd), dtype=torch.bfloat16)
    w = torch.ones((1, 4, 1, hd))
    with pytest.raises(ValueError, match=f"up to 128 .*got head size {hd}: "
                       "a config with rwkv_head_size above 128 needs a new "
                       "instance"):
        wkv_bind.wkv6_cuda(r, r, r, w, torch.zeros((1, hd)),
                           torch.zeros((1, 1, hd, hd)))
    assert not emulated
