"""Port parity: the kernels' plain versions against the reference kernels.

The port's wrappers (``repro_torch.kernels.*.ops``) run their plain PyTorch
version on a CPU tensor; here they are held against the reference's Pallas
kernels in interpret mode and its jnp oracles, on the same numpy-seeded
fp32 inputs.  Tolerance: ``atol = rtol = 1e-5`` — both sides accumulate in
fp32, and only the order of the sums differs.  The widths-W-and-2W check is
exact (``atol = 0``), as the reference pins it.

The CUDA kernels themselves cannot run here (no card, no nvcc); what these
tests pin about them is the dispatch: a non-CPU tensor never gets the plain
result, and a failure to load or launch the kernel propagates.
"""

import contextlib
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_port import to_torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.kernels.paged_attention.ops import paged_attention as jax_paged
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa_bind
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import paged_attention as pa_bind
from repro_torch.kernels.segment_zero import ops as sz_ops
from repro_torch.kernels.segment_zero import segment_zero as sz_bind
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6 import wkv6 as wkv_bind

TOL = dict(rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ paged decode


def _paged_case(seed, B, K, G, hd, page, lens):
    """Pages permuted over a pool larger than needed; rows -1 padded."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int32)
    W = max(-(-int(n) // page) for n in lens)
    need = [-(-int(n) // page) for n in lens]
    P = sum(need) + 3
    perm = rng.permutation(P)
    table = np.full((B, W), -1, np.int32)
    at = 0
    for b in range(B):
        table[b, :need[b]] = perm[at:at + need[b]]
        at += need[b]
    q = rng.standard_normal((B, K * G, hd)).astype(np.float32)
    kp = rng.standard_normal((P, page, K, hd)).astype(np.float32)
    vp = rng.standard_normal((P, page, K, hd)).astype(np.float32)
    return q, kp, vp, table, lens


@pytest.mark.parametrize("K,G", [(1, 1), (1, 5), (2, 1), (2, 5)])
def test_paged_plain_matches_reference_kernel(K, G):
    """Ragged lens, a mid-page tail, a dead row, -1 padding, W vs 2W."""
    hd, page = 32, 8
    lens = [19, 0, 8, 33]                 # mid-page, dead, page edge, tail
    q, kp, vp, table, lens = _paged_case(K * 10 + G, 4, K, G, hd, page, lens)
    scale = hd ** -0.5
    ref = np.asarray(jax_paged(q, kp, vp, table, lens, scale=scale,
                               interpret=True))
    out = pa_ops.paged_attention(to_torch(q), to_torch(kp), to_torch(vp),
                                 table, lens, scale=scale)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    wide = np.pad(table, ((0, 0), (0, table.shape[1])), constant_values=-1)
    out2 = pa_ops.paged_attention(to_torch(q), to_torch(kp), to_torch(vp),
                                  wide, lens, scale=scale)
    np.testing.assert_allclose(out2.numpy(), out.numpy(), rtol=0, atol=0)


def test_paged_plain_all_rows_dead():
    """Every row dead (an idle batch): exactly 0, never NaN."""
    q, kp, vp, table, lens = _paged_case(3, 2, 2, 3, 16, 4, [4, 4])
    table[:] = -1
    lens[:] = 0
    out = pa_ops.paged_attention(to_torch(q), to_torch(kp), to_torch(vp),
                                 table, lens, scale=0.25)
    assert torch.equal(out, torch.zeros_like(out))


def test_paged_plain_bf16_matches_reference_kernel():
    """bf16 in, bf16 out, fp32 inside — the serving dtype."""
    q, kp, vp, table, lens = _paged_case(7, 3, 2, 2, 64, 16, [40, 17, 1])
    scale = 64 ** -0.5
    ref = jax_paged(jnp.asarray(q, jnp.bfloat16),
                    jnp.asarray(kp, jnp.bfloat16),
                    jnp.asarray(vp, jnp.bfloat16), table, lens,
                    scale=scale, interpret=True)
    out = pa_ops.paged_attention(
        to_torch(q).bfloat16(), to_torch(kp).bfloat16(),
        to_torch(vp).bfloat16(), table, lens, scale=scale)
    assert out.dtype == torch.bfloat16
    # one bf16 rounding of the output apart at most
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=1e-2, atol=1e-2)


# ------------------------------------------------------------ flash prefill


@pytest.mark.parametrize("causal,window,cap,K,G", [
    (True, 0, 0.0, 2, 1),
    (False, 0, 0.0, 2, 2),
    (True, 64, 0.0, 2, 2),
    (True, 0, 30.0, 1, 5),
    (True, 32, 50.0, 2, 3),
])
def test_flash_plain_matches_reference_kernel(causal, window, cap, K, G):
    rng = np.random.default_rng(window + K * 7 + G)
    B, S, hd = 1, 256, 32
    q = rng.standard_normal((B, S, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    kw = dict(window=window, scale=hd ** -0.5, logit_cap=cap, causal=causal)
    kernel = np.asarray(jax_flash(q, k, v, interpret=True, **kw))
    oracle = np.asarray(jax_flash_ref(
        q.reshape(B, S, K * G, hd), k, v, window, scale=hd ** -0.5,
        logit_cap=cap, causal=causal)).reshape(kernel.shape)
    out = fa_ops.flash_attention(to_torch(q), to_torch(k), to_torch(v), **kw)
    assert out.shape == (B, S, K, G, hd)
    np.testing.assert_allclose(out.numpy(), kernel, **TOL)
    np.testing.assert_allclose(out.numpy(), oracle, **TOL)


@pytest.mark.parametrize("S", [1, 37, 300])
def test_flash_plain_ragged_length_matches_reference_oracle(S):
    """Prompt lengths no block divides: the port's kernel masks a ragged
    tail where the TPU kernel asserts; the reference oracle defines the
    function there."""
    rng = np.random.default_rng(S)
    K, G, hd = 2, 2, 16
    q = rng.standard_normal((2, S, K * G, hd)).astype(np.float32)
    k = rng.standard_normal((2, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((2, S, K, hd)).astype(np.float32)
    ref = np.asarray(jax_flash_ref(q, k, v, 0, scale=0.25))
    out = flash_attention_ref(to_torch(q), to_torch(k), to_torch(v), 0,
                              scale=0.25)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


# ---------------------------------------------------------------- dispatch


def _meta_paged():
    q = torch.empty((2, 10, 64), device="meta")
    kp = torch.empty((6, 16, 2, 64), device="meta")
    table = np.zeros((2, 3), np.int32)
    lens = np.ones((2,), np.int32)
    return q, kp, table, lens


def _meta_flash():
    q = torch.empty((1, 32, 2, 5, 64), device="meta")
    k = torch.empty((1, 32, 2, 64), device="meta")
    return q, k


def _meta_wkv6(dtype=torch.float32, hd=64):
    r = torch.empty((1, 20, 3, hd), dtype=dtype, device="meta")
    w = torch.empty((1, 20, 3, hd), device="meta")
    u = torch.empty((3, hd), device="meta")
    s0 = torch.empty((1, 3, hd, hd), device="meta")
    return r, w, u, s0


def _loader_raises(*_a, **_k):
    raise RuntimeError("kernel loader called")


OPS = ["paged", "flash", "wkv6", "segzero"]


@pytest.mark.parametrize("op", OPS)
def test_non_cpu_tensor_never_gets_the_plain_result(op, monkeypatch):
    """A tensor off the CPU goes to the kernel binding; with the kernel
    device pointed at it and the loader failing, the error propagates
    and no launch is counted — there is no fallback to the plain path."""
    monkeypatch.setattr(_build, "kernel", _loader_raises)
    if op == "wkv6":
        monkeypatch.setattr(wkv_bind, "KERNEL_DEVICE", "meta")
        r, w, u, s0 = _meta_wkv6()
        before = wkv_ops.wkv6.launches
        with pytest.raises(RuntimeError, match="kernel loader called"):
            wkv_ops.wkv6(r, r, r, w, u, s0)
        assert wkv_ops.wkv6.launches == before
    elif op == "segzero":
        monkeypatch.setattr(sz_bind, "KERNEL_DEVICE", "meta")
        before = sz_ops.segment_zero.launches
        with pytest.raises(RuntimeError, match="kernel loader called"):
            sz_ops.segment_zero(torch.empty((100,), device="meta"), 3, 9)
        assert sz_ops.segment_zero.launches == before
    elif op == "paged":
        monkeypatch.setattr(pa_bind, "KERNEL_DEVICE", "meta")
        q, kp, table, lens = _meta_paged()
        before = pa_ops.paged_attention.launches
        with pytest.raises(RuntimeError, match="kernel loader called"):
            pa_ops.paged_attention(q, kp, kp, table, lens, scale=0.1)
        assert pa_ops.paged_attention.launches == before
    else:
        monkeypatch.setattr(fa_bind, "KERNEL_DEVICE", "meta")
        q, k = _meta_flash()
        before = fa_ops.flash_attention.launches
        with pytest.raises(RuntimeError, match="kernel loader called"):
            fa_ops.flash_attention(q, k, k, window=0, scale=0.1)
        assert fa_ops.flash_attention.launches == before


@pytest.mark.parametrize("op", OPS)
def test_non_cuda_device_is_refused_by_the_binding(op):
    """Without the test override the binding accepts CUDA tensors only."""
    if op == "wkv6":
        r, w, u, s0 = _meta_wkv6()
        with pytest.raises(ValueError, match="CUDA"):
            wkv_ops.wkv6(r, r, r, w, u, s0)
    elif op == "segzero":
        with pytest.raises(ValueError, match="CUDA"):
            sz_ops.segment_zero(torch.empty((100,), device="meta"), 3, 9)
    elif op == "paged":
        q, kp, table, lens = _meta_paged()
        with pytest.raises(ValueError, match="CUDA"):
            pa_ops.paged_attention(q, kp, kp, table, lens, scale=0.1)
    else:
        q, k = _meta_flash()
        with pytest.raises(ValueError, match="CUDA"):
            fa_ops.flash_attention(q, k, k, window=0, scale=0.1)


# hd 320: past every kernel's largest instance (a smaller head dim is padded
# up to an instance: test_torch_head_dims.py)
@pytest.mark.parametrize("dtype,hd", [(torch.float16, 64), (torch.float32, 320)])
def test_bindings_refuse_what_the_kernels_do_not_take(dtype, hd, monkeypatch):
    monkeypatch.setattr(_build, "kernel", _loader_raises)
    monkeypatch.setattr(pa_bind, "KERNEL_DEVICE", "meta")
    monkeypatch.setattr(fa_bind, "KERNEL_DEVICE", "meta")
    monkeypatch.setattr(wkv_bind, "KERNEL_DEVICE", "meta")
    monkeypatch.setattr(sz_bind, "KERNEL_DEVICE", "meta")
    r, w, u, s0 = _meta_wkv6(dtype, hd)
    with pytest.raises(ValueError):
        wkv_ops.wkv6(r, r, r, w, u, s0)
    with pytest.raises(ValueError):     # float16, or not a flat buffer
        sz_ops.segment_zero(
            torch.empty((hd,) if dtype == torch.float16 else (2, hd),
                        dtype=dtype, device="meta"), 0, 1)
    q = torch.empty((2, 10, hd), dtype=dtype, device="meta")
    kp = torch.empty((6, 16, 2, hd), dtype=dtype, device="meta")
    with pytest.raises(ValueError):
        pa_ops.paged_attention(q, kp, kp, np.zeros((2, 3), np.int32),
                               np.ones((2,), np.int32), scale=0.1)
    qf = torch.empty((1, 8, 2, 2, hd), dtype=dtype, device="meta")
    kf = torch.empty((1, 8, 2, hd), dtype=dtype, device="meta")
    with pytest.raises(ValueError):
        fa_ops.flash_attention(qf, kf, kf, window=0, scale=0.1)


def test_flash_bf16_binding_refuses_misaligned_inputs(monkeypatch):
    """The bf16 route loads q/k/v by TMA, which needs 16-byte aligned
    bases: a view 2 bytes off is refused before any launch; the fp32 route
    has no such need and goes on to the kernel."""
    monkeypatch.setattr(_build, "kernel", _loader_raises)
    monkeypatch.setattr(fa_bind, "KERNEL_DEVICE", "cpu")
    for dtype in (torch.bfloat16, torch.float32):
        buf = torch.zeros(8 * 4 * 64 + 1, dtype=dtype)
        q = buf[1:].view(1, 8, 4, 64)
        k = torch.zeros((1, 8, 2, 64), dtype=dtype)
        assert q.is_contiguous() and q.data_ptr() % 16
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="aligned"):
                fa_bind.flash_attention_cuda(q, k, k, 0, scale=0.1)
        else:
            with pytest.raises(RuntimeError, match="kernel loader called"):
                fa_bind.flash_attention_cuda(q, k, k, 0, scale=0.1)


@pytest.mark.parametrize("page,W", [(16, 40), (8, 40), (16, 8)])
def test_paged_binding_passes_the_split_scratch(page, W, monkeypatch):
    """The wrapper allocates the fp32 split scratch of ``scratch_shape`` and
    passes its split count, which the entry point checks against W."""
    calls = []

    def fake_kernel(name, argtypes):
        def fn(*args):
            calls.append(args)
            return 0
        return fn

    monkeypatch.setattr(_build, "kernel", fake_kernel)
    monkeypatch.setattr(pa_bind, "KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    allocated = []
    empty = torch.empty

    def spy_empty(*shape, **kw):
        allocated.append((tuple(shape[0]) if len(shape) == 1 else shape, kw))
        return empty(*shape, **kw)

    monkeypatch.setattr(pa_bind.torch, "empty", spy_empty)
    q = torch.zeros((2, 10, 64))
    kp = torch.zeros((6, page, 2, 64))
    table = torch.zeros((2, W), dtype=torch.int32)
    lens = torch.ones((2,), dtype=torch.int32)
    pa_bind.paged_attention_cuda(q, kp, kp, table, lens, scale=0.1)
    (args,) = calls
    assert len(args) == len(pa_bind._ARGS)
    n_splits = -(-W // max(1, pa_bind.SPLIT_ROWS // page))
    assert args[13] == n_splits
    shape = pa_bind.scratch_shape(2, 2, 5, 64, page, W)
    assert shape == (2, 2, n_splits, 5, 66)
    assert (shape, {"dtype": torch.float32, "device": q.device}) in allocated


# ------------------------------------------------------------------- build


def test_c_entry_points_exist_in_the_sources():
    """Every symbol a binding looks up is an ``extern "C"`` of csrc/."""
    text = "\n".join(p.read_text() for p in _build.sources())
    exported = set(re.findall(r'extern "C"[^(]*?\b(repro_\w+)\s*\(', text))
    assert {"repro_paged_attention", "repro_flash_attention", "repro_wkv6",
            "repro_segment_zero", "repro_cuda_error_string"} <= exported
    names = {p.name for p in _build.sources()}
    assert {"paged_attention.cu", "flash_attention.cu", "wkv6.cu",
            "segment_zero.cu"} <= names
    # one library links every source: each symbol is defined once
    defs = re.findall(r'extern "C"[^(]*?\b(repro_\w+)\s*\(', text)
    assert len(defs) == len(set(defs)), sorted(defs)
    # each binding passes as many arguments as its entry point takes
    # (ctypes would not notice a mismatch)
    params = {name: len(args.split(",")) for name, args in re.findall(
        r'extern "C"[^(]*?\b(repro_\w+)\s*\(([^)]*)\)', text)}
    for name, binding in (("repro_paged_attention", pa_bind),
                          ("repro_flash_attention", fa_bind),
                          ("repro_wkv6", wkv_bind),
                          ("repro_segment_zero", sz_bind)):
        assert params[name] == len(binding._ARGS), name
    # the split length the paged wrapper sizes its scratch by is the
    # kernel's own
    rows = re.search(r"kSplitRows = (\d+);", text)
    assert rows and int(rows.group(1)) == pa_bind.SPLIT_ROWS


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No nvcc: a clear error, and nothing is loaded or cached."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_cache_key_tracks_the_sources(tmp_path, monkeypatch):
    """The cached library's name changes with any source byte."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.sources():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "_CSRC", csrc)
    before = _build._digest()
    assert _build._digest() == before
    first = sorted(csrc.glob("*.cu"))[0]
    first.write_text(first.read_text() + "\n// edited\n")
    assert _build._digest() != before


def test_build_dir_is_ignored_by_git(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    root = Path(__file__).resolve().parents[1]
    ignored = (root / ".gitignore").read_text().split()
    rel = _build.build_dir().resolve().relative_to(root).as_posix() + "/"
    assert rel in ignored
