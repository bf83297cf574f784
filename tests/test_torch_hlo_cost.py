"""The port's cost model (``repro_torch.launch.hlo_cost``) against the
reference's ``analyze_hlo`` and ``torch.utils.flop_counter``: the four cases
of ``tests/test_hlo_cost.py``, the fused byte count against the eager one,
and a chunk-counted token loop against the whole loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._higher_order_ops.scan import scan as torch_scan
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.launch.hlo_cost import analyze_hlo
from repro_torch.launch.hlo_cost import (
    CostMode,
    analyze_graph,
    wire_bytes,
)
from repro_torch.models.hybrid import ssm_scan
from repro_torch.models.rwkv import wkv6_scan

RNG = np.random.default_rng(0)


def _t(*shape):
    return torch.from_numpy(RNG.standard_normal(shape).astype(np.float32))


def test_loop_free_matches_flop_counter_and_reference():
    a, b = _t(128, 128), _t(128, 128)
    mine, _ = analyze_graph(lambda a, b: ((a @ b) @ b).sum(), (a, b))
    with FlopCounterMode(display=False) as fc:
        ((a @ b) @ b).sum()
    assert abs(mine.flops - fc.get_total_flops()) / fc.get_total_flops() < 0.05
    comp = jax.jit(lambda a, b: ((a @ b) @ b).sum()).lower(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy())).compile()
    ref = analyze_hlo(comp.as_text()).flops
    assert abs(mine.flops - ref) / ref < 0.05


@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
def test_scan_trip_multiplication(fake):
    def g(x, w):
        return torch_scan(lambda h, t: (torch.tanh(h @ w), h.clone()),
                          x, torch.zeros(12, 1))[0].sum()

    x, w = _t(64, 64), _t(64, 64)
    if fake:
        with FakeTensorMode() as fm:
            mine, _ = analyze_graph(g, (fm.from_tensor(x), fm.from_tensor(w)))
    else:
        mine, _ = analyze_graph(g, (x, w))
    expect = 12 * 2 * 64 ** 3
    assert abs(mine.flops - expect) / expect < 0.05
    assert 12 in mine.while_trip_counts


def test_scan_grad_equals_unrolled():
    w = _t(6, 32, 32) * 0.1
    x = _t(8, 32)

    def scan_loss(p, x):
        h = torch_scan(lambda h, w: (torch.tanh(h @ w), h.clone()), x, p)[0]
        return h.sum()

    def unrolled_loss(p, x):
        h = x
        for i in range(6):
            h = torch.tanh(h @ p[i])
        return h.sum()

    costs = []
    for f in (scan_loss, unrolled_loss):
        def step(p, x, f=f):
            p = p.detach().requires_grad_(True)
            return torch.autograd.grad(f(p, x), p)[0].sum()
        costs.append(analyze_graph(step, (w, x))[0].flops)
    assert abs(costs[0] - costs[1]) / costs[1] < 0.15


@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collectives_counted_with_groups(fake_world):
    group = dist.new_group(list(range(16)))
    with FakeTensorMode():
        x = torch.empty(64, 128)
        mine, _ = analyze_graph(lambda x: dist.all_reduce(x, group=group),
                                (x,))
    nbytes = 64 * 128 * 4
    assert mine.collectives["all-reduce"]["count"] == 1
    assert abs(mine.wire_bytes - 2 * nbytes * 15 / 16) < 1
    hlo = """
HloModule m

ENTRY %main (p: f32[64,128]) -> f32[64,128] {
  %p = f32[64,128]{1,0} parameter(0)
  ROOT %ar = f32[64,128]{1,0} all-reduce(%p), replica_groups=[16,16]<=[256], to_apply=%add
}
"""
    ref = analyze_hlo(hlo)
    assert ref.collectives["all-reduce"]["count"] == 1
    assert abs(mine.wire_bytes - ref.wire_bytes) < 1
    # ranks 0..15 span two nodes of 8 cards: the network carries it
    assert mine.wire_by_link == {"network": mine.wire_bytes}


def test_collective_kinds_and_links(fake_world):
    """Each of the four collectives a training mesh runs, by its kind,
    with the reference's wire bytes; a group inside one node rides
    NVLink."""
    node = dist.new_group(list(range(8)))
    with FakeTensorMode():
        x = torch.empty(64, 128)
        nb = 64 * 128 * 4

        def step(x):
            out = torch.empty(8 * 64, 128)
            dist.all_gather_into_tensor(out, x, group=node)
            dist.all_gather([torch.empty_like(x) for _ in range(8)], x,
                            group=node)
            dist.reduce_scatter_tensor(torch.empty(8, 128), x, group=node)
            dist.all_to_all_single(torch.empty_like(x), x, group=node)

        mine, _ = analyze_graph(step, (x,))
    c = mine.collectives
    assert c["all-gather"]["count"] == 2
    assert c["all-gather"]["wire"] == 2 * wire_bytes("all-gather", 8 * nb, 8)
    assert c["reduce-scatter"]["wire"] == wire_bytes("reduce-scatter",
                                                     nb / 8, 8)
    assert c["all-to-all"]["wire"] == wire_bytes("all-to-all", nb, 8)
    assert mine.wire_by_link == {"nvlink": mine.wire_bytes}


def test_fused_bytes_never_exceed_eager():
    """The fused rule drops elementwise traffic and charges gathers and
    in-place updates by their windows: below the eager count, which
    charges every operand and result whole."""
    w = _t(1000, 64)

    def step(idx, x, w):
        h = torch.nn.functional.embedding(idx, w)         # gather
        h = torch.tanh(h * 2.0 + 1.0)                     # fused away
        y = h @ x                                         # charged whole
        buf = torch.zeros(4096, 64)
        buf[:64] = y                                      # update window
        return buf.sum()

    idx = torch.from_numpy(RNG.integers(0, 1000, (64,)))
    cost, _ = analyze_graph(step, (idx, _t(64, 64), w))
    assert 0 < cost.bytes < cost.bytes_eager
    mm = 3 * 64 * 64 * 4
    assert cost.bytes >= mm                               # the product


def test_peak_counts_resident_and_live():
    x = torch.zeros(1024, 1024)                  # 4 MiB resident

    def step(x):
        a = x + 1                                # +4 MiB
        b = a * 2                                # +4 MiB, a still live
        del a
        return b.sum()

    cost, _ = analyze_graph(step, (x,))
    assert cost.resident_bytes == 4 * 2 ** 20
    assert cost.peak_bytes == 3 * 4 * 2 ** 20


@pytest.mark.parametrize("loop", ["wkv6", "ssm"])
@pytest.mark.parametrize("grad", [False, True], ids=["fwd", "fwd+bwd"])
def test_chunked_token_loop_matches_whole(loop, grad):
    """A token loop counted on 128 tokens and scaled to 256 gives the
    whole loop's FLOPs and fused bytes (its work is linear in T)."""
    B, T = 2, 256
    if loop == "wkv6":
        H, hd = 4, 16
        args = [_t(B, T, H, hd) for _ in range(3)] + [
            torch.rand(B, T, H, hd), _t(H, hd), torch.zeros(B, H, hd, hd)]
        fn = wkv6_scan
    else:
        di, N = 32, 8
        args = [_t(B, T, di), torch.rand(B, T, di), _t(B, T, N),
                _t(B, T, N), -torch.rand(di, N), torch.zeros(B, di, N)]
        fn = ssm_scan

    def step(*args):
        if not grad:
            return fn(*args)
        leaves = [a.detach().requires_grad_(True) for a in args[:4]]
        s, y = fn(*leaves, *args[4:])
        return torch.autograd.grad(y.sum() + s.sum(), leaves)

    whole, out_w = analyze_graph(step, args)
    chunk, out_c = analyze_graph(step, args, loop_chunk=128)
    assert abs(chunk.flops - whole.flops) / whole.flops < 0.01
    assert abs(chunk.bytes - whole.bytes) / whole.bytes < 0.01
    assert chunk.ops < 0.6 * whole.ops
    for a, b in zip(out_w, out_c):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_h100_constants_in_roofline():
    from repro_torch.launch.hlo_cost import HBM_BW, PEAK_FLOPS, HloCost

    c = HloCost(flops=2e12, bytes=3.35e9,
                flops_by_dtype={"bfloat16": 989e12, "float32": 67e12},
                wire_by_link={"nvlink": 450e9, "network": 100e9})
    r = c.roofline()
    assert r["compute_s"] == pytest.approx(2.0)
    assert r["memory_s"] == pytest.approx(3.35e9 / HBM_BW)
    assert r["collective_s"] == pytest.approx(1.0 + 2.0)
    assert r["dominant"] == "collective"
    assert PEAK_FLOPS[torch.bfloat16] == 989e12
    assert isinstance(CostMode().cost, HloCost)


def test_while_loop_trips_and_cond_branches():
    """A ``while_loop`` on real tensors is counted by the trips it makes;
    a ``cond`` counts both branches once, as the reference counts every
    branch of a ``conditional``; the results are the operators' own."""
    from torch._higher_order_ops.while_loop import while_loop

    w = _t(32, 32)

    def loop(i, h):
        return while_loop(lambda i, h: i < 5,
                          lambda i, h: (i + 1, torch.tanh(h @ w)), (i, h))

    i0, h0 = torch.tensor(0), _t(8, 32)
    cost, (i, h) = analyze_graph(loop, (i0, h0))
    assert int(i) == 5 and cost.while_trip_counts == [5]
    assert cost.flops == 5 * 2 * 8 * 32 * 32
    want = h0
    for _ in range(5):
        want = torch.tanh(want @ w)
    torch.testing.assert_close(h, want)

    def branch(x):
        return torch.cond(x.sum() > 0, lambda v: v @ w,
                          lambda v: (v @ w) @ w, (x,))

    cost, _ = analyze_graph(branch, (h0,))
    assert cost.flops == 3 * 2 * 8 * 32 * 32
