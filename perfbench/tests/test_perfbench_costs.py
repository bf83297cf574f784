"""The benchmark's operation and byte counts: K1 and K2 by hand, and the
whole step's FLOPs against ``FlopCounterMode`` on the program's plain
path (a small configuration, fp32, on the CPU)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import costs
from perfbench.tests.perfbench_tiny import TINY_PORT

QWEN = {"num_layers": 32, "d_model": 5120, "num_heads": 40,
        "num_kv_heads": 8, "d_ff": 27648, "vocab_size": 152064}


def test_k1_counts_by_hand():
    flops, nbytes = costs.k1_counts(QWEN, [100, 17], page_size=16)
    H, K, hd = 40, 8, 128
    assert flops == 4 * H * hd * 117
    want = (2 * 117 * K * hd * 2            # K and V rows, bf16
            + 4 * (7 + 2)                   # page-table entries: 7 + 2 pages
            + 4 * 2                         # two lengths
            + 2 * 2 * H * hd * 2)           # q and output rows, two lanes
    assert nbytes == want


def test_k2_counts_by_hand():
    H, K, hd = 40, 8, 128
    flops, nbytes = costs.k2_counts(QWEN, 4, 4)
    assert flops == 4 * H * hd * (1 + 2 + 3 + 4)
    assert nbytes == 2 * (2 * 4 * H * hd + 2 * 4 * K * hd)
    # query rows at an offset see the prefix: rows 2..3 of 4 keys
    f_off, _ = costs.k2_counts(QWEN, 2, 4, q_offset=2)
    assert f_off == 4 * H * hd * (3 + 4)
    # a window of 2 keys
    f_w, _ = costs.k2_counts(QWEN, 4, 4, window=2)
    assert f_w == 4 * H * hd * (1 + 2 + 2 + 2)
    f_nc, _ = costs.k2_counts(QWEN, 3, 5, causal=False)
    assert f_nc == 4 * H * hd * 15


def test_bound_takes_the_larger_term():
    assert costs.bound_seconds(989e12, 0) == pytest.approx(1.0)
    assert costs.bound_seconds(0, 3.35e12) == pytest.approx(1.0)
    # K1 at the kernel table's shape (PERF.md): 9802 live rows, G = 5
    _, nbytes = costs.k1_counts(QWEN, [9802 // 4] * 4, 16)
    assert costs.bound_seconds(0, nbytes) == pytest.approx(12.0e-6, rel=0.02)


def _tiny_model():
    from repro_torch.models import build_model
    from repro_torch.models.common import ArchConfig

    port = dict(TINY_PORT, dtype="float32")
    model = build_model(ArchConfig(**port), device="cpu")
    return port, model.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("S", [3, 17, 40])
def test_prefill_flops_against_flop_counter(S):
    port, model = _tiny_model()
    H, hd, L = 4, 16, 2
    tokens = torch.randint(0, port["vocab_size"], (1, S))
    with FlopCounterMode(display=False) as fc:
        model.paged_prefill(tokens)
    # the plain attention scores every (query, key) pair, the count only
    # the causal ones
    plain = 4 * H * hd * S * S * L
    causal = 4 * H * hd * (S * (S + 1) // 2) * L
    assert fc.get_total_flops() == costs.prefill_flops(port, S) - causal + plain


def test_decode_flops_against_flop_counter():
    port, model = _tiny_model()
    B, page, W = 3, 16, 4
    H, hd, L = 4, 16, 2
    pool = model.init_paged_state(B * W, page)
    table = torch.arange(B * W, dtype=torch.int32).reshape(B, W)
    pos = torch.tensor([20, 33, 47], dtype=torch.int32)
    tokens = torch.randint(0, port["vocab_size"], (B,))
    with FlopCounterMode(display=False) as fc:
        model.paged_decode_step(pool, tokens, table, pos)
    lens = [int(p) + 1 for p in pos]
    # the plain paged attention scores every row of the pages the longest
    # lane needs, for every lane
    rows = -(-max(lens) // page) * page
    plain = B * 4 * H * hd * rows * L
    useful = sum(4 * H * hd * n * L for n in lens)
    assert fc.get_total_flops() == costs.decode_flops(port, lens) - useful + plain
