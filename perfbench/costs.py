"""The benchmark's own operation and byte counts, and the H100's peaks.

Counts follow the algorithm, not the kernel: each input byte is read
once and each output byte written once, and only what the inputs need
is counted (the live rows of a paged batch, the causal half of a
prompt's scores).  They take the configuration as the benchmark's own
``port`` block of a configuration file (a plain dict), never an object
of the program.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence, Tuple

__all__ = [
    "PEAK_BF16_FLOPS", "PEAK_HBM_BYTES", "bound_seconds", "k1_counts",
    "k2_counts", "layer_matmul_params", "prefill_flops", "decode_flops",
]

#: one NVIDIA H100 SXM (data sheet; dense, no sparsity, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _dims(cfg: Mapping) -> Tuple[int, int, int, int, int, int, int, bool]:
    H, K = cfg["num_heads"], cfg["num_kv_heads"]
    D = cfg["d_model"]
    hd = cfg.get("head_dim") or D // H
    return (D, H, K, hd, cfg["d_ff"], cfg["vocab_size"], cfg["num_layers"],
            bool(cfg.get("gated", True)))


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two terms."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def k1_counts(cfg: Mapping, lens: Iterable[int], page_size: int,
              esize: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one paged decode attention call (one layer) over
    the live lanes' lengths ``lens`` (rows attended, ``pos + 1``): QK and
    PV, 4·H·hd a row; bytes are each live lane's K and V rows, its page
    table entries and length, its q row read and its output row
    written."""
    _, H, K, hd, *_ = _dims(cfg)
    flops = 0.0
    nbytes = 0.0
    for n in lens:
        flops += 4.0 * H * hd * n
        nbytes += (2.0 * n * K * hd * esize        # K and V rows
                   + 4.0 * -(-n // page_size)      # page table entries
                   + 4.0                           # its length
                   + 2.0 * H * hd * esize)         # q in, output out
    return flops, nbytes


def k2_counts(cfg: Mapping, sq: int, sk: int, q_offset: int = 0,
              causal: bool = True, window: int = 0,
              esize: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one prefill flash attention call (one layer,
    batch 1): query row i sits at position ``q_offset + i`` and sees the
    keys at or before it (within ``window`` when > 0); QK and PV, 4·H·hd
    a (query, key) pair; bytes are q, k, v read and the output written."""
    _, H, K, hd, *_ = _dims(cfg)
    if not causal and window <= 0:
        pairs = sq * sk
    elif window <= 0 and q_offset + sq <= sk:
        pairs = sq * q_offset + sq * (sq + 1) // 2
    else:
        pairs = 0
        for i in range(sq):
            p = q_offset + i
            hi = min(p + 1, sk) if causal else sk
            lo = max(0, p - window + 1) if window > 0 else 0
            pairs += max(hi - lo, 0)
    flops = 4.0 * H * hd * pairs
    nbytes = esize * (2.0 * sq * H * hd + 2.0 * sk * K * hd)
    return flops, nbytes


def layer_matmul_params(cfg: Mapping) -> int:
    """Weights one token multiplies through in one layer: q, k, v, o and
    the MLP (three matrices gated, two plain)."""
    D, H, K, hd, F, _, _, gated = _dims(cfg)
    return D * H * hd + 2 * D * K * hd + H * hd * D + (3 if gated else 2) * D * F


def prefill_flops(cfg: Mapping, tokens: int, start: int = 0,
                  logit_rows: int = 1) -> float:
    """Useful FLOPs of prefilling ``tokens`` positions from ``start`` (the
    rows before it resident, a shared prefix): every layer's products and
    causal attention over ``[0, position]``, and the head for
    ``logit_rows`` rows (a prefill scores its last position)."""
    D, H, _, hd, _, V, L, _ = _dims(cfg)
    attn_pairs = tokens * start + tokens * (tokens + 1) // 2
    return (2.0 * layer_matmul_params(cfg) * L * tokens
            + 4.0 * H * hd * attn_pairs * L + 2.0 * D * V * logit_rows)


def decode_flops(cfg: Mapping, lens: Sequence[int]) -> float:
    """Useful FLOPs of one decode step over the live lanes, each attending
    ``lens[i]`` rows: its token's products in every layer, its attention
    and its logits."""
    D, H, _, hd, _, V, L, _ = _dims(cfg)
    per_token = 2.0 * layer_matmul_params(cfg) * L + 2.0 * D * V
    return sum(per_token + 4.0 * H * hd * n * L for n in lens)
