"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]  48L d_model=5120 40H
(kv=8, head_dim=128) expert_d_ff=8192 vocab=202048; sigmoid top-1 router
with a shared expert; chunked-local attention (8192) on 3-of-4 layers
modeled as sliding window (DESIGN.md §4); vision patches fuse as a
256-token prefix (frontend stub).
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    num_experts=16, experts_per_token=1, expert_d_ff=8192,
    num_shared_experts=1, router_score="sigmoid_top1",
    local_window=8192, pattern_local=3, pattern_global=1,
    rope_base=500_000.0, num_patches=256, tie_embeddings=False,
)

REDUCED = ArchConfig(
    arch_id="llama4-scout-smoke", family="moe",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=256,
    num_experts=4, experts_per_token=1, expert_d_ff=64,
    num_shared_experts=1, router_score="sigmoid_top1",
    local_window=16, pattern_local=3, pattern_global=1,
    rope_base=500_000.0, num_patches=4, tie_embeddings=False,
)
