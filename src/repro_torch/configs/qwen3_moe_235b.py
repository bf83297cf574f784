"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8, QK-norm.

[hf:Qwen/Qwen3-235B-A22B (scaled from Qwen3-30B-A3B card); hf]
94L d_model=4096 64H (kv=4, head_dim=128) expert_d_ff=1536 vocab=151936;
softmax-over-top-k router (norm_topk_prob), no shared expert.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936,
    num_experts=128, experts_per_token=8, expert_d_ff=1536,
    qk_norm=True, rope_base=1_000_000.0, tie_embeddings=False,
)

REDUCED = ArchConfig(
    arch_id="qwen3-moe-smoke", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=256,
    num_experts=8, experts_per_token=2, expert_d_ff=32,
    qk_norm=True, rope_base=1_000_000.0, tie_embeddings=False,
)
