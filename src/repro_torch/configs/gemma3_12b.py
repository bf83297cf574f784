"""gemma3-12b [dense] — 5:1 local:global, 128k context.

[hf:google/gemma-3-12b-pt (scaled from 1b-pt card); unverified]
48L d_model=3840 16H (kv=8, head_dim=256) d_ff=15360 vocab=262144;
window 1024 on 5-of-6 layers; RoPE base 1M (global) / 10k (local);
QK-norm instead of softcap; sandwich norms.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262144,
    local_window=1024, pattern_local=5, pattern_global=1,
    rope_base=1_000_000.0, rope_base_local=10_000.0,
    qk_norm=True, query_scale=256 ** -0.5, post_norms=True, embed_scale=True,
    activation="gelu_tanh",
)

REDUCED = ArchConfig(
    arch_id="gemma3-12b-smoke", family="dense",
    num_layers=6, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    local_window=8, pattern_local=5, pattern_global=1,
    rope_base=1_000_000.0, rope_base_local=10_000.0,
    qk_norm=True, query_scale=16 ** -0.5, post_norms=True, embed_scale=True,
    activation="gelu_tanh",
)
