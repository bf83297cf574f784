"""qwen2.5-32b [dense] — GQA with QKV bias.

[hf:Qwen/Qwen2.5-32B (scaled from 0.5B card); hf]  64L d_model=5120 40H
(kv=8) d_ff=27648 vocab=152064; RoPE base 1e6; untied embeddings.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=27648, vocab_size=152064,
    qkv_bias=True, rope_base=1_000_000.0, tie_embeddings=False,
)

REDUCED = ArchConfig(
    arch_id="qwen2.5-32b-smoke", family="dense",
    num_layers=3, d_model=80, num_heads=5, num_kv_heads=1,
    d_ff=160, vocab_size=256,
    qkv_bias=True, rope_base=1_000_000.0, tie_embeddings=False,
)
