"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent decay.

[arXiv:2404.05892; hf:RWKV/rwkv-6-world-3b]  32L d_model=2560 d_ff=8960
vocab=65536; head_size 64 (40 WKV heads); O(1) decode state.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=8960, vocab_size=65536, rwkv_head_size=64,
)

REDUCED = ArchConfig(
    arch_id="rwkv6-3b-smoke", family="ssm",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=224, vocab_size=256, rwkv_head_size=16,
)
