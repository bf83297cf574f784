"""starcoder2-7b [dense] — full attention, GQA kv=4, plain GELU MLP.

[arXiv:2402.19173; hf:bigcode/starcoder2-7b]  32L d_model=4608 36H (kv=4)
d_ff=18432 vocab=49152; RoPE theta ~1e6; biased projections; non-gated MLP.
(RMSNorm substituted for LayerNorm — noted in DESIGN.md.)
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    d_ff=18432, vocab_size=49152,
    qkv_bias=True, rope_base=1_000_000.0, activation="gelu_tanh", gated=False,
    tie_embeddings=False,
)

REDUCED = ArchConfig(
    arch_id="starcoder2-7b-smoke", family="dense",
    num_layers=3, d_model=72, num_heads=6, num_kv_heads=2,
    d_ff=144, vocab_size=256,
    qkv_bias=True, rope_base=1_000_000.0, activation="gelu_tanh", gated=False,
    tie_embeddings=False,
)
