"""llava-next-34b [vlm] — anyres tiling stub over a 34B LM backbone.

[hf:llava-hf/llava-v1.6-34b (Yi-34B backbone); unverified]
60L d_model=7168 56H (kv=8, head_dim=128) d_ff=20480 vocab=64000;
576 patch embeddings fuse as the sequence prefix (frontend stub).
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    rope_base=5_000_000.0, num_patches=576, tie_embeddings=False,
)

REDUCED = ArchConfig(
    arch_id="llava-next-34b-smoke", family="vlm",
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=128, vocab_size=256,
    rope_base=5_000_000.0, num_patches=4, tie_embeddings=False,
)
