"""whisper-tiny [audio] — enc-dec; conv/mel frontend is a stub.

[arXiv:2212.04356; unverified]  4L encoder + 4L decoder, d_model=384,
6H (kv=6, head_dim=64), d_ff=1536, vocab=51865; encoder length 1500;
LayerNorm, plain GELU MLP, learned decoder positions.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    encoder_layers=4, encoder_len=1500,
    activation="gelu", gated=False, norm_eps=1e-5,
)

REDUCED = ArchConfig(
    arch_id="whisper-tiny-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256,
    encoder_layers=2, encoder_len=16,
    activation="gelu", gated=False, norm_eps=1e-5,
)
