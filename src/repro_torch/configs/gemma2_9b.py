"""gemma2-9b [dense] — local+global alternating, logit softcaps.

[arXiv:2408.00118; hf:google/gemma-2-9b]  42L d_model=3584 16H (kv=8,
head_dim=256) d_ff=14336 vocab=256000; sliding window 4096 on alternating
layers; attn-logit softcap 50, final-logit softcap 30; sandwich norms;
embeddings scaled by sqrt(d_model); GeGLU.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma2-9b", family="dense",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    local_window=4096, pattern_local=1, pattern_global=1,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    query_scale=256 ** -0.5, post_norms=True, embed_scale=True,
    activation="gelu_tanh",
)

REDUCED = ArchConfig(
    arch_id="gemma2-9b-smoke", family="dense",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    local_window=8, pattern_local=1, pattern_global=1,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    query_scale=16 ** -0.5, post_norms=True, embed_scale=True,
    activation="gelu_tanh",
)
