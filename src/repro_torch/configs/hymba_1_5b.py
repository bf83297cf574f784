"""hymba-1.5b [hybrid] — parallel attention + Mamba heads.

[arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base]  32L d_model=1600 25H (kv=5,
head_dim=64) d_ff=5504 vocab=32001 ssm_state=16; SWA 1024 except
first/middle/last global layers.  Meta tokens and the SSM depthwise conv
are omitted (backbone-only scope; DESIGN.md §4).
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    ssm_state_size=16, ssm_d_inner=3200, local_window=1024,
)

REDUCED = ArchConfig(
    arch_id="hymba-1.5b-smoke", family="hybrid",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    ssm_state_size=4, ssm_d_inner=128, local_window=8,
)
