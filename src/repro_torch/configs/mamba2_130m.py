"""mamba2-130m [ssm]: 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128 -- SSD (state-space duality).  [arXiv:2405.21060; unverified]

d_inner = 2*768 = 1536, head_dim 64 => 24 SSD heads (not divisible by the
16-way model axis; the rules engine replicates SSM heads -- the model is
130M params, so replication is cheap).  Decode state is O(1) in sequence
length: all decode cells incl. ``long_500k`` run.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2_130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    ssm_state=16,
    ssm_head_dim=16,
    vocab_size=256,
    vocab_pad_multiple=8,
    ssm_chunk=16,
)
