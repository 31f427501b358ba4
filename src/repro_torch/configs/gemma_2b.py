"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000 -- GeGLU, head_dim=256, embeddings scaled by sqrt(d),
(1+w) RMSNorm.  [arXiv:2403.08295; hf]

Pure full attention => ``long_500k`` skipped.  8 q-heads / 1 kv-head are
not divisible by the 16-way model axis: the sharding rules engine
replicates attention heads and shards the 16384-wide FFN + 256000 vocab
instead (DESIGN.md section 7).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma_2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    act="gelu",
    embed_scale=True,
    rms_offset=True,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=256,
    vocab_size=256,
    vocab_pad_multiple=8,
    attn_q_block=32,
    attn_kv_block=32,
)
