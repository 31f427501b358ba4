"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 -- GQA with QKV bias.  [arXiv:2407.10671; hf]

Pure full attention => ``long_500k`` skipped.  12 q-heads / 2 kv-heads
fall back to replicated attention on the 16-way model axis.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_1_5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    act="silu",
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=48,
    n_heads=3,
    n_kv_heads=1,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    vocab_pad_multiple=8,
    attn_q_block=32,
    attn_kv_block=32,
)
