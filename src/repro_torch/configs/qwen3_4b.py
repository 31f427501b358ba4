"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936 -- qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]

Pure full attention => ``long_500k`` is skipped (DESIGN.md shape skips).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3_4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    act="silu",
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    vocab_pad_multiple=8,
    attn_q_block=32,
    attn_kv_block=32,
)
