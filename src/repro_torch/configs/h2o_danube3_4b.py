"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 -- llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]

SWA (window 4096) is sub-quadratic: the KV cache is a 4096-slot ring
buffer, so ``long_500k`` RUNS for this arch (DESIGN.md shape skips).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o_danube3_4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    act="silu",
    sliding_window=4096,
    rope_theta=1e5,
    tie_embeddings=False,
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
    sliding_window=16,
    attn_q_block=32,
    attn_kv_block=32,
)
