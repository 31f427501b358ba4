"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192, 16 routed experts top-1 + 1 shared expert, vocab=202048,
early fusion.  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

~109B total / ~17B active parameters.  Experts shard 1:1 over the 16-way
model axis (EP); expert FFN width additionally shards over the data axes
(FSDP-style per-layer all-gather) so bf16 weights fit the 16 GB/chip
budget.  Early fusion uses the same precomputed-patch stub as pixtral.
The assignment line specifies full attention ("MoE, early fusion"), so
``long_500k`` is skipped (DESIGN.md).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4_scout_17b_16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,  # shared-expert path width
    vocab_size=202048,
    act="silu",
    n_experts=16,
    top_k=1,
    moe_d_ff=8192,
    n_shared_experts=1,
    shared_d_ff=8192,
    fsdp_experts=True,
    fsdp_params=True,
    rope_theta=5e5,
    tie_embeddings=False,
    n_image_patches=256,
    skip_shapes=("long_500k",),
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    n_experts=4,
    top_k=1,
    moe_d_ff=128,
    n_shared_experts=1,
    shared_d_ff=128,
    fsdp_experts=False,
    vocab_size=256,
    vocab_pad_multiple=8,
    n_image_patches=8,
    attn_q_block=32,
    attn_kv_block=32,
)
