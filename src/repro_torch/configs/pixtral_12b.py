"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 -- pixtral-ViT frontend + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]

The vision encoder is a STUB per the assignment: ``input_specs()``
provides precomputed, projected patch embeddings (B, 256, d_model) that
replace the first 256 token positions (early fusion).  Pure full
attention => ``long_500k`` skipped.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral_12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    act="silu",
    rope_theta=1e9,
    tie_embeddings=False,
    fsdp_params=True,
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
    vocab_size=256,
    vocab_pad_multiple=8,
    n_image_patches=8,
    attn_q_block=32,
    attn_kv_block=32,
)
