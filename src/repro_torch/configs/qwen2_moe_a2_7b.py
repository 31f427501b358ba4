"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (MHA kv=16) d_ff=1408
vocab=151936, 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

Expert parallelism: 60 experts padded to 64 over the 16-way model axis
(4 local experts / device; padded experts masked out of routing).  The
4 shared experts are modeled as one dense FFN of width 4*1408 = 5632
(the HF config's shared_expert_intermediate_size).  The EP all_to_all
emitted per MoE layer is the SWOT planner's pairwise/Bruck-schedulable
collective -- the paper-representative arch.  Full attention =>
``long_500k`` skipped.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_moe_a2_7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=5632,  # shared-expert path width
    vocab_size=151936,
    act="silu",
    qkv_bias=True,
    n_experts=60,
    top_k=4,
    moe_d_ff=1408,
    n_shared_experts=4,
    fsdp_params=True,
    shared_d_ff=5632,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=96,
    n_experts=6,
    top_k=2,
    moe_d_ff=32,
    n_shared_experts=1,
    shared_d_ff=96,
    vocab_size=256,
    vocab_pad_multiple=8,
    attn_q_block=32,
    attn_kv_block=32,
)
