"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=32000, ssm_state=64 -- Mamba2 stack + a SHARED attention block
(one set of weights) applied every 6 Mamba2 layers.
[arXiv:2411.15242; hf]

Layout here: 6 groups of (6 Mamba2 layers + shared attn/FFN block) + 2
trailing Mamba2 layers = 38 Mamba2 layers, 6 shared-block invocations
(each invocation keeps its own KV cache).  Hybrid => ``long_500k`` runs;
the shared-block KV cache for the 500k cell is sharded over the data
axis (kv_seq rule).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2_1_2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid_period=6,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    ssm_state=16,
    ssm_head_dim=16,
    hybrid_period=2,
    vocab_size=256,
    vocab_pad_multiple=8,
    ssm_chunk=16,
    attn_q_block=32,
    attn_kv_block=32,
)
