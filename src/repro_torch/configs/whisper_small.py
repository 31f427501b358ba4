"""whisper-small [audio]: 12+12L d_model=768 12H (MHA kv=12) d_ff=3072
vocab=51865 -- encoder-decoder, conv frontend STUB.
[arXiv:2212.04356; unverified]

``input_specs()`` provides precomputed frame embeddings (B, 1500, 768)
in place of the mel+conv frontend.  Learned decoder positions (448-entry
table, clamped beyond -- the assigned 32k decode cells exercise the KV
cache, not the position table).  Vocab 51865 pads to 51968 (x128) so it
shards 16 ways.  Full attention => ``long_500k`` skipped; 12 heads fall
back to replicated attention on the 16-way model axis.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper_small",
    family="audio",
    n_layers=12,
    n_encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    act="gelu",
    norm="layernorm",
    norm_eps=1e-5,
    qkv_bias=True,
    use_rope=False,
    learned_pos=448,
    n_audio_frames=1500,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)

SMOKE = CONFIG.replace(
    n_layers=2,
    n_encoder_layers=2,
    d_model=48,
    n_heads=3,
    n_kv_heads=3,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    vocab_pad_multiple=8,
    learned_pos=64,
    n_audio_frames=32,
    attn_q_block=32,
    attn_kv_block=32,
)
