"""Architecture configuration schema.

One ``ArchConfig`` per assigned architecture (see ``repro_torch.configs.registry``)
plus reduced variants for smoke tests.  Every field corresponds to a public
config of the source model; deviations are documented in DESIGN.md.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) evaluation cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)


def shape_cell(name: str) -> ShapeCell:
    for cell in SHAPES:
        if cell.name == name:
            return cell
    raise KeyError(f"unknown shape {name!r}; have {[c.name for c in SHAPES]}")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # default d_model // n_heads
    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU / plain MLP)
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: int | None = None
    tie_embeddings: bool = True
    embed_scale: bool = False  # Gemma: embeddings * sqrt(d_model)
    rms_offset: bool = False  # Gemma: (1 + w) RMSNorm
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    fsdp_experts: bool = False
    fsdp_params: bool = False  # ZeRO/FSDP: shard params+opt over data
    moe_token_slice: bool = False  # EP token slicing (Perf lever)
    aux_loss_coef: float = 0.01
    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # Hybrid (Zamba2): one shared attention block every ``hybrid_period``
    # Mamba2 layers (weights shared across invocations).
    hybrid_period: int = 0
    # Encoder-decoder (Whisper)
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500
    use_rope: bool = True
    learned_pos: int = 0  # >0: learned absolute positions (clamped table)
    # Early fusion (Pixtral / Llama4): precomputed patch embeddings replace
    # the first ``n_image_patches`` positions (frontend stub).
    n_image_patches: int = 0
    # Infra
    vocab_pad_multiple: int = 128
    scan_layers: bool = True
    remat: str = "full"  # none | full | dots
    attention_impl: str = "xla"  # xla | xla_skip | pallas
    sequence_parallel: bool = False
    attn_q_block: int = 512
    attn_kv_block: int = 512
    attn_probs_bf16: bool = False  # bf16 PV matmul (Perf lever)
    grad_accum: int = 1  # microbatch count (memory-capacity lever)
    # Which assigned shape cells apply (long_500k only for sub-quadratic).
    skip_shapes: tuple[str, ...] = ()

    @property
    def resolved_head_dim(self) -> int:
        return (
            self.head_dim
            if self.head_dim is not None
            else self.d_model // self.n_heads
        )

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return math.ceil(self.vocab_size / m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def shapes(self) -> tuple[ShapeCell, ...]:
        return tuple(c for c in SHAPES if c.name not in self.skip_shapes)
