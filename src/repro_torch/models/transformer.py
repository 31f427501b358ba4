"""Transformer building blocks: attention (GQA/rope/SWA/qk-norm), FFNs.

The port of ``src/repro/models/transformer.py``.  ``*_specs`` builds the
ParamSpec tree, ``*_fwd`` consumes materialized params (the reference's
layouts, e.g. ``wq`` (d, heads, head_dim)).  Full-sequence attention is
selected by ``ArchConfig.attention_impl``:

* ``xla``       -- `repro_torch.models.attention.blocked_attention`
* ``xla_skip``  -- same, causal/window block skipping (min FLOPs)
* ``pallas``    -- `repro_torch.kernels.flash_attention.flash_attention`
                   (the hand-written CUDA kernel; its plain version on
                   CPU tensors)

The projections, GLU products and the like are plain products
(``torch.einsum`` / ``@``), as the reference leaves them to XLA.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attention as flash_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (
    ParamSpec,
    activation,
    apply_rope,
    layer_norm,
    rms_norm,
    rope_frequencies,
)

# ---------------------------------------------------------------------------
# Norms.


def norm_specs(cfg: ArchConfig) -> dict[str, ParamSpec]:
    if cfg.norm == "rmsnorm":
        init = "zeros" if cfg.rms_offset else "ones"
        return {"w": ParamSpec((cfg.d_model,), ("embed",), init=init)}
    return {
        "w": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "b": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
    }


def norm_fwd(params, x, cfg: ArchConfig):
    if cfg.norm == "rmsnorm":
        return rms_norm(
            x, params["w"], eps=cfg.norm_eps, offset=cfg.rms_offset
        )
    return layer_norm(x, params["w"], params["b"], eps=cfg.norm_eps)


# ---------------------------------------------------------------------------
# Attention.


def attention_specs(cfg: ArchConfig, cross: bool = False) -> dict:
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    specs: dict = {
        "wq": ParamSpec((d, hq, dh), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, hkv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, hkv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec(
            (hq, dh, d),
            ("heads", "head_dim", "embed"),
            scale=1.0 / (hq * dh) ** 0.5,
        ),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((hq, dh), ("heads", "head_dim"), init="zeros")
        specs["bk"] = ParamSpec(
            (hkv, dh), ("kv_heads", "head_dim"), init="zeros"
        )
        specs["bv"] = ParamSpec(
            (hkv, dh), ("kv_heads", "head_dim"), init="zeros"
        )
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((dh,), ("head_dim",), init="ones")
        specs["k_norm"] = ParamSpec((dh,), ("head_dim",), init="ones")
    del cross  # cross-attention uses the same parameter shapes
    return specs


def attention_qkv(
    params,
    x: torch.Tensor,  # (B, S, D) query-side input
    kv_input: torch.Tensor,  # (B, Skv, D) key/value-side input
    cfg: ArchConfig,
    positions: torch.Tensor | None,  # (B, S) or (S,) absolute positions
    kv_positions: torch.Tensor | None = None,
    use_rope: bool = True,
):
    """Project to q/k/v with optional bias, qk-norm and rope."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", kv_input, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", kv_input, params["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], eps=cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], eps=cfg.norm_eps)
    if use_rope and positions is not None:
        dh = cfg.resolved_head_dim
        cos_q, sin_q = rope_frequencies(dh, cfg.rope_theta, positions)
        q = apply_rope(q, cos_q, sin_q)
        kp = positions if kv_positions is None else kv_positions
        cos_k, sin_k = rope_frequencies(dh, cfg.rope_theta, kp)
        k = apply_rope(k, cos_k, sin_k)
    return q, k, v


def attention_context(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cfg: ArchConfig,
    *,
    causal: bool,
) -> torch.Tensor:
    """Dispatch to the configured full-sequence attention implementation."""
    window = cfg.sliding_window if causal else None
    if cfg.attention_impl == "pallas":
        return flash_lib.flash_attention(q, k, v, causal=causal, window=window)
    return attn_lib.blocked_attention(
        q,
        k,
        v,
        causal=causal,
        window=window,
        q_block=cfg.attn_q_block,
        kv_block=cfg.attn_kv_block,
        skip_blocks=cfg.attention_impl == "xla_skip",
        probs_bf16=cfg.attn_probs_bf16,
    )


def attention_out(params, ctx_out: torch.Tensor) -> torch.Tensor:
    return torch.einsum(
        "bshk,hkd->bsd", ctx_out, params["wo"].to(ctx_out.dtype)
    )


def self_attention_fwd(
    params,
    x: torch.Tensor,
    cfg: ArchConfig,
    *,
    causal: bool = True,
    use_rope: bool = True,
) -> torch.Tensor:
    """Full-sequence self-attention (training / encoder)."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device) if use_rope else None
    q, k, v = attention_qkv(params, x, x, cfg, positions, use_rope=use_rope)
    ctx = attention_context(q, k, v, cfg, causal=causal)
    return attention_out(params, ctx)


# ---------------------------------------------------------------------------
# Feed-forward.


def glu_specs(d_model: int, d_ff: int) -> dict[str, ParamSpec]:
    return {
        "w_gate": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w_up": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w_down": ParamSpec(
            (d_ff, d_model), ("mlp", "embed"), scale=1.0 / d_ff**0.5
        ),
    }


def glu_fwd(params, x: torch.Tensor, act_name: str) -> torch.Tensor:
    act = activation(act_name)
    h = act(x @ params["w_gate"].to(x.dtype)) * (
        x @ params["w_up"].to(x.dtype)
    )
    return h @ params["w_down"].to(x.dtype)


def mlp_specs(d_model: int, d_ff: int) -> dict[str, ParamSpec]:
    return {
        "w_in": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "b_in": ParamSpec((d_ff,), ("mlp",), init="zeros"),
        "w_out": ParamSpec(
            (d_ff, d_model), ("mlp", "embed"), scale=1.0 / d_ff**0.5
        ),
        "b_out": ParamSpec((d_model,), ("embed",), init="zeros"),
    }


def mlp_fwd(params, x: torch.Tensor, act_name: str) -> torch.Tensor:
    act = activation(act_name)
    h = act(x @ params["w_in"].to(x.dtype) + params["b_in"].to(x.dtype))
    return h @ params["w_out"].to(x.dtype) + params["b_out"].to(x.dtype)
