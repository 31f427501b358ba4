"""Model assembly for the decoder family: embedding -> layers -> head.

The port of ``src/repro/models/lm.py``, decoder family (dense and vlm):
``build_model(cfg, device=)`` returns a ``Model`` bundle whose fields
mirror the reference's:

* ``init(generator)``                 -- materialize the params tree
* ``prefill(params, batch)``          -- full-sequence forward; returns the
                                         last-position logits and a KV cache
                                         ready for decoding
* ``decode_step(params, cache, tokens)`` -- one-token step
* ``specs`` / ``cache_specs(batch, max_len)`` -- ParamSpec trees

Params keep the reference's tree and layouts, layers stacked on axis 0,
float32 masters cast to ``COMPUTE_DTYPE`` (bf16) per call as the reference
casts them.  The layer loop is a Python loop over views of the stacks: the
reference's ``scan_layers`` and ``remat`` change nothing in an eager
forward without gradients.  ``decode_step`` writes the new token's K/V
into the cache in place (the reference returns a new cache), which saves a
copy of the whole cache per token.  Sharding (``ctx.constrain``, the mesh)
is a single-device no-op here until the port's mesh (ROADMAP item 12).

Not ported in this slice, raising ``NotImplementedError``: the moe, ssm,
hybrid and audio families (ROADMAP Queue 1 item 8) and
``sequence_parallel`` (item 12); the training loss (item 9).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import decode_attention
from repro_torch.models.common import (
    ParamSpec,
    init_params,
    stack_specs,
    tree_map,
)

COMPUTE_DTYPE = torch.bfloat16
Pytree = Any


class Model(NamedTuple):
    cfg: ArchConfig
    device: torch.device
    specs: Pytree
    init: Callable[[torch.Generator], Pytree]
    prefill: Callable[[Pytree, dict], tuple[torch.Tensor, Pytree]]
    decode_step: Callable[
        [Pytree, Pytree, torch.Tensor], tuple[torch.Tensor, Pytree]
    ]
    cache_specs: Callable[[int, int], Pytree]


# ---------------------------------------------------------------------------
# Shared pieces.


def _embed_specs(cfg: ArchConfig) -> dict[str, ParamSpec]:
    v, d = cfg.padded_vocab, cfg.d_model
    specs = {
        "embedding": ParamSpec(
            (v, d), ("vocab", "embed"), init="embed", scale=0.02
        )
    }
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((d, v), ("embed", "vocab"))
    return specs


def _embed(params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = params["embedding"][tokens.long()].to(COMPUTE_DTYPE)
    if cfg.embed_scale:
        # A 0-dim CPU tensor: rounded to bf16 first, as the reference's
        # constant, and no host-to-device copy.
        x = x * torch.tensor(cfg.d_model**0.5, dtype=COMPUTE_DTYPE)
    return x


def _fuse_image(x: torch.Tensor, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Early fusion: precomputed patch embeddings replace the first
    ``n_image_patches`` positions (the modality-frontend stub)."""
    if cfg.n_image_patches and "image_embeds" in batch:
        img = batch["image_embeds"].to(x.dtype)
        x = x.clone()
        x[:, : img.shape[1]] = img
    return x


def _logits(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.einsum(
            "bsd,vd->bsv", x, params["embedding"].to(x.dtype)
        )
    return torch.einsum("bsd,dv->bsv", x, params["head"].to(x.dtype))


def _layer(stacked: Pytree, i: int) -> Pytree:
    return tree_map(lambda p: p[i], stacked)


# ---------------------------------------------------------------------------
# Decoder (dense / vlm) family.


def _decoder_layer_specs(cfg: ArchConfig) -> dict:
    return {
        "ln1": tfm.norm_specs(cfg),
        "attn": tfm.attention_specs(cfg),
        "ln2": tfm.norm_specs(cfg),
        "ffn": tfm.glu_specs(cfg.d_model, cfg.d_ff),
    }


def _decoder_layer_full(lp, x: torch.Tensor, cfg: ArchConfig):
    """Prefill decoder layer; returns (x, (k, v))."""
    h = tfm.norm_fwd(lp["ln1"], x, cfg)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    q, k, v = tfm.attention_qkv(lp["attn"], h, h, cfg, positions)
    ctx_out = tfm.attention_context(q, k, v, cfg, causal=True)
    x = x + tfm.attention_out(lp["attn"], ctx_out)
    h2 = tfm.norm_fwd(lp["ln2"], x, cfg)
    return x + tfm.glu_fwd(lp["ffn"], h2, cfg.act), (k, v)


def _swa_cache_len(cfg: ArchConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def _ring_pack(k: torch.Tensor, w: int) -> torch.Tensor:
    """Pack the last ``w`` positions of (B, S, H, D) into ring order."""
    s = k.shape[1]
    if s <= w:
        return torch.nn.functional.pad(k, (0, 0, 0, 0, 0, w - s))
    tail = k[:, -w:]
    slots = (s - w + torch.arange(w, device=k.device)) % w
    out = torch.zeros_like(tail)
    out[:, slots] = tail
    return out


def _decoder_layer_decode(
    lp, x: torch.Tensor, cache: dict, length: torch.Tensor, cfg: ArchConfig
):
    """One-token decoder layer; cache = {'k','v'} (B, Smax, Hkv, Dh),
    updated in place at each sequence's slot."""
    h = tfm.norm_fwd(lp["ln1"], x, cfg)
    pos = length[:, None]  # (B, 1) absolute positions
    q, k, v = tfm.attention_qkv(lp["attn"], h, h, cfg, pos)
    ck, cv = cache["k"], cache["v"]
    w = ck.shape[1]
    slot = (length % w if cfg.sliding_window is not None else length).long()
    bidx = torch.arange(x.shape[0], device=x.device)
    ck[bidx, slot] = k[:, 0].to(ck.dtype)
    cv[bidx, slot] = v[:, 0].to(cv.dtype)
    eff_len = (
        torch.clamp(length + 1, max=w)
        if cfg.sliding_window is not None
        else length + 1
    )
    ctx_out = decode_attention(q, ck, cv, eff_len)
    x = x + tfm.attention_out(lp["attn"], ctx_out)
    h2 = tfm.norm_fwd(lp["ln2"], x, cfg)
    return x + tfm.glu_fwd(lp["ffn"], h2, cfg.act)


def _decoder_specs(cfg: ArchConfig) -> Pytree:
    specs = dict(_embed_specs(cfg))
    specs["layers"] = stack_specs(_decoder_layer_specs(cfg), cfg.n_layers)
    specs["final_norm"] = tfm.norm_specs(cfg)
    return specs


def _decoder_cache_specs(cfg: ArchConfig, batch: int, max_len: int):
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    w = _swa_cache_len(cfg, max_len)
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {
        "k": ParamSpec(
            (cfg.n_layers, batch, w, hkv, dh),
            kv_axes,
            init="zeros",
            dtype=COMPUTE_DTYPE,
        ),
        "v": ParamSpec(
            (cfg.n_layers, batch, w, hkv, dh),
            kv_axes,
            init="zeros",
            dtype=COMPUTE_DTYPE,
        ),
        "length": ParamSpec(
            (batch,), ("batch",), init="zeros", dtype=torch.int32
        ),
    }


def _build_decoder_model(cfg: ArchConfig, device: torch.device) -> Model:
    specs = _decoder_specs(cfg)

    def prefill(params, batch):
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = _embed(params, tokens, cfg)
        x = _fuse_image(x, batch, cfg)
        w = _swa_cache_len(cfg, s)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            x, (k, v) = _decoder_layer_full(_layer(params["layers"], i), x, cfg)
            if cfg.sliding_window is not None:
                k, v = _ring_pack(k, w), _ring_pack(v, w)
            ks.append(k.to(COMPUTE_DTYPE))
            vs.append(v.to(COMPUTE_DTYPE))
        hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
        empty = torch.zeros((0, b, w, hkv, dh), dtype=COMPUTE_DTYPE, device=x.device)
        x = tfm.norm_fwd(params["final_norm"], x, cfg)
        logits = _logits(params, x[:, -1:], cfg)[:, 0]
        cache = {
            "k": torch.stack(ks) if ks else empty,
            "v": torch.stack(vs) if vs else empty,
            "length": torch.full((b,), s, dtype=torch.int32, device=x.device),
        }
        return logits, cache

    def decode_step(params, cache, tokens):
        x = _embed(params, tokens, cfg)
        length = cache["length"]
        for i in range(cfg.n_layers):
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
            x = _decoder_layer_decode(
                _layer(params["layers"], i), x, layer_cache, length, cfg
            )
        x = tfm.norm_fwd(params["final_norm"], x, cfg)
        logits = _logits(params, x, cfg)[:, 0]
        return logits, {"k": cache["k"], "v": cache["v"], "length": length + 1}

    return Model(
        cfg=cfg,
        device=device,
        specs=specs,
        init=lambda generator: init_params(specs, generator, device),
        prefill=prefill,
        decode_step=decode_step,
        cache_specs=functools.partial(_decoder_cache_specs, cfg),
    )


_NOT_PORTED = {
    "moe": "models/moe.py, ROADMAP Queue 1 item 8",
    "ssm": "models/ssm.py and the ssd_scan kernel, ROADMAP Queue 1 item 8",
    "hybrid": "models/ssm.py and the ssd_scan kernel, ROADMAP Queue 1 item 8",
    "audio": "models/encdec.py, ROADMAP Queue 1 item 8",
}


def build_model(
    cfg: ArchConfig, *, device: "str | torch.device | None" = None
) -> Model:
    """The decoder model of ``cfg`` on ``device`` (None: the card)."""
    if cfg.sequence_parallel:
        raise NotImplementedError(
            "sequence_parallel needs the port's mesh (ROADMAP Queue 1 item 12)"
        )
    family = "moe" if cfg.is_moe else cfg.family
    if family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {family} family is not ported yet "
            f"({_NOT_PORTED[family]})"
        )
    if family not in ("dense", "vlm"):
        raise ValueError(f"unknown family {cfg.family!r}")
    return _build_decoder_model(cfg, resolve_device(device))
