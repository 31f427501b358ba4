"""Model assembly: embedding -> layers -> head, per family.

The port of ``src/repro/models/lm.py`` for the decoder (dense and vlm),
ssm (Mamba2) and hybrid (Zamba2) families: ``build_model(cfg, device=)``
returns a ``Model`` bundle whose fields mirror the reference's:

* ``init(generator)``                 -- materialize the params tree
* ``prefill(params, batch)``          -- full-sequence forward; returns the
                                         last-position logits and a cache
                                         ready for decoding
* ``decode_step(params, cache, tokens)`` -- one-token step
* ``specs`` / ``cache_specs(batch, max_len)`` -- ParamSpec trees

Params keep the reference's tree and layouts, layers stacked on axis 0
(the hybrid's groups doubly stacked), float32 masters cast to
``COMPUTE_DTYPE`` (bf16) per call as the reference casts them.  The layer
loop is a Python loop over views of the stacks: the reference's
``scan_layers`` and ``remat`` change nothing in an eager forward without
gradients.  ``decode_step`` writes the new token's K/V and each Mamba2
layer's conv and SSM states into the cache in place (the reference returns
a new cache), which saves a copy of the whole cache per token.  The cache
keeps the conv state in ``COMPUTE_DTYPE`` and the SSM state in float32.
Each Mamba2 layer's prefill runs the chunked scan through the
``ssd_scan`` CUDA kernel (`repro_torch.models.ssm`); the hybrid's shared
attention block is a decoder layer, with its own KV cache per invocation.
Sharding (``ctx.constrain``, the mesh) is a single-device no-op here until
the port's mesh (ROADMAP item 12).

Not ported yet, raising ``NotImplementedError``: the moe and audio
families (ROADMAP Queue 1 item 8) and ``sequence_parallel`` (item 12);
the training loss (item 9).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import ssm as ssm_lib
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


# ---------------------------------------------------------------------------
# Mamba2 (ssm) family.


def _mamba_layer_specs(cfg: ArchConfig) -> dict:
    return {
        "ln": tfm.norm_specs(cfg),
        "mamba": ssm_lib.mamba2_param_specs(
            cfg.d_model,
            cfg.d_inner,
            cfg.n_ssm_heads,
            cfg.ssm_state,
            cfg.ssm_conv,
        ),
    }


def _mamba_layer_full(lp, x: torch.Tensor, cfg: ArchConfig):
    """Prefill Mamba2 layer; returns (x, conv_state, ssm_state)."""
    h = tfm.norm_fwd(lp["ln"], x, cfg)
    y, conv_state, ssm_state = ssm_lib.mamba2_forward(
        h,
        lp["mamba"],
        n_heads=cfg.n_ssm_heads,
        head_dim=cfg.ssm_head_dim,
        d_state=cfg.ssm_state,
        chunk=cfg.ssm_chunk,
        norm_eps=cfg.norm_eps,
        return_states=True,
    )
    return x + y, conv_state.to(COMPUTE_DTYPE), ssm_state


def _mamba_layer_decode(lp, x: torch.Tensor, cache: dict, i: int, cfg: ArchConfig):
    """One-token Mamba2 layer ``i``; its conv and SSM states in ``cache``
    are overwritten in place."""
    h = tfm.norm_fwd(lp["ln"], x, cfg)
    y, conv_state, ssm_state = ssm_lib.mamba2_decode_step(
        h,
        lp["mamba"],
        cache["conv"][i],
        cache["ssm"][i],
        n_heads=cfg.n_ssm_heads,
        head_dim=cfg.ssm_head_dim,
        d_state=cfg.ssm_state,
        norm_eps=cfg.norm_eps,
    )
    cache["conv"][i] = conv_state
    cache["ssm"][i] = ssm_state
    return x + y


def _mamba_state_specs(cfg: ArchConfig, batch: int) -> dict:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": ParamSpec(
            (cfg.n_layers, batch, cfg.ssm_conv - 1, conv_ch),
            ("layers", "batch", None, "ssm_conv_ch"),
            init="zeros",
            dtype=COMPUTE_DTYPE,
        ),
        "ssm": ParamSpec(
            (
                cfg.n_layers,
                batch,
                cfg.n_ssm_heads,
                cfg.ssm_head_dim,
                cfg.ssm_state,
            ),
            ("layers", "batch", "ssm_heads", None, "ssm_state"),
            init="zeros",
            dtype=torch.float32,
        ),
    }


def _length_spec(batch: int) -> ParamSpec:
    return ParamSpec((batch,), ("batch",), init="zeros", dtype=torch.int32)


def _mamba_cache_specs(cfg: ArchConfig, batch: int, max_len: int):
    del max_len  # recurrent state is O(1) in sequence length
    return {**_mamba_state_specs(cfg, batch), "length": _length_spec(batch)}


def _build_mamba_model(cfg: ArchConfig, device: torch.device) -> Model:
    specs = dict(_embed_specs(cfg))
    specs["layers"] = stack_specs(_mamba_layer_specs(cfg), cfg.n_layers)
    specs["final_norm"] = tfm.norm_specs(cfg)

    def prefill(params, batch):
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = _embed(params, tokens, cfg)
        conv_states, ssm_states = [], []
        for i in range(cfg.n_layers):
            x, conv_state, ssm_state = _mamba_layer_full(
                _layer(params["layers"], i), x, cfg
            )
            conv_states.append(conv_state)
            ssm_states.append(ssm_state)
        x = tfm.norm_fwd(params["final_norm"], x, cfg)
        logits = _logits(params, x[:, -1:], cfg)[:, 0]
        cache = {
            "conv": torch.stack(conv_states),
            "ssm": torch.stack(ssm_states),
            "length": torch.full((b,), s, dtype=torch.int32, device=x.device),
        }
        return logits, cache

    def decode_step(params, cache, tokens):
        x = _embed(params, tokens, cfg)
        for i in range(cfg.n_layers):
            x = _mamba_layer_decode(_layer(params["layers"], i), x, cache, i, cfg)
        x = tfm.norm_fwd(params["final_norm"], x, cfg)
        logits = _logits(params, x, cfg)[:, 0]
        return logits, {**cache, "length": cache["length"] + 1}

    return Model(
        cfg=cfg,
        device=device,
        specs=specs,
        init=lambda generator: init_params(specs, generator, device),
        prefill=prefill,
        decode_step=decode_step,
        cache_specs=functools.partial(_mamba_cache_specs, cfg),
    )


# ---------------------------------------------------------------------------
# Zamba2 (hybrid) family: Mamba2 stack + one *shared* attention block.


def _hybrid_layout(cfg: ArchConfig) -> tuple[int, int]:
    """(n_groups, trailing): groups of ``period`` mamba layers + shared
    attention block, then ``trailing`` mamba layers."""
    period = cfg.hybrid_period
    n_groups = cfg.n_layers // period
    trailing = cfg.n_layers - n_groups * period
    return n_groups, trailing


def _hybrid_cache_specs(cfg: ArchConfig, batch: int, max_len: int):
    n_groups, _ = _hybrid_layout(cfg)
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    kv = ParamSpec(
        (n_groups, batch, max_len, hkv, dh),
        ("groups", "batch", "kv_seq", "kv_heads", "head_dim"),
        init="zeros",
        dtype=COMPUTE_DTYPE,
    )
    return {
        **_mamba_state_specs(cfg, batch),
        "shared_k": kv,
        "shared_v": kv,
        "length": _length_spec(batch),
    }


def _build_hybrid_model(cfg: ArchConfig, device: torch.device) -> Model:
    # The shared block decodes through the decoder layer, whose sliding-
    # window ring would diverge from the reference's write at ``length``.
    if cfg.sliding_window is not None:
        raise ValueError("the hybrid family has no sliding window")
    n_groups, trailing = _hybrid_layout(cfg)
    period = cfg.hybrid_period
    specs = dict(_embed_specs(cfg))
    specs["groups"] = stack_specs(
        stack_specs(_mamba_layer_specs(cfg), period, axis_name="layers"),
        n_groups,
        axis_name="groups",
    )
    specs["trailing"] = stack_specs(_mamba_layer_specs(cfg), trailing)
    specs["shared"] = _decoder_layer_specs(cfg)
    specs["final_norm"] = tfm.norm_specs(cfg)

    def mamba_blocks(params):
        """Each group's Mamba2 layer params, then the trailing layers'."""
        for g in range(n_groups):
            group = _layer(params["groups"], g)
            yield [_layer(group, i) for i in range(period)]
        yield [_layer(params["trailing"], i) for i in range(trailing)]

    def prefill(params, batch):
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = _embed(params, tokens, cfg)
        conv_states, ssm_states, ks, vs = [], [], [], []
        for g, block in enumerate(mamba_blocks(params)):
            for lp in block:
                x, conv_state, ssm_state = _mamba_layer_full(lp, x, cfg)
                conv_states.append(conv_state)
                ssm_states.append(ssm_state)
            if g < n_groups:
                x, (k, v) = _decoder_layer_full(params["shared"], x, cfg)
                ks.append(k.to(COMPUTE_DTYPE))
                vs.append(v.to(COMPUTE_DTYPE))
        x = tfm.norm_fwd(params["final_norm"], x, cfg)
        logits = _logits(params, x[:, -1:], cfg)[:, 0]
        cache = {
            "conv": torch.stack(conv_states),
            "ssm": torch.stack(ssm_states),
            "shared_k": torch.stack(ks),
            "shared_v": torch.stack(vs),
            "length": torch.full((b,), s, dtype=torch.int32, device=x.device),
        }
        return logits, cache

    def decode_step(params, cache, tokens):
        x = _embed(params, tokens, cfg)
        length = cache["length"]
        li = 0
        for g, block in enumerate(mamba_blocks(params)):
            for lp in block:
                x = _mamba_layer_decode(lp, x, cache, li, cfg)
                li += 1
            if g < n_groups:
                kv = {"k": cache["shared_k"][g], "v": cache["shared_v"][g]}
                x = _decoder_layer_decode(params["shared"], x, kv, length, cfg)
        x = tfm.norm_fwd(params["final_norm"], x, cfg)
        logits = _logits(params, x, cfg)[:, 0]
        return logits, {**cache, "length": length + 1}

    return Model(
        cfg=cfg,
        device=device,
        specs=specs,
        init=lambda generator: init_params(specs, generator, device),
        prefill=prefill,
        decode_step=decode_step,
        cache_specs=functools.partial(_hybrid_cache_specs, cfg),
    )


_NOT_PORTED = {
    "moe": "models/moe.py, ROADMAP Queue 1 item 8",
    "audio": "models/encdec.py, ROADMAP Queue 1 item 8",
}
_FAMILIES = {
    "dense": _build_decoder_model,
    "vlm": _build_decoder_model,
    "ssm": _build_mamba_model,
    "hybrid": _build_hybrid_model,
}


def build_model(
    cfg: ArchConfig, *, device: "str | torch.device | None" = None
) -> Model:
    """The model of ``cfg`` on ``device`` (None: the card)."""
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
    if family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _FAMILIES[family](cfg, resolve_device(device))
