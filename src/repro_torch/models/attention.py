"""Attention implementations: blocked (flash-style, plain torch) and decode.

The port of ``src/repro/models/attention.py``.  ``blocked_attention`` is
the ``xla`` / ``xla_skip`` route of ``ArchConfig.attention_impl``: an
online softmax over key/value blocks with O(S * block) memory instead of
the O(S^2) logits tensor.  Two modes:

* default: every KV block is computed and masked, for every query block
  (the reference's ``lax.map`` body), so causal attention does ~2x the
  minimal FLOPs;
* ``skip_blocks=True``: fully masked KV blocks (past the causal diagonal,
  wholly outside the window, wholly padding) are skipped per query block.

``decode_attention`` scores a single query against a KV cache.
``reference_attention`` is the O(S^2)-memory oracle of the tests.  The
``pallas`` route is the hand-written kernel,
`repro_torch.kernels.flash_attention`.

The reference's ``sharded_decode_attention`` (cache sharded over a mesh
axis) waits for the port's mesh (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def _block_scores(
    q_blk: torch.Tensor,  # (B, qb, Hq, D)
    k_blk: torch.Tensor,  # (B, kb, Hkv, D)
    scale: float,
) -> torch.Tensor:
    """Grouped-query scores (B, Hq, qb, kb) in fp32."""
    b, qb, hq, d = q_blk.shape
    _, kb, hkv, _ = k_blk.shape
    group = hq // hkv
    q32 = q_blk.float().reshape(b, qb, hkv, group, d)
    k32 = k_blk.float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q32, k32) * scale
    return scores.reshape(b, hq, qb, kb)


def _apply_mask(
    scores: torch.Tensor,  # (B, Hq, qb, kb)
    q_pos: torch.Tensor,  # (qb,)
    kv_pos: torch.Tensor,  # (kb,)
    kv_len: int,
    causal: bool,
    window: int | None,
) -> torch.Tensor:
    mask = kv_pos[None, :] < kv_len  # padding
    if causal:
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
    return torch.where(mask[None, None], scores, _NEG_INF)


def _attend_block(
    carry: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    q_blk: torch.Tensor,
    k_blk: torch.Tensor,
    v_blk: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    kv_len: int,
    causal: bool,
    window: int | None,
    scale: float,
    probs_bf16: bool = False,
):
    """One online-softmax accumulation step.

    ``probs_bf16``: cast the probability block to bf16 for the PV product
    (the reference's perf lever; ~1e-3 relative output error).
    """
    m_prev, l_prev, acc_prev = carry
    scores = _apply_mask(
        _block_scores(q_blk, k_blk, scale),
        q_pos,
        kv_pos,
        kv_len,
        causal,
        window,
    )
    m_blk = scores.amax(dim=-1)  # (B, Hq, qb)
    m_new = torch.maximum(m_prev, m_blk)
    correction = torch.exp(m_prev - m_new)
    p = torch.exp(scores - m_new[..., None])  # (B, Hq, qb, kb)
    b, kb, hkv, d = v_blk.shape
    hq = p.shape[1]
    group = hq // hkv
    # bf16 operands, float32 products and sums (as preferred_element_type).
    p_mm = p.to(torch.bfloat16).float() if probs_bf16 else p
    v_mm = (v_blk.to(torch.bfloat16) if probs_bf16 else v_blk).float()
    pv = torch.einsum(
        "bhgqk,bkhd->bhgqd",
        p_mm.reshape(b, hkv, group, p.shape[2], kb),
        v_mm,
    ).reshape(b, hq, p.shape[2], d)
    l_new = l_prev * correction + p.sum(dim=-1)
    acc_new = acc_prev * correction[..., None] + pv
    return m_new, l_new, acc_new


def blocked_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, D)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    q_block: int = 512,
    kv_block: int = 512,
    skip_blocks: bool = False,
    probs_bf16: bool = False,
) -> torch.Tensor:
    """Flash-style blocked attention; returns (B, Sq, Hq, D) in q.dtype.

    ``q_offset`` is the absolute position of q[0] (prefill continuation).
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    scale = 1.0 / math.sqrt(d)
    q_block = min(q_block, sq)
    kv_block = min(kv_block, skv)
    nq = math.ceil(sq / q_block)
    nkv = math.ceil(skv / kv_block)
    sq_pad, skv_pad = nq * q_block, nkv * kv_block
    dev = q.device
    if sq_pad != sq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, sq_pad - sq))
    if skv_pad != skv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, skv_pad - skv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, skv_pad - skv))
    kv_pos_all = torch.arange(skv_pad, device=dev)

    outs = []
    for qb_idx in range(nq):
        lo_pos = q_offset + qb_idx * q_block
        hi_pos = lo_pos + q_block - 1
        kv_indices = []
        for kb_idx in range(nkv):
            kv_lo = kb_idx * kv_block
            kv_hi = (kb_idx + 1) * kv_block - 1
            if skip_blocks and (
                (causal and kv_lo > hi_pos)  # entirely in the future
                or (window is not None and lo_pos - kv_hi >= window)
                or kv_lo >= skv  # entirely padding
            ):
                continue
            kv_indices.append(kb_idx)
        q_blk = q[:, qb_idx * q_block : (qb_idx + 1) * q_block]
        q_pos = lo_pos + torch.arange(q_block, device=dev)
        carry = (
            torch.full((b, hq, q_block), _NEG_INF, device=dev),
            torch.zeros((b, hq, q_block), device=dev),
            torch.zeros((b, hq, q_block, d), device=dev),
        )
        for kb_idx in kv_indices:
            sl = slice(kb_idx * kv_block, (kb_idx + 1) * kv_block)
            carry = _attend_block(
                carry, q_blk, k[:, sl], v[:, sl], q_pos, kv_pos_all[sl],
                skv, causal, window, scale, probs_bf16,
            )
        _, l, acc = carry
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=2)  # (B, Hq, Sq_pad, D)
    out = out[:, :, :sq].transpose(1, 2)  # (B, Sq, Hq, D)
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, 1, Hq, D)
    k_cache: torch.Tensor,  # (B, Smax, Hkv, D)
    v_cache: torch.Tensor,  # (B, Smax, Hkv, D)
    cache_len: torch.Tensor,  # (B,) valid entries per sequence
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Single-token attention against a KV cache: (B, 1, Hq, D)."""
    b, _, hq, d = q.shape
    _, smax, hkv, _ = k_cache.shape
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    q32 = q.float().reshape(b, hkv, group, d)
    scores = (
        torch.einsum("bhgd,bshd->bhgs", q32, k_cache.float()) * scale
    )  # (B, Hkv, G, Smax)
    pos = torch.arange(smax, device=q.device)[None]  # (1, Smax)
    mask = pos < cache_len[:, None]
    if window is not None:
        mask = mask & (pos >= cache_len[:, None] - window)
    scores = torch.where(mask[:, None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhgs,bshd->bhgd", probs, v_cache.float()
    ).reshape(b, 1, hq, d)
    return out.to(q.dtype)


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """O(S^2)-memory oracle used by tests."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    q32 = q.float().reshape(b, sq, hkv, group, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q32, k.float()) * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)
    kv_pos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= q_pos[:, None] - kv_pos[None, :] < window
    scores = torch.where(mask[None, None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)
