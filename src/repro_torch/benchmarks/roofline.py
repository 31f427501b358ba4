"""The least time an NVIDIA H100 could take for each kernel's work.

A bound is the larger of two times: the bytes the function must move
(each input read once, each output written once) at the card's memory
rate, and the operations it does on these inputs at the card's peak rate
for their type.  Where the work depends on the data (masked attention
pairs, causal chunk pairs, live timing steps), the count is what these
inputs need.  Rates: NVIDIA's H100 SXM data sheet, dense, at the full
700 W power limit.  Each function returns ``(ms, "bytes" | "operations")``.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {
    torch.bfloat16: 989e12,  # dense tensor cores
    torch.float16: 989e12,
    torch.float32: 67e12,  # CUDA cores, outside the tensor cores
    torch.float64: 34e12,
}


def bound(n_bytes: float, n_ops: float, dtype: torch.dtype) -> tuple[float, str]:
    """The larger of bytes at HBM rate and ops at ``dtype``'s peak, in ms."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def attention_flops(
    bhq: int, sq: int, skv: int, d: int, causal: bool, window: int | None
) -> int:
    """FLOPs of the two products over the unmasked (query, key) pairs."""
    q_pos = torch.arange(sq)[:, None]
    kv_pos = torch.arange(skv)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        mask &= kv_pos <= q_pos
    if window is not None:
        mask &= q_pos - kv_pos < window
    return 4 * bhq * d * int(mask.sum())


def attention_bound(
    q: torch.Tensor, k: torch.Tensor, causal: bool, window: int | None
) -> tuple[float, str]:
    """Head-major q (BHq, Sq, D), k and v (BHkv, Skv, D): q, k, v read and
    o written once; the products at q's dtype's peak."""
    bhq, sq, d = q.shape
    flops = attention_flops(bhq, sq, k.shape[1], d, causal, window)
    return bound(2 * _nbytes(q, k), flops, q.dtype)


def ssd_flops(bsz: int, heads: int, s: int, p: int, n: int, chunk: int) -> int:
    """FLOPs of the chunked scan.  Per chunk of q positions: C Bᵀ over the
    q(q+1)/2 causal pairs (2N each) once per batch row, since every head
    reads the same B and C; per row (batch x heads) the scores' product
    with xdt over those pairs (2P each), C Sᵀ and the state update (2qNP
    each)."""
    rows = bsz * heads
    chunk = min(chunk, s)
    lens = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    pairs = [q * (q + 1) // 2 for q in lens]
    flops = bsz * sum(2 * n * t for t in pairs)
    return flops + rows * sum(2 * p * t + 4 * q * n * p for q, t in zip(lens, pairs))


def ssd_bound(
    bsz: int, heads: int, s: int, p: int, n: int, chunk: int, with_init: bool
) -> tuple[float, str]:
    """Float32 head-major inputs: xdt, logd, b, c and the initial state
    read once, y and the final state written once."""
    rows = bsz * heads
    n_bytes = 4 * (2 * rows * s * p + rows * s + 2 * bsz * s * n
                   + (2 if with_init else 1) * rows * p * n)
    return bound(n_bytes, ssd_flops(bsz, heads, s, p, n, chunk), torch.float32)


def rmsnorm_bound(x: torch.Tensor, w: torch.Tensor) -> tuple[float, str]:
    """x and w read, out (x's dtype) written once; 4 float32 operations an
    element (square and add, normalize, scale)."""
    return bound(2 * _nbytes(x) + _nbytes(w), 4 * x.numel(), torch.float32)


def reduce_bound(
    a: torch.Tensor, out_dtype: torch.dtype, b: torch.Tensor | None = None
) -> tuple[float, str]:
    """a and b (of a's dtype unless given) read, out written once; one
    float32 add an element."""
    out_bytes = a.numel() * torch.empty((), dtype=out_dtype).element_size()
    in_bytes = _nbytes(a) + _nbytes(a if b is None else b)
    return bound(in_bytes + out_bytes, a.numel(), torch.float32)


def timing_scan_bound(
    tensors: dict[str, torch.Tensor], outs: tuple[torch.Tensor, ...]
) -> tuple[float, str]:
    """The packed batch read and the outputs written once; float64 ops:
    per live (step, plane) divide, add, max, busy add and step max, per
    live step 5 conservation and barrier ops, per bypass hop 5."""
    n_bytes = _nbytes(*tensors.values(), *outs)
    live = tensors["step_mask"][:, :, None] & tensors["plane_mask"][:, None, :]
    hops = (tensors["byp_plane"] >= 0) & (tensors["byp_vol"] > 0)[..., None]
    ops = 5 * int(live.sum()) + 5 * int(tensors["step_mask"].sum())
    ops += 5 * int(hops.sum())
    return bound(n_bytes, ops, torch.float64)
