"""Blocked online-softmax attention: CUDA kernel, plain version, wrapper.

``flash_attention_bhsd(q, k, v, causal=, window=)`` computes head-major
attention: q (BHq, Sq, D), k and v (BHkv, Skv, D), query row ``bh``
reading KV row ``bh // (BHq // BHkv)`` (GQA).  Scores ``q.k^T / sqrt(D)``
in float32, masked (``kv_pos >= Skv``; ``kv_pos > q_pos`` if causal;
``q_pos - kv_pos >= window`` if a window is given) to -1e30, not -inf;
an online softmax over KV blocks with float32 m, l and acc; the output
``acc / max(l, 1e-30)`` in q's dtype.

* ``flash_attention_bhsd_cuda`` launches ``csrc/flash_attention.cu``
  (built at first use, `repro_torch.kernels._build`), the port of the
  reference's Pallas kernel ``src/repro/kernels/flash_attention.py``
  (``_kernel``).  It takes CUDA tensors only.  bfloat16 and float16 run
  on the tensor cores (``wgmma`` on tiles that TMA loads, P.V at float32
  accuracy), float32 on the CUDA cores; the kernel's C entry point
  dispatches on the dtype.  The tensor-core path steps the head dim by
  16, so a 16-bit D that is not a multiple of 16 is zero-padded to one
  (``pad_head_dim``, one copy of q, k and v) and the output sliced back;
  the scale stays ``1/sqrt(D)`` of the true D.
* ``flash_attention_bhsd_plain`` is the same blocked online softmax in
  plain torch, vectorized over heads and query rows, one KV block per loop
  turn, with the same sentinel and float32 math.  It is the kernel's
  yardstick on the card and what runs on the CPU.
* ``flash_attention_bhsd`` dispatches on the tensors' device: the plain
  version for CPU tensors, the kernel for CUDA tensors (never the plain
  version on a card).  ``flash_attention_bhsd.launches`` counts kernel
  launches.
* ``flash_attention`` is the model-layout wrapper of the reference's
  ``src/repro/kernels/ops.py`` (``flash_attention``): (B, S, H, D) in and
  out, heads folded so that one KV group's query heads stay adjacent.

Rows with no unmasked key at all (only possible with a window and
``Sq >= Skv + window``) are outside the contract: the reference's value
there depends on its block padding.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

KV_BLOCK = 64  # the kernel's key tile; the plain version's block
MAX_HEAD_DIM = 256
MAX_QUERY_ROWS = 65535  # the kernel's grid.y
NEG_INF = -1e30  # the reference's mask sentinel (not -inf)
# The C entry point's codes beyond the CUDA runtime's errors.
_NO_ENCODE_ENTRY, _ENCODE_FAILED = 1999, 2000
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # C codes


def check_inputs(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None
) -> tuple[int, int, int, int, int]:
    """Validate head-major inputs; return ``(BHq, BHkv, Sq, Skv, D)``.

    Raises ``ValueError`` on a rank, shape, dtype or device mismatch, a
    query-row count that is not a multiple of the KV rows, or a window
    below 1.
    """
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k and v must be 3-D (BH, S, D)")
    bhq, sq, d = q.shape
    bhkv, skv, dk = k.shape
    if tuple(v.shape) != (bhkv, skv, dk) or dk != d:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not fit"
        )
    if bhkv < 1 or bhq % bhkv:
        raise ValueError(f"{bhq} query rows are not a multiple of {bhkv} KV rows")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: want one of {list(_DTYPES)}"
        )
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v lie on different devices")
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1")
    return bhq, bhkv, sq, skv, d


def flash_attention_bhsd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """The blocked online softmax in plain torch, on any device, in the
    kernel's KV blocks.  ``scale`` (default ``1/sqrt(D)``) is the kernel's
    own argument; given, it holds head-dim-padded inputs to the unpadded
    result."""
    bhq, bhkv, sq, skv, d = check_inputs(q, k, v, window)
    group = bhq // bhkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    dev = q.device
    # (BHkv, group * Sq, D): the query rows of one KV row, adjacent.
    q32 = q.float().reshape(bhkv, group * sq, d)
    q_pos = torch.arange(sq, device=dev).repeat(group)[:, None]
    m = torch.full((bhkv, group * sq, 1), NEG_INF, device=dev)
    l = torch.zeros((bhkv, group * sq, 1), device=dev)
    acc = torch.zeros((bhkv, group * sq, d), device=dev)
    for k0 in range(0, skv, KV_BLOCK):
        kb = k[:, k0 : k0 + KV_BLOCK].float()
        vb = v[:, k0 : k0 + KV_BLOCK].float()
        scores = torch.matmul(q32, kb.transpose(1, 2)) * scale
        kv_pos = torch.arange(k0, k0 + kb.shape[1], device=dev)[None, :]
        mask = kv_pos < skv
        if causal:
            mask = mask & (kv_pos <= q_pos)
        if window is not None:
            mask = mask & (q_pos - kv_pos < window)
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        correction = torch.exp(m - m_new)
        acc = acc * correction + torch.matmul(p, vb)
        l = l * correction + p.sum(dim=-1, keepdim=True)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(bhq, sq, d).to(q.dtype)


def kernel_head_dim(d: int, dtype: torch.dtype) -> int:
    """The head dim the kernel is given: a 16-bit D rounded up to a
    multiple of 16 (the tensor-core path's k16 step), float32 as it is."""
    return d if dtype == torch.float32 else -(-d // 16) * 16


def pad_head_dim(x: torch.Tensor, dg: int) -> torch.Tensor:
    """x (BH, S, D) zero-padded to (BH, S, dg); x itself if D == dg.  Zero
    columns add nothing to q.k and give zero output columns."""
    d = x.shape[-1]
    return x if d == dg else torch.nn.functional.pad(x, (0, dg - d))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    # Every pointer and the stream as c_void_p: left undeclared, ctypes
    # would pass them as 32-bit ints.
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int64] * 5
        + [ctypes.c_int, ctypes.c_int64, ctypes.c_float, ctypes.c_int]
        + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def flash_attention_bhsd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.

    Takes CUDA tensors only (raises ``ValueError`` otherwise), head dims
    up to ``MAX_HEAD_DIM`` and up to ``MAX_QUERY_ROWS`` query rows; raises
    ``RuntimeError`` if the launch, or for 16-bit inputs the encoding of a
    tensor map, fails.  ``Skv == 0`` gives zeros (no key: acc = 0, l = 0)
    without a launch.
    """
    bhq, bhkv, sq, skv, d = check_inputs(q, k, v, window)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(
            f"flash_attention_bhsd_cuda takes CUDA tensors, got tensors on {dev}"
        )
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    if bhq > MAX_QUERY_ROWS:
        raise ValueError(f"{bhq} query rows > {MAX_QUERY_ROWS}")
    if max(sq, skv) >= 2**31:
        raise ValueError(f"sequence lengths {sq}, {skv} do not fit 32 bits")
    if not (bhq and sq and skv):
        return torch.zeros_like(q)
    dg = kernel_head_dim(d, q.dtype)
    # Contiguous, and 16-byte aligned for the tensor maps' rows.
    q, k, v = (
        x if x.data_ptr() % 16 == 0 else x.clone()
        for x in (pad_head_dim(t, dg).contiguous() for t in (q, k, v))
    )
    out = torch.empty_like(q)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    stream = torch.cuda.current_stream(index).cuda_stream
    err = _library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bhq, bhkv, sq, skv, dg,
        int(causal), -1 if window is None else int(window),
        1.0 / math.sqrt(d), _DTYPES[q.dtype],
        index, stream,
    )
    if err >= _ENCODE_FAILED:
        raise RuntimeError(
            f"flash_attention: cuTensorMapEncodeTiled failed (CUresult "
            f"{err - _ENCODE_FAILED})"
        )
    if err == _NO_ENCODE_ENTRY:
        raise RuntimeError(
            "flash_attention: the driver provides no cuTensorMapEncodeTiled"
        )
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention_bhsd.launches += 1
    return out if dg == d else out[..., :d].contiguous()


def flash_attention_bhsd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Head-major attention on the tensors' device.

    CPU tensors run ``flash_attention_bhsd_plain``; CUDA tensors launch the
    kernel (``flash_attention_bhsd_cuda``) or raise.
    """
    if q.device.type == "cpu":
        return flash_attention_bhsd_plain(q, k, v, causal=causal, window=window)
    return flash_attention_bhsd_cuda(q, k, v, causal=causal, window=window)


flash_attention_bhsd.launches = 0


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, D)
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Model-layout flash attention: (B, S, H, D) in and out."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    # Head-major fold: (B, S, H, D) -> (B*H, S, D); queries of one KV
    # group stay adjacent so the kernel's bh // group indexing works.
    qm = q.transpose(1, 2).reshape(b * hq, sq, d)
    km = k.transpose(1, 2).reshape(b * hkv, skv, d)
    vm = v.transpose(1, 2).reshape(b * hkv, skv, d)
    out = flash_attention_bhsd(qm, km, vm, causal=causal, window=window)
    return out.reshape(b, hq, sq, d).transpose(1, 2)
