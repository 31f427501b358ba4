"""Public wrappers around the port's kernels, in the models' layouts.

The counterpart of the reference's ``src/repro/kernels/ops.py``, with its
four wrappers and their return values.  The reference's ``interpret``
argument has no counterpart: the tensors' device picks the route -- the
hand-written CUDA kernel on a card, its plain torch version on the CPU.

* ``flash_attention(q, k, v, causal=, window=)`` -- (B, S, H, D) in and
  out (`repro_torch.kernels.flash_attention`).
* ``ssd_scan(x, dt, a_log, b, c, chunk=)`` -- Mamba2 SSD in the model
  layout; returns y (B, S, H, P) in x's dtype, as the reference's does.
  The models call `repro_torch.kernels.ssd_scan.ssd_scan`, which also
  returns the final state.
* ``fused_reduce(a, b, out_dtype=)`` -- a + b in float32, cast to
  ``out_dtype``, any shape (`repro_torch.kernels.fused_reduce`, whose
  ``fused_reduce_flat`` takes any shape as it is).
* ``rmsnorm(x, weight, eps=, offset=)`` -- RMSNorm over the last dim of
  (..., D) (`repro_torch.kernels.rmsnorm`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_reduce import fused_reduce_flat as fused_reduce
from repro_torch.kernels.rmsnorm import rmsnorm


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) post-softplus
    a_log: torch.Tensor,  # (H,)
    b: torch.Tensor,  # (B, S, N)
    c: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = _ssd.MAX_CHUNK,
) -> torch.Tensor:
    """Mamba2 SSD in the model layout, from a zero state: y (B, S, H, P)
    in x's dtype."""
    y, _ = _ssd.ssd_scan(x, dt, a_log, b, c, chunk=chunk)
    return y


__all__ = ["flash_attention", "fused_reduce", "rmsnorm", "ssd_scan"]
