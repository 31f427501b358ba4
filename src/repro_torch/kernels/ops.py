"""Public wrappers around the port's kernels, in the models' layouts.

The counterpart of the reference's ``src/repro/kernels/ops.py``, with its
four wrappers.  The reference's ``interpret`` argument has no counterpart:
the tensors' device picks the route -- the hand-written CUDA kernel on a
card, its plain torch version on the CPU.

* ``flash_attention(q, k, v, causal=, window=)`` -- (B, S, H, D) in and
  out (`repro_torch.kernels.flash_attention`).
* ``ssd_scan(x, dt, a_log, b, c, chunk=, init_state=)`` -- Mamba2 SSD in
  the model layout; returns ``(y, final_state)``, where the reference's
  returns y alone (`repro_torch.kernels.ssd_scan`).
* ``fused_reduce(a, b, out_dtype=)`` -- a + b in float32, cast to
  ``out_dtype``, any shape (`repro_torch.kernels.fused_reduce`, whose
  ``fused_reduce_flat`` takes any shape as it is).
* ``rmsnorm(x, weight, eps=, offset=)`` -- RMSNorm over the last dim of
  (..., D) (`repro_torch.kernels.rmsnorm`).
"""

from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_reduce import fused_reduce_flat as fused_reduce
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = ["flash_attention", "fused_reduce", "rmsnorm", "ssd_scan"]
