"""PyTorch/CUDA port of the optical-collective planner.

``repro_torch`` plans collectives over an optical circuit-switched fabric
with PyTorch on an NVIDIA GPU: the grid greedy's per-step loop runs as
float64 tensor code on the device, and the schedule timing recurrence is a
hand-written CUDA kernel (`repro_torch.kernels.timing_scan`).  It mirrors
the layout of the reference package (``core/``, ``core/ir/``, ``obs/``,
``kernels/``) and imports nothing from it.

Entry point: ``repro_torch.core.api.plan(PlanRequest.grid(cells))``.
Every entry point takes ``device=`` (`repro_torch.device`).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
