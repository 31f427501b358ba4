"""PyTorch/CUDA port of the optical-collective planner and its model stack.

``repro_torch`` plans collectives over an optical circuit-switched fabric
with PyTorch on an NVIDIA GPU: the grid greedy's per-step loop runs as
float64 tensor code on the device, and the schedule timing recurrence is a
hand-written CUDA kernel (`repro_torch.kernels.timing_scan`).  It serves
the dense decoder family of the model stack, with a hand-written CUDA
flash-attention kernel in every prefill layer
(`repro_torch.kernels.flash_attention`).  It mirrors the layout of the
reference package (``core/``, ``core/ir/``, ``obs/``, ``kernels/``,
``configs/``, ``models/``, ``serve/``, ``launch/``) and imports nothing
from it.

Entry points: ``repro_torch.core.api.plan(PlanRequest.grid(cells))``;
``repro_torch.models.lm.build_model(cfg)`` with
``repro_torch.serve.engine.ServeEngine(model, params).generate(requests)``
(``python -m repro_torch.launch.serve``).  Every entry point takes
``device=`` (`repro_torch.device`).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
