"""Observability of the port: CCT attribution (host-side numpy)."""

from repro_torch.obs.attribution import (
    Attribution,
    attribute,
    build_attribution,
    closing_idle,
    component_sum,
    step_barriers,
)

__all__ = [
    "Attribution",
    "attribute",
    "build_attribution",
    "closing_idle",
    "component_sum",
    "step_barriers",
]
