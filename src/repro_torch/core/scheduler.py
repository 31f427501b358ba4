"""Sweep-scale planning entry point of the port: ``plan_grid``.

A thin delegate to `repro_torch.core.api.plan`: the batched greedy plans
every (fabric, pattern) cell together on the device
(``swot_greedy_grid``), then one more ``batch_evaluate`` pass scores the
strawman-ICR baseline for every cell, both through one ``TorchBackend``.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core.api import (
    GridCellPlan,
    PlannerOptions,
    PlanRequest,
    plan,
)
from repro_torch.core.fabric import OpticalFabric
from repro_torch.core.ir import TimingBackend
from repro_torch.core.patterns import Pattern
from repro_torch.core.schedule import DependencyMode


def plan_grid(
    cells: Sequence[tuple[OpticalFabric, Pattern]],
    backend: TimingBackend | None = None,
    rollout_horizon: int = 24,
    mode: DependencyMode = DependencyMode.CHAIN,
    bypass_depth: int = 0,
    independent_split: bool = False,
    planner: str | None = None,
    attribution: bool = False,
    device: str | None = None,
) -> list[GridCellPlan]:
    """Plan a whole sweep grid in one instance-batched pass on ``device``.

    ``mode`` picks the per-cell planner: CHAIN (the reserve-set greedy,
    with Topology-Bypassing relay candidates when ``bypass_depth >= 2``)
    or INDEPENDENT (least-finish-time packing, or water-fill splitting
    with ``independent_split=True``).  ``attribution=True`` attaches each
    cell's CCT decomposition to ``GridCellPlan.plan.attribution``.
    """
    result = plan(
        PlanRequest.grid(
            cells,
            options=PlannerOptions(
                mode=mode,
                backend=backend,
                planner=planner,
                bypass_depth=bypass_depth,
                independent_split=independent_split,
                rollout_horizon=rollout_horizon,
                attribution=attribution,
                device=device,
            ),
        )
    )
    return list(result.grid)
