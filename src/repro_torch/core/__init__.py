"""Optical-collective scheduling core of the port.

Fabric and pattern models, schedule objects and the executor (copies of
the reference's, host-side), the array IR with its device-side scoring
(`repro_torch.core.ir`), the grid greedy (`repro_torch.core.greedy`) and
the planning facade (`repro_torch.core.api`).
"""

from repro_torch.core.api import (
    GridCellPlan,
    PlannerOptions,
    PlanRequest,
    PlanResult,
    plan,
)
from repro_torch.core.baselines import (
    ideal_cct,
    prestage_for,
    strawman_cct,
    strawman_decisions,
    strawman_icr,
    strawman_instance,
)
from repro_torch.core.fabric import FIG5_LINK_BANDWIDTH, OpticalFabric
from repro_torch.core.greedy import GridPlan, swot_greedy_grid
from repro_torch.core.ir import (
    BatchInstance,
    BatchResult,
    TorchBackend,
    batch_evaluate,
    evaluate_decisions,
)
from repro_torch.core.patterns import ALGORITHMS, Pattern, get_pattern
from repro_torch.core.schedule import Decisions, DependencyMode, Schedule
from repro_torch.core.scheduler import plan_grid
from repro_torch.core.simulator import execute

__all__ = [
    "ALGORITHMS",
    "BatchInstance",
    "BatchResult",
    "Decisions",
    "DependencyMode",
    "FIG5_LINK_BANDWIDTH",
    "GridCellPlan",
    "GridPlan",
    "OpticalFabric",
    "Pattern",
    "PlanRequest",
    "PlanResult",
    "PlannerOptions",
    "Schedule",
    "TorchBackend",
    "batch_evaluate",
    "evaluate_decisions",
    "execute",
    "get_pattern",
    "ideal_cct",
    "plan",
    "plan_grid",
    "prestage_for",
    "strawman_cct",
    "strawman_decisions",
    "strawman_icr",
    "strawman_instance",
    "swot_greedy_grid",
]
