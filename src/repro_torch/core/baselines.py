"""Baseline schedulers from the paper's evaluation (Section 4.1.1).

The port's copy of the reference package's strawman and ideal baselines:

* **Strawman-ICR** -- naive intra-collective reconfiguration: every plane
  carries every step; on a config change all planes reconfigure in lockstep,
  pausing the collective for ``t_recfg`` (the paper's Fig. 5(a)).
* **Ideal** -- transmission at full aggregate NIC bandwidth, no
  reconfiguration or network constraints.

The one-shot baseline (static provisioning) is not ported yet.
"""

from __future__ import annotations

from repro_torch.core.fabric import OpticalFabric
from repro_torch.core.patterns import Pattern
from repro_torch.core.schedule import Decisions, Schedule
from repro_torch.core.simulator import execute


def prestage_for(fabric: OpticalFabric, pattern: Pattern) -> OpticalFabric:
    """All planes pre-staged at the first step's config (paper Fig. 5)."""
    return fabric.prestaged(pattern.steps[0].config)


def ideal_cct(fabric: OpticalFabric, pattern: Pattern) -> float:
    """CCT with no network constraints: aggregate bandwidth, zero reconfig."""
    total_bw = sum(fabric.plane_bandwidth(j) for j in range(fabric.n_planes))
    return sum(step.volume / total_bw for step in pattern.steps)


def _proportional_split(
    fabric: OpticalFabric, planes: list[int], volume: float
) -> dict[int, float]:
    total = sum(fabric.plane_bandwidth(j) for j in planes)
    return {
        j: volume * fabric.plane_bandwidth(j) / total for j in planes
    }


def strawman_decisions(fabric: OpticalFabric, pattern: Pattern) -> Decisions:
    """Strawman-ICR discrete decisions: every plane serves every step."""
    planes = list(range(fabric.n_planes))
    return Decisions(
        splits=tuple(
            _proportional_split(fabric, planes, step.volume)
            for step in pattern.steps
        )
    )


def strawman_icr(fabric: OpticalFabric, pattern: Pattern) -> Schedule:
    """Naive ICR: all planes, lockstep reconfiguration, no overlap."""
    return execute(fabric, pattern, strawman_decisions(fabric, pattern))


def strawman_cct(
    fabric: OpticalFabric, pattern: Pattern, device: str | None = None
) -> float:
    """Strawman-ICR CCT through the array IR on ``device``."""
    from repro_torch.core.ir import evaluate_decisions

    return evaluate_decisions(
        fabric, pattern, strawman_decisions(fabric, pattern), device=device
    ).cct


def strawman_instance(
    fabric: OpticalFabric, pattern: Pattern, prestage: bool = False
):
    """One ``BatchInstance`` evaluating the strawman on ``fabric``.

    ``prestage=True`` first stages every plane at the pattern's opening
    config (paper Fig. 5 setup).
    """
    from repro_torch.core.ir import BatchInstance

    if prestage:
        fabric = prestage_for(fabric, pattern)
    return BatchInstance(
        fabric, pattern, strawman_decisions(fabric, pattern)
    )
