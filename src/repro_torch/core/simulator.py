"""Event-driven executor: derive earliest-start timing from discrete decisions.

The port's copy of the reference package's object-path executor: it turns
grid decisions into validated ``Schedule`` objects (``GridPlan.schedule``).

Given per-step volume splits across planes (``Decisions``), the executor
derives the unique earliest-start timed schedule:

* a plane whose installed config differs from its next assigned step's
  config starts reconfiguring immediately after its previous activity ends
  (this is the paper's reconfiguration-communication overlap: the
  reconfiguration runs while *other* planes are still transmitting);
* transmissions start at ``max(step barrier, plane ready)`` in CHAIN mode
  (paper's P3), or at plane-ready in INDEPENDENT mode;
* bypass relays (``Decisions.bypass``) run BEFORE the step's direct
  traffic -- they ride the planes' *installed* configs, so they must
  precede any reconfiguration the direct splits force -- with
  store-and-forward hop serialization: hop 0 starts like a direct
  transmission, hop ``k+1`` at ``max(hop k end, plane ready)``;
* CCT follows deterministically.

Earliest-start timing is *optimal* for fixed discrete decisions: every
legality constraint is a lower bound on a start time, so the schedule is a
longest-path evaluation of the precedence DAG.  Optimizing CCT therefore
reduces to choosing the splits -- which is what the grid greedy
(`repro_torch.core.greedy`) does.

The executor doubles as the fault-injection point for straggler studies:
``OpticalFabric.plane_bandwidth_scale`` models degraded optical planes and
the schedulers re-balance splits around them.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core.fabric import OpticalFabric
from repro_torch.core.patterns import Pattern
from repro_torch.core.schedule import (
    Decisions,
    DependencyMode,
    Kind,
    PlaneActivity,
    Schedule,
)
from repro_torch.core.tolerances import EPS_VOLUME as _EPS_VOLUME


def execute(
    fabric: OpticalFabric,
    pattern: Pattern,
    decisions: Decisions,
    plane_ready: Sequence[float] | None = None,
    validate: bool = True,
) -> Schedule:
    """Derive the earliest-start ``Schedule`` for ``decisions``.

    ``plane_ready`` optionally gives a per-plane earliest activity time
    (default all-zero): the arbiter re-plans a job onto planes that free
    at different instants and threads those offsets through here.
    ``validate=False`` skips the legality check (earliest-start timing is
    legal by construction; callers that immediately re-validate, like
    benchmarks pitting specific validators against each other, opt out).
    """
    if len(decisions.splits) != pattern.n_steps:
        raise ValueError(
            f"decisions cover {len(decisions.splits)} steps, pattern has "
            f"{pattern.n_steps}"
        )
    n_planes = fabric.n_planes
    config: list[int | None] = [
        fabric.initial_config(j) for j in range(n_planes)
    ]
    if plane_ready is None:
        free = [0.0] * n_planes
    else:
        if len(plane_ready) != n_planes:
            raise ValueError("plane_ready length mismatch")
        if any(r < 0 for r in plane_ready):
            raise ValueError("plane_ready times must be non-negative")
        free = list(plane_ready)
    activities: list[PlaneActivity] = []
    barrier = 0.0  # end of previous step's window (CHAIN mode)
    bypass = decisions.bypass
    if bypass is not None and len(bypass) != pattern.n_steps:
        raise ValueError(
            f"bypass covers {len(bypass)} steps, pattern has "
            f"{pattern.n_steps}"
        )
    chain = decisions.mode is DependencyMode.CHAIN
    route_id = 0

    for i, step in enumerate(pattern.steps):
        split = decisions.splits[i]
        step_end = barrier
        active = sorted(
            (j, v) for j, v in split.items() if v > _EPS_VOLUME
        )
        routes = (
            [r for r in bypass[i] if r.volume > _EPS_VOLUME]
            if bypass is not None
            else []
        )
        if not active and not routes and step.volume > _EPS_VOLUME:
            raise ValueError(f"step {i} has volume but no active planes")
        # Bypass relays first: they ride installed configs, so they must
        # precede any reconfiguration this step's direct splits force.
        for route in routes:
            if len(route.planes) < 2:
                raise ValueError(
                    f"step {i} bypass route needs >= 2 hops, got "
                    f"{route.planes}"
                )
            prev_end = barrier if chain else 0.0
            for hop, j in enumerate(route.planes):
                if not 0 <= j < n_planes:
                    raise ValueError(
                        f"unknown plane {j} in step {i} bypass route"
                    )
                if config[j] is None:
                    raise ValueError(
                        f"step {i} bypass route rides unconfigured "
                        f"plane {j}"
                    )
                start = max(prev_end, free[j])
                end = start + route.volume / fabric.plane_bandwidth(j)
                activities.append(
                    PlaneActivity(
                        plane=j,
                        kind=Kind.XMIT,
                        step=i,
                        start=start,
                        end=end,
                        config=config[j],
                        volume=route.volume,
                        route=route_id,
                        hop=hop,
                    )
                )
                free[j] = end
                prev_end = end
            route_id += 1
            step_end = max(step_end, prev_end)
        for j, volume in active:
            if not 0 <= j < n_planes:
                raise ValueError(f"unknown plane {j} in step {i} split")
            if config[j] != step.config:
                start = free[j]
                end = start + fabric.t_recfg
                activities.append(
                    PlaneActivity(
                        plane=j,
                        kind=Kind.RECFG,
                        step=i,
                        start=start,
                        end=end,
                        config=step.config,
                    )
                )
                config[j] = step.config
                free[j] = end
            if decisions.mode is DependencyMode.CHAIN:
                start = max(barrier, free[j])
            else:
                start = free[j]
            end = start + volume / fabric.plane_bandwidth(j)
            activities.append(
                PlaneActivity(
                    plane=j,
                    kind=Kind.XMIT,
                    step=i,
                    start=start,
                    end=end,
                    config=step.config,
                    volume=volume,
                )
            )
            free[j] = end
            step_end = max(step_end, end)
        barrier = step_end

    schedule = Schedule(
        fabric=fabric,
        pattern=pattern,
        activities=tuple(activities),
        mode=decisions.mode,
    )
    if validate:
        schedule.validate()
    return schedule

