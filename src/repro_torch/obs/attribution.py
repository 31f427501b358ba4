"""CCT attribution: where does the completion time go, per plane per step?

The port's copy of the reference package's attribution.  It stays numpy on
the host: the timing kernel hands its four component cubes to
``build_attribution`` (through ``finalize_result``), and the closing-idle
refinement below is what makes conservation bitwise.

The paper's claim is about *time accounting* -- how much of the
reconfiguration latency is hidden by overlapping it with other planes'
transmissions.  A scalar CCT cannot show that.  This module decomposes
the CCT of any legal schedule into five per-plane components:

* ``t_xmit``         -- time spent transmitting direct (non-relay) traffic;
* ``t_bypass``       -- time spent carrying relay hops over installed
  configs (Topology Bypassing, `repro_torch.core.bypass`);
* ``t_recfg_wait``   -- *exposed* reconfiguration time: the amount by which
  a reconfiguration delayed its plane's next transmission beyond the step
  barrier.  In CHAIN mode this is
  ``max(barrier, free + t_recfg) - max(barrier, free)`` (somewhere in
  ``[0, t_recfg]``); INDEPENDENT mode has no barrier to hide behind, so
  every reconfiguration is fully exposed.
* ``t_recfg_hidden`` -- the rest of ``t_recfg``: reconfiguration that ran
  while the step barrier would have stalled the plane anyway.  This is the
  paper's reconfiguration-communication overlap, measured.
* ``t_idle``         -- the closing term: per plane,
  ``cct - (xmit + bypass + wait + hidden)``.  Barrier stalls, ready-time
  offsets, and post-finish slack all land here.

The five components sum *bitwise* to the CCT on every backend: ``t_idle``
is defined as the exact floating-point complement (``closing_idle``
refines it below the ulp when ``cct - comp`` rounds), so conservation is
a construction invariant, not a tolerance statement.  What keeps the four
*measured* components honest is oracle parity: the array recurrence and
the object-walk ``attribute`` agree within ``repro_torch.core.tolerances``.

The derived **overlap efficiency** -- hidden / (hidden + exposed)
reconfiguration time -- is the paper's headline as a single number in
``[0, 1]``; schedules with no reconfigurations at all report 1.0
(vacuously: there was nothing to expose).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.schedule import DependencyMode, Kind, Schedule

__all__ = [
    "Attribution",
    "attribute",
    "build_attribution",
    "closing_idle",
    "component_sum",
    "step_barriers",
]


def step_barriers(schedule: Schedule) -> tuple[float, ...]:
    """Barrier in force entering each step, in schedule-relative time.

    The running max of earlier steps' transmission-window ends (bypass
    hops included) -- exactly the recurrence's carried barrier; steps
    with no transmission activity inherit the previous barrier.  Shared
    by ``attribute``, so exposed-vs-hidden splits agree bitwise
    with the batched recurrence.
    """
    n_steps = schedule.pattern.n_steps
    step_end = [-np.inf] * n_steps
    for a in schedule.activities:
        if a.kind is Kind.XMIT and a.end > step_end[a.step]:
            step_end[a.step] = a.end
    barriers = [0.0] * n_steps
    running = 0.0
    for i in range(n_steps):
        barriers[i] = running
        if step_end[i] > running:
            running = step_end[i]
    return tuple(barriers)


def component_sum(
    t_xmit: np.ndarray,
    t_bypass: np.ndarray,
    t_recfg_wait: np.ndarray,
    t_recfg_hidden: np.ndarray,
) -> np.ndarray:
    """The canonical per-plane component reduction (summed over steps).

    One fixed association order shared by every producer and consumer, so
    "components sum to the CCT" means the same float on every backend.
    """
    return (
        t_xmit.sum(axis=-2)
        + t_bypass.sum(axis=-2)
        + t_recfg_wait.sum(axis=-2)
        + t_recfg_hidden.sum(axis=-2)
    )


def closing_idle(
    cct: np.ndarray, comp: np.ndarray, plane_mask: np.ndarray
) -> np.ndarray:
    """Per-plane idle time such that ``comp + idle == cct`` *bitwise*.

    ``cct - comp`` is exact by Sterbenz's lemma whenever ``comp`` is
    within a factor of two of ``cct``; outside that range the subtraction
    can round, leaving ``comp + idle`` a ulp off.  The refinement loop
    folds that residual back into ``idle`` (each pass shrinks the error
    below the previous ulp; two passes suffice in practice, four is a
    safe bound).
    """
    cct_col = np.asarray(cct, dtype=np.float64)[..., None]
    comp = np.asarray(comp, dtype=np.float64)
    idle = np.where(plane_mask, cct_col - comp, 0.0)
    for _ in range(4):
        err = np.where(plane_mask, cct_col - (comp + idle), 0.0)
        if not err.any():
            break
        idle = idle + err
    return idle


@dataclasses.dataclass(frozen=True)
class Attribution:
    """Per-(step, plane) CCT decomposition.

    Arrays carry an optional leading batch dimension: ``attribute``
    returns ``(S, P)`` components for one schedule, the batched engine
    returns ``(B, S, P)`` (padded steps/planes hold exact zeros; use the
    masks to trim).  All reductions below work for either shape.
    """

    t_xmit: np.ndarray  # (..., S, P) direct transmission time
    t_bypass: np.ndarray  # (..., S, P) relay-hop carry time
    t_recfg_wait: np.ndarray  # (..., S, P) exposed reconfiguration time
    t_recfg_hidden: np.ndarray  # (..., S, P) overlapped reconfiguration
    t_idle: np.ndarray  # (..., P) closing term (barrier stalls, slack)
    cct: np.ndarray  # (...,) the CCT being decomposed
    step_mask: np.ndarray  # (..., S) bool
    plane_mask: np.ndarray  # (..., P) bool

    @property
    def plane_total(self) -> np.ndarray:
        """Per-plane component sum incl. idle; equals ``cct`` bitwise on
        every unmasked plane (the conservation invariant)."""
        comp = component_sum(
            self.t_xmit, self.t_bypass, self.t_recfg_wait,
            self.t_recfg_hidden,
        )
        return comp + self.t_idle

    @property
    def exposed_recfg(self) -> np.ndarray:
        """Total exposed reconfiguration time per instance, (...)."""
        return self.t_recfg_wait.sum(axis=(-2, -1))

    @property
    def hidden_recfg(self) -> np.ndarray:
        """Total overlapped reconfiguration time per instance, (...)."""
        return self.t_recfg_hidden.sum(axis=(-2, -1))

    @property
    def overlap_efficiency(self) -> np.ndarray:
        """Fraction of reconfiguration time hidden by overlap, (...).

        ``hidden / (hidden + exposed)``; 1.0 when the schedule carries no
        reconfiguration time at all (vacuous overlap).
        """
        hidden = self.hidden_recfg
        total = hidden + self.exposed_recfg
        return np.where(total > 0.0, hidden / np.where(total > 0.0, total, 1.0), 1.0)

    @property
    def bypass_time_fraction(self) -> np.ndarray:
        """Relay-carry share of all transmission time, (...)."""
        byp = self.t_bypass.sum(axis=(-2, -1))
        total = byp + self.t_xmit.sum(axis=(-2, -1))
        return np.where(total > 0.0, byp / np.where(total > 0.0, total, 1.0), 0.0)

    def summary(self) -> str:
        """One-paragraph human rendering (single-instance shapes)."""
        us = 1e6
        cct = float(np.max(self.cct)) if self.cct.ndim else float(self.cct)
        parts = [
            f"cct {cct * us:.1f} us",
            f"xmit {float(self.t_xmit.sum()) * us:.1f} us",
            f"bypass {float(self.t_bypass.sum()) * us:.1f} us",
            f"recfg exposed {float(self.exposed_recfg.sum()) * us:.1f} us",
            f"hidden {float(self.hidden_recfg.sum()) * us:.1f} us",
            f"idle {float(self.t_idle.sum()) * us:.1f} us",
            f"overlap eff {float(np.mean(self.overlap_efficiency)):.2f}",
        ]
        return ", ".join(parts)


def build_attribution(
    cct: np.ndarray,
    t_xmit: np.ndarray,
    t_bypass: np.ndarray,
    t_recfg_wait: np.ndarray,
    t_recfg_hidden: np.ndarray,
    plane_mask: np.ndarray,
    step_mask: np.ndarray,
) -> Attribution:
    """Close the decomposition: derive ``t_idle`` and wrap the arrays.

    The shared epilogue for every timing backend (called from
    ``repro_torch.core.ir.engine.finalize_result``), so the conservation
    construction cannot drift between the kernel and its plain version.
    """
    cct = np.asarray(cct, dtype=np.float64)
    arrs = tuple(
        np.asarray(a, dtype=np.float64)
        for a in (t_xmit, t_bypass, t_recfg_wait, t_recfg_hidden)
    )
    plane_mask = np.asarray(plane_mask, dtype=bool)
    step_mask = np.asarray(step_mask, dtype=bool)
    idle = closing_idle(cct, component_sum(*arrs), plane_mask)
    return Attribution(
        t_xmit=arrs[0],
        t_bypass=arrs[1],
        t_recfg_wait=arrs[2],
        t_recfg_hidden=arrs[3],
        t_idle=idle,
        cct=cct,
        step_mask=step_mask,
        plane_mask=plane_mask,
    )


def attribute(schedule: Schedule) -> Attribution:
    """Decompose one timed ``Schedule`` by walking its activities.

    The object-path oracle for the vectorized attribution in
    ``batch_evaluate(..., attribution=True)``: works on any legal
    schedule, not just earliest-start ones.  Exposed reconfiguration time uses the counterfactual
    earliest start -- ``max(barrier, r.end) - max(barrier, r.start)``
    against the barrier in force when the reconfiguration's step begins
    -- clamped to ``[0, t_recfg]``.
    """
    n_steps = schedule.pattern.n_steps
    n_planes = schedule.fabric.n_planes
    t_xmit = np.zeros((n_steps, n_planes))
    t_bypass = np.zeros((n_steps, n_planes))
    t_wait = np.zeros((n_steps, n_planes))
    t_hidden = np.zeros((n_steps, n_planes))

    barrier_before = step_barriers(schedule)

    chain = schedule.mode is DependencyMode.CHAIN
    for a in schedule.activities:
        dur = a.end - a.start
        if a.kind is Kind.XMIT:
            if a.route >= 0:
                t_bypass[a.step, a.plane] += dur
            else:
                t_xmit[a.step, a.plane] += dur
        else:
            if chain:
                b = barrier_before[a.step]
                wait = min(max(max(b, a.end) - max(b, a.start), 0.0), dur)
            else:
                wait = dur
            t_wait[a.step, a.plane] += wait
            t_hidden[a.step, a.plane] += dur - wait

    return build_attribution(
        cct=np.float64(schedule.cct),
        t_xmit=t_xmit,
        t_bypass=t_bypass,
        t_recfg_wait=t_wait,
        t_recfg_hidden=t_hidden,
        plane_mask=np.ones(n_planes, dtype=bool),
        step_mask=np.ones(n_steps, dtype=bool),
    )
